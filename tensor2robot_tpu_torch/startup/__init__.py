"""Start-up plumbing: the kernel build cache and its watch
(`compile_cache`), the overlapped startup phases (`orchestrator`) and
the cold-start probes (`coldstart`, run as `python -m`)."""
