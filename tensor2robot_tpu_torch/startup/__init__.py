"""Start-up plumbing: the kernel build cache's watch and the overlapped
startup phases (`orchestrator`); the cold-start probes
(`startup/coldstart.py`) are ROADMAP A12."""
