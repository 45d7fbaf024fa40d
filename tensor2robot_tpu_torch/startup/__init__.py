"""Start-up plumbing: the kernel build cache's watch (the rest of the
JAX package's `startup/` is ROADMAP A12)."""
