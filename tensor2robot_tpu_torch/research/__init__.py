"""Research model families."""
