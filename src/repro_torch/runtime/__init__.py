"""Runtime support: deterministic fault injection."""
