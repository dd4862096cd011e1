"""Runtime support: deterministic fault injection and the training loop."""
