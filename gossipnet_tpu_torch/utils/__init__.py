"""Training utilities: metrics logging, step timing, checkpoints."""
