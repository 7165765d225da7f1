"""Training substrate: optimizers, losses and the single-device loop."""
