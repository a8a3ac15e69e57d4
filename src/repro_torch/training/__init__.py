"""Training: the optimizers and the fault-tolerant training loop."""
