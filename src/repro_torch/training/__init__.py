"""Training of the port: the optimizers and the training loop."""
