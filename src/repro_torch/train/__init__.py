"""Training substrate of the port: optimizers, the train step, CFS checkpoints."""
