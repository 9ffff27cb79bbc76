"""Training: the trainer CLI, train steps, optimizer, checkpoints, metrics."""
