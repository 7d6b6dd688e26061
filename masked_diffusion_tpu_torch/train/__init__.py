"""Training: optimizer and LR laws, the train step, the epoch loop."""
