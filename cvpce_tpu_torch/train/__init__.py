"""Training: the GLN detector's step, checkpoints and epoch loop."""
