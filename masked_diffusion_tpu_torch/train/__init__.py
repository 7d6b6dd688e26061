"""Training: optimizer and LR laws, the train step, the epoch loop; the
legacy GAN/EBM trainer (gan_trainer.py)."""
