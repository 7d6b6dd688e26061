"""The time-conditioned UNet and its factory; the legacy GAN, EBGAN and
saliency models (gan.py, ebgan.py, saliency.py)."""
