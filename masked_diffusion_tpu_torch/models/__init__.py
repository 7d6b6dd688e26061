"""The time-conditioned UNet and its factory."""
