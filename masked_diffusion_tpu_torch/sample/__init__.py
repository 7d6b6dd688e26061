"""The reverse-process sampler, its latents and standalone generation."""
