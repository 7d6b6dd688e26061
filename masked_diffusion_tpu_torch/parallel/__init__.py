"""Data, tensor and spatial parallelism on torch.distributed (counterpart of masked_diffusion_tpu/parallel)."""
