"""masked_diffusion_tpu_torch — the PyTorch/CUDA port of masked_diffusion_tpu.

The JAX package beside this one stays the reference; every module here mirrors
the module of the same name there (ops/schedule.py <-> ops/schedule.py, ...),
and the tests hold each against its counterpart. This package imports torch and
never jax. Importing it builds and loads no kernel: the CUDA sources under
csrc/ compile on first use (ops/build.py).
"""

__version__ = "0.1.0"
