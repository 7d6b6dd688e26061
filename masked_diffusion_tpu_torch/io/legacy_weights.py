"""Legacy model weights from the JAX package's Flax parameter trees.

One function per family turns a Flax variables dict (numpy or array
leaves) of masked_diffusion_tpu/models/{gan,ebgan,saliency}.py into the
state dict of the port's model of the same name, to be loaded with
strict=True. The port's submodules carry the Flax module names, so the
tensor names are the tree's paths joined by ".", and the layouts change:

  conv kernel HWIO (kh, kw, in, out)      -> weight (out, in, kh, kw)
  ConvTranspose kernel (kh, kw, in, out)  -> weight (in, out, kh, kw),
      flipped in space (Flax convolves with the kernel as stored; torch's
      transposed conv with it flipped; models/ebgan.py: AutoEncoder)
  Dense kernel (in, out)                  -> weight (out, in)
  GroupNorm scale / bias                  -> weight / bias
  a scalar gamma (PAM, CAM)               -> gamma, as it is

The NHWC flatten order needs no permuted kernel: the port's models permute
to NHWC around every flatten and reshape (models/ebgan.py).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[tuple, Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert(variables: Mapping[str, Any], renames: Mapping[str, str] = None,
             transposed: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    params = variables.get("params", variables)
    renames = renames or {}
    transposed = set(transposed)
    out = {}
    for path, leaf in _leaves(params):
        *mods, name = path
        arr = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            name = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif mods[-1] in transposed:
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                arr = arr.transpose(3, 2, 0, 1)
        elif name == "scale":
            name = "weight"
        key = ".".join([renames.get(m, m) for m in mods] + [name])
        out[key] = torch.from_numpy(arr.copy())  # C order; a 0-d gamma stays 0-d
    return out


def gan_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """models/gan.py's Generator or Discriminator."""
    return _convert(variables)


def ebgan_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """models/ebgan.py's EBGenerator, EBDiscriminator or AutoEncoder (whose
    dec1 and dec2 are the transposed convs)."""
    return _convert(variables, transposed=("dec1", "dec2"))


def saliency_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """models/saliency.py's GeneratorLatent, GeneratorBaseLine or Descriptor
    (ResidualStage's unnamed GroupNorm_0 is `norm` in the port)."""
    return _convert(variables, renames={"GroupNorm_0": "norm"})
