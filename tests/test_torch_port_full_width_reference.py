"""tests/data/jax_full_width.npz is what the JAX package computes now.

Each output array of the file is recomputed in memory by
tests/jax_full_width.py (the JAX package on the CPU at the flagship's full
width; a part of the file at a time, computed at its first array) and held
to the committed array within relative L2 1e-5, which allows for another
XLA-CPU vector width and nothing more: a change to the JAX package, or to
the inputs, seeds or weights the file records, fails here until the file
is written again (`python -m tests.jax_full_width`). The part that holds
the port to the file is tests/test_torch_port_full_width.py. Most of the
~4 minutes here is XLA compiling the four train steps.
"""

import numpy as np
import pytest

from masked_diffusion_tpu_torch.tools import full_width as fw

DRIFT = 1e-5
KEYS = fw.output_keys()


@pytest.fixture(scope="module")
def fresh():
    """part -> its arrays, computed at the first request."""
    from tests.jax_full_width import Reference

    jax_side, parts = Reference(), {}

    def get(part):
        if part not in parts:
            kind, _, mode = part.partition("-")
            parts[part] = jax_side.train(mode) if kind == "train" else getattr(jax_side, kind)()
        return parts[part]

    return get


@pytest.fixture(scope="module")
def committed():
    return fw.load()


@pytest.mark.parametrize("key", list(KEYS))
def test_reference_array_is_what_jax_computes(fresh, committed, key):
    value, old = fresh(KEYS[key])[key], committed[key]
    assert old.shape == value.shape and old.dtype == value.dtype, key
    if value.dtype.kind in "US":
        np.testing.assert_array_equal(old, value, err_msg=key)
        return
    assert np.isfinite(value).all(), key
    drift = np.linalg.norm(np.ravel(value - old)) / np.linalg.norm(np.ravel(old))
    assert drift <= DRIFT, f"{key}: relative L2 {drift:.3g} from the committed file"
