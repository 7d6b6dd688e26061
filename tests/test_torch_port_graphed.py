"""The graph-safe pieces of the train step (no JAX here: the card's tests
live in files that do not import it).

On the CPU: the exact-k wrapper's `seeds` route draws the kernel's Philox
at the tensor's (seed, offset), so its plain version equals the `bits`
route fed philox_kmask_bits; StepInputs takes the step's seeds from its CPU
generator in the order the eager step always drew them (a device
generator's seed, then the mask kernel's (seed, offset) or the
thresholding generator's seed). On the card (marked `cuda`): the seeded
kernel entry equals the by-value one bitwise, and a CUDA graph that
captured it draws new masks, exactly k an image, whenever the seeds tensor
is rewritten; the GroupNorm backward's counters refuse to be made under a
capture.
"""

import pytest
import torch

from masked_diffusion_tpu_torch.config import Config
from masked_diffusion_tpu_torch.ops import kmask
from masked_diffusion_tpu_torch.ops.degrade import generator_seed
from masked_diffusion_tpu_torch.ops.fused_degrade import philox_kmask_bits
from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan
from masked_diffusion_tpu_torch.train.step import StepInputs

B, H, W = 4, 16, 16


def _counts():
    return torch.tensor([0, 17, H * W - 1, H * W], dtype=torch.int32)


def test_seeds_route_is_the_kernels_philox_on_the_cpu():
    seeds = torch.tensor([123456789012345, 987654321098765], dtype=torch.int64)
    got = kmask.exact_count_masks(B, H, W, _counts(), seeds=seeds)
    bits = philox_kmask_bits(*seeds.tolist(), B, H * W)
    assert torch.equal(got, kmask.exact_count_masks(B, H, W, _counts(), bits=bits))
    assert (got == 0).sum(dim=(1, 2, 3)).tolist() == [0, 17, H * W - 1, H * W]
    with pytest.raises(ValueError, match="bits or seeds"):
        kmask.exact_count_masks(B, H, W, _counts(), seeds=seeds, bits=bits)
    with pytest.raises(TypeError, match="int64 \\(2,\\)"):
        kmask.exact_count_masks(B, H, W, _counts(), seeds=seeds.to(torch.int32))


@pytest.mark.parametrize("select", ["indexing", "thresholding"])
@pytest.mark.parametrize("rank", [0, 1])
def test_step_seeds_follow_the_eager_draw_order(select, rank):
    """host_seeds draws what the eager step drew from the same generator:
    ops/degrade.py:device_generator's seed first, then the sharded mask
    kernel's (ops/kmask.py: its generator folded with the data rank) or the
    thresholding field's generator's seed."""
    plan = MeshPlan(device=torch.device("cpu"), data_size=2, rank=rank)
    inputs = StepInputs(torch.device("cpu"), Config(select_degrade_pixel=select), plan)
    got = inputs.host_seeds(torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    want = (generator_seed(gen),)
    if select == "indexing":
        want += kmask.philox_seed(kmask.fold_generator(gen, rank))
    else:
        want += (generator_seed(gen),)
    assert got == want


@pytest.mark.cuda
def test_seeded_kernel_in_a_graph_draws_anew():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from masked_diffusion_tpu_torch.ops import groupnorm

    counts = _counts().cuda()
    seeds = torch.tensor([11, 22], dtype=torch.int64, device="cuda")
    by_value = kmask.exact_count_masks(B, H, W, counts,
                                       generator=torch.Generator().manual_seed(3))
    seed, offset = kmask.philox_seed(torch.Generator().manual_seed(3))
    seeds.copy_(torch.tensor([seed, offset]))
    assert torch.equal(kmask.exact_count_masks(B, H, W, counts, seeds=seeds), by_value)

    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = kmask.exact_count_masks(B, H, W, counts, seeds=seeds)
        with pytest.raises(RuntimeError, match="reserve"):
            groupnorm.reserve_counters(torch.device("cuda"), stream)
    seen = []
    for s in range(3):
        seeds.copy_(torch.tensor([s + 1, 7 * s]))
        graph.replay()
        torch.cuda.synchronize()
        want = kmask.exact_count_masks(
            B, H, W, counts.cpu(), bits=philox_kmask_bits(s + 1, 7 * s, B, H * W))
        assert torch.equal(out.cpu(), want)
        seen.append(out.clone())
    assert not torch.equal(seen[0], seen[1]) and not torch.equal(seen[1], seen[2])
