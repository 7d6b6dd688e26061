"""The train step, and the train-visuals pass of the save cadence.

Counterpart of masked_diffusion_tpu/train/step.py:_make_step_impl
(:103-217) and make_train_visuals_fn (:278-340), which share the work before
the UNet (_make_prepare). `base` and `mean_shift` are one step with the shift stage off
or on. Per step:

  timestep draw from the epoch's curriculum -> degrade (the exact-k mask
  kernel in indexing mode) -> (shift) -> UNet under autocast (bf16 for
  --mixed_precision bf16; every GroupNorm forward and backward is a CUDA
  kernel on CUDA) -> recon = net_in + out -> (inverse shift) -> (weighted)
  MSE in fp32 -> backward -> global-norm clip(1.0) -> optimizer update ->
  EMA update on sync steps.

The step makes no host sync: the schedule's per-timestep tables live on the
device, seeds come from a CPU torch.Generator, the counters are host
numbers, the LR and the EMA decay reach the device as 0-d tensors (one copy
from pinned memory a step), and the metrics come back as 0-d device tensors
for the trainer to fetch once per epoch (under a plan, the rank's own: the
trainer takes their mean over the ranks in that fetch).

The step's device work is one body (_make_body) that reads its per-step
inputs from tensors that stay put (StepInputs) and changes no host count,
so `make_train_epoch` (JAX's whole-epoch scan, --epoch_scan true) captures
it into a CUDA graph and replays it once a batch: the eager step and the
replay run the same kernels on the same numbers. Its draws on a card come
from device generators that the host reseeds each step from the step's CPU
generator, and from the mask kernel's Philox at a (seed, offset) it reads
from the device (ops/kmask.py); the optimizer's gradients are static
tensors zeroed in place, and its update reads the LR as a tensor
(train/optim.py). The UNet runs under autocast with no cast cache.

`draws=` is the one injection point: a TrainDraws giving the timestep
indices, the mask draws and the shift draws of the step, so the tests and
the smoke check can feed both packages the same random numbers.

Data-parallel (a parallel/mesh.MeshPlan of N > 1 ranks, one process each):
create_train_state wraps the model in DistributedDataParallel, whose
construction broadcasts rank 0's parameters, and the EMA copy is made after
it. The step takes this rank's rows of the global batch; injected draws are
the global batch's and are sliced to the rank's rows. DDP averages the
gradients over the ranks during backward (under gradient accumulation,
no_sync on every micro step but the window's last), so the clip at 1.0 and
the update see the global batch's gradient and every rank makes the same
update; the EMA follows the unwrapped module. Masks go through the sharded kernel form (ops/degrade.py), and
the caller's generator is the rank's own (train/trainer.py folds its seed).

Tensor and spatial parallelism (a plan with model_size M > 1; the model
placed by parallel/mesh.py:place_model before the optimizer is built): the
M ranks of a model group take the same rows and draws (the data rank's).
Under TP, DDP wraps the model over the data group only (a sharded
gradient is the rank's slice and may not be averaged across the model
group), and the optimizer averages the replicated gradients over the model
group and takes the clip's norm over the whole logical gradient
(train/optim.py:Optimizer.set_tensor_parallel). Under SP (plan.spatial) the UNet
splits its input and gathers its output itself (parallel/sp.py), so the
degrade, shift and loss run on whole images on every rank; DDP wraps the
model over all D x M ranks, each rank's gradient is its rows' share, and
the loss is scaled by M before the backward so that DDP's average over D x M
ranks is the mean over the D data ranks.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from masked_diffusion_tpu_torch.models.ema import ema_decay, ema_update
from masked_diffusion_tpu_torch.ops import shift as shift_ops
from masked_diffusion_tpu_torch.ops.degrade import degrade_training, generator_seed
from masked_diffusion_tpu_torch.ops.kmask import kmask_seeds
from masked_diffusion_tpu_torch.ops.schedule import MaskSchedule
from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan, local_rows
from masked_diffusion_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainDraws:
    """One step's random numbers.

    timeindex: (B,) int64 positions in the epoch's used-timestep list.
    bits: indexing masks, int64 (B, H*W) uint32 draws (ops/kmask.py).
    mask_uniform: thresholding masks, (B, 1|C, H, W) uniforms in [0, 1).
    uniform / normal: the shift draws of ops/shift.draw_shapes.
    """

    timeindex: torch.Tensor
    bits: Optional[torch.Tensor] = None
    mask_uniform: Optional[torch.Tensor] = None
    uniform: Optional[torch.Tensor] = None
    normal: Optional[torch.Tensor] = None


@dataclasses.dataclass
class TrainState:
    """The model, its EMA copy (None when EMA is off), the optimizer, the
    micro-step counter (which drives the EMA warmup and the logged LR), and
    the DistributedDataParallel wrapper of the model when data-parallel."""

    model: torch.nn.Module
    ema_model: Optional[torch.nn.Module]
    optimizer: Optimizer
    step: int = 0
    ddp: Optional[torch.nn.Module] = None


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       use_ema: bool = True, plan=None) -> TrainState:
    """The state of a fresh run. With a plan of more than one data rank, or
    spatial partitioning, the model (already on the rank's device, and
    placed on the plan's model axis) is wrapped in DistributedDataParallel,
    which gives every rank of its group that group's first rank's
    parameters, before the EMA copy (sharded like the model under TP)."""
    ddp = None
    spatial = plan is not None and plan.model_size > 1 and plan.spatial
    if plan is not None and (plan.data_size > 1 or spatial):
        from torch.nn.parallel import DistributedDataParallel

        dev = next(model.parameters()).device
        # SP: every rank (the default group); DP and TP: the data group
        ddp = DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            find_unused_parameters=False, process_group=None if spatial else plan.data_group)
    ema = None
    if use_ema:
        ema = copy.deepcopy(model).requires_grad_(False)
    return TrainState(model=model, ema_model=ema, optimizer=optimizer, ddp=ddp)


class StepKind(NamedTuple):
    """What a micro step does besides the forward and backward: zero the
    gradients (it starts an accumulation window), update the parameters (it
    closes one), follow with the EMA. A host fact of the step counts, so a
    CUDA graph is captured per kind."""

    starts: bool
    closes: bool
    ema: bool


def host_schedule(state: TrainState, n: int, accum: int,
                  lr_schedule: Optional[Callable[[int], float]], cfg):
    """([StepKind], [(optimizer LR, logged LR, EMA decay)]) of the next n
    micro steps from the state's counts, without changing them: the host
    numbers the eager step computes one at a time."""
    opt = state.optimizer
    kinds, rows = [], []
    for step, (starts, closes, count) in enumerate(opt.windows(n), state.step + 1):
        opt_step = step // accum
        ema = state.ema_model is not None and step % accum == 0
        kinds.append(StepKind(starts, closes, ema))
        rows.append((opt.schedule(count),
                     lr_schedule(opt_step) if lr_schedule is not None else 0.0,
                     ema_decay(opt_step, cfg.ema_inv_gamma, cfg.ema_power, 0.0,
                               cfg.ema_max_decay) if ema else 0.0))
    return kinds, rows


def finish_step(state: TrainState) -> None:
    """The host counts of one micro step: TrainState.step and the
    optimizer's window."""
    state.step += 1
    state.optimizer.advance()


def _put(dst: torch.Tensor, values) -> None:
    """dst <- values (host numbers), with no host sync: on a card one copy
    from pinned memory, which torch keeps until the copy has run."""
    src = torch.tensor(values, dtype=dst.dtype)
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class StepInputs:
    """A step's per-step inputs as tensors that stay put, so that a CUDA
    graph of the step reads each step's values from them, and its random
    streams.

    scalars: (3,) the optimizer's LR, the logged LR, the EMA decay (float32
    on a card, float64 on the CPU: the host numbers they were).
    The draws, from the step's CPU generator in the order the eager step
    has always taken them: on the CPU every draw is the generator's own
    (`generator`); on a card one seed of it seeds `gen` (the timestep draw
    and the shift), then either the mask kernel's Philox seed and offset
    (`seeds`, an int64 (2,) tensor the kernel reads; ops/kmask.py:kmask_seeds,
    folded with the data rank) or one seed of `gen_mask` (thresholding
    uniforms). The device generators are reseeded by the host before each
    step; a CUDA graph registers them, so each replay reads their seeds."""

    def __init__(self, device: torch.device, cfg, plan=None):
        self.device = device
        self.select = cfg.select_degrade_pixel
        self.plan = plan or MeshPlan(device=device)
        self.cpu = device.type == "cpu"
        self.scalars = torch.zeros(3, dtype=torch.float64 if self.cpu else torch.float32,
                                   device=device)
        self.generator: Optional[torch.Generator] = None
        self.gen = self.gen_mask = self.seeds = None
        if not self.cpu:
            self.gen = torch.Generator(device=device)
            if self.select == "thresholding":
                self.gen_mask = torch.Generator(device=device)
            else:
                self.seeds = torch.zeros(2, dtype=torch.int64, device=device)

    def device_generators(self):
        return [g for g in (self.gen, self.gen_mask) if g is not None]

    def host_seeds(self, generator: torch.Generator) -> tuple:
        """The step's draws of `generator` on a card: the device generator's
        seed, then the mask kernel's (seed, offset) or the thresholding
        generator's seed."""
        out = (generator_seed(generator),)
        if self.select == "indexing":
            return out + tuple(kmask_seeds(generator, self.plan))
        return out + (generator_seed(generator),)

    def reseed(self, host_seeds: tuple) -> None:
        """The device generators at the step's seeds (host only)."""
        self.gen.manual_seed(host_seeds[0])
        if self.gen_mask is not None:
            self.gen_mask.manual_seed(host_seeds[1])

    def put(self, generator: Optional[torch.Generator], scalars=None) -> None:
        """The eager step's inputs: draws from `generator` (None: the step's
        draws are injected), and the scalars."""
        if self.cpu:
            self.generator = generator
        elif generator is not None:
            host = self.host_seeds(generator)
            self.reseed(host)
            if self.seeds is not None:
                _put(self.seeds, host[1:])
        if scalars is not None:
            _put(self.scalars, scalars)


METRIC_KEYS = ("train_loss", "shifted_degrade_img_mean", "degraded_train_mean",
               "reconstruct_train_mean", "inverse_reconstruct_train_mean")


def _make_body(schedule: MaskSchedule, cfg, used_timesteps: np.ndarray, device, plan,
               lr_schedule) -> Callable:
    """body(state, img, inputs, kind, draws) -> metrics: one micro step's
    device work, the same for the eager step and a CUDA graph's capture:
    the draws, the degrade and shift, the UNet forward and backward, the
    update and the EMA where `kind` says so, at the LR and decay of
    `inputs.scalars`. Changes no host count and makes no host sync."""
    ranks = plan.data_size if plan is not None else 1
    # SP: each rank's gradient is its rows' share; DDP averages D x M of them
    loss_scale = plan.model_size if plan is not None and plan.spatial else 1
    prepare = _make_prepare(schedule, cfg, used_timesteps, device, plan)
    weight_table = (
        schedule.loss_weight_table(cfg.loss_weight_power_base, device)
        if cfg.loss_weight_use else None
    )
    mean_shift = cfg.method == "mean_shift"
    bf16 = cfg.weight_dtype == "bfloat16"

    def body(state: TrainState, img: torch.Tensor, inputs: StepInputs, kind: StepKind,
             draws: Optional[TrainDraws] = None) -> Dict[str, torch.Tensor]:
        if draws is not None and ranks > 1:
            rows = local_rows(img.shape[0] * ranks, plan)
            draws = TrainDraws(**{k: None if v is None else v[rows]
                                  for k, v in vars(draws).items()})
        p = prepare(img, inputs, draws)
        timeindex, degraded, shift, net_in = p["timeindex"], p["degraded"], p["shift"], p["net_in"]

        # --- UNet, residual reconstruction, fp32 loss
        opt = state.optimizer
        if kind.starts:
            opt.zero_grads()  # where a window starts; inside it the micro steps sum
        net = state.ddp if state.ddp is not None else state.model
        # DDP: only the accumulation window's last micro step all-reduces
        window_open = state.ddp is not None and not kind.closes
        with state.ddp.no_sync() if window_open else contextlib.nullcontext():
            # no cast cache: a graph's replays must cast the weights anew
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16,
                                cache_enabled=False):
                out = net(net_in, p["t"])
            recon = net_in + out.float()
            inv_recon = recon - shift if mean_shift else recon
            per_px = (inv_recon - img) ** 2
            if weight_table is not None:
                # indexed by timeindex, the reference's quirk (step.py:169)
                per_px = weight_table[timeindex][:, None, None, None] * per_px
            loss = per_px.mean()
            (loss * loss_scale).backward()
        if kind.closes:
            opt.apply_update(inputs.scalars[0])
        # --- EMA, only on sync boundaries (trainer_masked.py:151-153)
        if kind.ema:
            ema_update(state.ema_model.parameters(), state.model.parameters(),
                       inputs.scalars[2])

        with torch.no_grad():
            metrics = {
                "train_loss": loss.detach(),
                "shifted_degrade_img_mean": net_in.mean(),
                "degraded_train_mean": degraded.mean(),
                "reconstruct_train_mean": recon.detach().mean(),
                "inverse_reconstruct_train_mean": inv_recon.detach().mean(),
            }
            if lr_schedule is not None:
                metrics["lr"] = inputs.scalars[1].to(torch.float32, copy=True)
        return metrics

    return body


def _nchw(batch: torch.Tensor, device) -> torch.Tensor:
    return batch.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2).contiguous()


def _ema_to(state: TrainState, device) -> None:
    if state.ema_model is not None and next(state.ema_model.parameters()).device != device:
        state.ema_model.to(device)  # made before the model moved


def make_train_step(
    model: torch.nn.Module,
    schedule: MaskSchedule,
    cfg,
    optimizer: Optimizer,
    used_timesteps: np.ndarray,
    lr_schedule: Optional[Callable[[int], float]] = None,
    device="cuda",
    plan=None,
) -> Callable:
    """Build step(state, batch, generator=None, draws=None) -> metrics.

    batch: (B, H, W, C) NHWC images (the dataset's layout) on any device;
    with a plan of N > 1 ranks, this rank's B rows of the global batch.
    generator: a CPU torch.Generator for every seed of the step (default:
    seeded with cfg.seed). draws: a TrainDraws, replacing every draw (with a
    plan, the global batch's). `model` and `optimizer` are those of the
    state the step is given; the model, and at its first update the EMA
    copy, move to `device` (in place). The host computes the step's kind,
    LR and decay, puts them and the draws' seeds in the step's inputs, runs
    the body that make_train_epoch captures, and advances its counts."""
    device = torch.device(device)
    model.to(device)
    body = _make_body(schedule, cfg, used_timesteps, device, plan, lr_schedule)
    inputs = StepInputs(device, cfg, plan)
    accum = max(1, cfg.gradient_accumulation_steps)

    def step(state: TrainState, batch: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[TrainDraws] = None) -> Dict[str, torch.Tensor]:
        img = _nchw(batch, device)
        if generator is None:
            generator = torch.Generator().manual_seed(int(cfg.seed))
        (kind,), (scalars,) = host_schedule(state, 1, accum, lr_schedule, cfg)
        inputs.put(generator if draws is None else None, scalars)
        if kind.ema:
            _ema_to(state, device)
        metrics = body(state, img, inputs, kind, draws)
        finish_step(state)
        return metrics

    return step


_capture_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One capture stream a device for every TrainEpoch: torch keeps a
    cuBLAS workspace for each stream it ever ran a product on (tens of MB
    at CUBLAS_WORKSPACE_CONFIG=:4096:8), so a stream an epoch function would
    grow memory with every curriculum's recapture."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream(device)
    return _capture_streams[device]


class TrainEpoch:
    """An epoch of train steps through one body: make_train_step's steps,
    bit for bit (the same body on the same inputs and draws), on a card as
    CUDA graphs replayed once a batch. Built as make_train_step is, and
    under JAX's name make_train_epoch.

    epoch(state, data, sel, generators, draws=None, after_step=None,
    step_context=None) -> (metric keys, (n_done, k) metrics on the device)

      data: (N, H, W, C) the device-resident dataset; sel: (n, B) int64
      index rows, step j trains on data[sel[j]]; generators: the n steps'
      CPU generators (train/trainer.py:_step_generator), drawn from as the
      eager step draws; draws: a TrainDraws of (n, ...) stacked per-step
      draws in place of every draw. after_step(j) runs on the host after
      step j and stops the epoch when it returns True; step_context(j) is
      a context manager around step j (a profiler range). `state.step`,
      the optimizer's counts and nothing else on the host advance a step.

    The body reads everything that changes from step to step from tensors
    that stay put: the dataset, the epoch's index rows and its table of
    scalars (the optimizer's LR, the logged LR, the EMA decay) and mask
    seeds, copied in once an epoch, at the row of a device step counter
    that the body advances, and the draws of device generators the host
    reseeds; it writes its metrics into row `counter` of an (n, k) buffer,
    fetched once an epoch.

    On a card each kind of micro step (StepKind) runs eagerly once, on the
    epoch's own capture stream, then is captured into a CUDA graph (one
    memory pool for the kinds) and replayed: the host's work a step is the
    generators' reseed (which a replay writes to the device) and one graph
    launch. The first epoch's warm-up steps and captures are its only host
    syncs. A capture or a launch that fails raises; nothing falls back to
    the eager body. The kernels' launch counts add what each replay
    launches. On the CPU the same body runs eagerly every step.

    The graphs hold the addresses of the model's parameters and gradients,
    the optimizer's state and the EMA: a caller that replaces any of them
    (a checkpoint restore) makes a new TrainEpoch. One data-parallel or
    model-parallel rank only."""

    def __init__(self, model, schedule, cfg, optimizer, used_timesteps, lr_schedule=None,
                 device="cuda", plan=None):
        if plan is not None and plan.world_size > 1:
            raise NotImplementedError(
                f"make_train_epoch on a plan of {plan.data_size} x {plan.model_size} ranks: "
                "the graphed epoch runs one process")
        self.device = torch.device(device)
        model.to(self.device)
        self.cfg = cfg
        self.accum = max(1, cfg.gradient_accumulation_steps)
        self.lr_schedule = lr_schedule
        self.body = _make_body(schedule, cfg, used_timesteps, self.device, plan, lr_schedule)
        self.inputs = StepInputs(self.device, cfg, plan)
        self.keys = METRIC_KEYS + (("lr",) if lr_schedule is not None else ())
        self.cuda = self.device.type == "cuda"
        self.stream = _capture_stream(self.device) if self.cuda else None
        self.graphs: Dict[StepKind, tuple] = {}  # kind -> (CUDAGraph, launches a replay)
        self.warm: set = set()  # kinds run eagerly on the capture stream
        self.pool = None
        self.capture_seconds = 0.0  # host seconds in captures
        self.pool_bytes = 0  # device memory the captures reserved (the graphs' pool)
        self._bufs: Dict[str, torch.Tensor] = {}
        self._data: Optional[torch.Tensor] = None

    def drop_graphs(self) -> None:
        self.graphs.clear()
        self.warm.clear()
        self.pool = None

    def _buffer(self, name: str, values: torch.Tensor) -> torch.Tensor:
        """The static buffer `name` holding `values` in its first rows (one
        copy; on a card from pinned memory, no host sync). A buffer that
        must change shape or grow drops the graphs that read it."""
        buf = self._bufs.get(name)
        if (buf is None or buf.dtype != values.dtype or buf.shape[1:] != values.shape[1:]
                or buf.shape[0] < values.shape[0]):
            self.drop_graphs()
            buf = torch.zeros(values.shape, dtype=values.dtype, device=self.device)
            self._bufs[name] = buf
        if values.device.type == "cpu" and self.cuda:
            values = values.pin_memory()
        buf[:values.shape[0]].copy_(values, non_blocking=True)
        return buf

    def _step(self, state: TrainState, kind: StepKind, draws: bool) -> None:
        """One micro step at row `counter`, eagerly (the caller's stream)."""
        b = self._bufs
        row = b["counter"]
        img = _nchw(self._data[b["sel"].index_select(0, row)[0]], self.device)
        self.inputs.scalars.copy_(b["scalars"].index_select(0, row)[0])
        if self.inputs.seeds is not None and not draws:
            self.inputs.seeds.copy_(b["seeds"].index_select(0, row)[0])
        step_draws = None
        if draws:
            step_draws = TrainDraws(**{k: b[f"draws.{k}"].index_select(0, row)[0]
                                       for k in self._draw_keys})
        metrics = self.body(state, img, self.inputs, kind, step_draws)
        b["metrics"].index_copy_(0, row, torch.stack([metrics[k].float() for k in self.keys])[None])
        row.add_(1)

    def _capture(self, state: TrainState, kind: StepKind, draws: bool):
        import time

        from masked_diffusion_tpu_torch.ops import groupnorm, launches

        t0 = time.perf_counter()
        groupnorm.reserve_counters(self.device, self.stream)
        graph = torch.cuda.CUDAGraph()
        for gen in self.inputs.device_generators():
            graph.register_generator_state(gen)
        before = launches.snapshot()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            reserved = torch.cuda.memory_reserved(self.device)
            self._step(state, kind, draws)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        per_replay = launches.since(before)
        launches.set_to(before)  # the capture launched nothing
        if self.pool is None:
            self.pool = graph.pool()
        self.graphs[kind] = (graph, per_replay)
        self.capture_seconds += time.perf_counter() - t0
        return self.graphs[kind]

    def _run(self, state: TrainState, kind: StepKind, draws: bool) -> None:
        if not self.cuda:
            self._step(state, kind, draws)
            return
        entry = self.graphs.get(kind)
        if entry is None and kind in self.warm:
            entry = self._capture(state, kind, draws)
        if entry is None:
            # the kind's first step runs eagerly on the capture stream: the
            # lazy set-ups (optimizer state, kernel attributes, the
            # GroupNorm counters of that stream) happen outside the capture
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self._step(state, kind, draws)
            current.wait_stream(self.stream)
            self.warm.add(kind)
            return
        from masked_diffusion_tpu_torch.ops import launches

        graph, per_replay = entry
        graph.replay()
        launches.add(per_replay)

    def __call__(self, state: TrainState, data: torch.Tensor, sel, generators=None,
                 draws: Optional[TrainDraws] = None, after_step=None, step_context=None):
        sel = torch.as_tensor(sel, dtype=torch.int64)
        n = int(sel.shape[0])
        if data is not self._data:
            self.drop_graphs()
            self._data = data
        kinds, rows = host_schedule(state, n, self.accum, self.lr_schedule, self.cfg)
        dtype = self.inputs.scalars.dtype
        self._buffer("sel", sel)
        self._buffer("scalars", torch.tensor(rows, dtype=dtype))
        self._buffer("metrics", torch.zeros((n, len(self.keys)), dtype=torch.float32))
        self._buffer("counter", torch.zeros(1, dtype=torch.int64))
        host_seeds = None
        if draws is None:
            generators = list(generators)
            if len(generators) != n:
                raise ValueError(f"{len(generators)} generators for {n} steps")
            if self.cuda:
                host_seeds = [self.inputs.host_seeds(g) for g in generators]
                if self.inputs.seeds is not None:
                    self._buffer("seeds", torch.tensor([h[1:] for h in host_seeds],
                                                       dtype=torch.int64))
        else:
            self._draw_keys = tuple(k for k, v in vars(draws).items() if v is not None)
            for k in self._draw_keys:
                self._buffer(f"draws.{k}", getattr(draws, k))
        if any(k.ema for k in kinds):
            _ema_to(state, self.device)
        done = 0
        for j, kind in enumerate(kinds):
            if draws is None:
                if host_seeds is not None:
                    self.inputs.reseed(host_seeds[j])
                else:
                    self.inputs.generator = generators[j]
            with step_context(j) if step_context is not None else contextlib.nullcontext():
                self._run(state, kind, draws is not None)
            finish_step(state)
            done = j + 1
            if after_step is not None and after_step(j):
                break
        return self.keys, self._bufs["metrics"][:done].clone()


# JAX's name (train/step.py:make_train_epoch, which scans the step over the
# epoch's index rows in one program); TrainEpoch is its counterpart
make_train_epoch = TrainEpoch


def _make_prepare(schedule: MaskSchedule, cfg, used_timesteps: np.ndarray, device, plan):
    """prepare(img, inputs, draws) -> the step's work before the UNet
    (train/step.py:_make_step_impl up to the forward): the timestep draw from
    the epoch's curriculum, the degrade (the exact-k mask kernel in indexing
    mode) and, for mean_shift, the shift, drawing from a StepInputs. img is
    NCHW on `device`. Returns a dict: timeindex, t, degraded, masks,
    degrade_mask, mean_mask, shift (None for base) and net_in."""
    used = torch.as_tensor(np.asarray(used_timesteps, dtype=np.int64), device=device)
    n_used = int(used.numel())
    # per-curriculum-position tables on the device: the step only gathers
    amount_by_index = schedule.degrade_amount(used)
    ratio_by_index = schedule.shift_ratio(used)
    t_by_index = used.float()
    mean_shift = cfg.method == "mean_shift"
    per_channel = cfg.degrade_channel == "3-channel"

    def prepare(img: torch.Tensor, inputs: StepInputs,
                draws: Optional[TrainDraws] = None) -> Dict[str, Optional[torch.Tensor]]:
        b, c, h, w = img.shape
        # the generator of the timestep draw and the shift; of every draw on the CPU
        gen = inputs.generator if inputs.cpu else inputs.gen
        mask_draws = {}
        if draws is None:
            timeindex = torch.randint(0, n_used, (b,), generator=gen, device=device)
            if inputs.cpu:
                mask_draws["generator"] = gen
            elif cfg.select_degrade_pixel == "indexing":
                mask_draws["seeds"] = inputs.seeds
            else:
                mask_draws["uniforms"] = torch.rand((b, c if per_channel else 1, h, w),
                                                    generator=inputs.gen_mask, device=device)
        else:
            timeindex = draws.timeindex.to(device)
            mask_draws = {"bits": draws.bits, "uniforms": draws.mask_uniform}

        # --- degrade (scheduler.degrade_training)
        degraded, masks, degrade_mask, mean_mask = degrade_training(
            img, amount_by_index[timeindex], cfg.select_degrade_pixel, cfg.degrade_channel,
            cfg.mean_option, cfg.mean_area, plan=plan, **mask_draws,
        )

        # --- mean shift (trainer_masked_mean_shift.py:119-120)
        shift = None
        net_in = degraded
        if mean_shift:
            ratios = ratio_by_index[timeindex]
            if draws is None:
                shift = shift_ops.schedule_shift(gen, ratios, tuple(img.shape),
                                                 cfg.shift_type, cfg.noise_mean)
            else:
                shift = shift_ops.shift_from_draws(cfg.shift_type, ratios, tuple(img.shape),
                                                   draws.uniform, draws.normal, cfg.noise_mean)
            net_in = degraded + shift
        return {"timeindex": timeindex, "t": t_by_index[timeindex], "degraded": degraded,
                "masks": masks, "degrade_mask": degrade_mask, "mean_mask": mean_mask,
                "shift": shift, "net_in": net_in}

    return prepare


def make_train_visuals_fn(
    model: torch.nn.Module,
    schedule: MaskSchedule,
    cfg,
    used_timesteps: np.ndarray,
    device="cuda",
    plan=None,
) -> Callable:
    """Build visuals(batch, generator) -> the reference's train-time visual
    tensors (JAX train/step.py:make_train_visuals_fn; train_visual_names,
    trainer_masked.py:58, trainer_masked_mean_shift.py:58): input,
    degraded_img, degrade_binary_masks, degradation_mask, mean_pixel, mask
    (the network output, as the reference names it) and reconstructed_img,
    plus shift, shifted_degrade_img and inverse_shift_reconstructed_img on
    the mean-shift path; each (B, H, W, C) float32, NHWC.

    One forward under torch.no_grad, on the batch the step was given (NHWC;
    with a plan, this rank's rows), drawing as the step does from
    `generator` (a CPU torch.Generator). The trainer runs it once per save
    cadence, never in the hot loop."""
    device = torch.device(device)
    prepare = _make_prepare(schedule, cfg, used_timesteps, device, plan)
    inputs = StepInputs(device, cfg, plan)
    bf16 = cfg.weight_dtype == "bfloat16"

    def visuals(batch: torch.Tensor, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        img = _nchw(batch, device)
        inputs.put(generator)
        with torch.no_grad():
            p = prepare(img, inputs)
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
                out = model(p["net_in"], p["t"])
            recon = p["net_in"] + out.float()
            tensors = {
                "input": img,
                "degraded_img": p["degraded"],
                "degrade_binary_masks": p["masks"],
                "degradation_mask": p["degrade_mask"],
                "mean_pixel": p["mean_mask"],
                "mask": out.float(),
                "reconstructed_img": recon,
            }
            if p["shift"] is not None:
                tensors["shift"] = p["shift"]
                tensors["shifted_degrade_img"] = p["net_in"]
                tensors["inverse_shift_reconstructed_img"] = recon - p["shift"]
            return {k: v.expand(img.shape).permute(0, 2, 3, 1) for k, v in tensors.items()}

    return visuals
