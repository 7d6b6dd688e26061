#!/usr/bin/env python3
"""Smoke check of the PyTorch port (masked_diffusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
and nvcc. It builds the port's kernels from the checkout's sources,
holds each against its plain PyTorch version on the card, checks the
sampling slice against the plain CPU path, and serves images through the
port's CLI at the flagship width. Every phase raises on failure. Phases:

  1. environment: card name and power limit, torch/CUDA versions, SM count
     and maximum SM clock (the exp2 and integer rates of the bounds), the
     instructions of one Philox draw in the compiled code, build time
  2. fused degrade kernel vs its plain version, explicit bits (64x64x3,
     batch 64); then its Philox path's exact counts and kept share; then
     every branch of the exact-k launch plan (EXACT_K_SHAPES and every
     cluster size at 64x64): explicit bits and the Philox route, against the
     plain version fed the plain Philox's bits at the same seed and offset,
     masks bitwise; plans the kernel must refuse; each plan's resident
     clusters
  3. GroupNorm(+SiLU) kernel vs its plain version at every (C, H, W) the
     flagship UNet normalises, fp32, bf16 and fp16 (csrc/groupnorm_f16.cu,
     within one fp16 ulp of the plain version run in fp32 and rounded
     once), with the times; then at
     shapes that reach every branch of the launch plan (each cluster size,
     the warp path's widths, a slice re-read from device memory, a ragged
     5x7 and 45x45 span, a strided input), and each cluster size's
     resident clusters on the card
  4. slice parity: the sampler with both kernels on CUDA vs the plain
     versions on the CPU, same weights and draws, fp32 with TF32 off
  5. serving through the CLI: a seeded random flagship checkpoint, two
     requests of 16 images at 64x64 in bf16, linear+thresholding (50
     steps) and log+indexing (100 steps); kernel launch counts checked
  6. exact-k mask kernel vs its plain version, explicit bits (64x64 at
     batch 64 with k = 0, HW-1, HW and tied top bits; 128x128 at batch 8):
     masks bitwise equal; then its Philox path's exact counts and per-pixel
     frequency, and its time; then every plan branch as in phase 2
  7. GroupNorm(+SiLU) as training runs it, at the training batch (64): the
     forward with grad through the autograd Function and its backward
     kernel vs the plain forward and autograd through the plain version, at
     every (C, H, W) the flagship UNet normalises, fp32, bf16 and fp16 (the
     fp16 backward as the bf16 one), SiLU on and off; the backward also
     against its plain version
     (group_norm_silu_backward_plain) on the kernel's saved statistics, and
     bitwise equal over two runs; one kernel per forward and per backward
     call by a torch.profiler count; the plan's branch shapes and a strided
     incoming gradient; forward and backward times beside F.group_norm +
     F.silu
  8. train-step parity: the step with every kernel on CUDA vs the plain
     versions on the CPU, same weights and draws, 2 AdamW steps, fp32 with
     TF32 off, both schedule modes
  9. the flagship train step (batch 64, bf16), both modes: one step through
     the kernels vs one through their plain versions on the card (loss and
     gradient), then throughput; kernel launches per step checked, and the
     GroupNorm backward calls per step whose incoming gradient is strided
     (the kernel takes its strides: no copy)
 10. training through the CLI (--method mean_shift, log+indexing, 2 epochs),
     then serving the checkpoint it wrote; kernel launch counts checked
 11. tiny-head attention kernels, forward and backward, vs their plain
     versions, fp32 (TF32 off) and bf16 (a per-element limit from the
     rounding of P and dS, and a bias limit), where the main paths run them
     (S = 256, 1024, 4096) and at ragged shapes (S = 200, 384; D = 4): out
     and lse, then dq, dk, dv from the kernel's out and lse; the autograd
     Function (one launch of each) vs autograd through the plain version;
     times beside the plain versions', SDPA's forward and backward, the
     plain recompute's and the bounds; the backward's peak extra memory
 12. kernels 1 and 3 above 128x128 (keys in registers, 8 or 16 CTAs an
     image) at 256x256 and 160x160, batch 8: bitwise masks with explicit
     bits, the Philox route's exact k, determinism and per-pixel frequency;
     times at 256x256; the plan branches at those sizes and 256x256 at
     batch 1 as in phase 2
 13. GroupNorm(+SiLU) forward with grad and backward at unet6@256x256's
     norm shapes, batch 8
 14. slice parity on the CelebA-HQ topology (--num_attention 5): every
     kernel on CUDA vs the plain versions on the CPU, 4 reverse steps
 15. every zoo name at 128x128: one bf16 forward at batch 2, finite, with
     the tiny-head launches the topology implies; then one forward with grad
     and its backward, as many tiny-head backward launches as forward ones
 16. the CelebA-HQ launch config through the CLI (--num_attention 5, 64x64,
     batch 32, log+indexing at T=16, bf16): 2 epochs, then served; 10
     tiny-head launches per UNet forward, 10 backward launches per train step
 17. unet6 at 256x256 through the CLI (batch 8, bf16, log+indexing): 2
     epochs of 2 train steps, then served; 5 tiny-head launches per UNet
     forward, 5 backward launches per train step
 18. data-parallel: the sharded kernel forms (fused degrade, exact-k) at N =
     2 and 4 ranks, flagship shape, both select modes, each rank bitwise the
     single-device kernel on its rows with the folded seed and the plain
     version on the plain Philox's draws at that seed, exact counts,
     ranks' masks distinct; timed at a 2-rank shard beside the plain
     versions. Then 2 ranks under torch.distributed.run (this script with
     `--rank <dir>`; nccl on two cards, else gloo with both on cuda:0): a
     2-rank fp32 train step parity against one process (phase 8's
     tolerances), the flagship trained through the CLI with phase 10's
     flags, --mesh_data 2, 3 epochs (12 steps, the cadence at the last) and
     --profile_dir, served, and run through --method test (a target of 1);
     the dist line, per-rank launches (one sharded exact-k a train step, one
     sharded fused a reverse step), bitwise-equal ranks, global_step 12,
     each rank's trace of epoch 1 (its device idle share and the
     all-reduce's time: NCCL kernels' device ms on two cards, gloo's host ms
     with both ranks on cuda:0), ms/step from the untraced epoch 2, and the
     tester's ranks leaving in the same round with the same unique count,
     rank 1 writing no image, checked
 19. the reverse loop's plain branch (the modes the fused kernel does not
     cover) at the flagship's width, 64x64, batch 2, 5 steps, fp32 with
     TF32 off: CUDA vs the CPU path on the same draws within SLICE_TOL in
     SAMPLING_MODES (independent+momentum+thresholding 3-channel
     channel-wise; dependent_prev+boosting+indexing non_degraded_area;
     dependent_t+base_sampling+thresholding; independent+base_momentum+
     indexing with trajectory capture, its 11 fields and 4 means), each
     under set_sync_debug_mode("error") with the exact-k kernel launched 2,
     1 or 0 times a step; the captured mode again on the kernel's own
     Philox draws (every captured mask at t and t-1 degrades exactly the
     schedule's count); kernel 3's time at batch 2 and a bf16 flagship
     reverse step at batch 16, fused, plain and plain captured
 20. the flagship through the CLI with the default sampling flags (no
     --sampling, no --use_ema: --sampling base with EMA), phase 10's flags
     otherwise: the cadence's EMA grids, 11 x 4 trajectory PNGs, the train
     visuals and finite trajectory means; kernel 3 launched once a train
     step, once for the visuals pass and twice a reverse step of the
     captured cadence, whose ms a reverse step is logged beside phase 10's
     fused cadence; then the checkpoint served with dependent_prev +
     momentum (two requests of 16 images)
 21. checkpoints, resume and preemption at the flagship's width (phase
     10's flags, 4 steps an epoch): (a) 3 epochs through the Trainer API
     and (b) the same run SIGTERM'd in-process in its 6th step, restored
     into a fresh Trainer and finished, both under deterministic settings
     (cuDNN deterministic, torch.use_deterministic_algorithms, warn_only,
     CUBLAS_WORKSPACE_CONFIG): params and EMA bitwise equal, the max |diff|
     printed, the ops that warned named; (d) the host-blocking time of a
     sync and an async save of the full state, its bytes on disk and the
     restore time; (c) the CLI as a subprocess (this script with
     `--counted <file>`, 3 epochs) SIGTERM'd once log/metrics.jsonl has
     epoch 0's line, exit 0 with a preemption checkpoint, then resumed
     with --keep_last_checkpoints 1 --async_checkpoints true to
     global_step 12 with one complete checkpoint left, holding optimizer/
     and history.npz. Every run launches the GroupNorm and exact-k kernels
 22. the diversity tester (tester.py) at the flagship's width: (a) its dedup
     and matching on the card against the same functions on the CPU, with
     TF32 on in the process, on a fixed batch of 100 images with planted
     near-copies at cosines 0.9 +- 1e-3: the same kept images, neighbour
     indices, get_nearest_neighbor picks and buckets; (b) Tester.run(
     max_rounds=3) with random flagship weights, sample_num 100, bf16, log +
     indexing at T=100, on the fused branch (kernel 1 rounds x steps times)
     and in dependent_prev (kernel 3 once a step), seconds a round, ms a
     reverse step and images/s; (c) --method test through the CLI on phase
     10's checkpoint: exit 0, a test_stats line, sample_page_0.png,
     number_of_sample.png (with matplotlib), neighbor_*.png, final_sample.png
 23. interpolation sampling at the flagship's width: (a) the sampler on
     CUDA against the CPU path on the same weights and injected shared
     fields, fp32 with TF32 off, for base_momentum, momentum and boosting,
     within SLICE_TOL; (b) the flagship trained through the CLI with
     --interpolation_shift 0.5 (linear + thresholding at T=100, 2 epochs):
     ema_interpolation_00001.png on the cadence and the interpolation
     pass's ms a reverse step
 24. the reference user's inputs at the flagship's width: (a) the port's
     native preprocessing (g++, native/) builds, its single and batch entry
     points within NATIVE_TOL of the numpy bilinear reference; (b) an LSUN
     archive of 160 smooth JPEGs at 256x320x3 written with
     tools/lmdb_write.py (overflow values, a branch page); (c) the flagship
     trained on it through the CLI under MDT_NATIVE_PREPROCESS=1 with
     --profile_dir (phase 10's flags, 128 images, batch 64, 3 epochs, the
     cadence at T=20): a (128, 64, 64, 3) dataset through backend native, global_step 6, one
     trace_rank0.json of epoch 1's two steps naming the GroupNorm forward
     and backward and the exact-k kernels, and its device busy ms, wall ms
     and idle share; the load without native for comparison; (d) the final
     checkpoint rewritten as the reference writes one (.bin, legacy
     attention names, EMA hyperparameters in unet_ema/config.json, no
     meta.json or optimizer/), served with phase 5's flags (linear +
     thresholding, here at T=20, two requests of 16 images, kernel 1 once a
     reverse step), converted by `python -m masked_diffusion_tpu_torch.io.import_torch`
     (weights bitwise the original's, optimizer_imported false, a resume
     from it refused), and the original served at the same seed: the same
     images

 26. the legacy GAN/EBM path (cli/main_train.py), which launches none of
     the kernels (all eight counts 0 over the phase): (a) one GANTrainer
     step at the CLI's widths (batch 128, 32x32x3, Langevin 3) on the card
     and on the CPU from the same weights and draws, fp32 with TF32 off,
     losses, gradients and updates within GAN_*_RTOL, then ms/step; (b)
     the EBGAN models and the saliency stack (width 32, 256x256, batch 4)
     card vs CPU within LEGACY_FWD_RTOL, each forward's device ms; (c) the
     legacy CLI on the card (synthetic 32x32, batch 128, 2 epochs,
     --langevin_length 5): exit 0, finite losses, two sample grids, ms/step.
     Alone: `python3 -c "import tempfile, chip_smoke as c; smi = 'H100';
     c.phase_gan_step(smi); c.phase_legacy_forwards(smi);
     c.phase_legacy_cli(tempfile.mkdtemp(dir='build'), smi)"`
 27. tensor and spatial parallelism (parallel/tp.py, parallel/sp.py): 2
     ranks under torch.distributed.run (this script with `--grid <dir>`),
     data 1 x model 2, both on cuda:0 over gloo. (a) TP at the flagship's
     width (--tp_min_features 256) and (b) SP (every level split at M = 2):
     2 fp32 AdamW steps at batch 8 on injected draws (TF32 off) against
     one process on the card (losses, the last step's clipped gradient,
     the updates of parameters and EMA), each rank's bytes of parameters +
     AdamW state + EMA, its peak device memory and ms a step beside one
     process's, TP's sharded_fraction; unet6 at 256x256 under SP, one bf16
     forward and backward at batch 2, each rank's peak memory above the
     weights beside one process's, kernel 4 on the gathered attention
     blocks; the gloo all-gather and all-reduce of a (8, 512, 8, 8)
     activation; (c) the flagship through the CLI with --mesh_model 2 and
     with --mesh_spatial true (one epoch of 2 steps at batch 8, the
     cadence's fused sampler at T=8), per-rank launches checked, each
     checkpoint served by one process. Under SP the GroupNorm launches are
     exact: the split pair (phase 32's kernels) on the flagship's 65 split
     norms and kernels 2 and 2b whole on its 6 attention norms, a forward
     and a backward; unet6's split norms likewise. Alone (~2 min with the build):
     `python3 -c "import tempfile, chip_smoke as c; smi = c.phase_env();
     c.phase_grid(tempfile.mkdtemp(dir='build'), smi)"` (needs `mkdir -p
     build`)

 28. --epoch_scan true, the train step as CUDA graphs replayed once a
     batch (train/step.py:make_train_epoch), at the flagship's width: (f)
     first, before any capture, the GroupNorm backward on two streams at
     once, each launch bitwise the same launch alone and near its plain
     version; under deterministic(): (a) one epoch of 8 steps at batch 64
     eagerly and graphed from the same state, log + indexing and linear +
     thresholding, step losses, params, EMA and AdamW state bitwise equal,
     the replays' kmask launches (probed into device buffers) the eager
     run's, new each step, exactly k an image; (b) accumulation 2 likewise,
     then 4 curricula of 2 steps, each recaptured, peak and reserved memory
     flat; (c) CelebA-HQ 4 steps with the tiny-head kernels in the graph,
     bitwise; (d) a graphed run SIGTERM'd at step 6, restored, resumed
     mid-epoch: bitwise the uninterrupted one; (e) the CLI with
     --epoch_scan true, 2 epochs, then served; (g) a torch.profiler window
     of 4 eager and 4 replayed steps: host calls a step by name (one
     cudaGraphLaunch), ms a step and idle share, capture seconds and the
     graph pool's bytes. Alone (~2.5 min with the build): `python3 -c
     "import tempfile, chip_smoke as c; smi = c.phase_env(); d =
     tempfile.mkdtemp(dir='build'); c.phase_graphed_epoch(d, smi)"` (needs
     `mkdir -p build`)
 29. the trainer's device-data rule (train/trainer.py:use_device_data) and
     the launch farm (scripts_torch/) at the flagship's width: (a) the
     flagship (batch 64, bf16, log + indexing, T=4096) through the Trainer
     with the dataset on the card and with each batch copied in from the
     host, in turns: ms/step of each, a batch's gather + pin + copy and the
     copy alone; (b) scripts_torch/train/celeba_hq/masked_shift_mean/
     script_main.sh through scripts_torch/config/gpu_single.sh, on 64
     synthesized images in the CelebA-HQ folder layout and cut by
     FARM_CUTS (2 epochs, T=20, a cadence of 16 images), with
     MDT_DEVICE_DATA=1, and with MDT_DEVICE_DATA_CAP_MB=0 and --epoch_scan
     true, each a process whose CLI runs under deterministic() (this
     script with `--launched <dir>` in front of the CLI): losses,
     parameters, EMA and AdamW state bitwise equal, no device copy of the
     dataset in the capped run, no CUDA graph and no make_train_epoch; (c)
     the script through gpu_h100_4.sh with MDT_NPROC=2, both ranks on
     cuda:0 over gloo, each rank running the CLI as the script calls it
     (the rerun with --epoch_scan true was cut for phase 32; the CPU tests
     hold it bitwise), ms/step a rank; kernels 1, 2, 2b and 3 launched in
     every run. Alone (~2.5 min with the build):
     `python3 -c "import tempfile, chip_smoke as c; smi = c.phase_env(); d =
     tempfile.mkdtemp(dir='build'); c.phase_farm(d, smi)"` (needs `mkdir -p
     build`)
 30. the kernels against the JAX package's numbers at the flagship's full
     width (masked_diffusion_tpu_torch/tools/full_width.py on
     tests/data/jax_full_width.npz, which the JAX package wrote on the CPU):
     the flagship and CelebA-HQ's topology rebuilt from their seeded
     weights (held to the file's record of them), 64x64, batch 2; forwards
     at two timesteps, one train step (AdamW, clip 1.0, EMA) in both bench
     modes and three fused reverse steps from t = T in both, fp32 with TF32
     off and bf16 under autocast, each distance printed beside its bound
     (the tolerances of tests/test_torch_port_full_width.py); each case's
     launches counted from 0: kernels 2 and 2b in every norm, 3 in the
     indexing step, 1 in the reverse steps, 4 in CelebA-HQ's 10 attention
     blocks. Alone (~1.5 min with the build): `python3 -c "import
     chip_smoke as c; c.phase_env(); c.phase_jax_reference()"`
 31. the reference's default cadence at T=4096: (a) the flagship through
     the CLI with the default sampling flags (--sampling base, trajectory
     capture of 4 items) at log + indexing, --ddpm_num_steps 4096 (1421
     reverse steps), one train step at batch 64: 44 trajectory PNGs, finite
     trajectory means, kernel 3 twice a reverse step, the cadence's seconds
     and the peak device memory above the 3.07 GB of trajectory buffers,
     the trajectory's last sample_0 bitwise the images (the cadence
     replayed uncaptured was cut for phase 32; the CPU tests hold capture
     against no capture). Alone (~2 min with the build): `python3 -c
     "import tempfile, chip_smoke as c; smi = c.phase_env();
     c.phase_t4096_cadence(tempfile.mkdtemp(dir='build'), smi)"` (needs
     `mkdir -p build`)
 32. kernels 2 and 2b in their split modes (--mesh_spatial; ops/groupnorm.py:
     group_norm_split and group_norm_split_backward), the M ranks of a model
     group emulated in one process by row pieces and a sum of their (2,
     B*G) tensors in place of the all-reduce: at every local shape of the
     flagship's split norms at M = 2 (65 a forward) and M = 4, batch 8, and
     of unet6's at 256x256 at M = 2, batch 2, in fp32, bf16 and fp16, the
     forward and backward pairs against the plain split functions on the
     same pieces (fp32 under GN_TOL / GN_BWD_TOL; bf16 and fp16 within one
     ulp of the plain versions in fp32 rounded once, plus fp32's bound;
     dscale and dbias summed over the pieces under GN_BWD_SUM_TOL); at M =
     1 against kernels 2 and 2b whole; each pass's device ms at the
     flagship's M = 2 shapes in bf16 (one rank's rows) beside its byte
     bound and the plain pair's ms. Alone (~1.5 min with the build):
     `python3 -c "import chip_smoke as c; smi = c.phase_env();
     c.phase_split_groupnorm(smi)"`

Phases 11 and 12 run first (the newest kernels fail fast), phases 19,
22a and 23a after the slice phases, phase 32 after phase 13, phase 30
after phase 9; the main-path runs come last, in one work directory: phase
10, then three lanes at once (WORKER_LANES) — this process runs 26, 5, 20,
22b, 22c, 23b, 25c, 25d, 16, 17, 21 and 24 while two worker processes of
this script (`--worker <spec>`) run 18 then 29, and 31, 27 then 16b (the
CelebA-HQ config trained at fp32, `--mixed_precision no`) — and phase
28 alone after all three, so its eager and graphed step times share the
card with nothing. The kernel timings of the kernels line are all taken
before the lanes start; the main-path phases' own ms and seconds are taken
with the lanes sharing the card and the host's cores. The
kernels' `launches` are counted over those runs (phases 18's, 27's and
29's summed over their ranks and processes, phase 21's over its five, phase
28's with each graph replay adding what its capture launched, a worker's
phases in the worker's own counts),
with every count set to 0 just before each. Run phase 19 alone with `python3 -c "import chip_smoke as c;
c.phase_env(); c.phase_sampling_modes()"`, phases 10 and 20 with `python3
-c "import tempfile, chip_smoke as c; c.phase_env(); d =
tempfile.mkdtemp(dir='build'); c.phase_default_cli(d,
c.phase_train_cli(d)[1])"`, phase 21 with `python3 -c "import tempfile,
chip_smoke as c; smi = c.phase_env(); d = tempfile.mkdtemp(dir='build');
c.phase_preempt(d, smi)"`, phases 22 and 23 with `python3 -c "import
tempfile, chip_smoke as c; c.phase_env(); c.phase_tester_selection();
c.phase_interpolation_parity(); d = tempfile.mkdtemp(dir='build');
c.phase_train_cli(d); c.phase_tester_run(d); c.phase_tester_cli(d);
c.phase_interpolation_cli(d)"`, phase 24 with `python3 -c "import tempfile,
chip_smoke as c; smi = c.phase_env(); d = tempfile.mkdtemp(dir='build');
c.phase_reference_inputs(d, smi)"`. `bound_ms` is the least
time the card could take for the same work: the larger of the bytes moved
over 3.35 TB/s, the fp32 operations over 67 TFLOP/s (outside the tensor
cores) and the 32-bit integer operations at 64 a clock per SM times the SM
count times the card's maximum SM clock, from each run's shapes. For the
exact-k kernels the integer work is what any implementation must do: the
Philox draws (two a pixel for kernel 1, one for kernel 3) at
PHILOX_INT_OPS instructions each, read from the compiled code, and one
compare per key and selection. For the tiny-head kernels the products count at the dense bf16
tensor-core rate of 989 TFLOP/s; in fp32 by two routes, on the CUDA cores
at 67 TFLOP/s or as three tf32 products at the dense TF32 rate of 494.7
TFLOP/s, a route's bound the largest of its terms and the least of the
routes the bound; the softmax's other ~4 operations a score at 67
TFLOP/s, and one exp2 a score (forward; the least the backward needs) at
16 a clock per SM times the SM count times the card's maximum SM clock.
The exponentials set the bound in bf16 at every shape the main paths give
them, and in the fp32 forward; the split-TF32 products set the fp32
backward's. The fp32 instances have entries of their own
(`tinyhead_attention_fp32`, `tinyhead_attention_backward_fp32`, launched
on the main path by 16b), and the bf16 entries count bf16 launches.

Its last two lines are one JSON object of kernel results and
{"ok": true, "device": {...}}. Without CUDA it exits 2 and prints neither.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B_KERNEL = 64  # the bench's batch (bench.py BENCH_BATCH)
SIZE = 64
FUSED_TOL = 1e-6  # kernel and plain differ only in the masked sums' order
GN_TOL = {"float32": (1e-5, 1e-5),  # (atol, rtol): fp32 sums in another order
          "bfloat16": (8e-2, 2e-2),  # plain rounds each op to bf16, the kernel once
          # plain rounds each op to fp16, the kernel once; the fp16 forward is
          # also held within one fp16 ulp (plus fp32's bound) of the plain
          # version run in fp32 on the same values and rounded once
          # (gn_fp16_ulps)
          "float16": (1e-2, 4e-3)}
SLICE_TOL = 2e-3  # atol = rtol: cuDNN vs CPU conv sums over a 113.7M-param UNet, 10 steps
# GroupNorm backward, (atol, rtol). dx: fp32 sums in another order; bf16 x
# and g against the fp32 plain backward on the same (bf16-exact) values: one
# rounding of dx to bf16 (2^-8 relative). dscale/dbias are fp32 sums over
# B*H*W terms in either dtype; their atol grows with the term count.
GN_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2), "float16": (1e-2, 1e-2)}
GN_BWD_SUM_TOL = (1e-6, 1e-4)  # (atol per summed term, rtol)
# (B, C, H, W, G) that reach every branch of ops/groupnorm.py:gn_plan: the
# warp path's widths (2x2, 5x7 ragged, 8x8, 4x4 at 768 channels) and its 1,
# 2, 4 and 8 spans a CTA (batch 24, 64 and the tester's 100), one CTA a
# span (45x45, ragged), clusters of 2, 4, 8 and 16, and a slice re-read from device
# memory (fp32 backward at 256x256); tests/test_torch_port_groupnorm.py holds
# the same list to that coverage on the CPU
GN_BRANCH_SHAPES = ((2, 48, 5, 7, 16), (16, 512, 2, 2, 32), (16, 512, 8, 8, 32),
                    (4, 768, 4, 4, 32), (24, 512, 2, 2, 32), (64, 256, 8, 8, 32),
                    (100, 512, 4, 4, 32),
                    (2, 48, 45, 45, 16), (8, 128, 128, 128, 32), (8, 256, 128, 128, 32),
                    (8, 256, 256, 256, 32))
TRAIN_LOSS_RTOL = 2e-3  # losses, CUDA kernels vs CPU plain, fp32 with TF32 off
# parameter (and EMA) updates after 2 AdamW steps (phase 8; 3 in phase 18),
# relative L2 over the model:
# Adam divides each coordinate by its own gradient scale, so cuDNN's and the
# CPU's sums in another order move coordinates with near-zero gradients
TRAIN_UPDATE_RTOL = 1e-2
# one bf16 step at batch 64, kernels vs plain versions on the card, both under
# autocast: the plain GroupNorm rounds each elementwise op to bf16, the kernel
# once, so the two differ by bf16 rounding through 113.7M parameters. On an
# H100 the two steps differ by 0.003 relative L2 in the clipped gradient and
# 0.25 in the first AdamW update (the plain bf16 step differs from the plain
# fp32 one by 0.005 and 0.25); a backward kernel with a term of dx dropped
# gave 0.40 and 1.18, one with SiLU's derivative cut to g*sigmoid(y) 0.13 and
# 0.99. The tolerances sit between.
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_RTOL = 3e-2  # relative L2 over every parameter's clipped gradient
BF16_UPDATE_RTOL = 0.5  # relative L2 over every parameter's first update
TRAIN_STEPS_TIMED = 20
KMASK_Z = 5.0  # per-pixel |z| bound over 4096 pixels: a 4-sigma bound fails by
# chance at some pixel with probability ~0.25; 5 sigma keeps that under 0.3%
# the same chance of a false alarm (~0.25%) over the 65536 pixels of a 256x256
# image: 65536 * P(|z| > 5.5) = 0.0025
KMASK_Z_LARGE = 5.5
# unet6's 256x256 (16 CTAs an image at batch 8) and 160x160, no power of 2
LARGE_SIZES = (256, 160)
# (batch, height, width) of the exact-k kernels' plan branches
# (ops/fused_degrade.py:exact_k_plan): on 132 SMs 64x64 takes 4 CTAs an
# image at batch 1 and 16, 2 at batch 32 and 1 at batch 64; the ragged 45x45
# and 5x7 take single pixels, 1 CTA; LARGE_SIZES at batch 8 take 8 and
# 256x256 at batch 1 16
EXACT_K_SHAPES = ((1, 64, 64), (16, 64, 64), (32, 64, 64), (64, 64, 64), (1, 45, 45),
                  (1, 5, 7))
EXACT_K_LARGE_SHAPES = tuple((8, n, n) for n in LARGE_SIZES) + ((1, 256, 256),)
# tinyhead forward and backward kernels vs their plain versions in fp32 on the
# same inputs (bf16 ones widened exactly). fp32, (atol, rtol): the kernels'
# online base-2 softmax and sums over S keys in another order, a few fp32 ulps.
TINYHEAD_FP32_TOL = (1e-5, 1e-4)
# bf16: the kernels round P (and the backward dS) to bf16 for the second
# products, each value within BF16_U relative (bf16 keeps 8 significant bits;
# rounding to nearest errs by at most half a unit in the 8th), and round the
# result once. So per element, with P the fp32 softmax and M the sum of the
# magnitudes of the terms the kernel sums (out: P|V| of the row; gradients:
# see tinyhead_grad_mags), |kernel - plain| <= TH_ATOL + (BF16_U + TH_ETA) M +
# BF16_U |plain|, where TH_ETA covers the fp32 sums over up to 4096 terms and
# ex2.approx. A sound kernel's rounding errors have mean 0, so the signed mean
# error over the tensor, relative to mean |ref|, stays under TH_BIAS; a
# rounding that truncates shifts it by ~2^-8.5 while staying under the
# per-element limit. Readings: the worst error over its limit, and that bias.
BF16_U = 2.0**-8
TH_ATOL = 1e-5
TH_ETA = 1e-4
TH_BIAS = 2.0**-12
TH_LSE_TOL = (1e-5, 1e-5)  # lse, base 2: fp32 sums in another order, ex2.approx
# fp32 (split TF32): the same signed mean error. A sound kernel's products
# keep ~2^-22 and its tensor-core sums run a chunk long (a few fp32 ulps,
# 2^-20 at most, even if every sum truncated); one that truncates a split
# value to tf32 (2^-11 relative, always down) shifts it by ~3e-4 while
# staying near the per-element limit
TH_BIAS_FP32 = 2.0**-16
# the backward through the autograd Function vs autograd through the plain
# version, both in bf16: each side rounds its own intermediates (the kernel P,
# dS and, through the forward's bf16 out, D; autograd P and dP) and its result
TH_AUTOGRAD_BF16 = (4 * BF16_U, 2 * BF16_U)  # (share of M, share of |ref|)
TINYHEAD_SHAPES = (  # (B, heads, S, D) where the main paths run the kernel
    (32, 16, 1024, 8),  # the CelebA-HQ config: level 1 (32x32, 128 ch), 5 per forward
    (32, 32, 256, 8),   # the CelebA-HQ config: level 2 (16x16, 256 ch), 5 per forward
    (8, 64, 256, 8),    # unet6 at 256x256, batch 8: level 4 (16x16, 512 ch), 5 per forward
    (4, 16, 4096, 8),   # unet1 at 128x128, batch 4: level 1 (64x64, 128 ch), 5 per forward
)
TINYHEAD_RAGGED = ((2, 4, 200, 8), (2, 4, 384, 8), (2, 4, 256, 4), (2, 4, 200, 4))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# 32-bit integer multiply, add, logic and compare on the CUDA cores: 64 a
# clock per SM on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput); phase 1 sets the rate from the card's
# SM count and its maximum SM clock
INT_OPS_PER_CLOCK_PER_SM = 64
INT_OPS_PER_S = None
# instructions of one Philox4x32-10 draw (its first word) as the exact-k
# kernels compile it for sm_90a: the SASS of a probe kernel that draws once
# less its draw-free twin's, read with cuobjdump -sass by
# masked_diffusion_tpu_torch/tools/philox_sass.py (phase 1 logs it again)
PHILOX_INT_OPS = 42  # 50 SASS instructions less the 8 UIADD3 of the key
# schedule, which run once a warp on the uniform datapath (19 IMAD, 15 LOP3,
# 6 IADD3, 2 VIADD; CUDA 12 nvcc -O3, NVIDIA H100 80GB HBM3)
BF16_TC_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
TF32_TC_OPS_PER_S = 494.7e12  # H100 SXM dense TF32 tensor cores: half the bf16 rate
# exp2 on the special-function units: 16 a clock per SM on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput); phase 1
# sets it from the card's SM count and its maximum SM clock
EXP_PER_CLOCK_PER_SM = 16
EXP_PER_S = None


def log(msg: str) -> None:
    print(msg, flush=True)


def _event_ms(run, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, reps: int = 20, iters: int = 10):
    """(device ms, eager ms) of one fn() call. Device: `reps` calls captured
    in a CUDA graph and replayed `iters` times, so no host launch cost
    enters; eager: `reps` back-to-back calls, host launch cost included."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up outside the capture (compiles, plans)
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up's stream, whose GroupNorm counters it made
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = _event_ms(graph.replay, iters) / reps
    return device, _event_ms(fn, reps)


def bound(nbytes: float, ops: float, int_ops: float = 0.0):
    """(least ms for the work, "bytes" or "operations"): the larger of the
    bytes over the memory rate, fp32 operations over the fp32 rate and
    32-bit integer operations over the integer rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, int_ops / INT_OPS_PER_S if int_ops else 0.0) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_bound(b: int, c: int, hw: int):
    """Bound of one fused degrade call (base_momentum, degraded_area): x_t
    and x0 read, out and the mask written, two amounts read; two Philox draws
    and one compare per pixel and mask (integer); ~6 fp32 operations per
    element for the means, fills and update."""
    return bound(4 * (3 * b * c * hw + b * hw + 2 * b), 6 * b * c * hw,
                 b * hw * 2 * (PHILOX_INT_OPS + 1))


def kmask_bound(b: int, hw: int):
    """Bound of one exact-k mask call: the mask written and the counts read;
    one Philox draw and one compare per pixel (integer)."""
    return bound(4 * b * hw + 4 * b, 0, b * hw * (PHILOX_INT_OPS + 1))


def _exact_k_cases(rng, b: int, hw: int, ties: bool = True):
    """Draws and amounts for one exact-k check: (2, b, hw) uint32 draws (tied
    top bits in some images), counts per mask with k = 0, HW, 1 and HW - 1
    among them, ratios with 0 and 1 among them."""
    import numpy as np

    bits = rng.integers(0, 2**32, size=(2, b, hw), dtype=np.uint64).astype(np.int64)
    if ties and b > 2:
        bits[:, 1:3] &= 0xE0000000  # 8 values of top bits: heavy ties
    counts = rng.integers(0, hw + 1, size=(2, b))
    for i, k in enumerate((0, hw, 1, hw - 1)[:b]):
        counts[:, i] = k
    ratios = rng.uniform(0, 1, size=(2, b)).astype(np.float32)
    ratios[:, 0] = 0.0
    if b > 1:
        ratios[:, 1] = 1.0
    return bits, counts, ratios


def fused_branch_check(rng, b: int, h: int, w: int, launch_plan=None, c: int = 3) -> float:
    """Kernel 1 at one shape and plan: with explicit bits (ties, k = 0, 1,
    HW - 1, HW) and on the Philox route, both selections, both rules and
    means, against fused_rows on the same bits (the route's bits from the
    plain Philox at the same seed and offset): masks bitwise equal, outputs
    within FUSED_TOL, exact counts. Returns the worst |out - plain|."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.ops.fused_degrade import (
        fused_degrade_update,
        fused_rows,
        philox_fused_bits,
    )

    dev = torch.device("cuda")
    hw = h * w
    bits_np, counts, ratios = _exact_k_cases(rng, b, hw)
    bits = torch.from_numpy(bits_np).to(dev)
    xt = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32)).to(dev)
    x0 = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32)).to(dev)
    seed, offset = int(rng.integers(0, 2**62)), int(rng.integers(0, 2**40))
    route = philox_fused_bits(seed, offset, b, hw, dev)
    worst = 0.0
    for select, amounts in (("thresholding", ratios), ("indexing", counts.astype(np.float32))):
        amt = torch.from_numpy(amounts).to(dev)
        for rule, mean_mode, mean_value in (("base_momentum", "degraded_area", 0.0),
                                            ("base_sampling", "const", 0.25)):
            kw = dict(select=select, mean_mode=mean_mode, mean_value=mean_value, rule=rule)
            for name, given, ref_bits in (("bits", bits, bits), ("Philox", None, route)):
                out, mask = fused_degrade_update(
                    xt, x0, amt[0], amt[1], bits=given, seed=seed, offset=offset,
                    launch_plan=launch_plan, **kw)
                ref_out, ref_mask = fused_rows(
                    ref_bits[0], ref_bits[1], xt.reshape(b, -1), x0.reshape(b, -1),
                    amt[0][:, None], amt[1][:, None], channels=c, **kw)
                torch.cuda.synchronize()
                where = f"fused_degrade {b}x{h}x{w} plan {launch_plan} {name} {kw}"
                if not torch.equal(mask.reshape(b, hw), ref_mask):
                    raise AssertionError(f"{where}: masks differ from the plain version")
                err = (out.reshape(b, -1) - ref_out).abs().max().item()
                worst = max(worst, err)
                if not err <= FUSED_TOL:
                    raise AssertionError(f"{where}: max |out - plain| {err} > {FUSED_TOL}")
                if select == "indexing" and not torch.equal(
                        (1.0 - mask).reshape(b, hw).sum(1), amt[1]):
                    raise AssertionError(f"{where}: degraded counts != k")
    return worst


def kmask_branch_check(rng, b: int, h: int, w: int, launch_plan=None) -> None:
    """Kernel 3 at one shape and plan: with explicit bits (ties, k = 0, 1,
    HW - 1, HW), on the Philox route and on its device-seed entry (the
    seed and offset read from a tensor, as the train step's graphs launch
    it) against exact_count_masks_plain on the same bits (each Philox
    route's from the plain Philox at its seed and offset): masks bitwise
    equal, exact counts."""
    import torch

    from masked_diffusion_tpu_torch.ops.fused_degrade import philox_kmask_bits
    from masked_diffusion_tpu_torch.ops.kmask import (
        exact_count_masks,
        exact_count_masks_plain,
        philox_seed,
    )

    dev = torch.device("cuda")
    hw = h * w
    bits_np, counts_np, _ = _exact_k_cases(rng, b, hw)
    bits = torch.from_numpy(bits_np[0]).to(dev)
    counts = torch.from_numpy(counts_np[0].astype("int32")).to(dev)
    gen_seed = int(rng.integers(0, 2**62))
    seed, offset = philox_seed(torch.Generator().manual_seed(gen_seed))
    dseed, doffset = (int(v) for v in rng.integers(0, 2**62, 2))
    for name, kw, ref_bits in (
            ("bits", dict(bits=bits), bits),
            ("Philox", dict(generator=torch.Generator().manual_seed(gen_seed)),
             philox_kmask_bits(seed, offset, b, hw, dev)),
            ("seeds", dict(seeds=torch.tensor([dseed, doffset], dtype=torch.int64, device=dev)),
             philox_kmask_bits(dseed, doffset, b, hw, dev))):
        mask = exact_count_masks(b, h, w, counts, launch_plan=launch_plan, **kw)
        ref = exact_count_masks_plain(ref_bits, counts).reshape(mask.shape)
        torch.cuda.synchronize()
        where = f"kmask {b}x{h}x{w} plan {launch_plan} {name}"
        if not torch.equal(mask, ref):
            raise AssertionError(f"{where}: masks differ from the plain version")
        if not torch.equal((1.0 - mask).reshape(b, hw).sum(1).long(), counts.long()):
            raise AssertionError(f"{where}: zero counts != counts")


def exact_k_branches(kind: str, shapes, tag: str, seed: int):
    """fused_branch_check or kmask_branch_check at each shape on the plan the
    wrapper takes there, then at 64x64 batch 4 on every cluster size's plan
    (the ones this card's SM count does not pick included). Logs each plan
    and, for each plan, how many of its clusters the card holds at once.
    Returns (the plans the wrapper took, the worst |out - plain|)."""
    import ctypes

    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.ops import build
    from masked_diffusion_tpu_torch.ops import fused_degrade as fd

    rng = np.random.default_rng(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check = fused_branch_check if kind == "fused" else kmask_branch_check
    taken, worst, lines = set(), 0.0, []
    runs = [(b, h, w, None) for b, h, w in shapes]
    runs += [(4, 64, 64, fd.exact_k_plan_at(64 * 64, cs, True)) for cs in fd.EXACT_K_CLUSTER_SIZES]
    for b, h, w, forced in runs:
        plan = forced or fd.exact_k_plan(b, h * w, sms)
        if forced is None:
            taken.add(plan)
        worst = max(worst, check(rng, b, h, w, forced) or 0.0)
        lines.append(f"{b}x{h}x{w} {'forced' if forced else 'plan'} cs={plan.cs} "
                     f"threads={plan.threads} per_thread={plan.per_thread} vec={plan.vec}")
    routes = ("explicit bits and the Philox route" if kind == "fused" else
              "explicit bits, the Philox route and its device-seed entry (seeds=)")
    log(f"[{tag}] {kind}: {routes} against the plain version on the plain Philox's bits, "
        f"bitwise masks and exact counts at: " + "; ".join(lines))
    lib = build.load_library()
    query = lib.mdt_fused_degrade_max_clusters if kind == "fused" else lib.mdt_kmask_max_clusters
    for plan in sorted({p for *_, p in runs if p} | taken):
        n = ctypes.c_int(0)
        build.check(lib, query(*plan, ctypes.byref(n)), "max clusters")
        log(f"[{tag}] cudaOccupancyMaxActiveClusters: {kind} cs={plan.cs} threads="
            f"{plan.threads} per_thread={plan.per_thread} vec={plan.vec}: {n.value} at once")
    return taken, worst


def check_plan_coverage(kind: str, taken) -> None:
    """On a 132-SM card the branch shapes' plans reach every cluster size and
    both the vector and the ragged path (elsewhere the forced plans of
    exact_k_branches ran every cluster size)."""
    import torch

    from masked_diffusion_tpu_torch.ops.fused_degrade import EXACT_K_CLUSTER_SIZES

    reached = ({p.cs for p in taken}, {p.vec for p in taken})
    log(f"[2/6/12] {kind}: the branch shapes took cluster sizes {sorted(reached[0])}, "
        f"vector path {sorted(reached[1])}")
    if torch.cuda.get_device_properties(0).multi_processor_count == 132 and reached != (
            set(EXACT_K_CLUSTER_SIZES), {False, True}):
        raise AssertionError(f"{kind}: the branch shapes reached {reached}, not every branch "
                             "of exact_k_plan")


def _product_terms(ops: float, bf16: bool) -> dict:
    """ms of the products by route: bf16 on the tensor cores; fp32 on the
    CUDA cores ("products") or in split TF32 on the tensor cores (three tf32
    products a product, "products_tf32x3")."""
    if bf16:
        return {"products": ops / BF16_TC_OPS_PER_S * 1e3}
    return {"products": ops / FP32_OPS_PER_S * 1e3,
            "products_tf32x3": 3 * ops / TF32_TC_OPS_PER_S * 1e3}


def attention_terms(b: int, h: int, s: int, d: int, bf16: bool) -> dict:
    """ms of each lower bound of one tiny-head attention forward: q, k, v
    read and out written once; the two products (4*B*H*S^2*D operations) on
    the tensor cores in bf16, in fp32 by either route (_product_terms); one
    exp2 a score on the special-function units; the softmax's other ~4 fp32
    operations a score (scale and subtract, max, sum, cast)."""
    return {
        "bytes": 4 * b * h * s * d * (2 if bf16 else 4) / HBM_BYTES_PER_S * 1e3,
        **_product_terms(4 * b * h * s * s * d, bf16),
        "softmax": 4 * b * h * s * s / FP32_OPS_PER_S * 1e3,
        "exp": b * h * s * s / EXP_PER_S * 1e3,
    }


def attention_bwd_terms(b: int, h: int, s: int, d: int, bf16: bool) -> dict:
    """ms of each lower bound of one tiny-head attention backward: q, k, v,
    out, dO and lse read and dq, dk, dv written once; five products
    (10*B*H*S^2*D operations, by route as the forward's); one exp2 a score,
    the least a backward needs (P rebuilt once)."""
    return {
        "bytes": (8 * b * h * s * d * (2 if bf16 else 4) + 4 * b * h * s) / HBM_BYTES_PER_S * 1e3,
        **_product_terms(10 * b * h * s * s * d, bf16),
        "exp": b * h * s * s / EXP_PER_S * 1e3,
    }


def terms_bound(terms: dict):
    """(least ms, "bytes" or "operations", the term that sets it). With
    two product routes (fp32: "products" on the CUDA cores,
    "products_tf32x3" on the tensor cores) a route's bound is the largest
    of its terms, and the least over the routes is the bound."""
    routes = [{t: v for t, v in terms.items() if t != other}
              for other in ("products_tf32x3", "products") if other in terms]
    if len(routes) < 2:
        routes = [terms]
    term, ms = min(((max(r, key=r.get), max(r.values())) for r in routes), key=lambda x: x[1])
    return ms, "bytes" if term == "bytes" else "operations", term


def tinyhead_per_forward(cfg) -> int:
    """Attention blocks of one UNet forward at the shapes the tiny-head
    kernel takes (S >= 128, head_dim <= 8), counted from the topology:
    level i attends at (size / 2^i)^2 tokens with block_out_channels[i]."""
    n = len(cfg.block_out_channels)

    def at(level: int, blocks: int) -> int:
        res, ch = cfg.sample_size >> level, cfg.block_out_channels[level]
        heads = max(1, ch // cfg.attention_head_dim)
        return blocks if res * res >= 128 and ch // heads <= 8 else 0

    down = sum(at(i, cfg.layers_per_block) for i in range(n) if cfg.attn_down[i])
    up = sum(at(n - 1 - i, cfg.layers_per_block + 1) for i in range(n) if cfg.attn_up[i])
    return down + up + at(n - 1, 1)  # and the mid block, at the deepest level


def phase_env():
    import torch

    from masked_diffusion_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    global EXP_PER_S, INT_OPS_PER_S
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EXP_PER_S = EXP_PER_CLOCK_PER_SM * sms * float(clock.split()[0]) * 1e6
    INT_OPS_PER_S = INT_OPS_PER_CLOCK_PER_SM * sms * float(clock.split()[0]) * 1e6
    log(f"[1] {sms} SMs, max SM clock {clock}: {EXP_PER_S:.4g} exp2 a second "
        f"({EXP_PER_CLOCK_PER_SM} a clock per SM), {INT_OPS_PER_S:.4g} integer operations "
        f"a second ({INT_OPS_PER_CLOCK_PER_SM} a clock per SM)")
    sass = subprocess.run([sys.executable, "-m", "masked_diffusion_tpu_torch.tools.philox_sass"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    log(f"[1] one Philox draw: {PHILOX_INT_OPS} instructions in the bounds; the compiled "
        f"code now: {sass.stdout.strip() or sass.stderr.strip()[-300:]}")
    t0 = time.perf_counter()
    build.load_library()
    log(f"[1] csrc/*.cu built and loaded in {time.perf_counter() - t0:.2f} s "
        f"-> {os.path.relpath(build.library_path(), ROOT)}")
    for line in build.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[1]   ptxas: {line.strip()}")
        elif line.startswith("nvcc ") and line.endswith(" s"):
            log(f"[1]   {line}")  # a source's compile seconds
    return smi


def phase_fused():
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.ops.fused_degrade import (
        ExactKPlan,
        exact_k_plan_ok,
        fused_degrade_update,
        fused_rows,
    )

    dev = torch.device("cuda")
    b, c, hw = B_KERNEL, 3, SIZE * SIZE
    rng = np.random.default_rng(0)
    bits_np = rng.integers(0, 2**32, size=(2, b, hw), dtype=np.uint64).astype(np.int64)
    bits_np[:, 8:16] &= 0xE0000000  # 8 values of top bits: heavy ties for exact k
    bits = torch.from_numpy(bits_np).to(dev)
    xt = torch.from_numpy(rng.normal(size=(b, c, SIZE, SIZE)).astype(np.float32)).to(dev)
    x0 = torch.from_numpy(rng.normal(size=(b, c, SIZE, SIZE)).astype(np.float32)).to(dev)
    counts = rng.integers(0, hw + 1, size=(2, b)).astype(np.float32)
    counts[:, 0], counts[:, 1], counts[:, 2], counts[:, 3] = 0, hw, 1, hw - 1  # k=0, k=HW
    ratios = rng.uniform(0, 1, size=(2, b)).astype(np.float32)
    ratios[:, 0], ratios[:, 1] = 0.0, 1.0
    worst = 0.0
    for select, amounts in (("thresholding", ratios), ("indexing", counts)):
        amt = torch.from_numpy(amounts).to(dev)
        for rule in ("base_momentum", "base_sampling"):
            for mean_mode, mean_value in (("degraded_area", 0.0), ("const", 0.25)):
                kw = dict(select=select, mean_mode=mean_mode, mean_value=mean_value, rule=rule)
                out, mask = fused_degrade_update(xt, x0, amt[0], amt[1], bits=bits, **kw)
                ref_out, ref_mask = fused_rows(
                    bits[0], bits[1], xt.reshape(b, -1), x0.reshape(b, -1),
                    amt[0][:, None], amt[1][:, None], channels=c, **kw,
                )
                torch.cuda.synchronize()
                if not torch.equal(mask.reshape(b, hw), ref_mask):
                    raise AssertionError(f"fused_degrade {kw}: masks differ from the plain version")
                err = (out.reshape(b, -1) - ref_out).abs().max().item()
                worst = max(worst, err)
                if not err <= FUSED_TOL:
                    raise AssertionError(f"fused_degrade {kw}: max |out - plain| {err} > {FUSED_TOL}")
    log(f"[2] fused_degrade: 8 mode cases x (k=0, k=HW, ties) at {b}x{SIZE}x{SIZE}x{c}: "
        f"masks bitwise equal, max |out - plain| = {worst:.3g} (tol {FUSED_TOL})")

    # Philox path: exact k (indexing) and the kept share (thresholding)
    k = torch.from_numpy(counts[1]).to(dev)
    kw = dict(select="indexing", mean_mode="degraded_area", rule="base_momentum")
    _, m1 = fused_degrade_update(xt, x0, k, k, seed=1234, offset=7, **kw)
    _, m2 = fused_degrade_update(xt, x0, k, k, seed=1234, offset=7, **kw)
    _, m3 = fused_degrade_update(xt, x0, k, k, seed=1234, offset=8, **kw)
    degraded = (hw - m1.reshape(b, hw).sum(1)).long()
    if not torch.equal(degraded, k.long()):
        raise AssertionError("fused_degrade Philox indexing: degraded counts != k")
    if not torch.equal(m1, m2) or torch.equal(m1, m3):
        raise AssertionError("fused_degrade Philox: not deterministic per (seed, offset)")
    r = 0.3
    amt = torch.full((b,), r, device=dev)
    _, mt = fused_degrade_update(xt, x0, amt, amt, seed=99, offset=0, select="thresholding",
                                 mean_mode="degraded_area")
    n = b * hw
    kept = mt.sum().item() / n
    sigma = (r * (1 - r) / n) ** 0.5
    if abs(kept - (1 - r)) > 3 * sigma:
        raise AssertionError(f"fused_degrade Philox thresholding: kept {kept} vs {1 - r} +- 3*{sigma}")
    log(f"[2] Philox: exact k in all {b} images; kept share {kept:.5f} vs {1 - r} "
        f"(3 sigma = {3 * sigma:.5f}); deterministic per (seed, offset)")

    # times at the flagship shape, on the main path (Philox bits) vs plain
    # (bits drawn by torch, then the row math)
    times = {}
    for select, amounts in (("thresholding", ratios), ("indexing", counts)):
        a = torch.from_numpy(amounts).to(dev)
        kw = dict(select=select, mean_mode="degraded_area", mean_value=0.0, rule="base_momentum")

        def kernel():
            fused_degrade_update(xt, x0, a[0], a[1], seed=5, offset=1, **kw)

        def plain():
            bb = torch.randint(0, 2**32, (2, b, hw), device=dev, dtype=torch.int64)
            fused_rows(bb[0], bb[1], xt.reshape(b, -1), x0.reshape(b, -1), a[0][:, None],
                       a[1][:, None], channels=c, **kw)

        (k_dev, k_eager), (p_dev, p_eager) = cuda_ms(kernel), cuda_ms(plain)
        times[select] = (k_dev, p_dev)
        log(f"[2] time {select} {b}x{SIZE}x{SIZE}x{c}: kernel {k_dev:.4f} ms device "
            f"({k_eager:.4f} eager), plain {p_dev:.4f} ms device ({p_eager:.4f} eager)")
    bnd = fused_bound(b, c, hw)
    log(f"[2] bound {b}x{SIZE}x{SIZE}x{c}: {bnd[0]:.5f} ms by {bnd[1]} "
        f"({4 * (3 * b * c * hw + b * hw + 2 * b) / 1e6:.2f} MB; "
        f"{b * hw * 2 * (PHILOX_INT_OPS + 1) / 1e6:.1f} M integer operations)")

    # every branch of the launch plan, and plans the kernel refuses
    taken, branch_err = exact_k_branches("fused", EXACT_K_SHAPES, "2", 20)
    worst = max(worst, branch_err)
    ragged = torch.zeros((1, c, 5, 7), device=dev)
    refused = ((ExactKPlan(3, 256, 4, True), xt, k),  # a cluster of 3
               (ExactKPlan(2, 256, 4, True), xt, k),  # threads short of the slice
               (ExactKPlan(1, 512, 4, True), ragged, torch.full((1,), 3.0, device=dev)))
    for bad, x, kk in refused:
        if exact_k_plan_ok(bad, x.shape[0], x.shape[2] * x.shape[3]):
            raise AssertionError(f"exact_k_plan_ok takes {bad}")
        try:
            fused_degrade_update(x, x, kk, kk, select="indexing", mean_mode="degraded_area",
                                 launch_plan=bad)
        except RuntimeError:
            continue
        raise AssertionError(f"fused_degrade launched the plan {bad}, which it must refuse")
    log("[2] refused plans (cluster of 3; threads short of the slice; float4 groups on a "
        "ragged 5x7): each raised, as exact_k_plan_ok says")
    return worst, times, bnd, taken


def norm_shapes(batch: int, name: str = "default", size: int = SIZE, tag: str = "[3]"):
    """{((C, H, W), groups, silu): norms per forward} of a UNet: the flagship
    by default, or a zoo name at `size`."""
    import torch

    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.models.unet import GroupNormAct
    from masked_diffusion_tpu_torch.models.zoo import Model

    dev = torch.device("cuda")
    with dev:
        model = build_unet(3, size, size) if name == "default" else Model(name, 3, size, size)
        model = model.to(torch.bfloat16).eval()
    calls = {}

    def hook(mod, inputs, _out):
        key = (tuple(inputs[0].shape[1:]), mod.num_groups, mod.silu)
        calls[key] = calls.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, GroupNormAct)]
    t0 = time.perf_counter()
    with torch.inference_mode():
        model(torch.randn(batch, 3, size, size, device=dev, dtype=torch.bfloat16),
              torch.full((batch,), 10.0, device=dev))
    torch.cuda.synchronize()
    log(f"{tag} {name} forward at {size}x{size} with the CUDA GroupNorm (first launch "
        f"loads the library): {time.perf_counter() - t0:.2f} s; {sum(calls.values())} norms, "
        f"{len(calls)} shapes")
    for h in hooks:
        h.remove()
    return calls


def _gn_inputs(gen, batch, c, h, w):
    import torch

    dev = torch.device("cuda")
    x = torch.randn((batch, c, h, w), generator=gen, device=dev) * 1.7 + 0.3
    scale = torch.randn((c,), generator=gen, device=dev) * 0.1 + 1.0
    bias = torch.randn((c,), generator=gen, device=dev) * 0.1
    return x, scale, bias


def gn_ulps(out, ref32, tol, where: str) -> float:
    """A kernel's fp16 or bf16 output against its plain version run in fp32
    on the same values (ref32): every element within one ulp of ref32
    rounded once to out's dtype, plus `tol`, fp32's (atol, rtol) bound (the
    kernel's arithmetic before its rounding, whose error near zero outgrows
    an ulp there; an fp16 subnormal's ulp is 2^-24). Returns the largest
    difference in ulps; the worst element is named in the error."""
    import torch

    name = str(out.dtype).split(".")[1]
    bits, tiny = {"float16": (11, 2.0**-14), "bfloat16": (8, 2.0**-126)}[name]
    ref = ref32.to(out.dtype).float()
    _, exp = torch.frexp(ref.abs().clamp(min=tiny))
    ulp = torch.ldexp(torch.ones_like(ref), exp - bits)
    diff = (out.float() - ref).abs()
    atol, rtol = tol
    excess = diff - (ulp + atol + rtol * ref.abs())
    ulps = float((diff / ulp).max())
    if float(excess.max()) > 0:
        i = int(excess.argmax())
        raise AssertionError(
            f"{where}: {float(diff.flatten()[i]):.3g} from the plain version in fp32 rounded "
            f"once ({float(ref.flatten()[i]):.6g}) at element {i}, beyond one {name} ulp "
            f"({float(ulp.flatten()[i]):.3g}) plus atol {atol} rtol {rtol}; {ulps:.3g} ulps at "
            f"most")
    if ulps > 1.0:
        i = int((diff / ulp).argmax())
        log(f"[{name}] {where}: {ulps:.3g} ulps at the reference {float(ref.flatten()[i]):.6g} "
            f"(a difference of {float(diff.flatten()[i]):.3g}), within fp32's bound")
    return ulps


def gn_fp16_ulps(out, xd, scale, bias, groups: int, silu: bool, where: str) -> float:
    """The fp16 forward kernel's output against its plain version run in
    fp32 on the same values, by gn_ulps under GN_TOL's fp32 bound."""
    import torch

    from masked_diffusion_tpu_torch.ops.groupnorm import group_norm_silu_plain

    if out.dtype != torch.float16:
        raise AssertionError(f"group_norm_silu float16 {where}: output dtype {out.dtype}")
    ref = group_norm_silu_plain(xd.float(), scale.float(), bias.float(), groups, 1e-5, silu)
    return gn_ulps(out, ref, GN_TOL["float32"], f"group_norm_silu float16 {where}")


def phase_groupnorm(calls, batch: int):
    import torch
    import torch.nn.functional as F

    from masked_diffusion_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0}
    k_total = p_total = lib_total = bnd_total = 0.0
    f16 = dict(kernel=0.0, plain=0.0, library=0.0, ulps=0.0)
    with torch.inference_mode():
        for (chw, groups, silu), count in sorted(calls.items()):
            c, h, w = chw
            x, scale, bias = _gn_inputs(gen, batch, c, h, w)
            line = []
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                xd, sd, bd = x.to(dtype), scale.to(dtype), bias.to(dtype)
                out = group_norm_silu(xd, sd, bd, groups, 1e-5, silu)
                ref = group_norm_silu_plain(xd, sd, bd, groups, 1e-5, silu)
                name = str(dtype).split(".")[1]
                atol, rtol = GN_TOL[name]
                diff = (out.float() - ref.float()).abs()
                if out.dtype != dtype or not bool((diff <= atol + rtol * ref.float().abs()).all()):
                    raise AssertionError(
                        f"group_norm_silu {name} {(batch, c, h, w)} G={groups} silu={silu}: "
                        f"max err {diff.max().item()} beyond atol {atol} rtol {rtol}")
                worst[name] = max(worst[name], diff.max().item())
                if dtype == torch.float16:
                    f16["ulps"] = max(f16["ulps"], gn_fp16_ulps(
                        out, xd, sd, bd, groups, silu, f"{(batch, c, h, w)} G={groups}"))

                def library():
                    y = F.group_norm(xd, groups, sd, bd, 1e-5)
                    return F.silu(y) if silu else y

                kms, keager = cuda_ms(lambda: group_norm_silu(xd, sd, bd, groups, 1e-5, silu))
                pms, peager = cuda_ms(
                    lambda: group_norm_silu_plain(xd, sd, bd, groups, 1e-5, silu))
                lms, _ = cuda_ms(library)
                line.append(f"{name} kernel {kms:.4f} ({keager:.4f} eager) "
                            f"plain {pms:.4f} ({peager:.4f} eager) library {lms:.4f} ms")
                if dtype == torch.float16:
                    f16["kernel"] += count * kms
                    f16["plain"] += count * pms
                    f16["library"] += count * lms
                if dtype == torch.bfloat16:
                    n = batch * c * h * w
                    k_total += count * kms
                    p_total += count * pms
                    lib_total += count * lms
                    # x read, y written (bf16), scale, bias; ~12 operations per element
                    bnd_total += count * bound(2 * 2 * n + 4 * 2 * c, 12 * n)[0]
            log(f"[3] GN {batch}x{c}x{h}x{w} G={groups} silu={int(silu)} (x{count} per forward): "
                + "; ".join(line))
    log(f"[3] group_norm_silu: all shapes within tolerance; max err fp32 {worst['float32']:.3g}, "
        f"bf16 {worst['bfloat16']:.3g}, fp16 {worst['float16']:.3g} ({f16['ulps']:.3g} fp16 "
        f"ulps at most from the plain version in fp32 rounded once, each element within one "
        f"ulp plus fp32's bound; csrc/groupnorm_f16.cu); "
        f"device time per bf16 forward at batch {batch}: "
        f"kernel {k_total:.4f} ms, plain {p_total:.4f} ms, F.group_norm+F.silu "
        f"{lib_total:.4f} ms, bound {bnd_total:.5f} ms (bytes); per fp16 forward: kernel "
        f"{f16['kernel']:.4f} ms, plain {f16['plain']:.4f} ms, F.group_norm+F.silu "
        f"{f16['library']:.4f} ms (the bound as bf16's)")
    return worst["float32"], k_total, p_total, lib_total, (bnd_total, "bytes")


def phase_kmask():
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.ops.kmask import exact_count_masks, exact_count_masks_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    worst = 0.0
    for b, size in ((B_KERNEL, SIZE), (8, 128)):
        hw = size * size
        bits_np = rng.integers(0, 2**32, size=(b, hw), dtype=np.uint64).astype(np.int64)
        bits_np[2:6] &= 0xE0000000  # 8 values of top bits: heavy ties
        counts_np = rng.integers(0, hw + 1, size=(b,)).astype(np.int32)
        counts_np[:4] = (0, hw, hw - 1, 1)
        bits = torch.from_numpy(bits_np).to(dev)
        counts = torch.from_numpy(counts_np).to(dev)
        mask = exact_count_masks(b, size, size, counts, bits=bits)
        ref = exact_count_masks_plain(bits, counts).reshape(b, 1, size, size)
        torch.cuda.synchronize()
        worst = max(worst, (mask - ref).abs().max().item())
        if not torch.equal(mask, ref):
            raise AssertionError(f"kmask {b}x{size}x{size}: masks differ from the plain version")
        zeros = (1.0 - mask).reshape(b, hw).sum(1).long().cpu().numpy()
        if not np.array_equal(zeros, counts_np):
            raise AssertionError(f"kmask {b}x{size}x{size}: zero counts != counts")
    log(f"[6] kmask: explicit bits at {B_KERNEL}x{SIZE}x{SIZE} and 8x128x128 "
        f"(k = 0, 1, HW-1, HW, random; tied top bits): masks bitwise equal "
        f"(max |mask - plain| {worst}), exact counts")

    # Philox path: exact k, determinism, and per-pixel frequency
    b, hw = B_KERNEL, SIZE * SIZE
    counts = torch.from_numpy(rng.integers(0, hw + 1, size=(b,)).astype(np.int32)).to(dev)
    m1 = exact_count_masks(b, SIZE, SIZE, counts, generator=torch.Generator().manual_seed(3))
    m2 = exact_count_masks(b, SIZE, SIZE, counts, generator=torch.Generator().manual_seed(3))
    m3 = exact_count_masks(b, SIZE, SIZE, counts, generator=torch.Generator().manual_seed(4))
    if not torch.equal((1.0 - m1).reshape(b, hw).sum(1).long(), counts.long()):
        raise AssertionError("kmask Philox: zero counts != counts")
    if not torch.equal(m1, m2) or torch.equal(m1, m3):
        raise AssertionError("kmask Philox: not deterministic per seed")
    k = hw // 4
    quarter = torch.full((b,), k, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(5)
    draws = 8
    freq = sum((1.0 - exact_count_masks(b, SIZE, SIZE, quarter, generator=gen)).sum(0)
               for _ in range(draws)).reshape(hw) / (b * draws)
    p = k / hw
    z = (freq - p) / (p * (1 - p) / (b * draws)) ** 0.5
    zmax, zsq = z.abs().max().item(), z.square().mean().item()
    if zmax > KMASK_Z or not 0.9 <= zsq <= 1.1:
        raise AssertionError(f"kmask Philox: per-pixel frequency max |z| {zmax}, mean z^2 {zsq}")
    log(f"[6] Philox: exact k in all {b} images, deterministic per seed; degraded "
        f"frequency at k = HW/4 over {b} images x {draws} draws: max |z| {zmax:.3f} "
        f"(bound {KMASK_Z}) over {hw} pixels, mean z^2 {zsq:.4f} (1 expected)")

    kgen = torch.Generator().manual_seed(7)
    kms, keager = cuda_ms(lambda: exact_count_masks(b, SIZE, SIZE, counts, generator=kgen))

    def plain():
        bb = torch.randint(0, 2**32, (b, hw), device=dev, dtype=torch.int64)
        exact_count_masks_plain(bb, counts)

    pms, peager = cuda_ms(plain)
    bnd = kmask_bound(b, hw)
    log(f"[6] time {b}x{SIZE}x{SIZE}: kernel {kms:.4f} ms device ({keager:.4f} eager), "
        f"plain {pms:.4f} ms device ({peager:.4f} eager), bound {bnd[0]:.5f} ms by {bnd[1]}")
    taken, _ = exact_k_branches("kmask", EXACT_K_SHAPES, "6", 60)
    return worst, kms, pms, bnd, taken


def gn_backward_checks(xd, scale, bias, gd, groups: int, silu: bool, where: str) -> None:
    """The backward kernel at one shape, from the forward kernel's saved
    statistics: against its plain version (group_norm_silu_backward_plain)
    under GN_BWD_TOL and GN_BWD_SUM_TOL; bitwise the same dx, dscale and
    dbias over two runs; and bitwise the same from the same gradient held
    with channels as the fast axis (the layout the attention block hands
    its norm), whose strides the kernel takes."""
    import torch

    from masked_diffusion_tpu_torch.ops.groupnorm import (
        group_norm_silu_backward,
        group_norm_silu_backward_plain,
        group_norm_silu_forward,
    )

    _, mean, rstd = group_norm_silu_forward(xd, scale, bias, groups, 1e-5, silu)
    first = group_norm_silu_backward(xd, scale, bias, gd, mean, rstd, groups, silu)
    again = group_norm_silu_backward(xd, scale, bias, gd, mean, rstd, groups, silu)
    g_cl = gd.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    strided = group_norm_silu_backward(xd, scale, bias, g_cl, mean, rstd, groups, silu)
    for what, a, b, c in zip(("dx", "dscale", "dbias"), first, again, strided):
        if not torch.equal(a, b):
            raise AssertionError(f"group_norm_silu backward {where}: {what} differs between "
                                 f"two runs on the same inputs (max {(a - b).abs().max()})")
        if not torch.equal(a, c):
            raise AssertionError(f"group_norm_silu backward {where}: {what} from a strided "
                                 f"gradient differs from the contiguous one")
    ref = group_norm_silu_backward_plain(xd, scale, bias, gd, mean, rstd, groups, silu)
    b, _, h, w = xd.shape
    atol, rtol = GN_BWD_TOL[str(xd.dtype).split(".")[1]]
    sum_atol = GN_BWD_SUM_TOL[0] * b * h * w
    for what, got, r, a_, r_ in (("dx", first[0], ref[0], atol, rtol),
                                 ("dscale", first[1], ref[1], sum_atol, GN_BWD_SUM_TOL[1]),
                                 ("dbias", first[2], ref[2], sum_atol, GN_BWD_SUM_TOL[1])):
        diff = (got.float() - r.float()).abs()
        if got.dtype != r.dtype or not bool((diff <= a_ + r_ * r.float().abs()).all()):
            raise AssertionError(
                f"group_norm_silu backward {where}: {what} vs group_norm_silu_backward_plain "
                f"max err {diff.max().item()} beyond atol {a_} rtol {r_}")


GN_PROFILED = False  # profiled once per process


def gn_profile_one_call(xd, scale, bias, gd, groups: int, silu: bool, calls: int = 4,
                        tries: int = 3) -> None:
    """torch.profiler's count of the device work of forwards with grad and
    of their backwards through the autograd Function, `calls` of each in a
    window: one kernel per call, no sum, cast, copy or memset beside it. A
    window in which the profiler records no device work at all is taken
    again, up to `tries` times, and then reported as not measured (the
    launch counters still hold every call to one launch each)."""
    global GN_PROFILED
    GN_PROFILED = True
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from masked_diffusion_tpu_torch.ops.groupnorm import group_norm_silu

    def leaves():
        return [t.detach().requires_grad_(True) for t in (xd, scale, bias)]

    def device_rows(make):
        """make() prepares the inputs outside the window and returns the work."""
        for _ in range(tries):
            run = make()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            rows = [(e.key, e.count) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "#" not in e.key
                    and not getattr(e, "is_user_annotation", False)]
            if rows:
                return rows
        return None

    def forwards():
        ins = [leaves() for _ in range(calls)]
        return lambda: [group_norm_silu(*t, groups, 1e-5, silu) for t in ins]

    def backwards():
        ins = [leaves() for _ in range(calls)]
        ys = [group_norm_silu(*t, groups, 1e-5, silu) for t in ins]
        return lambda: [torch.autograd.grad(y, t, gd) for y, t in zip(ys, ins)]

    fwd, bwd = device_rows(forwards), device_rows(backwards)
    for what, rows, frag in (("forward", fwd, "gn_fwd_"), ("backward", bwd, "gn_bwd_")):
        if rows is None:
            log(f"[7] torch.profiler recorded no device work in {tries} windows of {calls} "
                f"{what} calls: kernels per call not measured (one launch each by the counters)")
            continue
        if sum(n for _, n in rows) != calls or not all(frag in k for k, _ in rows):
            raise AssertionError(f"group_norm_silu with grad: {calls} {what} calls ran {rows} "
                                 f"on the device; expected one {frag}* kernel each")
        log(f"[7] torch.profiler, {calls} {what} calls at {tuple(xd.shape)} {xd.dtype}: "
            f"{rows[0][0][:60]}..., one kernel each")


def phase_groupnorm_branches():
    """[3] and [7] at GN_BRANCH_SHAPES: every branch of the launch plan. The
    forward (serving: scale and bias in x's dtype; x contiguous and
    channels_last) against the plain version under GN_TOL, then with grad and
    its backward as gn_train_check holds them. Logs each shape's plans and,
    for each cluster size used, how many clusters the card holds at once."""
    import torch

    from masked_diffusion_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    seen, clusters = set(), {}
    for (b, c, h, w, groups) in GN_BRANCH_SHAPES:
        x, scale, bias = _gn_inputs(gen, b, c, h, w)
        g = torch.randn(x.shape, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            xd, gd, sd, bd = x.to(dtype), g.to(dtype), scale.to(dtype), bias.to(dtype)
            with torch.inference_mode():
                ref = gn.group_norm_silu_plain(xd, sd, bd, groups, 1e-5, True).float()
                for layout in (torch.contiguous_format, torch.channels_last):
                    out = gn.group_norm_silu(xd.contiguous(memory_format=layout), sd, bd,
                                             groups, 1e-5, True)
                    atol, rtol = GN_TOL[name]
                    diff = (out.float() - ref).abs()
                    if not bool((diff <= atol + rtol * ref.abs()).all()):
                        raise AssertionError(
                            f"group_norm_silu {name} {(b, c, h, w)} G={groups} {layout}: max "
                            f"err {diff.max().item()} beyond atol {atol} rtol {rtol}")
            err = gn_train_check(xd, scale, bias, gd, groups, True)
            plans = []
            for backward in (False, True):
                p = gn._cuda_plan(b, c, h, w, groups, dtype, backward)
                seen.add(("lane", p.per_lane) if p.per_lane else ("ctas", p.ctas))
                seen.add(("on_chip", p.on_chip))
                seen.add(("per_cta", p.spans_per_cta))
                if p.ctas > 1:
                    clusters[(backward, name, p.ctas, p.threads, p.smem)] = \
                        gn.max_active_clusters(backward, dtype, p)
                plans.append(f"{'backward' if backward else 'forward'} ctas={p.ctas} "
                             f"per_lane={p.per_lane} per_cta={p.spans_per_cta} "
                             f"threads={p.threads} smem={p.smem} "
                             f"on_chip={p.on_chip}")
            log(f"[7] GN branch {(b, c, h, w)} G={groups} {name}: forward (contiguous and "
                f"channels_last x), with grad and backward within tolerance, max |dx| err "
                f"{err:.3g}; " + "; ".join(plans))
    want = {("lane", 2), ("lane", 8), ("lane", 32), ("ctas", 1), ("ctas", 2),
            ("ctas", 4), ("ctas", 8), ("ctas", 16), ("on_chip", True), ("on_chip", False),
            ("per_cta", 1), ("per_cta", 2), ("per_cta", 4), ("per_cta", 8)}
    if seen != want:
        raise AssertionError(f"the GroupNorm branch shapes reached {sorted(seen)}, "
                             f"not every branch of the plan {sorted(want)}")
    for (backward, name, ctas, threads, smem), n in sorted(clusters.items()):
        log(f"[7] cudaOccupancyMaxActiveClusters: GN {'backward' if backward else 'forward'} "
            f"{name}, {ctas} CTAs of {threads} threads and {smem} B of shared memory: "
            f"{n} clusters at once")


def gn_train_check(xd, scale, bias, gd, groups: int, silu: bool) -> float:
    """GroupNorm(+SiLU) with grad at one shape, as a train step runs it: the
    forward through the autograd Function (one forward and one backward
    launch) against the plain forward, its gradients against autograd
    through the plain version in fp32 on the same values, then
    gn_backward_checks. Returns the max |dx| error."""
    import torch

    from masked_diffusion_tpu_torch.ops.groupnorm import (
        group_norm_silu,
        group_norm_silu_backward,
        group_norm_silu_plain,
    )

    dtype = xd.dtype
    name = str(dtype).split(".")[1]
    batch, c, h, w = xd.shape
    where = f"{name} {(batch, c, h, w)} G={groups} silu={silu}"
    # the training path: fp32 scale and bias (parameters under
    # autocast), x and the incoming gradient in the step's dtype
    xg = xd.detach().requires_grad_(True)
    sg = scale.detach().requires_grad_(True)
    bg = bias.detach().requires_grad_(True)
    launched = group_norm_silu.launches, group_norm_silu_backward.launches
    y = group_norm_silu(xg, sg, bg, groups, 1e-5, silu)
    dx, ds, db = torch.autograd.grad(y, (xg, sg, bg), gd)
    launched = (group_norm_silu.launches - launched[0],
                group_norm_silu_backward.launches - launched[1])
    if launched != (1, 1):
        raise AssertionError(f"group_norm_silu with grad launched (forward, "
                             f"backward) {launched} kernels, expected (1, 1)")
    with torch.no_grad():
        ref_y = group_norm_silu_plain(xd, scale, bias, groups, 1e-5, silu)
        if dtype == torch.float16:
            gn_fp16_ulps(y.detach(), xd, scale, bias, groups, silu, f"with grad {where}")
    fa, fr = GN_TOL[name]
    fdiff = (y.detach().float() - ref_y.float()).abs()
    if y.dtype != dtype or not bool((fdiff <= fa + fr * ref_y.float().abs()).all()):
        raise AssertionError(
            f"group_norm_silu forward with grad {name} {(batch, c, h, w)} "
            f"G={groups} silu={silu}: max err {fdiff.max().item()} beyond "
            f"atol {fa} rtol {fr}")
    # the plain backward in fp32 on the same values
    xr = xd.float().requires_grad_(True)
    sr = scale.clone().requires_grad_(True)
    br = bias.clone().requires_grad_(True)
    yr = group_norm_silu_plain(xr, sr, br, groups, 1e-5, silu)
    rx, rs, rb = torch.autograd.grad(yr, (xr, sr, br), gd.float())
    atol, rtol = GN_BWD_TOL[name]
    sum_atol = GN_BWD_SUM_TOL[0] * batch * h * w
    errs = []
    for what, got, ref, a, r in (("dx", dx, rx, atol, rtol),
                                 ("dscale", ds, rs, sum_atol, GN_BWD_SUM_TOL[1]),
                                 ("dbias", db, rb, sum_atol, GN_BWD_SUM_TOL[1])):
        diff = (got.float() - ref).abs()
        if not bool((diff <= a + r * ref.abs()).all()):
            raise AssertionError(
                f"group_norm_silu backward {name} {what} {(batch, c, h, w)} "
                f"G={groups} silu={silu}: max err {diff.max().item()} beyond "
                f"atol {a} rtol {r}")
        errs.append(diff.max().item())
    if dx.dtype != dtype:
        raise AssertionError(f"dx dtype {dx.dtype} != {dtype}")
    gn_backward_checks(xd, scale, bias, gd, groups, silu, where)
    return errs[0]


def phase_groupnorm_train(calls, batch: int, tag: str = "[7]", timed: bool = True):
    """GroupNorm(+SiLU) as a train step runs it, at the training batch: the
    forward with grad through the autograd Function (forward kernel, fp32
    statistics saved), then its backward kernel, against the plain forward
    and autograd through the plain version. Returns the backward's (max
    fp32 |dx| err, kernel ms, plain ms, library ms, bound) and the bf16
    forward's (kernel ms, plain ms, library ms, bound) per train step
    (zeros when not `timed`)."""
    import torch
    import torch.nn.functional as F

    from masked_diffusion_tpu_torch.ops.groupnorm import (
        group_norm_silu_backward,
        group_norm_silu_backward_plain,
        group_norm_silu_forward,
        group_norm_silu_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0}
    bwd = dict(kernel=0.0, plain=0.0, library=0.0, bound=0.0, backward_plain=0.0)
    fwd_t = dict(kernel=0.0, plain=0.0, library=0.0, bound=0.0)
    f16_bwd = f16_fwd = 0.0  # the fp16 instance's kernel times
    shapes = sorted({(chw, groups) for chw, groups, _ in calls})
    for chw, groups in shapes:
        c, h, w = chw
        x, scale, bias = _gn_inputs(gen, batch, c, h, w)
        g = torch.randn(x.shape, generator=gen, device=dev)
        line = []
        for silu in (True, False):
            count = calls.get((chw, groups, silu), 0)
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                name = str(dtype).split(".")[1]
                xd, gd = x.to(dtype), g.to(dtype)
                worst[name] = max(worst[name], gn_train_check(xd, scale, bias, gd, groups, silu))
                if not GN_PROFILED:
                    gn_profile_one_call(xd, scale, bias, gd, groups, silu)
                if not timed or count == 0 or dtype == torch.float32:
                    continue
                _, mean, rstd = group_norm_silu_forward(xd, scale, bias, groups, 1e-5, silu)

                def kernel():
                    group_norm_silu_backward(xd, scale, bias, gd, mean, rstd, groups, silu)

                def fwd_bwd(fn):
                    xg = xd.detach().requires_grad_(True)
                    sg = scale.detach().requires_grad_(True)
                    bg = bias.detach().requires_grad_(True)
                    torch.autograd.grad(fn(xg, sg, bg), (xg, sg, bg), gd)

                def fwd(fn):
                    with torch.no_grad():
                        fn(xd, scale, bias)

                def plain_fn(xx, ss, bb):
                    return group_norm_silu_plain(xx, ss, bb, groups, 1e-5, silu)

                def lib_fn(xx, ss, bb):
                    y = F.group_norm(xx, groups, ss.to(xx.dtype), bb.to(xx.dtype), 1e-5)
                    return F.silu(y) if silu else y

                kms, _ = cuda_ms(kernel)
                kfwd, _ = cuda_ms(lambda: group_norm_silu_forward(xd, scale, bias, groups,
                                                                  1e-5, silu))
                if dtype == torch.float16:  # its kernels' times; the rest as bf16's
                    f16_bwd += count * kms
                    f16_fwd += count * kfwd
                    line.append(f"fp16 silu={int(silu)} x{count}: backward kernel {kms:.4f}, "
                                f"forward kernel {kfwd:.4f} ms")
                    continue
                bpms = cuda_ms(lambda: group_norm_silu_backward_plain(
                    xd, scale, bias, gd, mean, rstd, groups, silu))[0]
                bwd["backward_plain"] += count * bpms
                pfwd = cuda_ms(lambda: fwd(plain_fn))[0]
                lfwd = cuda_ms(lambda: fwd(lib_fn))[0]
                pms = cuda_ms(lambda: fwd_bwd(plain_fn))[0] - pfwd
                lms = cuda_ms(lambda: fwd_bwd(lib_fn))[0] - lfwd
                n = batch * c * h * w
                for acc, k, p, lib in ((bwd, kms, pms, lms), (fwd_t, kfwd, pfwd, lfwd)):
                    acc["kernel"] += count * k
                    acc["plain"] += count * p
                    acc["library"] += count * lib
                # backward: x and g read, dx written (bf16), fp32 partials; ~40
                # operations per element over the two passes. forward: x read,
                # y written (bf16), fp32 scale, bias and statistics; ~12
                bwd["bound"] += count * bound(3 * 2 * n + 2 * 4 * batch * c, 40 * n)[0]
                fwd_t["bound"] += count * bound(2 * 2 * n + 2 * 4 * c + 2 * 4 * batch * groups,
                                                12 * n)[0]
                line.append(f"silu={int(silu)} x{count}: backward kernel {kms:.4f} plain "
                            f"{bpms:.4f} autograd through the plain forward {pms:.4f} "
                            f"library {lms:.4f} ms, forward kernel {kfwd:.4f} plain "
                            f"{pfwd:.4f} library {lfwd:.4f} ms")
        log(f"{tag} GN train {batch}x{c}x{h}x{w} G={groups}: forward with grad and backward "
            f"within tolerance" + ("; bf16 " + "; ".join(line) if line else ""))
    log(f"{tag} group_norm_silu with grad at batch {batch}: all shapes within tolerance, one "
        f"forward and one backward launch each; max |dx| err fp32 {worst['float32']:.3g}, "
        f"bf16 {worst['bfloat16']:.3g}, fp16 {worst['float16']:.3g} (csrc/groupnorm_f16.cu, "
        f"its forward within one fp16 ulp plus fp32's bound)")
    if timed:
        log(f"{tag} device time per fp16 train step at batch {batch} (csrc/groupnorm_f16.cu): "
            f"GN backward kernel {f16_bwd:.4f} ms, forward kernel {f16_fwd:.4f} ms (the "
            f"bounds as bf16's)")
    for what, acc in (("backward", bwd), ("forward", fwd_t)):
        if not timed:
            break
        log(f"{tag} device time per bf16 train step, GN {what} at batch {batch}: kernel "
            f"{acc['kernel']:.4f} ms, "
            + (f"plain (group_norm_silu_backward_plain) {acc['backward_plain']:.4f} ms, "
               f"autograd through the plain forward " if what == "backward" else "plain ")
            + f"{acc['plain']:.4f} ms, F.group_norm+F.silu "
            f"{acc['library']:.4f} ms, bound {acc['bound']:.5f} ms (bytes)"
            + (" (backward = forward+backward minus forward)" if what == "backward" else ""))
    return ((worst["float32"], bwd["kernel"], bwd["backward_plain"], bwd["library"],
             (bwd["bound"], "bytes")),
            (fwd_t["kernel"], fwd_t["plain"], fwd_t["library"], (fwd_t["bound"], "bytes")))


# [32] kernels 2 and 2b in their split modes (--mesh_spatial), M ranks
# emulated in one process by row pieces and a sum of their (2, B*G) tensors
SP_SPLIT_NORMS = 65  # of the flagship's 71 norms a forward, split at M = 2
SP_WHOLE_NORMS = 6  # its attention blocks' norms, on kernel 2 whole under SP
SPLIT_ONLY = ("group_norm_split", "group_norm_split_backward")  # under --mesh_spatial alone
# the fp32 tiny-head kernels' own counts: models that attend at S >= 128 in fp32 alone
FP32_ONLY = ("tinyhead_attention_fp32", "tinyhead_attention_backward_fp32")


def _unet(name: str, size: int):
    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.models.zoo import Model

    return build_unet(3, size, size) if name == "default" else Model(name, 3, size, size)


def split_norm_names(m: int, name: str = "default", size: int = SIZE) -> set:
    """The names of the GroupNormAct modules that parallel/sp.py:split_module
    splits at model size m (each runs once a forward), from a model on the
    meta device: the flagship by default, or a zoo name at `size`."""
    import types

    import torch

    from masked_diffusion_tpu_torch.parallel import sp

    with torch.device("meta"):
        twin = _unet(name, size)
    # rank 1 of m: split_module prints nothing and touches no tensor
    sp.split_module(twin, types.SimpleNamespace(model_size=m, rank=1, model_rank=1))
    return {n for n, mod in twin.named_modules() if isinstance(mod, sp.SplitGroupNormAct)}


def split_norm_shapes(m: int, name: str = "default", size: int = SIZE):
    """{((C, H / m, W), groups, silu): norms per forward} of the norms that
    parallel/sp.py:split_module splits at model size m: each rank's local
    shape. The flagship by default, or a zoo name at `size`."""
    import torch

    from masked_diffusion_tpu_torch.models.unet import GroupNormAct

    split = split_norm_names(m, name, size)
    dev = torch.device("cuda")
    with dev:
        model = _unet(name, size).to(torch.bfloat16).eval()
    calls = {}

    def hook(mod, inputs, _out):
        c, h, w = inputs[0].shape[1:]
        key = ((c, h // m, w), mod.num_groups, mod.silu)
        calls[key] = calls.get(key, 0) + 1

    hooks = [mod.register_forward_hook(hook) for n, mod in model.named_modules()
             if n in split and isinstance(mod, GroupNormAct)]
    with torch.inference_mode():
        model(torch.randn(1, 3, size, size, device=dev, dtype=torch.bfloat16),
              torch.full((1,), 10.0, device=dev))
    for h in hooks:
        h.remove()
    del model
    return calls


def split_check(x, scale, bias, g, groups: int, silu: bool, m: int, where: str) -> dict:
    """Kernels 2 and 2b in their split modes on m row pieces of x (each
    piece one rank's rows, contiguous), the pieces' sums added in order in
    place of the all-reduce, against the plain split functions on the same
    pieces: fp32 under GN_TOL / GN_BWD_TOL; bf16 and fp16 within one ulp of
    the plain versions in fp32 rounded once (plus fp32's bound); the
    statistics, dscale and dbias (summed over the pieces) in fp32. Returns
    the max |y| and |dx| errors and the pieces, statistics and sums the
    timing reuses."""
    import torch

    from masked_diffusion_tpu_torch.ops import groupnorm as gn

    name = str(x.dtype).split(".")[1]
    b, c, h, w = x.shape
    pieces = [p.contiguous() for p in x.chunk(m, 2)]
    g_pieces = [p.contiguous() for p in g.chunk(m, 2)]
    count = float(m * (c // groups) * (h // m) * w)
    sums = sum(gn.group_norm_sums(p, groups) for p in pieces)
    fwd = [gn.group_norm_apply(p, scale, bias, sums, count, groups, 1e-5, silu) for p in pieces]
    ref_sums = sum(gn.group_norm_sums_plain(p.float(), groups) for p in pieces)
    ref = [gn.group_norm_apply_plain(p.float(), scale, bias, ref_sums, count, groups, 1e-5, silu)
           for p in pieces]
    fa, fr = GN_TOL["float32"]
    stats = torch.stack([torch.stack(f[1:]) for f in fwd])
    ref_stats = torch.stack([torch.stack(r[1:]) for r in ref])
    if not bool(((stats - ref_stats).abs() <= fa + fr * ref_stats.abs()).all()):
        raise AssertionError(f"[32] split GroupNorm {where}: statistics max err "
                             f"{float((stats - ref_stats).abs().max()):.3g}")
    y, y_ref = torch.cat([f[0] for f in fwd], 2), torch.cat([r[0] for r in ref], 2)
    if y.dtype != x.dtype:
        raise AssertionError(f"[32] split GroupNorm {where}: y dtype {y.dtype}")
    if x.dtype == torch.float32:
        diff = (y - y_ref).abs()
        if not bool((diff <= fa + fr * y_ref.abs()).all()):
            raise AssertionError(f"[32] split GroupNorm {where}: y max err "
                                 f"{float(diff.max()):.3g} beyond atol {fa} rtol {fr}")
    else:
        gn_ulps(y, y_ref, GN_TOL["float32"], f"[32] split GroupNorm {where}: y")

    first = [gn.group_norm_backward_sums(p, scale, bias, gp, f[1], f[2], groups, silu)
             for p, gp, f in zip(pieces, g_pieces, fwd)]
    msums = sum(f[0] for f in first)
    dx = torch.cat([gn.group_norm_backward_apply(p, scale, bias, gp, f[1], f[2], msums, count,
                                                 groups, silu)
                    for p, gp, f in zip(pieces, g_pieces, fwd)], 2)
    ref_first = [gn.group_norm_backward_sums_plain(p.float(), scale, bias, gp.float(), f[1],
                                                   f[2], groups, silu)
                 for p, gp, f in zip(pieces, g_pieces, fwd)]
    ref_msums = sum(r[0] for r in ref_first)
    dx_ref = torch.cat([gn.group_norm_backward_apply_plain(p.float(), scale, bias, gp.float(),
                                                           f[1], f[2], ref_msums, count,
                                                           groups, silu)
                        for p, gp, f in zip(pieces, g_pieces, fwd)], 2)
    ba, br = GN_BWD_TOL["float32"]
    if dx.dtype != x.dtype:
        raise AssertionError(f"[32] split GroupNorm {where}: dx dtype {dx.dtype}")
    if x.dtype == torch.float32:
        diff = (dx - dx_ref).abs()
        if not bool((diff <= ba + br * dx_ref.abs()).all()):
            raise AssertionError(f"[32] split GroupNorm backward {where}: dx max err "
                                 f"{float(diff.max()):.3g} beyond atol {ba} rtol {br}")
    else:
        gn_ulps(dx, dx_ref, GN_BWD_TOL["float32"], f"[32] split GroupNorm backward {where}: dx")
    sum_atol = GN_BWD_SUM_TOL[0] * b * h * w
    for what, i in (("dscale", 1), ("dbias", 2)):
        got = sum(f[i].float() for f in first)
        want = sum(r[i].float() for r in ref_first)
        if not bool(((got - want).abs() <= sum_atol + GN_BWD_SUM_TOL[1] * want.abs()).all()):
            raise AssertionError(f"[32] split GroupNorm backward {where}: {what} max err "
                                 f"{float((got - want).abs().max()):.3g} beyond atol "
                                 f"{sum_atol:.3g} rtol {GN_BWD_SUM_TOL[1]}")
    return {"y_err": float((y.float() - y_ref).abs().max()),
            "dx_err": float((dx.float() - dx_ref).abs().max()),
            "pieces": pieces, "g_pieces": g_pieces, "fwd": fwd, "sums": sums, "msums": msums,
            "count": count}


def split_whole_check(x, scale, bias, g, groups: int, silu: bool, where: str) -> None:
    """M = 1: the split pair on the whole image against kernel 2 and 2b whole
    (group_norm_silu_forward / _backward) under GN_TOL, GN_BWD_TOL and
    GN_BWD_SUM_TOL of x's dtype; the statistics in fp32."""
    import torch

    from masked_diffusion_tpu_torch.ops import groupnorm as gn

    name = str(x.dtype).split(".")[1]
    b, c, h, w = x.shape
    count = float((c // groups) * h * w)
    y, mean, rstd = gn.group_norm_apply(x, scale, bias, gn.group_norm_sums(x, groups), count,
                                        groups, 1e-5, silu)
    y_w, mean_w, rstd_w = gn.group_norm_silu_forward(x, scale, bias, groups, 1e-5, silu)
    sums, dscale, dbias = gn.group_norm_backward_sums(x, scale, bias, g, mean_w, rstd_w, groups,
                                                      silu)
    dx = gn.group_norm_backward_apply(x, scale, bias, g, mean_w, rstd_w, sums, count, groups,
                                      silu)
    whole = gn.group_norm_silu_backward(x, scale, bias, g, mean_w, rstd_w, groups, silu)
    sum_atol = GN_BWD_SUM_TOL[0] * b * h * w
    for what, got, want, (atol, rtol) in (
            ("y", y, y_w, GN_TOL[name]), ("mean", mean, mean_w, GN_TOL["float32"]),
            ("rstd", rstd, rstd_w, GN_TOL["float32"]), ("dx", dx, whole[0], GN_BWD_TOL[name]),
            ("dscale", dscale, whole[1], (sum_atol, GN_BWD_SUM_TOL[1])),
            ("dbias", dbias, whole[2], (sum_atol, GN_BWD_SUM_TOL[1]))):
        diff = (got.float() - want.float()).abs()
        if got.dtype != want.dtype or not bool((diff <= atol + rtol * want.float().abs()).all()):
            raise AssertionError(f"[32] split GroupNorm at M = 1 {where}: {what} vs the whole "
                                 f"kernel, max err {float(diff.max()):.3g} beyond atol {atol} "
                                 f"rtol {rtol}")


def phase_split_groupnorm(smi: str) -> dict:
    """[32] Kernels 2 and 2b in their split modes (ops/groupnorm.py:
    group_norm_split and _backward, as parallel/sp.py runs them), at every
    local shape of the flagship's split norms at M = 2 and M = 4 (batch
    GRID_BATCH) and of unet6's at 256x256 at M = 2 (GRID_UNET6_BATCH), fp32,
    bf16 and fp16, SiLU as the norm has it: split_check, and at M = 1 on the
    flagship's whole shapes split_whole_check. Then each pass's device ms at
    the flagship's M = 2 shapes in bf16 (one rank's rows; the all-reduce not
    included) beside its byte bound and the plain pair's ms. Returns the
    forward and backward pairs' (max fp32 err, kernel ms, plain ms, bound)
    per rank per forward (backward) at M = 2."""
    import torch

    from masked_diffusion_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)
    cases = (("flagship", 2, GRID_BATCH, split_norm_shapes(2)),
             ("flagship", 4, GRID_BATCH, split_norm_shapes(4)),
             ("unet6 256x256", 2, GRID_UNET6_BATCH, split_norm_shapes(2, "unet6", 256)))
    if sum(cases[0][3].values()) != SP_SPLIT_NORMS:
        raise AssertionError(f"[32] the flagship splits {sum(cases[0][3].values())} norms a "
                             f"forward at M = 2, not {SP_SPLIT_NORMS}")
    worst = {"y": 0.0, "dx": 0.0}
    timed = dict(fwd=0.0, bwd=0.0, fwd_plain=0.0, bwd_plain=0.0, fwd_bound=0.0, bwd_bound=0.0)
    for label, m, batch, shapes in cases:
        for ((c, hl, w), groups, silu), per_forward in sorted(shapes.items()):
            x, scale, bias = _gn_inputs(gen, batch, c, hl * m, w)
            g = torch.randn(x.shape, generator=gen, device=dev)
            line = []
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                name = str(dtype).split(".")[1]
                xd, gd = x.to(dtype), g.to(dtype)
                where = f"{label} M={m} {name} {(batch, c, hl, w)} G={groups} silu={silu}"
                got = split_check(xd, scale, bias, gd, groups, silu, m, where)
                if dtype == torch.float32:
                    worst["y"] = max(worst["y"], got["y_err"])
                    worst["dx"] = max(worst["dx"], got["dx_err"])
                if label == "flagship" and m == 2:
                    split_whole_check(xd, scale, bias, gd, groups, silu, where)
                if label != "flagship" or m != 2 or dtype != torch.bfloat16:
                    continue
                p, gp, (_, mean, rstd) = got["pieces"][0], got["g_pieces"][0], got["fwd"][0]
                sums, msums, count = got["sums"], got["msums"], got["count"]
                ms = {
                    "fwd sums": cuda_ms(lambda: gn.group_norm_sums(p, groups))[0],
                    "fwd apply": cuda_ms(lambda: gn.group_norm_apply(
                        p, scale, bias, sums, count, groups, 1e-5, silu))[0],
                    "bwd sums": cuda_ms(lambda: gn.group_norm_backward_sums(
                        p, scale, bias, gp, mean, rstd, groups, silu))[0],
                    "bwd apply": cuda_ms(lambda: gn.group_norm_backward_apply(
                        p, scale, bias, gp, mean, rstd, msums, count, groups, silu))[0]}
                plain_fwd = cuda_ms(lambda: gn.group_norm_apply_plain(
                    p, scale, bias, gn.group_norm_sums_plain(p, groups), count, groups, 1e-5,
                    silu))[0]
                plain_bwd = cuda_ms(lambda: gn.group_norm_backward_apply_plain(
                    p, scale, bias, gp, mean, rstd, gn.group_norm_backward_sums_plain(
                        p, scale, bias, gp, mean, rstd, groups, silu)[0], count, groups,
                    silu))[0]
                n, bg, pc = p.numel(), batch * groups, 2 * 4 * c
                # each pass's bytes, every input read once and every output written once
                # (bf16 x, g, y, dx; fp32 sums and statistics, 8 bytes a span; scale and
                # bias or dscale and dbias; the backward's (2, B, C) parts), and its fp32
                # operations
                bounds = {"fwd sums": bound(2 * n + 8 * bg, 3 * n),
                          "fwd apply": bound(2 * 2 * n + 2 * 8 * bg + pc, 12 * n),
                          "bwd sums": bound(2 * 2 * n + 2 * 8 * bg + 2 * pc + 8 * batch * c,
                                            25 * n),
                          "bwd apply": bound(3 * 2 * n + 2 * 8 * bg + pc, 20 * n)}
                timed["fwd"] += per_forward * (ms["fwd sums"] + ms["fwd apply"])
                timed["bwd"] += per_forward * (ms["bwd sums"] + ms["bwd apply"])
                timed["fwd_plain"] += per_forward * plain_fwd
                timed["bwd_plain"] += per_forward * plain_bwd
                timed["fwd_bound"] += per_forward * (bounds["fwd sums"][0]
                                                     + bounds["fwd apply"][0])
                timed["bwd_bound"] += per_forward * (bounds["bwd sums"][0]
                                                     + bounds["bwd apply"][0])
                line = [f"{k} {v:.4f} ms (bound {bounds[k][0]:.5f}, {bounds[k][1]})"
                        for k, v in ms.items()]
                line.append(f"plain pair forward {plain_fwd:.4f}, backward {plain_bwd:.4f} ms")
            log(f"[32] split GN {label} M={m} {(batch, c, hl, w)} G={groups} silu={int(silu)} "
                f"(x{per_forward} a forward): fp32, bf16, fp16 within tolerance"
                + (", M = 1 against the whole kernels too" if label == "flagship" and m == 2
                   else "") + ("; bf16 rank 0: " + "; ".join(line) if line else ""))
        log(f"[32] {label} at M = {m}: {sum(shapes.values())} split norms a forward, "
            f"{len(shapes)} local shapes")
    log(f"[32] group_norm_split (kernels 2/2b split modes): every shape within tolerance; max "
        f"fp32 err y {worst['y']:.3g}, dx {worst['dx']:.3g}; device time a rank per bf16 "
        f"forward of the flagship at M = 2, batch {GRID_BATCH} ({SP_SPLIT_NORMS} split norms, "
        f"the all-reduces not included; {smi}): forward pairs {timed['fwd']:.4f} ms, plain "
        f"{timed['fwd_plain']:.4f}, bound {timed['fwd_bound']:.5f} (bytes: 2 reads of x, 1 "
        f"write of y); backward pairs {timed['bwd']:.4f} ms, plain {timed['bwd_plain']:.4f}, "
        f"bound {timed['bwd_bound']:.5f} (2 reads of x and g, 1 write of dx, fp32 parts); no "
        f"library call takes outside statistics (F.group_norm reduces its own)")
    return {"forward": (worst["y"], timed["fwd"], timed["fwd_plain"],
                        (timed["fwd_bound"], "bytes")),
            "backward": (worst["dx"], timed["bwd"], timed["bwd_plain"],
                         (timed["bwd_bound"], "bytes"))}


def _flagship_weights(seed: int, num_attention: int = 1):
    import torch

    from masked_diffusion_tpu_torch.models.factory import build_unet

    torch.manual_seed(seed)
    model = build_unet(num_attention=num_attention)
    model.conv_out.reset_parameters()  # random, not zero: the output must depend on it
    return model


def phase_slice(tag: str = "[4]", num_attention: int = 1,
                modes=(("linear", "thresholding", 10, 5), ("log", "indexing", 10, 5))):
    """The sampler with every kernel on CUDA vs the plain versions on the
    CPU: same weights and draws, fp32 with TF32 off. modes: (schedule,
    selection, T, reverse steps run, the last of the used timesteps)."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.cli.main_train_masked import parse
    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.ops.shift import draw_shapes
    from masked_diffusion_tpu_torch.ops.tinyhead_attention import tinyhead_attention
    from masked_diffusion_tpu_torch.sample.latent import latent_initial
    from masked_diffusion_tpu_torch.sample.loop import StepDraws, make_sample_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = 2
    ref_model = _flagship_weights(1, num_attention)
    for sched, select, t_steps, steps in modes:
        cfg, _ = parse([
            "--method", "sample", "--data_size", str(SIZE), "--ddpm_schedule", sched,
            "--ddpm_num_steps", str(t_steps), "--select_degrade_pixel", select,
            "--degrade_channel", "1-channel", "--mean_option", "degraded_area",
            "--mean_area", "image-wise", "--shift_type", "1-d_constant",
            "--momentum_adaptive", "base_momentum", "--sampling_mask_dependency",
            "independent", "--mixed_precision", "no", "--sample_latent_shape", "uniform",
        ])
        schedule = build_schedule(sched, t_steps, SIZE, select)
        used = schedule.timesteps_for_epoch(1, 10, 1)[-steps:]
        rng = np.random.default_rng(2)
        u_shape, _ = draw_shapes(cfg.shift_type, (batch, 3, SIZE, SIZE))
        cpu_draws = [
            StepDraws(
                bits=torch.from_numpy(rng.integers(0, 2**32, size=(2, batch, SIZE * SIZE),
                                                   dtype=np.uint64).astype(np.int64)),
                uniform=torch.from_numpy(rng.uniform(-1, 1, size=u_shape).astype(np.float32)),
            )
            for _ in used
        ]
        cuda_draws = [StepDraws(bits=d.bits.cuda(), uniform=d.uniform.cuda()) for d in cpu_draws]
        latent = latent_initial(torch.Generator().manual_seed(3), batch, 3, SIZE, "uniform",
                                device="cpu")
        outs = {}
        for dev, draws in (("cuda", cuda_draws), ("cpu", cpu_draws)):
            model = build_unet(num_attention=num_attention)
            model.load_state_dict(ref_model.state_dict())
            fn = make_sample_fn(model, schedule, cfg, used, device=dev)
            lat = latent.to(dev)
            launched = tinyhead_attention.launches
            t0 = time.perf_counter()
            if dev == "cuda":
                # the loop must not make the host wait on the card: any
                # synchronising call inside it raises in this mode
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(lat, draws=lambda i, d=draws: d[i])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            outs[dev] = out.cpu()
            launched = tinyhead_attention.launches - launched
            want = len(used) * tinyhead_per_forward(model.config) if dev == "cuda" else 0
            if launched != want:
                raise AssertionError(f"slice {sched} on {dev}: {launched} tinyhead launches, "
                                     f"expected {want}")
            log(f"{tag} {sched}+{select} on {dev}: {len(used)} steps in "
                f"{time.perf_counter() - t0:.2f} s"
                + (f" with no host sync inside the loop, {launched} tinyhead launches"
                   if dev == "cuda" else ""))
        a, r = outs["cuda"], outs["cpu"]
        if not (torch.isfinite(a).all() and a.shape == (batch, SIZE, SIZE, 3)):
            raise AssertionError(f"slice {sched}: non-finite or misshapen output {tuple(a.shape)}")
        err = (a - r).abs().max().item()
        if not torch.allclose(a, r, atol=SLICE_TOL, rtol=SLICE_TOL):
            raise AssertionError(f"slice {sched}+{select}: CUDA vs CPU max err {err}")
        log(f"{tag} slice parity num_attention={num_attention} {sched}+{select}: CUDA kernels "
            f"vs CPU plain, max |diff| {err:.3g} (atol = rtol = {SLICE_TOL}); output std "
            f"{r.std().item():.4f}")
    torch.backends.cudnn.allow_tf32 = True


def serve_argv(ckpt: str, sched: str, select: str, steps: int, dir_work: str):
    """Phase 5's request: --method sample of ckpt, two requests (batches) of
    16 images at 64x64 in bf16, the fused branch."""
    return [
        "--method", "sample", "--test_model_path", ckpt, "--data_name", "synthetic",
        "--data_size", str(SIZE), "--data_subset", "True", "--data_subset_num", "256",
        "--batch_size", "16", "--sample_num", "32", "--mixed_precision", "bf16",
        "--ddpm_schedule", sched, "--ddpm_num_steps", str(steps),
        "--select_degrade_pixel", select, "--degrade_channel", "1-channel",
        "--mean_option", "degraded_area", "--mean_area", "image-wise",
        "--shift_type", "1-d_constant", "--momentum_adaptive", "base_momentum",
        "--sampling_mask_dependency", "independent", "--use_wandb", "False",
        "--dir_work", dir_work, "--device", "cuda",
    ]


def phase_serve(workdir: str):
    import torch

    from masked_diffusion_tpu_torch.cli.main_train_masked import main
    from masked_diffusion_tpu_torch.io.weights import diffusers_config_from_unet, save_checkpoint

    model = _flagship_weights(4)
    ckpt = save_checkpoint(os.path.join(workdir, "checkpoint-epoch-0"),
                           model.state_dict(), diffusers_config_from_unet(model.config))
    del model
    launches = {}
    runs = []
    for sched, select, steps in (("linear", "thresholding", 50), ("log", "indexing", 100)):
        argv = serve_argv(ckpt, sched, select, steps, os.path.join(workdir, sched))
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        counts = read_counts()
        n_fused, n_gn = counts["fused_degrade_update"], counts["group_norm_silu"]
        sys.stdout.write(buf.getvalue())
        stats = json.loads(
            next(ln for ln in buf.getvalue().splitlines() if ln.startswith("sample_stats "))
            .split(" ", 1)[1]
        )
        pngs = sorted(f for f in os.listdir(stats["out_dir"]) if f.endswith(".png"))
        if rc != 0 or not stats["finite"] or stats["images"] != 32:
            raise AssertionError(f"serve {sched}: rc {rc}, stats {stats}")
        if len(pngs) != 32 + stats["batches"]:
            raise AssertionError(f"serve {sched}: {len(pngs)} PNGs on disk")
        if stats["steps"] != steps:
            raise AssertionError(f"serve {sched}: {stats['steps']} steps, expected {steps}")
        if n_fused != stats["steps"] * stats["batches"] or n_gn <= 0:
            raise AssertionError(f"serve {sched}: launches fused {n_fused}, "
                                 f"groupnorm {n_gn}, steps x batches "
                                 f"{stats['steps'] * stats['batches']}")
        if (counts["group_norm_silu_backward"] or counts["exact_count_masks"]
                or counts["tinyhead_attention_backward"] or not same_through_sharded(counts)):
            raise AssertionError(f"serve {sched}: training kernels launched, or the fused "
                                 f"kernel not through its sharded form: {counts}")
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        runs.append(stats)
        log(f"[5] serve {sched}+{select}: {stats['images']} images, {stats['steps']} steps x "
            f"{stats['batches']} batches, {stats['images_per_sec']:.3f} images/s, "
            f"{stats['ms_per_step']:.3f} ms/step on {stats['device']}; launches: fused "
            f"{n_fused}, groupnorm {n_gn}; {len(pngs)} PNGs")
    return launches, runs


def _train_cfg(sched: str, select: str, steps: int, *extra):
    from masked_diffusion_tpu_torch.cli.main_train_masked import parse

    cfg, _ = parse([
        "--method", "mean_shift", "--data_size", str(SIZE), "--ddpm_schedule", sched,
        "--ddpm_num_steps", str(steps), "--select_degrade_pixel", select,
        "--degrade_channel", "1-channel", "--mean_option", "degraded_area",
        "--mean_area", "image-wise", "--shift_type", "1-d_constant", "--optim", "adamw",
        "--lr_scheduler", "cosine", "--lr", "1e-4", "--lr_warmup_steps", "0",
        "--use_ema", "True", *extra,
    ])
    return cfg


MODES = (("linear", "thresholding", 1000), ("log", "indexing", 4096))


def phase_train_parity():
    import warnings

    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from masked_diffusion_tpu_torch.train.step import (
        TrainDraws,
        create_train_state,
        make_train_step,
    )
    from masked_diffusion_tpu_torch.utils import host

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, steps, hw = 2, 2, SIZE * SIZE
    ref_model = _flagship_weights(8)
    init = {k: v.clone() for k, v in ref_model.state_dict().items()}
    for sched, select, t_steps in MODES:
        cfg = _train_cfg(sched, select, t_steps, "--mixed_precision", "no")
        schedule = build_schedule(sched, t_steps, SIZE, select)
        used = schedule.timesteps_for_epoch(0, 10, 1)
        rng = np.random.default_rng(9)
        data = [dict(
            img=torch.from_numpy(rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)),
            draws=TrainDraws(
                timeindex=torch.from_numpy(rng.integers(0, len(used), batch)),
                bits=torch.from_numpy(rng.integers(0, 2**32, (batch, hw), dtype=np.uint64)
                                      .astype(np.int64)),
                mask_uniform=torch.from_numpy(
                    rng.uniform(0, 1, (batch, 1, SIZE, SIZE)).astype(np.float32)),
                uniform=torch.from_numpy(rng.uniform(-1, 1, batch).astype(np.float32)),
            )) for _ in range(steps)]
        runs = {}
        for dev in ("cuda", "cpu"):
            model = build_unet()
            model.load_state_dict(ref_model.state_dict())
            model.to(dev)
            lr = build_lr_schedule("cosine", 1e-4, 0, 100)
            opt = build_optimizer("adamw", model.parameters(), lr, 1.0, 1)
            state = create_train_state(model, opt, use_ema=True)
            step = make_train_step(model, schedule, cfg, opt, used, lr, device=dev)
            on_dev = [(d["img"].to(dev), TrainDraws(**{
                k: None if v is None else v.to(dev) for k, v in vars(d["draws"]).items()}))
                for d in data]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the first step loads the kernels and builds the optimizer's
            # state; the later ones must not make the host wait
            # on the card
            losses = [step(state, *on_dev[0][:1], draws=on_dev[0][1])["train_loss"]]
            torch.cuda.synchronize()
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    for img, draws in on_dev[1:]:
                        losses.append(step(state, img, draws=draws)["train_loss"])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            synced = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
            if synced:
                raise AssertionError(f"train step on CUDA synchronised the host "
                                     f"{len(synced)} times: {synced[:2]}")
            runs[dev] = (torch.stack(losses).cpu(),
                         {k: v.detach().cpu() for k, v in model.state_dict().items()},
                         {k: v.detach().cpu() for k, v in state.ema_model.state_dict().items()})
            log(f"[8] {sched}+{select} on {dev}: {steps} steps in "
                f"{time.perf_counter() - t0:.2f} s"
                + (" with no host sync in step 2" if dev == "cuda" else ""))
        lc, lp = runs["cuda"][0], runs["cpu"][0]
        if not torch.isfinite(lc).all() or not torch.allclose(lc, lp, rtol=TRAIN_LOSS_RTOL,
                                                                atol=0):
            raise AssertionError(f"train parity {sched}: losses CUDA {lc} vs CPU {lp}")
        errs = []
        for which in (1, 2):
            diff2 = upd2 = 0.0
            for k, ref in runs["cpu"][which].items():
                diff2 += float((runs["cuda"][which][k] - ref).square().sum())
                upd2 += float((ref - init[k]).square().sum())
            errs.append((diff2 / upd2) ** 0.5)
        if not max(errs) <= TRAIN_UPDATE_RTOL:
            raise AssertionError(f"train parity {sched}: update norms differ by {errs}")
        log(f"[8] train parity {sched}+{select}: losses {[round(float(v), 6) for v in lp]} "
            f"max rel diff {float(((lc - lp) / lp).abs().max()):.3g} (rtol {TRAIN_LOSS_RTOL}); "
            f"update rel L2 diff params {errs[0]:.3g}, EMA {errs[1]:.3g} "
            f"(tol {TRAIN_UPDATE_RTOL})")
    torch.backends.cudnn.allow_tf32 = True


@contextlib.contextmanager
def plain_versions():
    """Route the UNet's GroupNorms and the indexing masks through their
    plain versions, on whatever device the tensors lie: for comparing a
    train step with and without the kernels, never on the main path."""
    import masked_diffusion_tpu_torch.models.unet as unet_mod
    import masked_diffusion_tpu_torch.ops.degrade as degrade_mod
    from masked_diffusion_tpu_torch.ops.groupnorm import group_norm_silu_plain
    from masked_diffusion_tpu_torch.ops.kmask import exact_count_masks_plain

    def masks(batch, height, width, counts, *, plan, generator=None, bits=None):
        return exact_count_masks_plain(bits, counts).reshape(-1, 1, height, width)

    saved = unet_mod.group_norm_silu, degrade_mod.exact_count_masks_sharded
    unet_mod.group_norm_silu, degrade_mod.exact_count_masks_sharded = group_norm_silu_plain, masks
    try:
        yield
    finally:
        unet_mod.group_norm_silu, degrade_mod.exact_count_masks_sharded = saved


def phase_train_bf16_parity():
    """One bf16 train step at the flagship shape (batch 64, AdamW + cosine,
    EMA on), through the kernels and through their plain versions on the
    card, from the same weights and the same injected draws: the loss, the
    clipped gradient and the parameter update, each to its tolerance. A
    first AdamW update is lr * g/|g| per coordinate, so bf16 noise flips
    the coordinates whose gradient lies near zero and the update's
    tolerance is the looser. The plain step in fp32 (TF32 off) is printed
    as the yardstick of bf16 rounding."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.models.unet import GroupNormAct
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from masked_diffusion_tpu_torch.train.step import (
        TrainDraws,
        create_train_state,
        make_train_step,
    )

    batch, hw = B_KERNEL, SIZE * SIZE
    ref_model = _flagship_weights(10)
    norms = sum(isinstance(m, GroupNormAct) for m in ref_model.modules())
    init = [p.detach().cuda() for p in ref_model.parameters()]
    for sched, select, t_steps in MODES:
        schedule = build_schedule(sched, t_steps, SIZE, select)
        used = schedule.timesteps_for_epoch(0, 10, 1)
        rng = np.random.default_rng(11)
        img = torch.from_numpy(rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)).cuda()
        draws = TrainDraws(
            timeindex=torch.from_numpy(rng.integers(0, len(used), batch)).cuda(),
            bits=torch.from_numpy(rng.integers(0, 2**32, (batch, hw), dtype=np.uint64)
                                  .astype(np.int64)).cuda(),
            mask_uniform=torch.from_numpy(
                rng.uniform(0, 1, (batch, 1, SIZE, SIZE)).astype(np.float32)).cuda(),
            uniform=torch.from_numpy(rng.uniform(-1, 1, batch).astype(np.float32)).cuda(),
        )
        runs = {}
        for route, precision in (("kernels", "bf16"), ("plain", "bf16"), ("plain", "no")):
            fp32 = precision == "no"
            torch.backends.cudnn.allow_tf32 = not fp32
            torch.backends.cuda.matmul.allow_tf32 = False
            cfg = _train_cfg(sched, select, t_steps, "--mixed_precision", precision)
            model = build_unet()
            model.load_state_dict(ref_model.state_dict())
            model.cuda()
            lr = build_lr_schedule("cosine", 1e-4, 0, 1000)
            opt = build_optimizer("adamw", model.parameters(), lr, 1.0, 1)
            state = create_train_state(model, opt, use_ema=True)
            step = make_train_step(model, schedule, cfg, opt, used, lr, device="cuda")
            reset_counts()
            with plain_versions() if route == "plain" else contextlib.nullcontext():
                loss = step(state, img, draws=draws)["train_loss"].item()
            counts = read_counts()
            want = dict.fromkeys(counts, 0)
            if route == "kernels":
                want.update(group_norm_silu=norms, group_norm_silu_backward=norms,
                            exact_count_masks=int(select == "indexing"),
                            exact_count_masks_sharded=int(select == "indexing"))
            if counts != want:
                raise AssertionError(f"bf16 parity {sched} {route}: launches {counts}, "
                                     f"expected {want}")
            runs[(route, precision)] = (
                loss, [p.grad.detach().float() for p in model.parameters()],
                [p.detach() - p0 for p, p0 in zip(model.parameters(), init)])
            del state, opt, step
        torch.backends.cudnn.allow_tf32 = True

        def rel_l2(a, b):
            num = sum(float((x - y).square().sum()) for x, y in zip(a, b))
            return (num / sum(float(y.square().sum()) for y in b)) ** 0.5

        k, p, f = runs[("kernels", "bf16")], runs[("plain", "bf16")], runs[("plain", "no")]
        loss_diff = abs(k[0] - p[0]) / abs(p[0])
        grad_diff, upd_diff = rel_l2(k[1], p[1]), rel_l2(k[2], p[2])
        yard = (abs(p[0] - f[0]) / abs(f[0]), rel_l2(p[1], f[1]), rel_l2(p[2], f[2]))
        log(f"[9] bf16 step parity {sched}+{select} batch {batch}: kernels vs plain on the "
            f"card, loss {k[0]:.6f} vs {p[0]:.6f} (rel diff {loss_diff:.3g}, tol "
            f"{BF16_LOSS_RTOL}), gradient rel L2 diff {grad_diff:.3g} (tol {BF16_GRAD_RTOL}), "
            f"update rel L2 diff {upd_diff:.3g} (tol {BF16_UPDATE_RTOL}); yardstick plain "
            f"bf16 vs plain fp32: loss {yard[0]:.3g}, gradient {yard[1]:.3g}, update "
            f"{yard[2]:.3g}")
        if not (np.isfinite(k[0]) and loss_diff <= BF16_LOSS_RTOL
                and grad_diff <= BF16_GRAD_RTOL and upd_diff <= BF16_UPDATE_RTOL):
            raise AssertionError(f"bf16 parity {sched}+{select}: loss rel diff {loss_diff}, "
                                 f"gradient rel L2 diff {grad_diff}, update {upd_diff}")
        del runs


def phase_train_throughput(smi: str):
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.models.unet import GroupNormAct
    from masked_diffusion_tpu_torch.ops.groupnorm import group_norm_silu_backward
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from masked_diffusion_tpu_torch.train.step import create_train_state, make_train_step

    batch = B_KERNEL
    out = {}
    for sched, select, t_steps in MODES:
        cfg = _train_cfg(sched, select, t_steps, "--mixed_precision", "bf16")
        schedule = build_schedule(sched, t_steps, SIZE, select)
        used = schedule.timesteps_for_epoch(0, 10, 1)
        torch.cuda.reset_peak_memory_stats()
        torch.manual_seed(0)
        model = build_unet().cuda()
        norms = sum(isinstance(m, GroupNormAct) for m in model.modules())
        lr = build_lr_schedule("cosine", 1e-4, 0, 1000)  # bench.py:381-382
        opt = build_optimizer("adamw", model.parameters(), lr, 1.0, 1)
        state = create_train_state(model, opt, use_ema=True)
        step = make_train_step(model, schedule, cfg, opt, used, lr, device="cuda")
        rng = np.random.default_rng(0)
        data = torch.from_numpy(rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)).cuda()
        gen = torch.Generator().manual_seed(1)
        for _ in range(3):
            step(state, data, gen)
        torch.cuda.synchronize()
        reset_counts()
        strided_before = group_norm_silu_backward.strided
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS_TIMED):
            metrics = step(state, data, gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        strided = group_norm_silu_backward.strided - strided_before
        per = {k: v / TRAIN_STEPS_TIMED for k, v in counts.items()}
        want = dict.fromkeys(per, 0)
        want.update(exact_count_masks=int(select == "indexing"), group_norm_silu=norms,
                    group_norm_silu_backward=norms,
                    exact_count_masks_sharded=int(select == "indexing"))
        if per != want:
            raise AssertionError(f"train {sched}: launches per step {per}, expected {want}")
        if not bool(torch.isfinite(metrics["train_loss"])):
            raise AssertionError(f"train {sched}: non-finite loss")
        ms = 1e3 * seconds / TRAIN_STEPS_TIMED
        out[select] = (ms, batch * TRAIN_STEPS_TIMED / seconds)
        log(f"[9] train {sched}+{select} bf16 batch {batch} at {SIZE}x{SIZE} ({smi}): "
            f"{ms:.3f} ms/step, {out[select][1]:.2f} images/s over {TRAIN_STEPS_TIMED} steps "
            f"after 3 warm-up; launches per step {per}; GroupNorm backward calls per step "
            f"with a strided incoming gradient, taken by the kernel's strides (no copy): "
            f"{strided / TRAIN_STEPS_TIMED:g}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, state, opt, step
        torch.cuda.empty_cache()
    return out


def flagship_cli_args(workdir: str):
    """(training argv, flags shared with serving) of the flagship through the
    CLI: batch 64, bf16, log + indexing at T=200, 2 epochs of 4 steps."""
    common = [
        "--data_name", "synthetic", "--data_size", str(SIZE), "--data_subset", "True",
        "--data_subset_num", "256", "--batch_size", "64", "--sample_num", "16",
        "--mixed_precision", "bf16", "--ddpm_schedule", "log", "--ddpm_num_steps", "200",
        "--select_degrade_pixel", "indexing", "--degrade_channel", "1-channel",
        "--mean_option", "degraded_area", "--mean_area", "image-wise",
        "--shift_type", "1-d_constant", "--momentum_adaptive", "base_momentum",
        "--sampling_mask_dependency", "independent", "--use_wandb", "False",
        "--device", "cuda",
    ]
    argv = ["--method", "mean_shift", "--num_epochs", "2", "--save_images_epochs", "2",
            "--sampling", "momentum", "--optim", "adamw", "--lr", "1e-4",
            "--lr_scheduler", "cosine", "--lr_warmup_steps", "0",
            "--dir_work", os.path.join(workdir, "train"), *common]
    return argv, common


def phase_train_cli(workdir: str):
    import numpy as np

    from masked_diffusion_tpu_torch.cli.main_train_masked import main

    argv, common = flagship_cli_args(workdir)
    buf = io.StringIO()
    cadence = {}
    reset_counts()
    with contextlib.redirect_stdout(buf), _timed_cadence(cadence):
        rc = main(argv)
    train_counts = read_counts()
    sys.stdout.write(buf.getvalue())
    line = next(ln for ln in buf.getvalue().splitlines() if ln.startswith("train_stats "))
    stats = json.loads(line.split(" ", 1)[1])
    if rc != 0 or stats["epochs"] != 2 or stats["global_step"] != 8:
        raise AssertionError(f"train CLI: rc {rc}, stats {stats}")
    (ckpt,) = stats["checkpoints"]
    run = os.path.dirname(os.path.dirname(ckpt))
    with open(os.path.join(run, "log", "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    if [r["epoch"] for r in rows] != [0, 1] or not all(np.isfinite(r["train_loss"]) for r in rows):
        raise AssertionError(f"train CLI: metrics.jsonl {rows}")
    for sub in ("unet", "unet_ema"):
        for name in ("config.json", "diffusion_pytorch_model.safetensors"):
            if not os.path.exists(os.path.join(ckpt, sub, name)):
                raise AssertionError(f"train CLI: {ckpt}/{sub}/{name} missing")
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    grids = os.listdir(os.path.join(run, "train", "image", "ema_sample_img"))
    if meta["global_step"] != 8 or "ema_sample_00001_global.png" not in grids:
        raise AssertionError(f"train CLI: meta {meta}, grids {grids}")
    # one process reaches the kernels through their sharded forms on one rank;
    # one exact-k launch a train step and one for the cadence's visuals pass
    off = ("tinyhead_attention", "tinyhead_attention_backward", *SPLIT_ONLY, *FP32_ONLY)
    if (train_counts["exact_count_masks"] != 8 + 1 or any(train_counts[k] for k in off)
            or not all(n for k, n in train_counts.items() if k not in off)
            or not same_through_sharded(train_counts)):
        raise AssertionError(f"train CLI: launches {train_counts}")
    log(f"[10] train CLI mean_shift log+indexing: 2 epochs x 4 steps, losses "
        f"{[round(v, 5) for v in stats['loss_mean_epoch']]}, {stats['ms_per_step']:.3f} "
        f"ms/step and {stats['images_per_sec']:.2f} images/s (epoch 1) on {stats['device']}; "
        f"checkpoint {os.path.basename(ckpt)} with unet/, unet_ema/, meta.json; EMA grids "
        f"{sorted(grids)}; launches {train_counts}; the fused cadence: {cadence['steps']} "
        f"reverse steps of 16 images in {cadence['seconds']:.2f} s, "
        f"{1e3 * cadence['seconds'] / cadence['steps']:.3f} ms a reverse step")

    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = main(["--method", "sample", "--test_model_path", ckpt,
                   "--dir_work", os.path.join(workdir, "serve"), *common])
    serve_counts = read_counts()
    sys.stdout.write(buf.getvalue())
    line = next(ln for ln in buf.getvalue().splitlines() if ln.startswith("sample_stats "))
    served = json.loads(line.split(" ", 1)[1])
    if rc != 0 or not (served["finite"] and served["ema"] and served["images"] == 16):
        raise AssertionError(f"serve the trained checkpoint: rc {rc}, {served}")
    if not (serve_counts["fused_degrade_update"] and serve_counts["group_norm_silu"]) or (
            not same_through_sharded(serve_counts)):
        raise AssertionError(f"serve the trained checkpoint: launches {serve_counts}")
    log(f"[10] served the trained checkpoint (EMA weights): {served['images']} images, "
        f"{served['steps']} steps, {served['ms_per_step']:.3f} ms/step; launches {serve_counts}")
    perf = {"train_ms": stats["ms_per_step"], "train_ips": stats["images_per_sec"],
            "serve_ms": served["ms_per_step"], "serve_ips": served["images_per_sec"],
            "cadence_ms": 1e3 * cadence["seconds"] / cadence["steps"]}
    return {k: train_counts[k] + serve_counts[k] for k in train_counts}, perf


def tinyhead_out_mag(q, k, v, scale):
    """P|V| per output element: the sum of the magnitudes of the terms of
    out = P V, P the fp32 softmax."""
    import torch

    p = torch.softmax(torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float().abs())


def tinyhead_grad_mags(q, k, v, g, scale):
    """(M_dq, M_dk, M_dv): per gradient element, the sum of the magnitudes
    of the terms that make it, P the fp32 softmax: dS is bounded by
    P (|dO| |V|^T + Dmag) with Dmag = |dO| . P|V| >= |D|, then M_dv = P^T
    |dO|, M_dq = scale dS_mag |K|, M_dk = scale dS_mag^T |Q|."""
    import torch

    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale, dim=-1)
    m_dv = torch.einsum("bhst,bhsd->bhtd", p, gf.abs())
    dmag = (gf.abs() * torch.einsum("bhst,bhtd->bhsd", p, vf.abs())).sum(-1, keepdim=True)
    ds = torch.einsum("bhsd,bhtd->bhst", gf.abs(), vf.abs()).add_(dmag).mul_(p)
    del p
    m_dq = torch.einsum("bhst,bhtd->bhsd", ds, kf.abs()) * scale
    m_dk = torch.einsum("bhst,bhsd->bhtd", ds, qf.abs()) * scale
    return m_dq, m_dk, m_dv


def _graph_grad_ms(forward, leaves, g, reps, iters):
    """Device ms of forward(*leaves) and of torch.autograd.grad through it,
    each captured in a CUDA graph (the forward inside, so that its backward
    runs on the capture stream): (forward ms, forward + backward ms)."""
    import torch

    fwd, _ = cuda_ms(lambda: forward(*leaves), reps, iters)
    both, _ = cuda_ms(lambda: torch.autograd.grad(forward(*leaves), leaves, g), reps, iters)
    return fwd, both


def phase_tinyhead():
    """The tiny-head attention kernels, forward and backward, against their
    plain versions at the main paths' shapes and at ragged ones, fp32 (TF32
    off; the kernels' split TF32 held to the fp32 limits) and bf16; the
    backward bitwise equal over two runs, and in bf16 without bias; the
    backward in both dtypes on plans other than its own (passes, slices,
    warps past S) and refusing plans it does not take; their times beside
    the plain versions', SDPA's and the bounds (fp32: both product routes,
    the bound the least), with the backward's plan; the backward's peak
    extra memory at every main shape in both dtypes; the autograd Function
    against autograd through the plain version. Returns ({dtype: max err of
    the forward}, {dtype: max err of the backward}, {(shape, dtype): forward
    (ms, plain ms, SDPA ms, terms)}, {(shape, dtype): backward (ms, plain
    ms, SDPA ms, terms, recompute ms)}, {(shape, dtype): (peak extra bytes
    of the backward, inputs' bytes)})."""
    import math

    import torch
    import torch.nn.functional as F

    from masked_diffusion_tpu_torch.ops.tinyhead_attention import (
        BWD_MEMORY_SHARE,
        BWD_WARP_KEYS,
        TinyheadBwdPlan,
        launch_backward,
        tinyhead_attention,
        tinyhead_attention_backward,
        tinyhead_attention_plain,
        tinyhead_backward_plain,
        tinyhead_bwd_plan,
        tinyhead_forward,
        tinyhead_forward_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def plan_text(plan):
        return (f"plan {plan.keys} keys a CTA, {plan.slices} slices, {plan.warps} warps, "
                f"workspace {plan.workspace / 2**20:.2f} MiB")
    gen = torch.Generator(device=dev).manual_seed(12)
    worst = {}
    fwd_times, bwd_times = {}, {}

    def check(got, ref, limit, what):
        """got within limit of ref element-wise; limit a tensor or (atol,
        rtol). Returns the max abs error; keeps the worst ratio per `what`."""
        diff = (got.float() - ref.float()).abs()
        if isinstance(limit, tuple):
            limit = limit[0] + limit[1] * ref.float().abs()
        ratio = (diff / limit).max().item()
        if got.shape != ref.shape or not ratio <= 1.0:
            raise AssertionError(f"tinyhead {what}: max err {diff.max().item()}, "
                                 f"{ratio:.3g} times its limit")
        err = diff.max().item()
        w = worst.setdefault(what.split(" (")[0], [0.0, 0.0])
        w[0], w[1] = max(w[0], err), max(w[1], ratio)
        return err, ratio

    def bf16_limit(mag, ref, eta=BF16_U, rho=BF16_U):
        return TH_ATOL + (eta + TH_ETA) * mag + rho * ref.float().abs()

    def bias(got, ref):
        ref = ref.float()
        return ((got.float() - ref) * ref.sign()).sum().item() / ref.abs().sum().item()

    for shape in TINYHEAD_SHAPES + TINYHEAD_RAGGED:
        b, h, s, d = shape
        scale = 1.0 / math.sqrt(d)
        main = shape in TINYHEAD_SHAPES
        qkvg = [torch.randn(shape, generator=gen, device=dev) for _ in range(4)]
        line = []
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            bf16 = dtype == torch.bfloat16
            q, k, v, g = (t.to(dtype) for t in qkvg)
            wide = [t.float() for t in (q, k, v, g)]
            with torch.inference_mode():
                # forward, as serving runs it (no lse), then with lse
                out = tinyhead_attention(q, k, v, scale)
                out2, lse = tinyhead_forward(q, k, v, scale)
                ref, ref_lse = tinyhead_forward_plain(*wide[:3], scale)
                torch.cuda.synchronize()
                if out.dtype != dtype or not torch.equal(out, out2):
                    raise AssertionError(f"tinyhead {shape} {name}: output dtype {out.dtype}, "
                                         f"equal with lse {torch.equal(out, out2)}")
                limit = (bf16_limit(tinyhead_out_mag(*wide[:3], scale), ref) if bf16
                         else TINYHEAD_FP32_TOL)
                err, ratio = check(out, ref, limit, f"out {name} ({shape})")
                beta = bias(out, ref)
                bias_limit = TH_BIAS if bf16 else TH_BIAS_FP32
                if not abs(beta) <= bias_limit:
                    raise AssertionError(f"tinyhead {shape} {name}: signed mean error {beta:.3g} "
                                         f"of mean |ref|, limit {bias_limit:.3g}")
                lse_err, _ = check(lse, ref_lse, TH_LSE_TOL, f"lse {name} ({shape})")
                # backward kernel vs the plain backward in fp32 on the same
                # inputs, out and lse
                grads = tinyhead_attention_backward(q, k, v, out2, lse, g, scale)
                again = tinyhead_attention_backward(q, k, v, out2, lse, g, scale)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                    raise AssertionError(f"tinyhead backward {shape} {name}: two runs differ")
                plain = tinyhead_backward_plain(*wide[:3], out2.float(), lse, wide[3], scale)
                mags = tinyhead_grad_mags(*wide, scale)
                bwd, bwd_bias = [], []
                for x, a, w, mag in zip("qkv", grads, plain, mags):
                    lim = (bf16_limit(mag, w) if bf16
                           else TINYHEAD_FP32_TOL[0] + TINYHEAD_FP32_TOL[1] * mag)
                    if a.dtype != dtype:
                        raise AssertionError(f"tinyhead d{x} {shape}: dtype {a.dtype}")
                    bwd.append(check(a, w, lim, f"d{x} {name} vs plain ({shape})"))
                    bwd_bias.append(bias(a, w))
                if not max(abs(x) for x in bwd_bias) <= bias_limit:
                    raise AssertionError(
                        f"tinyhead backward {shape} {name}: signed mean errors of dq/dk/dv "
                        f"{'/'.join(f'{x:.3g}' for x in bwd_bias)} of mean |ref|, limit "
                        f"{bias_limit:.3g}")
                del grads, again, plain
            # the autograd Function vs autograd through the plain version
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            before = (tinyhead_attention.launches, tinyhead_attention_backward.launches)
            got = torch.autograd.grad(tinyhead_attention(*leaves, scale), leaves, g)
            launched = (tinyhead_attention.launches - before[0],
                        tinyhead_attention_backward.launches - before[1])
            if launched != (1, 1):
                raise AssertionError(f"tinyhead {shape} {name} with grad: launches (forward, "
                                     f"backward) {launched}, expected (1, 1)")
            refs = [t.clone().requires_grad_(True) for t in (q, k, v)]
            want = torch.autograd.grad(tinyhead_attention_plain(*refs, scale), refs, g)
            ag = []
            for x, a, w, mag in zip("qkv", got, want, mags):
                lim = (bf16_limit(mag, w, *TH_AUTOGRAD_BF16) if bf16
                       else TINYHEAD_FP32_TOL[0] + TINYHEAD_FP32_TOL[1] * mag)
                ag.append(check(a, w, lim, f"d{x} {name} vs autograd ({shape})"))
            del got, want, leaves, refs, mags
            summary = (f"{name}: out err {err:.3g} ({ratio:.3g} of limit, bias {beta:.3g}), "
                       f"lse err {lse_err:.3g}; "
                       f"dq/dk/dv err vs plain {'/'.join(f'{e:.3g}' for e, _ in bwd)} "
                       f"({max(r for _, r in bwd):.3g} of limit, bias "
                       f"{'/'.join(f'{x:.3g}' for x in bwd_bias)}"
                       + "; bitwise over two runs), vs autograd "
                       f"{'/'.join(f'{e:.3g}' for e, _ in ag)} ({max(r for _, r in ag):.3g})")
            if not main:
                line.append(summary)
                continue
            # times: CUDA-graph device ms, the kernels 20 calls a graph
            # replayed 10 times; above 2^28 scores the rest 3 and 3 (the
            # S=4096 plain versions hold 4 GiB per (S, S) tensor)
            reps, iters = (3, 3) if b * h * s * s > 2**28 else (20, 10)
            with torch.inference_mode():
                kms, _ = cuda_ms(lambda: tinyhead_attention(q, k, v, scale), 20, 10)
                pms, _ = cuda_ms(lambda: tinyhead_attention_plain(q, k, v, scale), reps, iters)
                lms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                                 reps, iters)
                bkms, _ = cuda_ms(lambda: tinyhead_attention_backward(q, k, v, out2, lse, g,
                                                                      scale), 20, 10)
                bpms, _ = cuda_ms(lambda: tinyhead_backward_plain(q, k, v, out2, lse, g, scale),
                                  reps, iters)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            # the recompute through the plain version under autograd (as the JAX _bwd)
            rec_f, rec_fb = _graph_grad_ms(lambda *a: tinyhead_attention_plain(*a, scale),
                                           leaves, g, reps, iters)
            sdpa_f, sdpa_fb = _graph_grad_ms(
                lambda *a: F.scaled_dot_product_attention(*a, scale=scale), leaves, g, reps,
                iters)
            del leaves
            terms = attention_terms(b, h, s, d, bf16)
            bterms = attention_bwd_terms(b, h, s, d, bf16)
            bnd, bbnd = terms_bound(terms), terms_bound(bterms)
            fwd_times[(shape, name)] = (kms, pms, lms, terms)
            bwd_times[(shape, name)] = (bkms, bpms, sdpa_fb - sdpa_f, bterms, rec_fb)
            line.append(
                f"{summary}; forward kernel {kms:.4f} ms, plain {pms:.4f}, SDPA {lms:.4f}, "
                f"bound {bnd[0]:.5f} ({bnd[2]}, {bnd[0] / kms:.1%} of it; " + ", ".join(
                    f"{t} {v:.5f}" for t, v in terms.items()) + f"); backward kernel "
                f"{bkms:.4f} ms, plain {bpms:.4f}, recompute {rec_fb:.4f} (its forward "
                f"{rec_f:.4f}), SDPA backward {sdpa_fb - sdpa_f:.4f} (forward + backward "
                f"{sdpa_fb:.4f}), bound {bbnd[0]:.5f} ({bbnd[2]}, {bbnd[0] / bkms:.1%} of it; "
                + ", ".join(f"{t} {v:.5f}" for t, v in bterms.items()) + "), "
                + plan_text(tinyhead_bwd_plan(b * h, s, sms, d, q.element_size())))
        log(f"[11] tinyhead {shape}: " + "; ".join(line))
        del qkvg, q, k, v, g, wide, out, out2, lse, ref, ref_lse
        torch.cuda.empty_cache()

    # the backward on plans other than its own at ragged shapes. bf16 (64
    # keys a warp): passes (one slice), 6, 8 and 16 warps in one slice
    # (warps past S; chunks of 64 and 128 queries), d = 4 in passes and in
    # 16 warps. fp32 (32 keys a warp): passes (one slice, 4, 6 and 8
    # warps), 2 slices of 8 warps, d = 4 in one pass of 8 warps (warps past
    # S) and in passes. Then plans each refuses
    forced = {
        (torch.bfloat16, (2, 4, 384, 8)): [
            TinyheadBwdPlan(512, 1, 4, 0), TinyheadBwdPlan(384, 1, 6, 0),
            TinyheadBwdPlan(512, 1, 8, 0), TinyheadBwdPlan(1024, 1, 16, 0)],
        (torch.bfloat16, (2, 4, 200, 4)): [TinyheadBwdPlan(512, 1, 4, 0),
                                           TinyheadBwdPlan(1024, 1, 16, 0)],
        (torch.float32, (2, 4, 384, 8)): [
            TinyheadBwdPlan(384, 1, 4, 0), TinyheadBwdPlan(384, 1, 6, 0),
            TinyheadBwdPlan(512, 1, 8, 0), TinyheadBwdPlan(256, 2, 8, 0)],
        (torch.float32, (2, 4, 200, 4)): [TinyheadBwdPlan(256, 1, 8, 0),
                                          TinyheadBwdPlan(256, 1, 4, 0)],
    }
    # (keys, slices, warps, with a workspace). bf16: short of S; 3 warps; an
    # empty slice; a workspace where one slice of one pass writes dq; none
    # where two slices need one; 17 warps; keys not whole passes. fp32:
    # short of S; 3 warps; an empty slice; none where two slices need one; 9
    # and 12 warps (its most is 8; bf16 takes 12); keys not whole passes
    refused = {
        torch.bfloat16: [(256, 1, 4, False), (192, 2, 3, True), (256, 3, 4, True),
                         (384, 1, 6, True), (256, 2, 4, False), (1088, 1, 17, False),
                         (320, 2, 4, True)],
        torch.float32: [(256, 1, 8, False), (96, 4, 3, True), (128, 4, 4, True),
                        (256, 2, 8, False), (288, 2, 9, True), (160, 3, 4, True),
                        (768, 1, 12, True)],
    }
    lines = []
    for (dtype, shape), plans in forced.items():
        name = str(dtype).split(".")[1]
        bf16 = dtype == torch.bfloat16
        b, h, s, d = shape
        scale = 1.0 / math.sqrt(d)
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4))
        wide = [t.float() for t in (q, k, v, g)]
        warp_keys = BWD_WARP_KEYS[q.element_size()]
        with torch.inference_mode():
            out, lse = tinyhead_forward(q, k, v, scale)
            plain = tinyhead_backward_plain(*wide[:3], out.float(), lse, wide[3], scale)
            mags = tinyhead_grad_mags(*wide, scale)
            for plan in plans:
                parts = plan.slices > 1 or plan.keys > warp_keys * plan.warps
                plan = plan._replace(
                    workspace=plan.slices * b * h * s * 32 if parts else 0)
                grads = launch_backward(q, k, v, out, lse, g, scale, plan)
                again = launch_backward(q, k, v, out, lse, g, scale, plan)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(grads, again)):
                    raise AssertionError(f"tinyhead backward {shape} {name} {plan}: two runs "
                                         "differ")
                errs = [check(a, w, bf16_limit(mag, w) if bf16 else
                              TINYHEAD_FP32_TOL[0] + TINYHEAD_FP32_TOL[1] * mag,
                              f"d{x} {name} vs plain, forced plan ({shape} {plan})")[0]
                        for x, a, w, mag in zip("qkv", grads, plain, mags)]
                lines.append(f"{shape} {name} {plan_text(plan)}: dq/dk/dv err "
                             + "/".join(f"{e:.3g}" for e in errs))
        for keys, slices, warps, ws in refused[dtype] if shape == (2, 4, 384, 8) else ():
            plan = TinyheadBwdPlan(keys, slices, warps, slices * b * h * s * 32 if ws else 0)
            try:
                launch_backward(q, k, v, out, lse, g, scale, plan)
            except RuntimeError:
                continue
            raise AssertionError(f"tinyhead backward {shape} {name}: plan {plan} was not "
                                 "refused")
    log("[11] tinyhead backward on forced plans, bitwise over two runs and within the "
        "limits: " + "; ".join(lines) + "; refused at (2, 4, 384, 8): " + "; ".join(
            f"{str(dt).split('.')[1]} " + ", ".join(
                f"{k}/{n}/{w}{' with a workspace' if ws else ''}" for k, n, w, ws in plans)
            for dt, plans in refused.items()))
    del q, k, v, g, wide, out, lse, plain, mags
    torch.cuda.empty_cache()

    # peak extra device memory of one backward at each main shape in each
    # dtype (its outputs and workspace), the plain recompute's at the first
    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        del res
        return torch.cuda.max_memory_allocated() - base

    peaks = {}
    for shape, dtype in itertools.product(TINYHEAD_SHAPES, (torch.float32, torch.bfloat16)):
        b, h, s, d = shape
        name = str(dtype).split(".")[1]
        scale = 1.0 / math.sqrt(d)
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4))
        with torch.inference_mode():
            out, lse = tinyhead_forward(q, k, v, scale)
        inputs = sum(t.numel() * t.element_size() for t in (q, k, v, out, g))

        def recompute():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            return torch.autograd.grad(tinyhead_attention_plain(*leaves, scale), leaves, g)

        kpeak = peak(lambda: tinyhead_attention_backward(q, k, v, out, lse, g, scale))
        if not kpeak < BWD_MEMORY_SHARE * inputs:
            raise AssertionError(f"tinyhead backward {shape} {name}: peak extra memory {kpeak} "
                                 f"bytes, limit {BWD_MEMORY_SHARE} x {inputs}")
        rpeak = (peak(recompute) if shape == TINYHEAD_SHAPES[0] and dtype == torch.bfloat16
                 else None)
        peaks[(shape, name)] = (kpeak, inputs)
        log(f"[11] tinyhead backward {shape} {name}: peak extra device memory "
            f"{kpeak / 2**20:.2f} MiB, {kpeak / inputs:.3f} x q, k, v, out, dO "
            f"({inputs / 2**20:.2f} MiB), "
            f"{plan_text(tinyhead_bwd_plan(b * h, s, sms, d, q.element_size()))}"
            + (f"; the plain recompute {rpeak / 2**30:.3f} GiB" if rpeak else ""))
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    log("[11] tinyhead_attention: all shapes within their limits; worst (max abs err, ratio "
        "to limit): " + "; ".join(f"{w} {e:.3g} {r:.3g}" for w, (e, r) in sorted(worst.items())))
    names = ("float32", "bfloat16")
    fwd_err = {n: worst[f"out {n}"][0] for n in names}
    bwd_err = {n: max(worst[f"d{x} {n} vs plain"][0] for x in "qkv") for n in names}
    return fwd_err, bwd_err, fwd_times, bwd_times, peaks


def phase_exact_k_large():
    """Kernels 1 and 3 above 128x128 (keys in registers across a cluster of
    8 or 16 CTAs an image): explicit bits against the plain versions,
    bitwise masks; the Philox route's exact k, determinism and, at 256x256,
    per-pixel frequency; times at 256x256; then the Philox route against
    the plain versions on the plain Philox's bits at EXACT_K_LARGE_SHAPES."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.ops.fused_degrade import fused_degrade_update, fused_rows
    from masked_diffusion_tpu_torch.ops.kmask import exact_count_masks, exact_count_masks_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    b, c = 8, 3
    worst_fused = worst_kmask = 0.0
    for size in LARGE_SIZES:
        hw = size * size
        bits_np = rng.integers(0, 2**32, size=(2, b, hw), dtype=np.uint64).astype(np.int64)
        bits_np[:, 4:7] &= 0xE0000000  # 8 values of top bits: heavy ties
        counts = rng.integers(0, hw + 1, size=(2, b))
        counts[:, :4] = (0, 1, hw - 1, hw)
        bits = torch.from_numpy(bits_np).to(dev)
        cnt = torch.from_numpy(counts[0].astype(np.int32)).to(dev)
        mask = exact_count_masks(b, size, size, cnt, bits=bits[0])
        ref = exact_count_masks_plain(bits[0], cnt).reshape(b, 1, size, size)
        torch.cuda.synchronize()
        worst_kmask = max(worst_kmask, (mask - ref).abs().max().item())
        if not torch.equal(mask, ref):
            raise AssertionError(f"kmask {b}x{size}x{size}: masks differ from the plain version")
        if not torch.equal((1.0 - mask).reshape(b, hw).sum(1).long(), cnt.long()):
            raise AssertionError(f"kmask {b}x{size}x{size}: zero counts != counts")

        xt = torch.from_numpy(rng.normal(size=(b, c, size, size)).astype(np.float32)).to(dev)
        x0 = torch.from_numpy(rng.normal(size=(b, c, size, size)).astype(np.float32)).to(dev)
        ratios = rng.uniform(0, 1, size=(2, b)).astype(np.float32)
        ratios[:, 0], ratios[:, 1] = 0.0, 1.0
        for select, amounts in (("thresholding", ratios), ("indexing", counts.astype(np.float32))):
            amt = torch.from_numpy(amounts).to(dev)
            for rule, mean_mode, mean_value in (("base_momentum", "degraded_area", 0.0),
                                                ("base_sampling", "const", 0.25)):
                kw = dict(select=select, mean_mode=mean_mode, mean_value=mean_value, rule=rule)
                out, m = fused_degrade_update(xt, x0, amt[0], amt[1], bits=bits, **kw)
                ref_out, ref_m = fused_rows(bits[0], bits[1], xt.reshape(b, -1),
                                            x0.reshape(b, -1), amt[0][:, None], amt[1][:, None],
                                            channels=c, **kw)
                torch.cuda.synchronize()
                if not torch.equal(m.reshape(b, hw), ref_m):
                    raise AssertionError(f"fused_degrade {size}x{size} {kw}: masks differ")
                err = (out.reshape(b, -1) - ref_out).abs().max().item()
                worst_fused = max(worst_fused, err)
                if not err <= FUSED_TOL:
                    raise AssertionError(f"fused_degrade {size}x{size} {kw}: max |out - plain| "
                                         f"{err} > {FUSED_TOL}")
                if select == "indexing" and not torch.equal(
                        (1.0 - m).reshape(b, hw).sum(1), amt[1]):
                    raise AssertionError(f"fused_degrade {size}x{size}: degraded counts != k")

        # Philox route: exact k and determinism, both kernels
        kf = cnt.float()
        kw = dict(select="indexing", mean_mode="degraded_area")
        m1, m2, m3 = (exact_count_masks(b, size, size, cnt,
                                        generator=torch.Generator().manual_seed(sd))
                      for sd in (3, 3, 4))
        f1, f2, f3 = (fused_degrade_update(xt, x0, kf, kf, seed=1234, offset=off, **kw)[1]
                      for off in (7, 7, 8))
        for what, a1, a2, a3 in (("kmask", m1, m2, m3), ("fused_degrade", f1, f2, f3)):
            if not torch.equal((1.0 - a1).reshape(b, hw).sum(1).long(), cnt.long()):
                raise AssertionError(f"{what} Philox {size}x{size}: degraded counts != k")
            if not torch.equal(a1, a2) or torch.equal(a1, a3):
                raise AssertionError(f"{what} Philox {size}x{size}: not deterministic per seed")
        log(f"[12] {size}x{size}, batch {b}: kmask and fused_degrade (C={c}, 2 selections x 2 "
            f"rules and means) with explicit bits (k = 0, 1, HW-1, HW, random; tied top "
            f"bits): masks bitwise equal to the plain versions, exact counts, max |out - "
            f"plain| {worst_fused:.3g} (tol {FUSED_TOL}); Philox: exact k in all {b} images, "
            f"deterministic per seed")

    # per-pixel degraded frequency at 256x256, k = HW/4, over b * draws masks
    size = LARGE_SIZES[0]
    hw, k, draws = size * size, size * size // 4, 64
    quarter = torch.full((b,), k, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(5)
    xt = torch.zeros((b, c, size, size), device=dev)
    freqs = {
        "kmask": sum((1.0 - exact_count_masks(b, size, size, quarter, generator=gen)).sum(0)
                     for _ in range(draws)),
        "fused_degrade": sum((1.0 - fused_degrade_update(
            xt, xt, quarter.float(), quarter.float(), seed=77, offset=i, select="indexing",
            mean_mode="degraded_area")[1]).sum(0) for i in range(draws)),
    }
    p = k / hw
    for what, f in freqs.items():
        z = (f.reshape(hw) / (b * draws) - p) / (p * (1 - p) / (b * draws)) ** 0.5
        zmax, zsq = z.abs().max().item(), z.square().mean().item()
        if zmax > KMASK_Z_LARGE or not 0.9 <= zsq <= 1.1:
            raise AssertionError(f"{what} Philox {size}x{size}: per-pixel frequency max |z| "
                                 f"{zmax}, mean z^2 {zsq}")
        log(f"[12] {what} Philox {size}x{size}: degraded frequency at k = HW/4 over {b} "
            f"images x {draws} draws: max |z| {zmax:.3f} (bound {KMASK_Z_LARGE}) over {hw} "
            f"pixels, mean z^2 {zsq:.4f} (1 expected)")

    # times at 256x256, batch 8, Philox bits (the main path's route)
    x0 = torch.randn((b, c, size, size), device=dev)
    counts_t = torch.randint(0, hw + 1, (b,), device=dev, dtype=torch.int32)
    a = counts_t.float()
    kgen = torch.Generator().manual_seed(7)
    times = {}

    def kmask_plain():
        exact_count_masks_plain(torch.randint(0, 2**32, (b, hw), device=dev, dtype=torch.int64),
                                counts_t)

    def fused_plain():
        bb = torch.randint(0, 2**32, (2, b, hw), device=dev, dtype=torch.int64)
        fused_rows(bb[0], bb[1], x0.reshape(b, -1), x0.reshape(b, -1), a[:, None], a[:, None],
                   channels=c, select="indexing", mean_mode="degraded_area", mean_value=0.0,
                   rule="base_momentum")

    for what, kernel, plain, bnd in (
        ("kmask", lambda: exact_count_masks(b, size, size, counts_t, generator=kgen),
         kmask_plain, kmask_bound(b, hw)),
        ("fused_degrade", lambda: fused_degrade_update(
            x0, x0, a, a, seed=5, offset=1, select="indexing", mean_mode="degraded_area"),
         fused_plain, fused_bound(b, c, hw)),
    ):
        kms, _ = cuda_ms(kernel)
        pms, _ = cuda_ms(plain, 5, 4)
        times[what] = (kms, pms, bnd)
        log(f"[12] time {what} {b}x{size}x{size}" + (f"x{c}" if what == "fused_degrade" else "")
            + f" (Philox, indexing): kernel {kms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bnd[0]:.5f} ms by {bnd[1]}")
    fused_taken, err = exact_k_branches("fused", EXACT_K_LARGE_SHAPES, "12", 120)
    kmask_taken, _ = exact_k_branches("kmask", EXACT_K_LARGE_SHAPES, "12", 121)
    return max(worst_fused, err), worst_kmask, times, fused_taken, kmask_taken


def phase_zoo():
    """Every zoo name at 128x128: one bf16 forward at batch 2 with random
    weights, the output finite and the tiny-head launches as the topology
    says; then one forward with grad and its backward, with as many
    tiny-head backward launches as forward ones, every gradient finite.
    Returns {name: tiny-head backward launches per train step}."""
    import torch

    from masked_diffusion_tpu_torch.models.zoo import ZOO_NAMES, Model
    from masked_diffusion_tpu_torch.ops.tinyhead_attention import (
        tinyhead_attention,
        tinyhead_attention_backward,
    )

    dev = torch.device("cuda")
    size, batch = 128, 2
    gen = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((batch, 3, size, size), generator=gen, device=dev).to(torch.bfloat16)
    t = torch.full((batch,), 10.0, device=dev)
    backward = {}
    for name in ZOO_NAMES:
        torch.manual_seed(0)
        with dev:
            model = Model(name, 3, size, size)
        model.conv_out.reset_parameters()  # random, not zero: the output must depend on it
        model = model.to(torch.bfloat16).eval()
        want = tinyhead_per_forward(model.config)
        before = tinyhead_attention.launches
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(x, t)
        torch.cuda.synchronize()
        launched = tinyhead_attention.launches - before
        if out.shape != x.shape or not bool(torch.isfinite(out).all()) or launched != want:
            raise AssertionError(f"zoo {name} at {size}x{size}: shape {tuple(out.shape)}, "
                                 f"finite {bool(torch.isfinite(out).all())}, tinyhead "
                                 f"launches {launched}, expected {want}")
        before = (tinyhead_attention.launches, tinyhead_attention_backward.launches)
        model(x, t).float().square().mean().backward()
        torch.cuda.synchronize()
        with_grad = (tinyhead_attention.launches - before[0],
                     tinyhead_attention_backward.launches - before[1])
        finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        if with_grad != (want, want) or not finite:
            raise AssertionError(f"zoo {name} at {size}x{size} with grad: tinyhead launches "
                                 f"(forward, backward) {with_grad}, expected {want} each; "
                                 f"gradients finite {finite}")
        backward[name] = with_grad[1]
        params = sum(p.numel() for p in model.parameters())
        log(f"[15] zoo {name} at {size}x{size}, bf16, batch {batch}: {params / 1e6:.1f}M "
            f"params, block_out_channels {model.config.block_out_channels}, output finite, "
            f"std {out.float().std().item():.4f}; tinyhead launches {launched} (expected "
            f"{want}); with grad {with_grad[0]} forward and {with_grad[1]} backward tinyhead "
            f"launches, gradients finite; {time.perf_counter() - t0:.2f} s")
        del model, out
        torch.cuda.empty_cache()
    return backward


def _run_cli(argv, tag: str):
    """main(argv) with every launch count set to 0 just before; returns (rc,
    the JSON of its `tag` line, launches)."""
    from masked_diffusion_tpu_torch.cli.main_train_masked import main

    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    counts = read_counts()
    sys.stdout.write(buf.getvalue())
    line = next(ln for ln in buf.getvalue().splitlines() if ln.startswith(tag + " "))
    return rc, json.loads(line.split(" ", 1)[1]), counts


def phase_cli_pair(tag: str, what: str, common, train_extra, per_forward: int, epochs: int,
                   steps_per_epoch: int, serve: bool = True):
    """Train through the CLI (--method mean_shift), then, if `serve`, serve
    the checkpoint it wrote (--method sample, EMA weights). Checks the
    counts: one kmask launch per indexing train step and one for the
    cadence's visuals pass, one fused launch per reverse step, `per_forward`
    tinyhead launches per UNet forward (one per train step, the visuals pass
    and each reverse step) and `per_forward` tinyhead backward launches per
    train step, none in serving; all of them on the fp32 kernels under
    --mixed_precision no, none otherwise. Returns the launches of both
    runs."""
    import numpy as np

    fp32 = common[common.index("--mixed_precision") + 1] == "no"

    def with_fp32(want):
        for name in ("tinyhead_attention", "tinyhead_attention_backward"):
            want[f"{name}_fp32"] = want[name] if fp32 else 0
        return want

    rc, stats, train = _run_cli(["--method", "mean_shift", "--num_epochs", str(epochs),
                                 *train_extra, *common], "train_stats")
    steps = epochs * steps_per_epoch
    if rc != 0 or stats["global_step"] != steps or not np.isfinite(stats["loss_mean_epoch"]).all():
        raise AssertionError(f"{what} train CLI: rc {rc}, stats {stats}")
    (ckpt,) = stats["checkpoints"]
    # one save cadence (the last epoch): its visuals pass is one more exact-k
    # launch and one more UNet forward
    want = with_fp32({"exact_count_masks": steps + 1,
                      "tinyhead_attention": per_forward * (steps + 1 + train["fused_degrade_update"]),
                      "tinyhead_attention_backward": per_forward * steps})
    if (any(train[k] != n for k, n in want.items()) or not train["fused_degrade_update"]
            or not same_through_sharded(train)):
        raise AssertionError(f"{what} train CLI: launches {train}, expected {want}")
    log(f"{tag} {what} train CLI: {epochs} epochs x {steps_per_epoch} steps, losses "
        f"{[round(v, 5) for v in stats['loss_mean_epoch']]}, {stats['ms_per_step']:.3f} ms/step "
        f"and {stats['images_per_sec']:.2f} images/s (last epoch) on {stats['device']}; "
        f"launches {train} ({per_forward} tinyhead forward launches per UNet forward, "
        f"{per_forward} backward launches per train step"
        + (", all on the fp32 kernels)" if fp32 else ")"))
    if not serve:
        return train

    rc, served, serve = _run_cli(["--method", "sample", "--test_model_path", ckpt, *common],
                                 "sample_stats")
    n_steps = served["steps"] * served["batches"]
    want = with_fp32({"exact_count_masks": 0, "fused_degrade_update": n_steps,
                      "tinyhead_attention": per_forward * n_steps,
                      "tinyhead_attention_backward": 0})
    if rc != 0 or not (served["finite"] and served["ema"]) or any(
            serve[k] != n for k, n in want.items()) or not same_through_sharded(serve):
        raise AssertionError(f"{what} serve CLI: rc {rc}, {served}, launches {serve}, "
                             f"expected {want}")
    log(f"{tag} {what} served the trained checkpoint (EMA weights): {served['images']} "
        f"images, {served['steps']} steps x {served['batches']} batches, "
        f"{served['ms_per_step']:.3f} ms/step; launches {serve}")
    return {k: train[k] + serve[k] for k in train}


def celeba_cli_args(dir_work: str, precision: str):
    """(common flags, training flags) of the CelebA-HQ launch config through
    the CLI at --mixed_precision `precision`."""
    common = [
        "--data_name", "synthetic", "--data_size", "64", "--data_subset", "True",
        "--data_subset_num", "64", "--batch_size", "32", "--num_attention", "5",
        "--sample_num", "16", "--mixed_precision", precision, "--ddpm_schedule", "log",
        "--ddpm_num_steps", "16", "--select_degrade_pixel", "indexing",
        "--mean_option", "degraded_area", "--mean_area", "image-wise",
        "--shift_type", "1-d_constant", "--sample_latent_shape", "data",
        "--momentum_adaptive", "base_momentum", "--sampling_mask_dependency", "independent",
        "--use_wandb", "False", "--device", "cuda", "--dir_work", dir_work,
    ]
    train = ["--optim", "adamw", "--lr", "3e-5", "--lr_scheduler", "cosine",
             "--lr_warmup_steps", "500", "--use_ema", "True", "--sampling", "momentum",
             "--save_images_epochs", "1000"]
    return common, train


def phase_celeba_cli(workdir: str):
    """The CelebA-HQ launch config (scripts/train/celeba_hq/base/script_main.sh:
    --num_attention 5 at 64x64, batch 32, mean_shift, log + indexing at
    T=16, 1-d_constant, base_momentum, bf16) on synthetic data, 2 epochs of
    2 steps, then served; 10 tinyhead launches per forward."""
    common, train = celeba_cli_args(os.path.join(workdir, "celeba"), "bf16")
    return phase_cli_pair("[16]", "CelebA-HQ config", common, train, 10, 2, 2)


def phase_celeba_fp32_cli(workdir: str):
    """[16b] The CelebA-HQ config of phase 16 at the CLI's default precision
    (--mixed_precision no: fp32), one epoch of 2 train steps and its
    cadence: every tiny-head launch on the fp32 (split-TF32) kernels, 10
    forward and 10 backward a train step and 10 a forward of the cadence,
    counted exactly. Its directory (a 1.8 GB checkpoint) is removed after."""
    import shutil

    root = os.path.join(workdir, "celeba_fp32")
    common, train = celeba_cli_args(root, "no")
    runs = phase_cli_pair("[16b]", "CelebA-HQ config, fp32", common, train, 10, 1, 2,
                          serve=False)
    shutil.rmtree(root, ignore_errors=True)
    return runs


def phase_unet6_cli(workdir: str):
    """unet6 at 256x256 (the reference's per-size table), batch 8, bf16, log +
    indexing: 2 epochs of 2 train steps, then served; 5 tinyhead launches per
    forward."""
    common = [
        "--model", "unet6", "--data_name", "synthetic", "--data_size", "256",
        "--data_subset", "True", "--data_subset_num", "16", "--batch_size", "8",
        "--sample_num", "8", "--mixed_precision", "bf16", "--ddpm_schedule", "log",
        "--ddpm_num_steps", "8", "--select_degrade_pixel", "indexing",
        "--mean_option", "degraded_area", "--mean_area", "image-wise",
        "--shift_type", "1-d_constant", "--momentum_adaptive", "base_momentum",
        "--sampling_mask_dependency", "independent", "--use_wandb", "False",
        "--device", "cuda", "--dir_work", os.path.join(workdir, "unet6"),
    ]
    train = ["--optim", "adamw", "--lr", "1e-4", "--lr_scheduler", "cosine",
             "--lr_warmup_steps", "0", "--use_ema", "True", "--sampling", "momentum",
             "--save_images_epochs", "2"]
    return phase_cli_pair("[17]", "unet6 256x256", common, train, 5, 2, 2)


# [19] the plain branch's modes: (what, schedule, selection, flags, capture)
SAMPLING_MODES = (
    ("independent+momentum+thresholding, 3-channel, channel-wise degraded_area", "linear",
     "thresholding", ["--sampling_mask_dependency", "independent", "--momentum_adaptive",
                      "momentum", "--degrade_channel", "3-channel", "--mean_option",
                      "degraded_area", "--mean_area", "channel-wise"], False),
    ("dependent_prev+boosting+indexing, non_degraded_area", "log", "indexing",
     ["--sampling_mask_dependency", "dependent_prev", "--momentum_adaptive", "boosting",
      "--mean_option", "non_degraded_area"], False),
    ("dependent_t+base_sampling+thresholding", "linear", "thresholding",
     ["--sampling_mask_dependency", "dependent_t", "--momentum_adaptive", "base_sampling",
      "--mean_option", "degraded_area"], False),
    ("independent+base_momentum+indexing, captured", "log", "indexing",
     ["--sampling_mask_dependency", "independent", "--momentum_adaptive", "base_momentum",
      "--mean_option", "degraded_area"], True),
)
SAMPLING_TIMED_BATCH = 16
SAMPLING_TIMED_STEPS = 25  # 50 before phase 32 took the time


def kmask_per_step(cfg) -> int:
    """Exact-k launches a plain-branch reverse step makes: one for each mask
    drawn by index (t and t-1 when independent, t-1 when dependent_prev)."""
    if cfg.select_degrade_pixel != "indexing":
        return 0
    return 2 if cfg.sampling_mask_dependency == "independent" else 1


def _close(a, b) -> bool:
    import torch

    return bool(torch.isfinite(a).all()) and torch.allclose(a, b, atol=SLICE_TOL, rtol=SLICE_TOL)


def _mode_cfg(sched, select, flags, t_steps, *extra):
    """(cfg, schedule) of a `--method sample` mode at the flagship's size."""
    from masked_diffusion_tpu_torch.cli.main_train_masked import parse
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule

    cfg, _ = parse(["--method", "sample", "--data_size", str(SIZE), "--ddpm_schedule", sched,
                    "--ddpm_num_steps", str(t_steps), "--select_degrade_pixel", select,
                    "--shift_type", "1-d_constant", *flags, *extra])
    return cfg, build_schedule(sched, t_steps, SIZE, select)


def _run_sampler(ref_model, cfg, schedule, used, dev, capture, lat, **kw):
    """make_sample_fn of a fresh flagship with ref_model's weights, run on
    `dev` (sync debug "error" on CUDA); returns (out, kernel launches)."""
    import torch

    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.sample.loop import make_sample_fn

    model = build_unet()
    model.load_state_dict(ref_model.state_dict())
    fn = make_sample_fn(model, schedule, cfg, used, device=dev, capture_trajectory=capture,
                        capture_items=lat.shape[0])
    lat = lat.to(dev)
    reset_counts()
    if dev == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(lat, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, read_counts()


def plain_branch_parity(ref_model, latent, what, sched, select, flags, capture, steps,
                        tag="[19]", extra=()):
    """One mode on the plain branch, `steps` reverse steps, fp32 with TF32
    off: CUDA against the CPU path on the same injected draws within
    SLICE_TOL (with capture: every field and mean), kernel 3 launched
    kmask_per_step times a step on CUDA, kernel 1 never. Returns the max
    |diff|."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.ops.shift import draw_shapes
    from masked_diffusion_tpu_torch.sample.loop import (
        TRAJECTORY_FIELDS,
        TRAJECTORY_MEANS,
        StepDraws,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, hw = latent.shape[0], SIZE * SIZE
    cfg, schedule = _mode_cfg(sched, select, flags, steps, "--mixed_precision", "no", *extra)
    used = schedule.timesteps_for_epoch(1, 10, 1)[-steps:]
    channels = 3 if cfg.degrade_channel == "3-channel" else 1
    rng = np.random.default_rng(19)
    u_shape, _ = draw_shapes(cfg.shift_type, (batch, 3, SIZE, SIZE))
    cpu_draws = [StepDraws(
        bits=torch.from_numpy(rng.integers(0, 2**32, size=(2, batch, hw),
                                           dtype=np.uint64).astype(np.int64)),
        mask_uniform=torch.from_numpy(
            rng.uniform(size=(2, batch, channels, SIZE, SIZE)).astype(np.float32)),
        uniform=torch.from_numpy(rng.uniform(-1, 1, size=u_shape).astype(np.float32)),
    ) for _ in used]
    cuda_draws = [StepDraws(**{k: None if v is None else v.cuda()
                               for k, v in vars(d).items()}) for d in cpu_draws]
    outs = {}
    for dev, draws in (("cuda", cuda_draws), ("cpu", cpu_draws)):
        t0 = time.perf_counter()
        outs[dev], counts = _run_sampler(ref_model, cfg, schedule, used, dev, capture, latent,
                                         draws=lambda i, d=draws: d[i])
        want = kmask_per_step(cfg) * len(used) if dev == "cuda" else 0
        if (counts["exact_count_masks"] != want
                or counts["exact_count_masks_sharded"] != want
                or counts["fused_degrade_update"] or counts["fused_degrade_update_sharded"]):
            raise AssertionError(f"{tag} {what} on {dev}: launches {counts}, expected "
                                 f"{want} exact_count_masks and no fused launch")
        log(f"{tag} {what} on {dev}: {len(used)} steps in {time.perf_counter() - t0:.2f} s"
            + (f" with no host sync inside the loop, {want} exact_count_masks launches "
               f"({kmask_per_step(cfg)} a step)" if dev == "cuda" else ""))
    a, r = outs["cuda"], outs["cpu"]
    pairs = [("sample_0", a, r)]
    if capture:
        (a, ta), (r, tr) = a, r
        pairs = [("sample_0", a, r)] + [(name, ta[name], tr[name])
                                        for name in TRAJECTORY_FIELDS]
        pairs += [(f"mean {name}", ta["means"][name], tr["means"][name])
                  for name in TRAJECTORY_MEANS]
        for name in TRAJECTORY_FIELDS:
            if tuple(ta[name].shape) != (len(used), batch, SIZE, SIZE, 3):
                raise AssertionError(f"{tag} {what}: {name} {tuple(ta[name].shape)}")
    if tuple(a.shape) != (batch, SIZE, SIZE, 3):
        raise AssertionError(f"{tag} {what}: output {tuple(a.shape)}")
    errs = {}
    for name, x, y in pairs:
        x = x.cpu()
        errs[name] = (x - y).abs().max().item()
        if not _close(x, y):
            raise AssertionError(f"{tag} {what}: {name} CUDA vs CPU max err {errs[name]}")
    log(f"{tag} {what}: CUDA vs CPU plain, max |diff| {max(errs.values()):.3g} over "
        f"{len(pairs)} tensors (atol = rtol = {SLICE_TOL}); output std {r.std().item():.4f}")
    return max(errs.values())


def phase_sampling_modes(steps: int = 5):
    """[19] The reverse loop's plain branch at the flagship's width, 64x64,
    batch 2, `steps` reverse steps, fp32 with TF32 off: CUDA (the exact-k
    kernel for indexing masks) against the CPU path (its plain version) on
    the same injected draws, within SLICE_TOL, for SAMPLING_MODES
    (plain_branch_parity); the captured mode compares all 11 fields and the
    4 means. Each CUDA run is under set_sync_debug_mode("error") and
    launches kernel 3 (through its sharded form) kmask_per_step times a
    step, kernel 1 never. Then the captured mode on the kernel's own Philox
    draws: every captured mask at t and t-1 degrades exactly the schedule's
    count. Then times, bf16: kernel 3 at batch 2, and a flagship reverse
    step at batch SAMPLING_TIMED_BATCH on the fused branch, the plain one
    and the plain one captured."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.ops.kmask import exact_count_masks, exact_count_masks_plain
    from masked_diffusion_tpu_torch.sample.latent import latent_initial
    from masked_diffusion_tpu_torch.sample.loop import make_sample_fn

    batch, hw = 2, SIZE * SIZE
    ref_model = _flagship_weights(19)
    latent = latent_initial(torch.Generator().manual_seed(3), batch, 3, SIZE, "uniform",
                            device="cpu")
    for mode in SAMPLING_MODES:
        plain_branch_parity(ref_model, latent, *mode, steps)

    # the captured mode on the kernel's own Philox draws: exact counts
    what, sched, select, flags, _ = SAMPLING_MODES[-1]
    cfg, schedule = _mode_cfg(sched, select, flags, steps, "--mixed_precision", "no")
    used = schedule.timesteps_for_epoch(1, 10, 1)[-steps:]
    (out, traj), counts = _run_sampler(ref_model, cfg, schedule, used, "cuda", True, latent,
                                       generator=torch.Generator().manual_seed(5))
    walk = used[::-1].copy()  # capture row j is reverse step j
    nxt = np.where(np.arange(len(walk)) == len(walk) - 1, walk, walk - 1)
    for field, ts in (("degrade_mask_t", walk), ("degrade_mask_next_t", nxt)):
        want = schedule.degrade_amount(torch.as_tensor(ts)).long()[:, None].expand(-1, batch)
        got = (1.0 - traj[field][..., 0]).sum(dim=(2, 3)).round().long().cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"[19] Philox draws: {field} degraded counts {got.tolist()}, "
                                 f"expected {want.tolist()}")
        if not bool(((traj[field] == 0) | (traj[field] == 1)).all()):
            raise AssertionError(f"[19] Philox draws: {field} is not binary")
    if counts["exact_count_masks"] != 2 * len(used) or not torch.isfinite(out).all():
        raise AssertionError(f"[19] Philox draws: launches {counts}")
    log(f"[19] {what} on the kernel's own Philox draws: every captured mask at t and t-1 of "
        f"{batch} images x {len(used)} steps degrades exactly the schedule's count "
        f"(t from {int(walk.max())} down to {int(walk.min())}); "
        f"{counts['exact_count_masks']} exact_count_masks launches")

    # times (bf16): kernel 3 at this phase's batch; a flagship reverse step
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = True
    counts2 = torch.full((batch,), hw // 3, dtype=torch.int32, device=dev)
    kgen = torch.Generator().manual_seed(8)
    kms, keager = cuda_ms(lambda: exact_count_masks(batch, SIZE, SIZE, counts2, generator=kgen))
    pms, _ = cuda_ms(lambda: exact_count_masks_plain(
        torch.randint(0, 2**32, (batch, hw), device=dev, dtype=torch.int64), counts2))
    kbnd = kmask_bound(batch, hw)
    log(f"[19] exact_count_masks at {batch}x{SIZE}x{SIZE} (the loop's masks at this batch): "
        f"kernel {kms:.4f} ms device ({keager:.4f} eager), plain {pms:.4f} ms, bound "
        f"{kbnd[0]:.5f} ms by {kbnd[1]}")
    b = SAMPLING_TIMED_BATCH
    lat = latent_initial(torch.Generator().manual_seed(4), b, 3, SIZE, "uniform",
                         device="cpu").to(dev)
    base = ["--sampling_mask_dependency", "independent", "--mean_option", "degraded_area"]
    fns, per = {}, {}
    for name, rule, capture in (("fused", "base_momentum", False),
                                ("plain (momentum rule)", "momentum", False),
                                ("plain, captured", "base_momentum", True)):
        cfg, schedule = _mode_cfg("log", "indexing", base + ["--momentum_adaptive", rule], 200,
                                  "--mixed_precision", "bf16")
        used = schedule.timesteps_for_epoch(1, 10, 1)[-SAMPLING_TIMED_STEPS:]
        model = build_unet()
        model.load_state_dict(ref_model.state_dict())
        fns[name] = make_sample_fn(model, schedule, cfg, used, device=dev,
                                   capture_trajectory=capture, capture_items=4)
        fns[name](lat, torch.Generator().manual_seed(0))  # warm-up
        reset_counts()
        fns[name](lat, torch.Generator().manual_seed(0))
        per[name] = read_counts()
    timed = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:  # in turns: a b c c b a
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[name](lat, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        timed[name].append(1e3 * (time.perf_counter() - t0) / SAMPLING_TIMED_STEPS)
    timed = {name: sum(v) / len(v) for name, v in timed.items()}
    for name, ms in timed.items():
        log(f"[19] flagship reverse step, bf16, batch {b}, log+indexing, {name}: {ms:.3f} "
            f"ms/step over {SAMPLING_TIMED_STEPS} steps (mean of 2 runs in turns); launches a "
            f"step: fused {per[name]['fused_degrade_update'] / SAMPLING_TIMED_STEPS:g}, "
            f"exact_count_masks {per[name]['exact_count_masks'] / SAMPLING_TIMED_STEPS:g}")
    del fns
    torch.cuda.empty_cache()
    return {"kmask_b2": (kms, pms, kbnd), "reverse_ms": timed}


def _timed_cadence(record: dict):
    """A context that times each Trainer.sample_ema call of the run (the
    cadence's sampling, up to the host copy of its images) into record:
    {"seconds", "steps"}."""
    import masked_diffusion_tpu_torch.train.trainer as trainer_mod

    real = trainer_mod.Trainer.sample_ema

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        out = real(self, *a, **k)
        record["seconds"] = record.get("seconds", 0.0) + time.perf_counter() - t0
        record["steps"] = record.get("steps", 0) + len(self.timesteps_used_epoch)
        return out

    @contextlib.contextmanager
    def ctx():
        trainer_mod.Trainer.sample_ema = timed
        try:
            yield record
        finally:
            trainer_mod.Trainer.sample_ema = real

    return ctx()


DEFAULT_CLI_T = 20  # phase 20's training --ddpm_num_steps (the serve keeps phase 10's 200)


def phase_default_cli(workdir: str, flagship_perf: dict):
    """[20] The flagship through the CLI with the default sampling flags (no
    --sampling, no --use_ema: EMA on, --sampling base): phase 10's flags
    otherwise (batch 64, bf16, log + indexing, 2 epochs of 4 steps,
    --sample_num 16) but the training run at T=DEFAULT_CLI_T (phase 31 runs
    the captured cadence at T=4096). The cadence samples with trajectory
    capture on the plain branch. Checks the EMA grids, 11 x 4 trajectory PNGs, the train
    visuals, finite trajectory means in metrics.jsonl, and kernel 3's
    launches: one a train step, one for the visuals pass, two a reverse step
    of the cadence; none of kernel 1. Then serves the checkpoint with
    dependent_prev + momentum (two requests of 16): one exact-k launch a
    reverse step. Returns the launches of both runs."""
    import numpy as np

    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.sample.loop import TRAJECTORY_FIELDS

    argv, common = flagship_cli_args(os.path.join(workdir, "default"))
    i = argv.index("--sampling")
    argv = argv[:i] + argv[i + 2:]
    argv[argv.index("--ddpm_num_steps") + 1] = str(DEFAULT_CLI_T)
    if "--use_ema" in argv:
        raise AssertionError("phase 20 runs the default --use_ema")
    cadence = {}
    with _timed_cadence(cadence):
        rc, stats, train = _run_cli(argv, "train_stats")
    if rc != 0 or stats["global_step"] != 8 or not np.isfinite(stats["loss_mean_epoch"]).all():
        raise AssertionError(f"[20] default-flags train CLI: rc {rc}, stats {stats}")
    (ckpt,) = stats["checkpoints"]
    run = os.path.dirname(os.path.dirname(ckpt))
    image = os.path.join(run, "train", "image")
    grids = sorted(os.listdir(os.path.join(image, "ema_sample_img")))
    traj = sorted(os.listdir(os.path.join(image, "sample_all_t")))
    want_traj = sorted(f"{f}_00001_item{k}.png" for f in TRAJECTORY_FIELDS for k in range(4))
    visuals = sorted(f for d in ("train_image", "noisy_image", "mask_image", "img",
                                 "noise_image", "predict_image", "shift_input", "shift_noisy")
                     for f in os.listdir(os.path.join(image, d)))
    if grids != ["ema_sample_00001_global.png", "ema_sample_00001_local.png"] or (
            traj != want_traj or len(visuals) != 20):
        raise AssertionError(f"[20] EMA grids {grids}, trajectory PNGs {len(traj)}, "
                             f"visual grids {visuals}")
    with open(os.path.join(run, "log", "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    means = [r for r in rows if "ema_sample_t_mean" in r]
    keys = ("ema_sample_mean", "ema_sample_t_mean", "ema_sample_0_mean",
            "ema_sample_shift_t_mean", "ema_sample_0_shift_mean")
    if len(means) != 1 or not all(np.isfinite(means[0][k]) for k in keys):
        raise AssertionError(f"[20] trajectory means in metrics.jsonl: {means}")
    schedule = build_schedule("log", DEFAULT_CLI_T, SIZE, "indexing")
    reverse = len(schedule.timesteps_for_epoch(1, 2, 1))  # the last epoch's curriculum
    if cadence.get("steps") != reverse:
        raise AssertionError(f"[20] cadence sampled {cadence}, expected {reverse} steps")
    want = {"exact_count_masks": 8 + 1 + 2 * reverse, "fused_degrade_update": 0,
            "tinyhead_attention": 0, "tinyhead_attention_backward": 0}
    if any(train[k] != n for k, n in want.items()) or not same_through_sharded(train) or not (
            train["group_norm_silu"] and train["group_norm_silu_backward"]):
        raise AssertionError(f"[20] default-flags train CLI: launches {train}, expected {want}")
    cadence_ms = 1e3 * cadence["seconds"] / reverse
    log(f"[20] train CLI with the default sampling flags (--sampling base, EMA): 2 epochs x 4 "
        f"steps, losses {[round(v, 5) for v in stats['loss_mean_epoch']]}, "
        f"{stats['ms_per_step']:.3f} ms/step; the captured cadence: {reverse} reverse steps of "
        f"16 images in {cadence['seconds']:.2f} s, {cadence_ms:.3f} ms a reverse step (phase "
        f"10's fused cadence: {flagship_perf['cadence_ms']:.3f}); {len(traj)} trajectory PNGs, "
        f"{len(visuals)} train-visual grids, EMA grids {grids}; trajectory means "
        f"{ {k: round(means[0][k], 5) for k in keys} }; launches {train} (exact_count_masks: "
        f"8 train steps + 1 visuals pass + 2 x {reverse} reverse steps)")

    serve_args = list(common)
    for flag, value in (("--sampling_mask_dependency", "dependent_prev"),
                        ("--momentum_adaptive", "momentum"), ("--batch_size", "16"),
                        ("--sample_num", "32")):
        serve_args[serve_args.index(flag) + 1] = value
    rc, served, serve = _run_cli(["--method", "sample", "--test_model_path", ckpt, "--dir_work",
                                  os.path.join(workdir, "default", "serve"), *serve_args],
                                 "sample_stats")
    n_steps = served["steps"] * served["batches"]
    want = {"exact_count_masks": n_steps, "fused_degrade_update": 0,
            "group_norm_silu_backward": 0}
    if rc != 0 or not (served["finite"] and served["ema"] and served["images"] == 32
                       and served["batches"] == 2) or any(
            serve[k] != n for k, n in want.items()) or not same_through_sharded(serve):
        raise AssertionError(f"[20] serve dependent_prev+momentum: rc {rc}, {served}, "
                             f"launches {serve}, expected {want}")
    log(f"[20] served the checkpoint, dependent_prev+momentum (EMA weights): "
        f"{served['images']} images, {served['steps']} steps x {served['batches']} batches, "
        f"{served['ms_per_step']:.3f} ms/step, {served['images_per_sec']:.3f} images/s; "
        f"launches {serve}")
    return {k: train[k] + serve[k] for k in train}, cadence_ms


# [21] checkpoints, resume and preemption at the flagship's width
RESUME_EPOCHS = 3  # (a)/(b): 3 epochs of 4 steps
PREEMPT_AT = 6  # (b): SIGTERM in the step that makes global step 6 (epoch 1, step 2)
CLI_EPOCHS = 3  # (c): 12 steps (24 before phase 27 took the time)
RESUME_T = 20  # --ddpm_num_steps of (a)-(c): a cadence of 20 reverse steps keeps it short
CLI_TIMEOUT = 600  # seconds for (c)'s preempted CLI subprocess


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms, torch's deterministic mode with
    CUBLAS_WORKSPACE_CONFIG, and no cuDNN autotuning; restored afterwards.
    warn_only: an op with no deterministic form warns instead of raising,
    and the warnings are collected (yielded list) so the op can be named."""
    import warnings

    import torch

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
        if saved[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[4]


def _resume_setup(workdir: str):
    """(cfg, device, dataset, histogram) of phase 21's Trainer-API runs:
    phase 10's flags, 3 epochs of 4 steps, the cadence at the last epoch
    only."""
    from masked_diffusion_tpu_torch.cli.main_train_masked import parse
    from masked_diffusion_tpu_torch.data.datasets import get_dataset
    from masked_diffusion_tpu_torch.data.histogram import compute_mean_histogram

    argv, _ = flagship_cli_args(workdir)
    argv = _with(argv, "--num_epochs", str(RESUME_EPOCHS), "--save_images_epochs", "3",
                 "--ddpm_num_steps", str(RESUME_T))
    cfg, device = parse(argv)
    data = get_dataset(cfg.dir_dataset, cfg.data_name, cfg.data_size, cfg.data_set,
                       cfg.data_subset, cfg.data_subset_num, seed=cfg.seed)
    return cfg, device, data, compute_mean_histogram(data.data, cfg.sample_num, cfg.mean_area)


def _with(argv, *pairs):
    """argv with each (flag, value) of pairs set (replaced, else appended)."""
    argv = list(argv)
    for flag, value in zip(pairs[::2], pairs[1::2]):
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    return argv


def _run_dirs(cfg, workdir: str, sub: str):
    from masked_diffusion_tpu_torch.utils.dirs import Dir

    return Dir(task="train", content=sub, dir_work=workdir, data_name=cfg.data_name,
               data_size=cfg.data_size, method=cfg.method)


def _host_state(trainer) -> dict:
    """Params and EMA of a trainer, copied to the host."""
    out = {f"p.{k}": v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    out.update({f"e.{k}": v.detach().cpu().clone()
                for k, v in trainer.state.ema_model.state_dict().items()})
    return out


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _release() -> None:
    """Return the card memory of trainers the caller has dropped."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _uninterrupted(cfg, device, data, hist, workdir: str, sub: str):
    """(a): 3 epochs through the Trainer API; (host state, counts, losses)."""
    from masked_diffusion_tpu_torch.train.trainer import Trainer

    reset_counts()
    t = Trainer(cfg, data, hist, device=device)
    t.train(0, RESUME_EPOCHS, dirs=_run_dirs(cfg, workdir, sub))
    out = (_host_state(t), read_counts(), list(t.loss_mean_epoch))
    del t
    _release()
    return out


def _check_counts(what: str, counts: dict) -> None:
    need = ("group_norm_silu", "group_norm_silu_backward", "exact_count_masks")
    if not all(counts[k] > 0 for k in need):
        raise AssertionError(f"[21] {what}: launches {counts}, expected {need} above 0")


def phase_preempt(workdir: str, smi: str) -> dict:
    """[21] Checkpoints, resume and preemption, the flagship at full width
    (113.7M parameters, 64x64x3, bf16, batch 64, log + indexing at
    T=RESUME_T, phase 10's other flags, 4 steps an epoch).
    (a) 3 epochs uninterrupted, through the Trainer API; (b) the same run
    SIGTERM'd in-process inside the step that makes global step 6 (epoch
    1, step 2), restored into a fresh Trainer and finished: params and EMA
    must equal (a)'s bitwise; both under `deterministic()`. Should they
    differ, a second uninterrupted run measures the card's own
    run-to-run difference and (b)'s may not exceed it. (c) the CLI as a
    subprocess, 6 epochs, --save_images_epochs 3: SIGTERM from outside once
    log/metrics.jsonl has the first epoch's line; it must exit 0 with a
    preemption checkpoint; then rerun with --resume_from_checkpoint latest
    --keep_last_checkpoints 1 --async_checkpoints true: global_step 24 and
    exactly one complete checkpoint left, with optimizer/ and history.npz.
    (d) the host-blocking time of a sync and an async save, the bytes on
    disk and the restore time. Every run launches the GroupNorm forward and
    backward and exact-k kernels (counts above 0). Returns the launches of
    all runs, (b)'s and (c)'s counted just as the others'."""
    import signal as signals
    import types

    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.cli.main_train_masked import parse
    from masked_diffusion_tpu_torch.io import checkpoint as ckpt_io
    from masked_diffusion_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    work = os.path.join(workdir, "preempt")
    cfg, device, data, hist = _resume_setup(work)
    runs = []

    with deterministic() as caught:
        ref, counts, ref_losses = _uninterrupted(cfg, device, data, hist, work, "a")
        _check_counts("(a) uninterrupted", counts)
        runs.append(counts)

        reset_counts()
        pre = Trainer(cfg, data, hist, device=device)
        make = pre._get_step_fn

        def get(used):
            fn = make(used)

            def step(*a, **k):
                out = fn(*a, **k)
                if pre.global_step + 1 == PREEMPT_AT:
                    signals.raise_signal(signals.SIGTERM)
                return out
            return step

        pre._get_step_fn = get
        result = pre.train(0, RESUME_EPOCHS, dirs=_run_dirs(cfg, work, "b"))
        if not result["preempted"] or pre.global_step != PREEMPT_AT:
            raise AssertionError(f"[21] (b) SIGTERM at step {PREEMPT_AT}: preempted "
                                 f"{result['preempted']}, global_step {pre.global_step}")
        (path,) = result["checkpoints"]
        del pre, make, get
        _release()
        res = Trainer(cfg, data, hist, device=device)
        gs = res.restore(path)
        first, skip = divmod(gs, data.num_batches(cfg.batch_size))
        res.train(first, RESUME_EPOCHS - first, skip, gs, dirs=_run_dirs(cfg, work, "b"))
        counts = read_counts()
        _check_counts("(b) preempted and resumed", counts)
        runs.append(counts)
        got = _host_state(res)
        diff = _max_diff(ref, got)
        bitwise = all(torch.equal(ref[k], got[k]) for k in ref)
        losses_equal = res.loss_mean_epoch == ref_losses
        own = None
        if not (bitwise and losses_equal):
            again, counts, _ = _uninterrupted(cfg, device, data, hist, work, "a2")
            runs.append(counts)
            own = _max_diff(ref, again)
        varying = sorted({str(w.message).split("\n")[0][:200] for w in caught
                          if "deterministic" in str(w.message)})
    log(f"[21] (b) SIGTERM in step {PREEMPT_AT} (epoch 1, step 2), restored from "
        f"{os.path.basename(path)} into a fresh Trainer, finished at global_step "
        f"{res.global_step}: params and EMA vs the uninterrupted run (a) "
        f"{'BITWISE EQUAL' if bitwise else 'differ'}, max |diff| {diff:.3g}; loss_mean_epoch "
        f"{'equal' if losses_equal else 'differs'} ({[round(v, 6) for v in ref_losses]}); "
        f"deterministic mode (cuDNN deterministic, torch.use_deterministic_algorithms "
        f"warn_only, CUBLAS_WORKSPACE_CONFIG=:4096:8); ops without a deterministic form: "
        f"{varying or 'none warned'}")
    if own is not None:
        log(f"[21] (b) two uninterrupted runs differ by max |diff| {own:.3g} on the card")
        if not (own > 0 and diff <= own):
            raise AssertionError(f"[21] (b) resumed run differs by {diff:.3g}, two "
                                 f"uninterrupted runs by {own:.3g}")

    # (d) save and restore times of the flagship's full state
    save_dir = os.path.join(work, "timed")
    dirs = types.SimpleNamespace(list_dir={"checkpoint": save_dir})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync_path = res._save_checkpoint(dirs, 100, None, res._history())
    sync_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, files in os.walk(sync_path) for f in files)
    t0 = time.perf_counter()
    res._save_checkpoint(dirs, 101, None, res._history(), async_save=True)
    async_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_io.wait_for_async_saves()
    drain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res.restore(sync_path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    log(f"[21] (d) the flagship's full state (params, EMA, AdamW moments and steps; "
        f"{nbytes} bytes on disk): a sync save blocks the host {sync_s:.3f} s, an async save "
        f"{async_s:.3f} s (its write then took {drain_s:.3f} s more in the background), a "
        f"restore takes {restore_s:.3f} s ({smi})")
    del res
    _release()

    # (c) the CLI: preempted from outside, then resumed with retention and async saves
    argv, _ = flagship_cli_args(os.path.join(work, "cli"))
    argv = _with(argv, "--num_epochs", str(CLI_EPOCHS), "--save_images_epochs", "3",
                 "--date", "preempt", "--time", "run", "--ddpm_num_steps", str(RESUME_T))
    run_dirs = _run_dirs_of(parse(argv)[0])
    metrics = os.path.join(run_dirs["log"], "metrics.jsonl")
    counts_path = os.path.join(work, "cli_counts.json")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--counted", counts_path, *argv],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    signalled = False
    deadline = time.monotonic() + CLI_TIMEOUT
    try:
        while proc.poll() is None and time.monotonic() < deadline:
            if os.path.exists(metrics) and os.path.getsize(metrics) > 0:
                proc.send_signal(signals.SIGTERM)
                signalled = True
                break
            time.sleep(0.02)
        output, _ = proc.communicate(timeout=max(1, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signals.SIGKILL)
            proc.communicate()
    sys.stdout.write("".join(f"[21|cli] {ln}\n" for ln in output.splitlines()
                             if ln.startswith(("train_stats", "SIGTERM", "*****"))))
    if not signalled:
        raise AssertionError(f"[21] (c) the CLI ended (rc {proc.returncode}) before the signal "
                             f"landed\n{output[-3000:]}")
    stats = [ln for ln in output.splitlines() if ln.startswith("train_stats ")]
    if proc.returncode != 0 or not stats:
        raise AssertionError(f"[21] (c) preempted CLI: rc {proc.returncode}\n{output[-4000:]}")
    first = json.loads(stats[-1].split(" ", 1)[1])
    with open(counts_path) as f:
        counts = json.load(f)
    _check_counts("(c) preempted CLI", counts)
    runs.append(counts)
    with open(os.path.join(first["checkpoints"][-1], "meta.json")) as f:
        meta = json.load(f)
    if not first["preempted"] or meta.get("preempted") is not True or (
            first["global_step"] >= 4 * CLI_EPOCHS):
        raise AssertionError(f"[21] (c) preempted CLI: stats {first}, meta {meta}")

    rc, stats, counts = _run_cli(argv + ["--resume_from_checkpoint", "latest",
                                         "--keep_last_checkpoints", "1",
                                         "--async_checkpoints", "true"], "train_stats")
    _check_counts("(c) resumed CLI", counts)
    runs.append(counts)
    ckpt_dir = run_dirs["checkpoint"]
    left = sorted(os.listdir(ckpt_dir))
    complete = [d for d in left if ckpt_io.is_complete_checkpoint(os.path.join(ckpt_dir, d))]
    kept = os.path.join(ckpt_dir, left[0]) if left else ""
    if (rc != 0 or stats["global_step"] != 4 * CLI_EPOCHS or stats["preempted"]
            or len(left) != 1 or complete != left
            or not {"optimizer", "history.npz"} <= set(os.listdir(kept))
            or not np.isfinite(stats["loss_mean_epoch"]).all()):
        raise AssertionError(f"[21] (c) resumed CLI: rc {rc}, stats {stats}, left {left}")
    log(f"[21] (c) CLI SIGTERM'd from outside after epoch 0's metrics line: exit 0, "
        f"preemption checkpoint {os.path.basename(first['checkpoints'][-1])} at global_step "
        f"{first['global_step']}; resumed with --keep_last_checkpoints 1 --async_checkpoints "
        f"true to global_step {stats['global_step']} ({len(stats['loss_mean_epoch'])} epoch "
        f"means), left {left} with optimizer/ and history.npz; phase 21 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {k: sum(c[k] for c in runs) for k in runs[0]}


def _run_dirs_of(cfg) -> dict:
    """The run directory's paths the CLI makes for cfg (none made here)."""
    from masked_diffusion_tpu_torch.utils.dirs import Dir

    return Dir(task=cfg.task, content=cfg.content, dir_work=cfg.dir_work,
               dir_dataset=cfg.dir_dataset, data_name=cfg.data_name, data_set=cfg.data_set,
               data_size=cfg.data_size, date=cfg.date, time=cfg.time, method=cfg.method,
               title=cfg.title, make_dirs=False).list_dir


def counted_main(counts_path: str, argv) -> int:
    """The CLI's main(argv) with every launch count set to 0 just before;
    writes the counts to counts_path after it (phase 21's subprocess)."""
    sys.path.insert(0, ROOT)
    from masked_diffusion_tpu_torch.cli.main_train_masked import main

    reset_counts()
    rc = main(argv)
    with open(counts_path, "w") as f:
        json.dump(read_counts(), f)
    return rc


DDP_RANKS = 2
DDP_TIMEOUT = 600  # seconds for one torch.distributed.run of phase 18
DDP_PARITY_BATCH = 4  # global; 2 rows a rank
DDP_EPOCHS = 3  # of 4 steps: epoch 0 warms up, epoch 1 is traced, epoch 2 timed
DDP_STEPS = 4 * DDP_EPOCHS
DDP_T = 20  # --ddpm_num_steps of the CLI runs: 20 reverse steps a cadence, serve and test


def phase_sharded():
    """[18] The data-parallel forms on the card, no process group: every rank
    of an N-rank plan (N = 2, 4) at the flagship shape (global batch 64,
    64x64x3), both select modes, bitwise the single-device kernel call on
    that rank's rows with the folded seed; exact counts per shard; local
    image 0 of ranks 0 and 1 (same count) masked differently. Then each
    form at a 2-rank shard (32 rows) against its plain version on injected
    bits, and timed beside the plain version, with the shard's bound."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.ops.fused_degrade import (
        fused_degrade_update,
        fused_degrade_update_sharded,
        fused_rows,
        philox_fused_bits,
        philox_kmask_bits,
    )
    from masked_diffusion_tpu_torch.ops.kmask import (
        exact_count_masks,
        exact_count_masks_plain,
        exact_count_masks_sharded,
        philox_seed,
    )
    from masked_diffusion_tpu_torch.ops.shard import fold_seed
    from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan

    dev = torch.device("cuda")
    b, c, hw = B_KERNEL, 3, SIZE * SIZE
    rng = np.random.default_rng(18)
    xt = torch.from_numpy(rng.normal(size=(b, c, SIZE, SIZE)).astype(np.float32)).to(dev)
    x0 = torch.from_numpy(rng.normal(size=(b, c, SIZE, SIZE)).astype(np.float32)).to(dev)
    counts = rng.integers(0, hw + 1, size=(2, b)).astype(np.float32)
    counts[:, ::16] = hw // 3  # local image 0 of every rank at N = 2 and 4: one count
    ratios = rng.uniform(0, 1, size=(2, b)).astype(np.float32)
    for n in (2, 4):
        per = b // n
        for select, amounts in (("thresholding", ratios), ("indexing", counts)):
            amt = torch.from_numpy(amounts).to(dev)
            kw = dict(select=select, mean_mode="degraded_area", rule="base_momentum", offset=5)
            masks = []
            for r in range(n):
                rows = slice(r * per, (r + 1) * per)
                out, mask = fused_degrade_update_sharded(
                    xt[rows], x0[rows], amt[0, rows], amt[1, rows],
                    plan=MeshPlan(dev, n, r), batch=b, seed=4242, **kw)
                ref, ref_mask = fused_degrade_update(
                    xt[rows], x0[rows], amt[0, rows], amt[1, rows], seed=fold_seed(4242, r), **kw)
                torch.cuda.synchronize()
                if not (torch.equal(out, ref) and torch.equal(mask, ref_mask)):
                    raise AssertionError(f"[18] fused sharded {select} N={n} rank {r}: not "
                                         "bitwise the per-rank kernel call on the folded seed")
                route = philox_fused_bits(fold_seed(4242, r), 5, per, hw, dev)
                plain_out, plain_mask = fused_rows(
                    route[0], route[1], xt[rows].reshape(per, -1), x0[rows].reshape(per, -1),
                    amt[0, rows][:, None], amt[1, rows][:, None], channels=c,
                    select=select, mean_mode="degraded_area", mean_value=0.0,
                    rule="base_momentum")
                if not torch.equal(mask.reshape(per, hw), plain_mask) or not (
                        (out.reshape(per, -1) - plain_out).abs().max().item() <= FUSED_TOL):
                    raise AssertionError(f"[18] fused sharded {select} N={n} rank {r}: not the "
                                         "plain version on the plain Philox's folded draws")
                if select == "indexing" and not torch.equal(
                        (1.0 - mask).reshape(per, hw).sum(1), amt[1, rows]):
                    raise AssertionError(f"[18] fused sharded N={n} rank {r}: counts != k")
                masks.append(mask)
            if torch.equal(masks[0][0], masks[1][0]):
                raise AssertionError(f"[18] fused sharded {select} N={n}: ranks 0 and 1 gave "
                                     "local image 0 the same mask")
        cnt = torch.from_numpy(counts[0].astype(np.int32)).to(dev)
        seed0 = int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(8)))
        masks = []
        for r in range(n):
            rows = slice(r * per, (r + 1) * per)
            got = exact_count_masks_sharded(b, SIZE, SIZE, cnt[rows], plan=MeshPlan(dev, n, r),
                                            generator=torch.Generator().manual_seed(8))
            # rank 0 draws from the shared generator, rank r from the folded one
            gen_seed = 8 if r == 0 else fold_seed(seed0, r)
            route = philox_kmask_bits(*philox_seed(torch.Generator().manual_seed(gen_seed)),
                                      per, hw, dev)
            ref = exact_count_masks(per, SIZE, SIZE, cnt[rows],
                                    generator=torch.Generator().manual_seed(gen_seed))
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"[18] kmask sharded N={n} rank {r}: not bitwise the "
                                     "per-rank kernel call on the folded seed")
            if not torch.equal(got, exact_count_masks_plain(route, cnt[rows]).reshape(got.shape)):
                raise AssertionError(f"[18] kmask sharded N={n} rank {r}: not the plain "
                                     "version on the plain Philox's folded draws")
            if not torch.equal((1.0 - got).reshape(per, hw).sum(1).int(), cnt[rows]):
                raise AssertionError(f"[18] kmask sharded N={n} rank {r}: counts != k")
            masks.append(got)
        if torch.equal(masks[0][0], masks[1][0]):
            raise AssertionError(f"[18] kmask sharded N={n}: ranks 0 and 1 gave local image 0 "
                                 "the same mask")
    log(f"[18] sharded forms at N = 2 and 4, global batch {b} at {SIZE}x{SIZE}x{c}, "
        "thresholding and indexing: every rank bitwise the single-device kernel on its rows "
        "with the folded seed, and the plain version on the plain Philox's draws at that "
        "seed; exact counts per shard; local image 0 of ranks 0 and 1 masked differently")

    # a 2-rank shard: against the plain version on injected bits, then timed
    per, plan = b // DDP_RANKS, MeshPlan(dev, DDP_RANKS, 1)
    rows = slice(per, 2 * per)
    bits = torch.from_numpy(rng.integers(0, 2**32, size=(2, per, hw), dtype=np.uint64)
                            .astype(np.int64)).to(dev)
    amt = torch.from_numpy(counts).to(dev)[:, rows]
    kw = dict(select="indexing", mean_mode="degraded_area", mean_value=0.0, rule="base_momentum")
    out, mask = fused_degrade_update_sharded(xt[rows], x0[rows], amt[0], amt[1], plan=plan,
                                             batch=b, bits=bits, **kw)
    ref, ref_mask = fused_rows(bits[0], bits[1], xt[rows].reshape(per, -1),
                               x0[rows].reshape(per, -1), amt[0][:, None], amt[1][:, None],
                               channels=c, **kw)
    fused_err = (out.reshape(per, -1) - ref).abs().max().item()
    if not torch.equal(mask.reshape(per, hw), ref_mask) or not fused_err <= FUSED_TOL:
        raise AssertionError(f"[18] fused sharded vs plain: masks or |out - plain| {fused_err}")
    cnt = amt[0].to(torch.int32)
    got = exact_count_masks_sharded(b, SIZE, SIZE, cnt, plan=plan, bits=bits[0])
    kmask_err = (got - exact_count_masks_plain(bits[0], cnt).reshape(got.shape)).abs().max().item()
    if kmask_err != 0.0:
        raise AssertionError(f"[18] kmask sharded vs plain: max |mask - plain| {kmask_err}")
    gen = torch.Generator().manual_seed(9)

    def fused():
        fused_degrade_update_sharded(xt[rows], x0[rows], amt[0], amt[1], plan=plan, batch=b,
                                     seed=7, offset=1, **kw)

    def fused_plain():
        bb = torch.randint(0, 2**32, (2, per, hw), device=dev, dtype=torch.int64)
        fused_rows(bb[0], bb[1], xt[rows].reshape(per, -1), x0[rows].reshape(per, -1),
                   amt[0][:, None], amt[1][:, None], channels=c, **kw)

    def kmask():
        exact_count_masks_sharded(b, SIZE, SIZE, cnt, plan=plan, generator=gen)

    def kmask_plain():
        bb = torch.randint(0, 2**32, (per, hw), device=dev, dtype=torch.int64)
        exact_count_masks_plain(bb, cnt)

    (f_ms, f_eager), (fp_ms, _) = cuda_ms(fused), cuda_ms(fused_plain)
    (k_ms, k_eager), (kp_ms, _) = cuda_ms(kmask), cuda_ms(kmask_plain)
    # the shard's work, counted as phases 2 and 6 count the whole batch's
    f_bound, k_bound = fused_bound(per, c, hw), kmask_bound(per, hw)
    log(f"[18] per-rank shard of {per} rows at {SIZE}x{SIZE}: fused_degrade_update_sharded "
        f"(indexing) {f_ms:.4f} ms device ({f_eager:.4f} eager), plain {fp_ms:.4f} ms, bound "
        f"{f_bound[0]:.5f} ms by {f_bound[1]}, max |out - plain| {fused_err:.3g}; "
        f"exact_count_masks_sharded {k_ms:.4f} ms device ({k_eager:.4f} eager), plain "
        f"{kp_ms:.4f} ms, bound {k_bound[0]:.5f} ms by {k_bound[1]}, max |mask - plain| "
        f"{kmask_err}")
    return {"fused": (fused_err, f_ms, fp_ms, f_bound), "kmask": (kmask_err, k_ms, kp_ms, k_bound)}


def _parity_data(used_len: int):
    """The global batch and draws of phase 18's parity steps (numpy, seeded)."""
    import numpy as np

    rng = np.random.default_rng(181)
    n, hw = DDP_PARITY_BATCH, SIZE * SIZE
    return [dict(
        img=rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32),
        timeindex=rng.integers(0, used_len, n),
        bits=rng.integers(0, 2**32, (n, hw), dtype=np.uint64).astype(np.int64),
        uniform=rng.uniform(-1, 1, n).astype(np.float32)) for _ in range(3)]


def parity_steps(plan, dev):
    """3 fp32 flagship train steps (TF32 off, log + indexing, AdamW, EMA) on
    phase 18's global batch on `dev`, this plan's rows (None: one process,
    all rows). Returns (losses, {name: parameter and EMA tensors on the
    CPU})."""
    import torch

    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.parallel.mesh import local_rows
    from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from masked_diffusion_tpu_torch.train.step import (
        TrainDraws,
        create_train_state,
        make_train_step,
    )
    from masked_diffusion_tpu_torch.utils import host

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sched, select, t_steps = MODES[1]
    cfg = _train_cfg(sched, select, t_steps, "--mixed_precision", "no")
    schedule = build_schedule(sched, t_steps, SIZE, select)
    used = schedule.timesteps_for_epoch(0, 10, 1)
    model = _flagship_weights(8).to(dev)
    lr = build_lr_schedule("cosine", 1e-4, 0, 100)
    opt = build_optimizer("adamw", model.parameters(), lr, 1.0, 1)
    state = create_train_state(model, opt, use_ema=True, plan=plan)
    step = make_train_step(model, schedule, cfg, opt, used, lr, device=dev, plan=plan)
    rows = local_rows(DDP_PARITY_BATCH, plan) if plan is not None else slice(None)
    losses = []
    for d in _parity_data(len(used)):
        draws = TrainDraws(**{k: torch.from_numpy(v).to(dev) for k, v in d.items() if k != "img"})
        losses.append(step(state, torch.from_numpy(d["img"][rows]).to(dev),
                           draws=draws)["train_loss"])
    # each rank's loss is its rows'; the global batch's is their mean, as the
    # trainer logs it
    losses = host.mean_over_ranks(torch.stack(losses)).tolist()
    tensors = {**{f"p.{k}": v.detach().cpu() for k, v in model.state_dict().items()},
               **{f"e.{k}": v.detach().cpu() for k, v in state.ema_model.state_dict().items()}}
    torch.backends.cudnn.allow_tf32 = True
    return losses, tensors


def _checksum(tensors: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode() + tensors[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_main(workdir: str) -> int:
    """One rank of phase 18 under torch.distributed.run: the parity steps,
    then the flagship through the CLI data-parallel (train, serve what it
    wrote, and --method test on it), each with the launch counts set to 0
    just before and read just after; writes rank<r>.json (and rank 0 its
    parity tensors) to workdir."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import masked_diffusion_tpu_torch.sample.generate as generate_mod
    import masked_diffusion_tpu_torch.tester as tester_mod
    import masked_diffusion_tpu_torch.train.trainer as trainer_mod
    from masked_diffusion_tpu_torch.cli.main_train_masked import main
    from masked_diffusion_tpu_torch.parallel.mesh import init_distributed, make_mesh

    # a card for each rank where the machine has them, else both ask for cuda:0
    device_arg = "cuda" if torch.cuda.device_count() >= DDP_RANKS else "cuda:0"
    device = init_distributed(device_arg)
    plan = make_mesh(DDP_RANKS, 1, device)
    out = {"rank": plan.rank, "device": str(device), "backend": dist.get_backend()}
    losses, tensors = parity_steps(plan, device)
    out["parity"] = {"losses": losses, "checksum": _checksum(tensors)}
    if plan.rank == 0:
        torch.save(tensors, os.path.join(workdir, "parity_rank0.pt"))

    seen = {}
    train, generate = trainer_mod.Trainer.train, generate_mod.generate_images

    def train_and_keep(self, *a, **k):
        seen["trainer"], seen["train"] = self, train(self, *a, **k)
        return seen["train"]

    def generate_and_keep(*a, **k):
        seen["generate"] = generate(*a, **k)
        return seen["generate"]

    run_tester = tester_mod.Tester.run

    def run_and_keep(self, *a, **k):
        seen["test"], seen["test_steps"] = run_tester(self, *a, **k), len(self.timesteps_used_epoch)
        return seen["test"]

    writes = {"n": 0}

    def counted(write):
        def wrapper(*a, **k):
            writes["n"] += 1
            return write(*a, **k)
        return wrapper

    trainer_mod.Trainer.train = train_and_keep
    generate_mod.generate_images = generate_and_keep
    tester_mod.Tester.run = run_and_keep
    tester_mod.save_image_grid = counted(tester_mod.save_image_grid)
    tester_mod.save_png = counted(tester_mod.save_png)
    argv, common = flagship_cli_args(os.path.join(workdir, "ddp"))
    argv, common = ([device_arg if a == "cuda" else a
                     for a in _with(args, "--ddpm_num_steps", str(DDP_T))]
                    for args in (argv, common))
    # 3 epochs, the cadence at the last; --profile_dir traces epoch 1 on
    # every rank, and the rates come from epoch 2
    argv = _with(argv, "--mesh_data", str(DDP_RANKS), "--num_epochs", str(DDP_EPOCHS),
                 "--save_images_epochs", str(DDP_EPOCHS), "--profile_dir",
                 os.path.join(workdir, "prof"))
    for what, args in (("train", argv), ("serve", None), ("test", None)):
        if what != "train":
            # the tester's target: one round reaches it (phase 22c)
            args = ["--method", "sample" if what == "serve" else "test", "--test_model_path",
                    out["checkpoints"][0], "--mesh_data", str(DDP_RANKS), "--dir_work",
                    os.path.join(workdir, "ddp", what), *common,
                    *(["--data_subset_num", "1"] if what == "test" else [])]
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = main(args)
        out[f"{what}_counts"] = read_counts()
        sys.stdout.write(buf.getvalue())
        if rc != 0:
            raise AssertionError(f"rank {plan.rank} {what}: rc {rc}")
        if what == "train":
            trainer, result = seen["trainer"], seen["train"]
            model = {f"p.{k}": v.detach().cpu() for k, v in trainer.model.state_dict().items()}
            model.update({f"e.{k}": v.detach().cpu()
                          for k, v in trainer.state.ema_model.state_dict().items()})
            out.update(checksum=_checksum(model), global_step=trainer.global_step,
                       cadence_steps=len(trainer.timesteps_used_epoch),
                       checkpoints=result["checkpoints"], train_ms=result["ms_per_step"],
                       train_ips=result["images_per_sec"])
        elif what == "test":
            t = seen["test"]
            out.update(test_rounds=t["rounds"], test_unique=len(t["unique_images"]),
                       test_history=t["num_unique_history"], test_steps=seen["test_steps"],
                       test_writes=writes["n"])
        else:
            g = seen["generate"]
            out.update(serve_ms=g["ms_per_step"], serve_ips=g["images_per_sec"],
                       serve_steps=g["steps"], serve_batches=g["batches"],
                       serve_images=len(g["images"]),
                       serve_finite=bool(torch.isfinite(torch.from_numpy(g["images"])).all()))
    with open(os.path.join(workdir, f"rank{plan.rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _run_group(cmd, timeout: int, env=None):
    """Run cmd in a session of its own (in `env`, default this process's);
    on timeout kill the whole session (torch.distributed.run and its
    ranks). Returns (rc, stdout + stderr)."""
    import signal

    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True, env=env)
    try:
        output, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        output, _ = proc.communicate()
        raise AssertionError(f"{' '.join(cmd[:6])} ...: no end in {timeout} s\n{output[-4000:]}")
    except BaseException:  # a worker lane stopped from outside: its ranks go too
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    return proc.returncode, output


def phase_ddp(workdir: str, smi: str, single: dict):
    """[18] Data-parallel on 2 ranks through torch.distributed.run (nccl when
    the machine has two cards, else gloo with both ranks on cuda:0): the
    parity steps against one process on the same global batch (phase 8's
    tolerances), then the flagship CLI trained (phase 10's flags at
    T=DDP_T plus --mesh_data 2 and --profile_dir: global batch 64, 3 epochs
    of 4 steps)
    and served on 2 ranks. Checks the dist line, the per-rank launches (one
    sharded exact-k launch per train step, one sharded fused launch per
    reverse step), bitwise-equal ranks, global_step 12, one run tree, one
    trace a rank of epoch 1, whose idle share and all-reduce time it prints.
    Returns the launches summed over the ranks and both runs."""
    import numpy as np
    import torch

    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    rc, output = _run_group(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(DDP_RANKS), os.path.join(ROOT, "chip_smoke.py"), "--rank", workdir], DDP_TIMEOUT)
    seconds = time.perf_counter() - t0
    sys.stdout.write("".join(f"[18|ranks] {ln}\n" for ln in output.splitlines()
                             if ln.startswith(("dist:", "train_stats", "sample_stats",
                                               "test_stats", "sampled", "*****"))))
    if rc != 0:
        raise AssertionError(f"[18] torch.distributed.run: rc {rc}\n{output[-6000:]}")
    ranks = []
    for r in range(DDP_RANKS):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    dist_lines = [ln for ln in output.splitlines() if ln.startswith("dist: ")]
    if len(dist_lines) != 1:
        raise AssertionError(f"[18] expected one dist: line, got {dist_lines}")
    dist_info = json.loads(dist_lines[0][len("dist: "):])
    own = torch.cuda.device_count() >= DDP_RANKS
    want_devices = [f"cuda:{r}" for r in range(DDP_RANKS)] if own else ["cuda:0"] * DDP_RANKS
    if (dist_info["backend"] != ("nccl" if own else "gloo") or dist_info["world_size"] != DDP_RANKS
            or dist_info["devices"] != want_devices):
        raise AssertionError(f"[18] dist line {dist_info}, expected backend "
                             f"{'nccl' if own else 'gloo'} on {want_devices}")

    # parity: 2 ranks vs one process on the same global batch, fp32, TF32 off
    one_losses, one = parity_steps(None, torch.device("cuda"))
    two = torch.load(os.path.join(workdir, "parity_rank0.pt"))
    lt, lo = np.array(ranks[0]["parity"]["losses"]), np.array(one_losses)
    if ranks[0]["parity"] != ranks[1]["parity"]:
        raise AssertionError(f"[18] parity: the ranks differ: {ranks[0]['parity']} vs "
                             f"{ranks[1]['parity']}")
    init = _flagship_weights(8).state_dict()
    errs = []
    for prefix in ("p.", "e."):
        diff2 = upd2 = 0.0
        for k, ref in one.items():
            if k.startswith(prefix):
                diff2 += float((two[k] - ref).square().sum())
                upd2 += float((ref - init[k[2:]]).square().sum())
        errs.append((diff2 / upd2) ** 0.5)
    loss_diff = float(np.abs((lt - lo) / lo).max())
    if not (np.isfinite(lt).all() and loss_diff <= TRAIN_LOSS_RTOL
            and max(errs) <= TRAIN_UPDATE_RTOL):
        raise AssertionError(f"[18] parity: losses 2 ranks {lt} vs 1 {lo}, update rel L2 "
                             f"{errs}")
    log(f"[18] parity, flagship fp32 (TF32 off), log+indexing, global batch "
        f"{DDP_PARITY_BATCH}, 3 AdamW steps: 2 ranks ({dist_info['backend']}) vs 1 process, "
        f"losses {[round(float(v), 6) for v in lo]}, max rel diff {loss_diff:.3g} (rtol "
        f"{TRAIN_LOSS_RTOL}); update rel L2 diff params {errs[0]:.3g}, EMA {errs[1]:.3g} (tol "
        f"{TRAIN_UPDATE_RTOL}); ranks bitwise equal (checksum "
        f"{ranks[0]['parity']['checksum'][:16]})")

    # the CLI runs, per rank
    total = {}
    for rank in ranks:
        tc, sc = rank["train_counts"], rank["serve_counts"]
        reverse = rank["cadence_steps"]  # one cadence sample, at the last epoch
        n_serve = rank["serve_steps"] * rank["serve_batches"]
        # a launch a train step, and one for the cadence's visuals pass
        want_train = {"exact_count_masks": DDP_STEPS + 1,
                      "exact_count_masks_sharded": DDP_STEPS + 1,
                      "fused_degrade_update": reverse, "fused_degrade_update_sharded": reverse,
                      "tinyhead_attention": 0, "tinyhead_attention_backward": 0}
        want_serve = {"exact_count_masks": 0, "exact_count_masks_sharded": 0,
                      "fused_degrade_update": n_serve, "fused_degrade_update_sharded": n_serve,
                      "group_norm_silu_backward": 0}
        if (any(tc[k] != n for k, n in want_train.items()) or not tc["group_norm_silu"]
                or not tc["group_norm_silu_backward"]
                or any(sc[k] != n for k, n in want_serve.items()) or not sc["group_norm_silu"]):
            raise AssertionError(f"[18] rank {rank['rank']}: launches train {tc}, serve {sc}; "
                                 f"expected {want_train}, {want_serve}")
        if (rank["global_step"] != DDP_STEPS or rank["serve_images"] != 16
                or not rank["serve_finite"]):
            raise AssertionError(f"[18] rank {rank['rank']}: {rank}")
        xc, n_test = rank["test_counts"], rank["test_rounds"] * rank["test_steps"]
        want_test = {"fused_degrade_update": n_test, "fused_degrade_update_sharded": n_test,
                     "exact_count_masks": 0, "group_norm_silu_backward": 0}
        if any(xc[k] != n for k, n in want_test.items()) or not xc["group_norm_silu"]:
            raise AssertionError(f"[18] rank {rank['rank']}: --method test launches {xc}, "
                                 f"expected {want_test}")
        for counts in (tc, sc, xc):
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
    if ranks[0]["checksum"] != ranks[1]["checksum"] or (
            ranks[0]["checkpoints"] != ranks[1]["checkpoints"]):
        raise AssertionError(f"[18] the ranks' final parameters or checkpoints differ: "
                             f"{[(r['checksum'][:16], r['checkpoints']) for r in ranks]}")
    runs = os.listdir(os.path.join(workdir, "ddp", "train", "result", "test_code", "synthetic",
                                   "mean_shift"))
    stats = json.loads(next(ln for ln in output.splitlines() if ln.startswith("train_stats "))
                       .split(" ", 1)[1])
    served = json.loads(next(ln for ln in output.splitlines() if ln.startswith("sample_stats "))
                        .split(" ", 1)[1])
    pngs = [f for f in os.listdir(served["out_dir"]) if f.endswith(".png")]
    if (len(runs) != 1 or stats["global_step"] != DDP_STEPS or stats["ranks"] != DDP_RANKS
            or len(pngs) != 16 + served["batches"]):
        raise AssertionError(f"[18] run trees {runs}, train_stats {stats}, {len(pngs)} PNGs")
    # --method test: the ranks leave in the same round with the same count;
    # only rank 0 writes and prints
    tested = [ln for ln in output.splitlines() if ln.startswith("test_stats ")]
    agreed = [(r["test_rounds"], r["test_unique"], r["test_history"]) for r in ranks]
    if (len(tested) != 1 or agreed[0] != agreed[1] or not ranks[0]["test_writes"]
            or ranks[1]["test_writes"]):
        raise AssertionError(f"[18] --method test on {DDP_RANKS} ranks: rounds, unique, "
                             f"history {agreed}, writes {[r['test_writes'] for r in ranks]}, "
                             f"{len(tested)} test_stats lines")
    tstats = json.loads(tested[0].split(" ", 1)[1])
    backend = f"{dist_info['backend']}, {dist_info['cards']}"
    # --profile_dir: each rank traced epoch 1 of the CLI run
    prof = os.path.join(workdir, "prof")
    traces = sorted(os.listdir(prof))
    readings = [_trace_reading(os.path.join(prof, f"trace_rank{r}.json"))
                for r in range(DDP_RANKS)]
    want_steps = [(1, i) for i in range(DDP_STEPS // DDP_EPOCHS)]
    if traces != [f"trace_rank{r}.json" for r in range(DDP_RANKS)] or any(
            steps != want_steps for steps, _, _ in readings):
        raise AssertionError(f"[18] --profile_dir: files {traces}, traced steps "
                             f"{[r[0] for r in readings]}, expected {want_steps} on every rank")
    per_rank = []
    for r, (_, _, summary) in enumerate(readings):
        if own:  # NCCL's all-reduce kernels on each rank's card
            reduce = [v for k, v in summary["collectives_device_ms"].items()
                      if "allreduce" in k.lower()]
        else:  # gloo's all-reduce on the host, enqueue to completion
            reduce = [v for k, v in summary["collectives_host_ms"].items()
                      if "all_reduce" in k]
        ms, calls = sum(v["ms"] for v in reduce), sum(v["calls"] for v in reduce)
        if not calls:
            raise AssertionError(f"[18] rank {r}: no all-reduce in the trace: {summary}")
        # gloo's buckets queue behind each other: their spans overlap, so the
        # time with one in flight is the reading; NCCL's kernels serialize
        flight = ms if own else sum(v["in_flight_ms"] for v in reduce)
        per_rank.append(f"rank {r}: window {summary['wall_ms']:.3f} ms wall, device busy "
                        f"{summary['device_busy_ms']:.3f} ms, idle share "
                        f"{summary['device_idle_share']:.4f}, all-reduce in flight "
                        f"{flight:.3f} ms ({flight / len(want_steps):.3f} ms a step; {calls} "
                        f"calls summing {ms:.3f} ms)")
    log(f"[18] --profile_dir on {DDP_RANKS} ranks, epoch 1 ({len(want_steps)} steps), the "
        f"all-reduce read as "
        + ("NCCL kernels' device ms (one card a rank)" if own else
           "gloo's host ms (both ranks on cuda:0)") + "; " + "; ".join(per_rank))
    log(f"[18] train CLI on {DDP_RANKS} ranks ({backend}; {smi}): global batch 64 (32 a "
        f"rank), {DDP_EPOCHS} epochs x 4 steps, global_step {DDP_STEPS} on every rank, final "
        f"parameters and EMA bitwise equal across ranks (checksum "
        f"{ranks[0]['checksum'][:16]}); ms/step per rank (epoch 2, untraced) "
        f"{[round(r['train_ms'], 3) for r in ranks]}, {ranks[0]['train_ips']:.2f} images/s "
        f"global (one process, phase 10: {single['train_ms']:.3f} ms/step, "
        f"{single['train_ips']:.2f} images/s); per rank per train step 1 exact_count_masks_"
        f"sharded launch (and 1 for the visuals pass), per reverse step 1 "
        f"fused_degrade_update_sharded launch; launches "
        f"per rank {[r['train_counts'] for r in ranks]}")
    log(f"[18] served the 2-rank checkpoint on {DDP_RANKS} ranks: {served['images']} images "
        f"(8 a rank), {served['steps']} steps x {served['batches']} batch(es); ms/step per rank "
        f"{[round(r['serve_ms'], 3) for r in ranks]}, {ranks[0]['serve_ips']:.3f} images/s "
        f"global (one process, phase 10: {single['serve_ms']:.3f} ms/step, "
        f"{single['serve_ips']:.3f} images/s); {len(pngs)} PNGs written once")
    log(f"[18] --method test on the 2-rank checkpoint on {DDP_RANKS} ranks: both ranks left "
        f"after {agreed[0][0]} round(s) with {agreed[0][1]} unique (history {agreed[0][2]}), "
        f"{tstats['ms_per_step']:.3f} ms a reverse step, {tstats['images_per_sec']:.2f} images/s; "
        f"image writes rank 0 {ranks[0]['test_writes']}, rank 1 {ranks[1]['test_writes']}; "
        f"launches per rank {[r['test_counts'] for r in ranks]}; phase 18's ranks took "
        f"{seconds:.1f} s")
    return total


# [27] tensor and spatial parallelism: 2 ranks sharing the card over gloo
GRID_RANKS = 2  # data 1 x model 2
GRID_TIMEOUT = 900  # seconds for the torch.distributed.run of phase 27
GRID_BATCH = 8  # every rank holds all 8 rows (one data rank)
GRID_LOSS_RTOL = 1e-4  # tests/test_torch_port_parallel.py's
# The last step's clipped gradient, grid vs one process, relative L2: the
# gathers, halos and split statistics change no term, but cuDNN picks other
# algorithms for the ranks' convolutions (half the output channels under TP,
# half the rows under SP), which sum in another order
GRID_GRAD_RTOL = 1e-4
# Parameters and EMA after 2 AdamW steps, relative L2 of the update. AdamW's
# first steps move a coordinate by about lr * g / (|g| + eps), so among 113.7M
# coordinates those whose gradient nearly cancels turn the convolutions'
# summation-order noise into moves up to lr: the CPU tests' elementwise atol
# of 2e-5 (a toy model) is reported here beside the bound, not asserted
GRID_UPDATE_RTOL = 1e-3
# ... and no coordinate further apart than AdamW can move two runs apart in
# 2 steps: at most ~1 lr in the first step and ~1.4 lr in the second each
GRID_MOVE_BOUND = 5
GRID_UNET6_BATCH = 2
GRID_SAMPLE_NUM = 4
GRID_T = 8  # the CLI runs' --ddpm_num_steps (log + indexing; 20 before phase 29)


def _grid_data(used_len: int):
    """The global batch and draws of phase 27's parity steps (numpy, seeded)."""
    import numpy as np

    rng = np.random.default_rng(271)
    n, hw = GRID_BATCH, SIZE * SIZE
    return [dict(
        img=rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32),
        timeindex=rng.integers(0, used_len, n),
        bits=rng.integers(0, 2**32, (n, hw), dtype=np.uint64).astype(np.int64),
        uniform=rng.uniform(-1, 1, n).astype(np.float32)) for _ in range(2)]


def grid_parity(plan, dev):
    """2 fp32 flagship train steps (TF32 off, log + indexing, AdamW, EMA) at
    batch 8 on `dev`, the model placed on `plan`'s model axis (None: one
    process). Returns the losses, each step's ms (host clock, synchronised),
    the peak device memory above what was allocated before, the bytes of
    parameters + AdamW state + EMA this process holds, the flagship's
    sharded_fraction at M = 2, and on the CPU the one-process layout of the
    parameters ("p"), EMA ("e") and the last step's clipped gradient ("g")."""
    import torch

    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.parallel import tp as tp_mod
    from masked_diffusion_tpu_torch.parallel.mesh import place_model
    from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from masked_diffusion_tpu_torch.train.step import (
        TrainDraws,
        create_train_state,
        make_train_step,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sched, select, t_steps = MODES[1]
    cfg = _train_cfg(sched, select, t_steps, "--mixed_precision", "no")
    schedule = build_schedule(sched, t_steps, SIZE, select)
    used = schedule.timesteps_for_epoch(0, 10, 1)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = _flagship_weights(27).to(dev)
    fraction = tp_mod.sharded_fraction(model.state_dict().values(), GRID_RANKS,
                                       cfg.tp_min_features)
    if plan is not None:
        place_model(model, plan, cfg.tp_min_features)
    names, params = zip(*model.named_parameters())
    lr = build_lr_schedule("cosine", 1e-4, 0, 100)
    opt = build_optimizer("adamw", params, lr, 1.0, 1, names=names)
    if getattr(model, "tp_sharded", ()):
        opt.set_tensor_parallel(model.tp_sharded, plan.model_group)
    state = create_train_state(model, opt, use_ema=True, plan=plan)
    step = make_train_step(model, schedule, cfg, opt, used, lr, device=dev, plan=plan)
    losses, ms = [], []
    for d in _grid_data(len(used)):
        draws = TrainDraws(**{k: torch.from_numpy(v).to(dev) for k, v in d.items() if k != "img"})
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(step(state, torch.from_numpy(d["img"]).to(dev),
                                 draws=draws)["train_loss"]))
        torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated(dev) - base
    moments = [v for s in opt.base.state.values() for v in s.values() if torch.is_tensor(v)]
    held = sum(t.numel() * t.element_size()
               for t in (*params, *moments, *state.ema_model.parameters()))

    def whole(sd):
        sd = tp_mod.gather_state(sd, model, plan) if plan is not None else sd
        return {k: v.detach().cpu().clone() for k, v in sd.items()}

    out = {"losses": losses, "ms": ms, "peak": peak, "held": held, "fraction": fraction,
           "p": whole(model.state_dict()), "e": whole(state.ema_model.state_dict()),
           "g": whole({n: p.grad for n, p in zip(names, params)})}
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    return out


def grid_unet6_peak(plan, dev, size: int = 256) -> dict:
    """One bf16 forward and backward of unet6 at size x size (256), batch 2,
    placed on `plan` (None: one process): the peak device memory above the
    weights, the output's finiteness and the ms (host clock, synchronised)."""
    import torch

    from masked_diffusion_tpu_torch.models.zoo import Model
    from masked_diffusion_tpu_torch.parallel.mesh import place_model

    torch.manual_seed(6)
    model = Model("unet6", 3, size, size, 3).to(dev)
    if plan is not None:
        place_model(model, plan)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(GRID_UNET6_BATCH, 3, size, size, generator=gen, device=dev)
    t = torch.full((GRID_UNET6_BATCH,), 10.0, device=dev)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = model(x, t)
    out.float().square().mean().backward()
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    return {"peak": torch.cuda.max_memory_allocated(dev) - base, "ms": ms,
            "finite": bool(torch.isfinite(out).all()), "shape": list(out.shape)}


def grid_collective_ms(plan, dev) -> dict:
    """ms of the model group's all-gather (along channels) and all-reduce of
    a (8, 512, 8, 8) fp32 activation on the card: under gloo both go
    through host memory."""
    import torch

    from masked_diffusion_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_sum

    x = torch.randn(8, 512, 8, 8, device=dev)
    out = {}
    for name, fn in (("all_gather", lambda: all_gather_rows(x, 1, plan.model_group,
                                                            plan.model_size)),
                     ("all_reduce", lambda: all_reduce_sum(x, plan.model_group))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize(dev)
        out[name] = 1e3 * (time.perf_counter() - t0) / 20
    return out


def grid_cli_args(workdir: str, mode: str):
    """(training argv, flags shared with serving) of the flagship through the
    CLI on phase 27's grid: batch 8, one epoch of 2 steps, the cadence's
    fused sampler at T=8, --mesh_model 2 (and --mesh_spatial true for SP),
    both ranks on cuda:0."""
    argv, common = flagship_cli_args(os.path.join(workdir, mode))
    pairs = ("--batch_size", "8", "--data_subset_num", "16", "--sample_num",
             str(GRID_SAMPLE_NUM), "--ddpm_num_steps", str(GRID_T))
    common = _with([a if a != "cuda" else "cuda:0" for a in common], *pairs)
    argv = _with([a if a != "cuda" else "cuda:0" for a in argv], *pairs, "--num_epochs", "1",
                 "--save_images_epochs", "1", "--mesh_data", "1", "--mesh_model",
                 str(GRID_RANKS), "--mesh_spatial", str(mode == "sp"))
    return argv, common


def grid_rank_main(workdir: str) -> int:
    """One rank of phase 27 under torch.distributed.run: the TP and SP
    parity steps, the unet6 forward and backward under SP, the collectives'
    times, then the flagship through the CLI with --mesh_model 2 and with
    --mesh_spatial true, each CLI run with the launch counts set to 0 just
    before and read just after; writes grid_rank<r>.json (and rank 0 its
    parity tensors) to workdir."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import masked_diffusion_tpu_torch.train.trainer as trainer_mod
    from masked_diffusion_tpu_torch.cli.main_train_masked import main
    from masked_diffusion_tpu_torch.parallel.mesh import init_distributed, make_mesh

    device = init_distributed("cuda:0")
    rank = dist.get_rank()
    out = {"rank": rank, "device": str(device), "backend": dist.get_backend(), "seconds": {}}
    t_part = time.perf_counter()

    def part_done(name):  # the seconds of each part of the rank's work
        nonlocal t_part
        out["seconds"][name] = round(time.perf_counter() - t_part, 1)
        t_part = time.perf_counter()

    for mode in ("tp", "sp"):
        plan = make_mesh(1, GRID_RANKS, device, spatial=mode == "sp")
        reset_counts()
        res = grid_parity(plan, device)
        res["launches"] = read_counts()
        tensors = {k: res.pop(k) for k in ("p", "e", "g")}
        if rank == 0:
            torch.save(tensors, os.path.join(workdir, f"{mode}_rank0.pt"))
        del tensors
        out[mode] = res
        _release()
        part_done(f"{mode} parity")
    plan = make_mesh(1, GRID_RANKS, device, spatial=True)
    reset_counts()
    out["unet6"] = grid_unet6_peak(plan, device)
    out["unet6"]["launches"] = read_counts()
    _release()
    out["collectives"] = grid_collective_ms(plan, device)
    part_done("unet6 and collectives")

    seen = {}
    train = trainer_mod.Trainer.train

    def train_and_keep(self, *a, **k):
        seen["steps"] = None
        result = train(self, *a, **k)
        seen["steps"] = len(self.timesteps_used_epoch)
        return result

    trainer_mod.Trainer.train = train_and_keep
    for mode in ("tp", "sp"):
        argv, _ = grid_cli_args(workdir, mode)
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        counts = read_counts()
        sys.stdout.write(buf.getvalue())
        if rc != 0:
            raise AssertionError(f"[27] rank {rank} CLI {mode}: rc {rc}")
        out[f"cli_{mode}"] = {"counts": counts, "cadence_steps": seen["steps"]}
        _release()
        part_done(f"CLI {mode}")
    with open(os.path.join(workdir, f"grid_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _rel(a: dict, b: dict, base: dict = None) -> float:
    """Relative L2 of a against b over every tensor; with base, of the
    updates a - base against b - base."""
    num = den = 0.0
    for k, ref in b.items():
        num += float((a[k].double() - ref.double()).square().sum())
        d = ref.double() - (base[k].double() if base is not None else 0.0)
        den += float(d.square().sum())
    return (num / den) ** 0.5


def phase_grid(workdir: str, smi: str) -> dict:
    """[27] Tensor and spatial parallelism on 2 ranks sharing cuda:0 over
    gloo (data 1 x model 2) through torch.distributed.run (this script with
    `--grid <dir>`): (a) TP and (b) SP parity steps at the flagship's width
    against one process on the card, each rank's bytes of state and peak
    memory; unet6 at 256x256 under SP, each rank's peak memory above the
    weights against one process; the gloo collectives' ms; (c) the flagship
    trained through the CLI with --mesh_model 2 and with --mesh_spatial
    true (one epoch of 2 steps and the cadence's sampler), each checkpoint
    served by one process with --method sample. Checks per-rank launches
    and returns them summed over the ranks, with the serves'."""
    import numpy as np
    import torch

    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    rc, output = _run_group(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(GRID_RANKS), os.path.join(ROOT, "chip_smoke.py"), "--grid", workdir], GRID_TIMEOUT)
    seconds = time.perf_counter() - t0
    sys.stdout.write("".join(f"[27|ranks] {ln}\n" for ln in output.splitlines()
                             if ln.startswith(("dist:", "sp:", "train_stats", "*****"))))
    if rc != 0:
        raise AssertionError(f"[27] torch.distributed.run: rc {rc}\n{output[-6000:]}")
    ranks = []
    for r in range(GRID_RANKS):
        with open(os.path.join(workdir, f"grid_rank{r}.json")) as f:
            ranks.append(json.load(f))
    sp_lines = [json.loads(ln[4:]) for ln in output.splitlines() if ln.startswith("sp: ")]
    if not sp_lines or not all(all(lv["split"] for lv in ln["levels"]) for ln in sp_lines):
        raise AssertionError(f"[27] expected every level split at M = 2: {sp_lines}")

    # (a), (b): the grid's parity steps against one process on the card
    one = grid_parity(None, torch.device("cuda"))
    init = _flagship_weights(27).state_dict()
    lr = 1e-4
    readings = {}
    for mode in ("tp", "sp"):
        got = torch.load(os.path.join(workdir, f"{mode}_rank0.pt"))
        losses = [r[mode]["losses"] for r in ranks]
        loss_diff = float(np.abs(np.array(losses[0]) / np.array(one["losses"]) - 1).max())
        grad = _rel(got["g"], one["g"])
        upd = [_rel(got[k], one[k], init) for k in ("p", "e")]
        worst = max(float((got[k][n] - one[k][n]).abs().max()) for k in ("p", "e")
                    for n in one[k])
        above = sum(int(((got[k][n] - one[k][n]).abs() > 2e-5).sum()) for k in ("p", "e")
                    for n in one[k])
        if (losses[0] != losses[1] or loss_diff > GRID_LOSS_RTOL or grad > GRID_GRAD_RTOL
                or max(upd) > GRID_UPDATE_RTOL or worst > GRID_MOVE_BOUND * lr):
            raise AssertionError(
                f"[27] {mode} parity: losses {losses} vs {one['losses']} (rel {loss_diff:.3g}), "
                f"gradient rel L2 {grad:.3g}, update rel L2 params/EMA {upd}, max |diff| "
                f"{worst:.3g} ({above} entries above 2e-5)")
        readings[mode] = (loss_diff, grad, upd, worst, above)
        # SP: the split pair on every split norm, kernel 2 whole on the attention
        # blocks' norms, a forward and a backward a step; TP: no split launch
        steps = len(one["losses"])
        want = ({"group_norm_split": steps * SP_SPLIT_NORMS,
                 "group_norm_split_backward": steps * SP_SPLIT_NORMS,
                 "group_norm_silu": steps * SP_WHOLE_NORMS,
                 "group_norm_silu_backward": steps * SP_WHOLE_NORMS} if mode == "sp" else
                {"group_norm_split": 0, "group_norm_split_backward": 0})
        for r in ranks:
            n = r[mode]["launches"]
            if any(n[k] != v for k, v in want.items()) or not (
                    n["group_norm_silu"] and n["group_norm_silu_backward"]) or any(
                    n[k] for k in ("tinyhead_attention", "tinyhead_attention_backward")):
                raise AssertionError(f"[27] {mode} parity launches rank {r['rank']}: {n}, "
                                     f"expected {want}")
    tp_held = [r["tp"]["held"] for r in ranks]
    frac = one["fraction"]
    expect = one["held"] * (1 - frac / 2)
    if any(abs(h - expect) > 1e-6 * one["held"] for h in tp_held) or any(
            r["sp"]["held"] != one["held"] for r in ranks):
        raise AssertionError(f"[27] state bytes: TP ranks {tp_held}, SP ranks "
                             f"{[r['sp']['held'] for r in ranks]}, one process {one['held']}, "
                             f"sharded fraction {frac}")
    for mode, (loss_diff, grad, upd, worst, above) in readings.items():
        log(f"[27{'a' if mode == 'tp' else 'b'}] {mode.upper()} data 1 x model 2 (gloo, both "
            f"ranks on cuda:0; {smi}): flagship fp32 (TF32 off), log+indexing, batch 8, 2 AdamW "
            f"steps vs one process: losses {[round(v, 6) for v in one['losses']]}, max rel "
            f"diff {loss_diff:.3g} (rtol {GRID_LOSS_RTOL}); the last step's clipped gradient "
            f"rel L2 {grad:.3g} (tol {GRID_GRAD_RTOL}); update rel L2 params {upd[0]:.3g}, EMA "
            f"{upd[1]:.3g} (tol {GRID_UPDATE_RTOL}); max |param or EMA diff| {worst:.3g}, "
            f"{above} entries above 2e-5; ms a step per rank (step 2) "
            f"{[round(r[mode]['ms'][1], 3) for r in ranks]} vs one process "
            f"{one['ms'][1]:.3f}; peak memory per rank "
            f"{[round(r[mode]['peak'] / 2**30, 3) for r in ranks]} GiB vs one process "
            f"{one['peak'] / 2**30:.3f}; parameters + AdamW state + EMA per rank "
            f"{[r[mode]['held'] for r in ranks]} bytes vs one process {one['held']}; launches "
            f"per rank {[r[mode]['launches'] for r in ranks]}")
    log(f"[27a] TP sharded_fraction {frac:.4f} at M = 2 (--tp_min_features 256): a rank holds "
        f"{tp_held[0] / one['held']:.4f} of one process's state")

    # unet6 at 256x256 under SP: the activations' memory per rank
    one6 = grid_unet6_peak(None, torch.device("cuda"))
    split6 = len(split_norm_names(GRID_RANKS, "unet6", 256))
    for r in ranks:
        u, n = r["unet6"], r["unet6"]["launches"]
        if not (u["finite"] and one6["finite"]) or u["shape"] != one6["shape"] or not (
                n["tinyhead_attention"] and n["tinyhead_attention_backward"]) or not (
                n["group_norm_split"] == n["group_norm_split_backward"] == split6
                and n["group_norm_silu"] == n["group_norm_silu_backward"]):
            raise AssertionError(f"[27] unet6 SP rank {r['rank']}: {u}, one process {one6}, "
                                 f"{split6} split norms a forward")
    coll = ranks[0]["collectives"]
    log(f"[27b] unet6 256x256 bf16 forward + backward at batch {GRID_UNET6_BATCH} under SP "
        f"(every level split): peak memory above the weights per rank "
        f"{[round(r['unet6']['peak'] / 2**30, 3) for r in ranks]} GiB vs one process "
        f"{one6['peak'] / 2**30:.3f} GiB; ms per rank {[round(r['unet6']['ms'], 1) for r in ranks]}"
        f" vs {one6['ms']:.1f} (one call, host clock); kernel 4 on the gathered blocks, "
        f"launches per rank {[r['unet6']['launches'] for r in ranks]}; gloo through host "
        f"memory, a (8, 512, 8, 8) fp32 activation: all-gather {coll['all_gather']:.3f} ms, "
        f"all-reduce {coll['all_reduce']:.3f} ms")

    # (c) the CLI runs, per rank, and each checkpoint served by one process
    total = {}
    for mode in ("tp", "sp"):
        stats = [json.loads(ln.split(" ", 1)[1]) for ln in output.splitlines()
                 if ln.startswith("train_stats ") and f'"spatial": {str(mode == "sp").lower()}'
                 in ln]
        if len(stats) != 1 or stats[0]["global_step"] != 2 or stats[0]["ranks"] != GRID_RANKS:
            raise AssertionError(f"[27] CLI {mode}: train_stats {stats}")
        for r in ranks:
            c, steps = r[f"cli_{mode}"]["counts"], r[f"cli_{mode}"]["cadence_steps"]
            want = {"exact_count_masks": 3, "exact_count_masks_sharded": 3,
                    "fused_degrade_update": steps, "fused_degrade_update_sharded": steps}
            if mode == "sp":  # 2 train steps; every forward SP_SPLIT_NORMS pairs and
                # SP_WHOLE_NORMS whole launches
                want.update(group_norm_split_backward=2 * SP_SPLIT_NORMS,
                            group_norm_silu_backward=2 * SP_WHOLE_NORMS)
                forwards = c["group_norm_split"] * SP_WHOLE_NORMS == \
                    c["group_norm_silu"] * SP_SPLIT_NORMS
            else:
                want.update(group_norm_split=0, group_norm_split_backward=0)
                forwards = True
            if any(c[k] != n for k, n in want.items()) or not forwards or not (
                    c["group_norm_silu"] and c["group_norm_silu_backward"]):
                raise AssertionError(f"[27] CLI {mode} rank {r['rank']}: launches {c}, "
                                     f"expected {want}")
            for k, n in c.items():
                total[k] = total.get(k, 0) + n
        (ckpt,) = stats[0]["checkpoints"]
        _, common = grid_cli_args(workdir, mode)
        common = [a if a != "cuda:0" else "cuda" for a in common]
        rc, served, counts = _run_cli(["--method", "sample", "--test_model_path", ckpt,
                                       "--dir_work", os.path.join(workdir, f"serve_{mode}"),
                                       *common], "sample_stats")
        n_serve = served["steps"] * served["batches"]
        if rc != 0 or not (served["finite"] and served["ema"]) or (
                served["images"] != GRID_SAMPLE_NUM or counts["fused_degrade_update"] != n_serve
                or not same_through_sharded(counts)):
            raise AssertionError(f"[27] serve the {mode} checkpoint: rc {rc}, {served}, {counts}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        log(f"[27c] CLI --mesh_model 2{' --mesh_spatial true' if mode == 'sp' else ''} on "
            f"{GRID_RANKS} ranks: 1 epoch of 2 steps at batch 8 ({stats[0]['ms_per_step']:.3f} "
            f"ms/step with warm-up), the cadence's {ranks[0][f'cli_{mode}']['cadence_steps']} "
            f"reverse steps; launches per rank {[r[f'cli_{mode}']['counts'] for r in ranks]}; its "
            f"checkpoint served by one process: {served['images']} images, "
            f"{served['ms_per_step']:.3f} ms/step, launches {counts}")
    log(f"[27] phase 27's ranks took {seconds:.1f} s, rank 0's parts "
        f"{ranks[0]['seconds']}")
    return total


# [22] the diversity tester at the flagship's width
TESTER_SAMPLE_NUM = 100  # the reference tester's round (cfg.sample_num default)
TESTER_ROUNDS = 2  # the first pays warm-up and is left out of the times
TESTER_T = 100  # (b)'s --ddpm_num_steps
TESTER_PLANTED = 100  # images in phase 22's fixed batch
# cosines of 64x64x3 images, card vs CPU, both fp32: sums in another order,
# 3.6e-7 on an H100. A TF32 product (10-bit mantissa) errs by ~4e-6 there,
# which phase 22a measures alongside, so the limit tells the two apart
TESTER_COS_TOL = 1.5e-6
TESTER_MODES = (("fused", ["--sampling_mask_dependency", "independent"]),
                ("dependent_prev", ["--sampling_mask_dependency", "dependent_prev"]))


def _near_copy(rng, img, cos: float):
    """An image whose cosine with img is `cos` (a random orthogonal part),
    scaled by a random positive factor."""
    import numpy as np

    x = img.reshape(-1).astype(np.float64)
    x = x / np.linalg.norm(x)
    z = rng.normal(size=x.shape)
    z -= (z @ x) * x
    z /= np.linalg.norm(z)
    y = cos * x + np.sqrt(1.0 - cos * cos) * z
    return (y * rng.uniform(0.5, 2.0) * np.linalg.norm(img)).reshape(img.shape).astype(np.float32)


def phase_tester_selection():
    """[22a] The tester's dedup and matching on the card against the same
    functions on the CPU, with TF32 on in the process (the functions turn
    it off inside the call): a fixed batch of TESTER_PLANTED 64x64 images,
    50 random bases, 49 near-copies of them at cosines 0.9 +- 1e-3 and a
    zero image, shuffled. The kept images of greedy_dedup and dedup_against,
    the nearest-neighbour indices, get_nearest_neighbor's picks (with and
    without flips) and assign_similar_neighbor's buckets and changed set
    must be equal."""
    import types

    import numpy as np
    import torch

    from masked_diffusion_tpu_torch import tester as tmod

    rng = np.random.default_rng(22)
    bases = rng.uniform(-1, 1, (50, SIZE, SIZE, 3)).astype(np.float32)
    copies = [_near_copy(rng, bases[i], tmod.COSINE_SIMILARITY_TH + (1e-3 if i % 2 else -1e-3))
              for i in range(49)]
    batch = np.concatenate([bases, np.stack(copies), np.zeros((1, SIZE, SIZE, 3), np.float32)])
    batch = batch[rng.permutation(TESTER_PLANTED)]
    train = rng.uniform(-1, 1, (64, SIZE, SIZE, 3)).astype(np.float32)
    train[:10] = batch[:10] + 0.2 * rng.uniform(-1, 1, (10, SIZE, SIZE, 3))  # near matches
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    out = {}
    try:
        # what cosine_matrix would give if it kept the process's TF32
        va, vb = (torch.from_numpy(tmod._flatten_normalize(x)).cuda() for x in (train, batch))
        tf32 = (va @ vb.T).cpu().numpy()
        for dev in ("cuda", "cpu"):
            kept = tmod.greedy_dedup(batch, device=dev)
            fresh = tmod.dedup_against(batch[50:], batch[:50], device=dev)
            sim = tmod.cosine_matrix(train, batch, dev)
            nn_idx = sim.argmax(axis=0)
            picks = [tmod.get_nearest_neighbor(batch, train, 32, flip, device=dev)
                     for flip in (True, False)]
            buckets, changed = tmod.Tester.assign_similar_neighbor(
                types.SimpleNamespace(device=torch.device(dev)), batch,
                [np.empty((0, SIZE, SIZE, 3), np.float32) for _ in range(len(train))], nn_idx)
            out[dev] = dict(kept=kept, fresh=fresh, sim=sim, nn_idx=nn_idx, picks=picks,
                            buckets=buckets, changed=changed)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    a, r = out["cuda"], out["cpu"]
    same = {
        "greedy_dedup": np.array_equal(a["kept"], r["kept"]),
        "dedup_against": np.array_equal(a["fresh"], r["fresh"]),
        "nearest_neighbor_idx": np.array_equal(a["nn_idx"], r["nn_idx"]),
        "get_nearest_neighbor": all(np.array_equal(x, y) for x, y in zip(a["picks"], r["picks"])),
        "assign_similar_neighbor": a["changed"] == r["changed"] and all(
            np.array_equal(x, y) for x, y in zip(a["buckets"], r["buckets"])),
    }
    err = float(np.abs(a["sim"] - r["sim"]).max())
    tf32_err = float(np.abs(tf32 - r["sim"]).max())
    if not all(same.values()):
        raise AssertionError(f"[22a] the card selects otherwise than the CPU: {same}, cosine "
                             f"max |diff| {err}")
    if not err <= TESTER_COS_TOL < tf32_err:
        raise AssertionError(f"[22a] cosine max |diff| card vs CPU {err}, with TF32 {tf32_err}: "
                             f"the limit {TESTER_COS_TOL} must hold the first and not the second")
    # the planted pairs straddle the threshold: one of each of the 24 pairs
    # at 0.901 drops out, the 25 at 0.899 stay
    if len(r["kept"]) != TESTER_PLANTED - 24:
        raise AssertionError(f"[22a] kept {len(r['kept'])} of {TESTER_PLANTED}: the planted "
                             f"cosines are off")
    log(f"[22a] tester selection, {TESTER_PLANTED} images at {SIZE}x{SIZE} with 49 planted "
        f"near-copies at cosines 0.9 +- 1e-3 (TF32 on in the process): the card keeps the same "
        f"{len(r['kept'])} (greedy_dedup) and {len(r['fresh'])} (dedup_against), the same "
        f"nearest-neighbour indices and get_nearest_neighbor picks (flips on and off) and "
        f"the same {len(r['changed'])} changed buckets as the CPU; cosine max |diff| {err:.3g} "
        f"(limit {TESTER_COS_TOL}; a TF32 product's {tf32_err:.3g})")


def phase_tester_kernels(calls):
    """[22a] The kernels of phase 22b at its batch, TESTER_SAMPLE_NUM, on
    the plans that batch takes: group_norm_silu at every norm shape of the
    flagship, fp32 and bf16, against group_norm_silu_plain under GN_TOL
    (the warp path's 8 spans a CTA is reached only from batch 66 on), and
    kernels 1 and 3 at 64x64 as fused_branch_check and kmask_branch_check
    hold them."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.ops import groupnorm as gn

    dev, b = torch.device("cuda"), TESTER_SAMPLE_NUM
    gen = torch.Generator(device=dev).manual_seed(23)
    worst, per_cta = {}, set()
    with torch.inference_mode():
        for (c, h, w), groups, silu in sorted(calls):
            x, scale, bias = _gn_inputs(gen, b, c, h, w)
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[1]
                xd, sd, bd = x.to(dtype), scale.to(dtype), bias.to(dtype)
                out = gn.group_norm_silu(xd, sd, bd, groups, 1e-5, silu).float()
                ref = gn.group_norm_silu_plain(xd, sd, bd, groups, 1e-5, silu).float()
                atol, rtol = GN_TOL[name]
                diff = (out - ref).abs()
                if not bool((diff <= atol + rtol * ref.abs()).all()):
                    raise AssertionError(
                        f"[22a] group_norm_silu {name} {(b, c, h, w)} G={groups}: max err "
                        f"{diff.max().item()} beyond atol {atol} rtol {rtol}")
                worst[name] = max(worst.get(name, 0.0), diff.max().item())
                per_cta.add(gn._cuda_plan(b, c, h, w, groups, dtype, False).spans_per_cta)
    if 8 not in per_cta:
        raise AssertionError(f"[22a] the flagship's norms at batch {b} took {per_cta} spans a "
                             "CTA, not the warp path's 8")
    rng = np.random.default_rng(24)
    fused_err = fused_branch_check(rng, b, SIZE, SIZE)
    kmask_branch_check(rng, b, SIZE, SIZE)
    log(f"[22a] at batch {b}: group_norm_silu at the flagship's {len(calls)} norm shapes "
        f"within GN_TOL, max err fp32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g} "
        f"(spans a CTA {sorted(per_cta)}); fused_degrade_update {b}x{SIZE}x{SIZE} (max "
        f"|out - plain| {fused_err:.3g}) and exact_count_masks: bitwise masks, exact counts")


def _flagship_dataset(n: int):
    from masked_diffusion_tpu_torch.data.datasets import get_dataset

    return get_dataset("", "synthetic", SIZE, data_subset=True, num_data=n)


def phase_tester_run(workdir: str):
    """[22b] Tester.run(max_rounds=TESTER_ROUNDS) at the flagship's width
    (random weights, 64x64, bf16, log + indexing at T=100, sample_num 100,
    a target of 256 that the rounds do not reach), on the fused branch and
    in dependent_prev, each with the counts set to 0 just before: kernel 1
    rounds x steps times on the fused branch, kernel 3 once a step in
    dependent_prev, 71 GroupNorm launches a UNet forward. Returns (launches
    of both runs, {mode: (seconds a round, ms a reverse step, images/s)})."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.cli.main_train_masked import parse
    from masked_diffusion_tpu_torch.data.histogram import compute_mean_histogram
    from masked_diffusion_tpu_torch.tester import Tester
    from masked_diffusion_tpu_torch.utils.dirs import Dir

    data = _flagship_dataset(256)
    hist = compute_mean_histogram(data.data, TESTER_SAMPLE_NUM, "image-wise")
    model = _flagship_weights(22)
    total, perf = {}, {}
    for name, flags in TESTER_MODES:
        cfg, _ = parse(["--method", "test", "--data_size", str(SIZE), "--ddpm_schedule", "log",
                        "--ddpm_num_steps", str(TESTER_T), "--select_degrade_pixel",
                        "indexing", "--mean_option", "degraded_area", "--shift_type",
                        "1-d_constant", "--momentum_adaptive", "base_momentum",
                        "--mixed_precision", "bf16", "--sample_num", str(TESTER_SAMPLE_NUM),
                        "--data_subset_num", "256", *flags])
        tester = Tester(cfg, data, model, dataset_hist=hist, device="cuda")
        dirs = Dir("train", "tester", os.path.join(workdir, "tester", name),
                   data_name="synthetic", method="test")
        steps = len(tester.timesteps_used_epoch)
        reset_counts()
        result = tester.run(dirs, max_rounds=TESTER_ROUNDS,
                            generator=torch.Generator().manual_seed(22))
        counts = read_counts()
        rounds = result["rounds"]
        fused = name == "fused"
        want = {"fused_degrade_update": rounds * steps if fused else 0,
                "exact_count_masks": 0 if fused else rounds * steps,
                "group_norm_silu": 71 * rounds * steps, "group_norm_silu_backward": 0,
                "tinyhead_attention": 0}
        if (rounds != TESTER_ROUNDS or any(counts[k] != n for k, n in want.items())
                or not same_through_sharded(counts)):
            raise AssertionError(f"[22b] {name}: {rounds} rounds, launches {counts}, "
                                 f"expected {want}")
        u = result["unique_images"]
        if not (len(u) and u.shape[1:] == (SIZE, SIZE, 3) and np.isfinite(u).all()):
            raise AssertionError(f"[22b] {name}: unique images {u.shape}")
        timed = result["timed_rounds"]
        perf[name] = (result["seconds"] / timed,
                      1e3 * result["sample_seconds"] / (timed * steps),
                      timed * TESTER_SAMPLE_NUM / result["sample_seconds"])
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        log(f"[22b] Tester.run at the flagship's width, {name}: {rounds} rounds of "
            f"{TESTER_SAMPLE_NUM} images x {steps} reverse steps (bf16, log+indexing "
            f"T={TESTER_T}), "
            f"unique counts {result['num_unique_history']}; {perf[name][0]:.3f} s a round, "
            f"{perf[name][1]:.3f} ms a reverse step, {perf[name][2]:.2f} images/s (rounds 2-"
            f"{rounds}); launches {counts}")
    return total, perf


def phase_tester_cli(workdir: str):
    """[22c] --method test through the CLI on the checkpoint phase 10's
    trained flagship wrote (EMA weights), phase 10's flags with
    --data_subset_num 1 (a target one round reaches: an untrained model's
    near-constant samples have cosines near +-1 with one another). Checks
    exit 0, the test_stats line, sample_page_0.png, number_of_sample.png
    (where matplotlib is installed), neighbor_*.png and final_sample.png,
    and kernel 1 once a reverse step. Returns the launches."""
    import glob

    (ckpt,) = glob.glob(os.path.join(workdir, "train", "**", "checkpoint-epoch-*"),
                        recursive=True)
    _, common = flagship_cli_args(workdir)
    rc, stats, counts = _run_cli(["--method", "test", "--test_model_path", ckpt, "--dir_work",
                                  os.path.join(workdir, "test"), *common,
                                  "--data_subset_num", "1"], "test_stats")
    root = os.path.dirname(stats["out_dir"])
    files = sorted(f for _, _, names in os.walk(root) for f in names if f.endswith(".png"))
    try:
        import matplotlib  # noqa: F401

        plot = ["number_of_sample.png"]
    except ImportError:
        plot = []
    want_files = ["final_sample.png", "neighbor_0.png", "sample_page_0.png", *plot]
    n = stats["rounds"] * stats["steps"]
    want = {"fused_degrade_update": n, "exact_count_masks": 0,
            "group_norm_silu": 71 * n, "group_norm_silu_backward": 0}
    if (rc != 0 or not stats["ema"] or stats["unique"] < 1 or stats["device"] == "cpu"
            or any(f not in files for f in want_files)
            or any(counts[k] != v for k, v in want.items()) or not same_through_sharded(counts)):
        raise AssertionError(f"[22c] --method test: rc {rc}, {stats}, files {files}, launches "
                             f"{counts}, expected {want}")
    log(f"[22c] --method test through the CLI on phase 10's checkpoint (EMA weights): "
        f"{stats['rounds']} round(s) of {stats['sample_num']} images x {stats['steps']} steps, "
        f"{stats['unique']} unique of a target of {stats['target']}, "
        f"{stats['ms_per_step']:.3f} ms a reverse step, {stats['images_per_sec']:.2f} images/s "
        f"on {stats['device']}; files {files}; launches {counts}")
    return counts


# [23] interpolation sampling at the flagship's width
INTERP_STEPS = 3  # reverse steps of 23a: the CPU side runs the 113.7M-param UNet


def phase_interpolation_parity():
    """[23a] The interpolation sampler on CUDA against the CPU path, same
    weights and injected shared fields, fp32 with TF32 off, 3 images at
    64x64, linear + thresholding at T=INTERP_STEPS, shift 0.5, for
    base_momentum, momentum and boosting: max |diff| within SLICE_TOL. The
    CUDA runs are under set_sync_debug_mode("error") and launch the
    GroupNorm kernel 71 times a step and no mask kernel."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.cli.main_train_masked import parse
    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.sample.interpolation import RULES, make_interpolation_sample_fn
    from masked_diffusion_tpu_torch.sample.loop import StepDraws

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_model = _flagship_weights(23)
    schedule = build_schedule("linear", INTERP_STEPS, SIZE, "thresholding")
    used = schedule.timesteps_for_epoch(1, 10, 1)
    rng = np.random.default_rng(23)
    fields = torch.from_numpy(rng.uniform(size=(len(used), 1, 1, SIZE, SIZE)).astype(np.float32))
    errs = {}
    t0 = time.perf_counter()
    for rule in RULES:
        cfg, _ = parse(["--method", "mean_shift", "--data_size", str(SIZE), "--ddpm_schedule",
                        "linear", "--ddpm_num_steps", str(INTERP_STEPS),
                        "--select_degrade_pixel", "thresholding", "--mean_option",
                        "degraded_area", "--momentum_adaptive", rule, "--sample_num", "3",
                        "--interpolation_shift", "0.5", "--mixed_precision", "no"])
        outs = {}
        for dev in ("cuda", "cpu"):
            model = build_unet()
            model.load_state_dict(ref_model.state_dict())
            fn = make_interpolation_sample_fn(model, schedule, cfg, used, 0.5, device=dev)
            f = fields.to(dev)
            reset_counts()
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                out, mu = fn(draws=lambda i: StepDraws(mask_uniform=f[i]))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            counts = read_counts()
            want = 71 * len(used) if dev == "cuda" else 0
            if (counts["group_norm_silu"] != want or counts["fused_degrade_update"]
                    or counts["exact_count_masks"]):
                raise AssertionError(f"[23a] {rule} on {dev}: launches {counts}")
            outs[dev] = out.cpu()
        a, r = outs["cuda"], outs["cpu"]
        if tuple(a.shape) != (3, SIZE, SIZE, 3) or not _close(a, r):
            raise AssertionError(f"[23a] {rule}: CUDA vs CPU max err "
                                 f"{(a - r).abs().max().item()}, shape {tuple(a.shape)}")
        errs[rule] = (a - r).abs().max().item()
    torch.backends.cudnn.allow_tf32 = True
    log(f"[23a] interpolation sampler at the flagship's width, 3 images, {len(used)} steps, "
        f"fp32 (TF32 off), shared fields injected: CUDA vs CPU max |diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (atol = rtol = {SLICE_TOL}); no host sync inside the loop, 71 GroupNorm launches "
        f"a step; {time.perf_counter() - t0:.1f} s")


INTERP_CLI_T = 100  # 23b's --ddpm_num_steps: the EMA cadence and the sweep, 100 steps each


def phase_interpolation_cli(workdir: str):
    """[23b] The flagship trained through the CLI with --interpolation_shift
    0.5, linear + thresholding at T=INTERP_CLI_T, phase 10's flags otherwise (2
    epochs of 4 steps, one save): the cadence writes
    ema_interpolation_00001.png beside the EMA grids; no exact-k launch,
    kernel 1 once a reverse step of the EMA cadence. Returns (launches, the
    interpolation pass's ms a reverse step)."""
    import masked_diffusion_tpu_torch.train.trainer as trainer_mod

    argv, _ = flagship_cli_args(os.path.join(workdir, "interpolation"))
    for flag, value in (("--ddpm_schedule", "linear"),
                        ("--select_degrade_pixel", "thresholding"),
                        ("--ddpm_num_steps", str(INTERP_CLI_T))):
        argv[argv.index(flag) + 1] = value
    argv += ["--interpolation_shift", "0.5"]
    real = trainer_mod.Trainer._save_interpolation_sample
    record = {}

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        real(self, *a, **k)
        record["seconds"] = record.get("seconds", 0.0) + time.perf_counter() - t0
        record["steps"] = record.get("steps", 0) + len(self.timesteps_used_epoch)

    trainer_mod.Trainer._save_interpolation_sample = timed
    try:
        rc, stats, counts = _run_cli(argv, "train_stats")
    finally:
        trainer_mod.Trainer._save_interpolation_sample = real
    (ckpt,) = stats["checkpoints"]
    grids = sorted(os.listdir(os.path.join(os.path.dirname(os.path.dirname(ckpt)), "train",
                                           "image", "ema_sample_img")))
    want_grids = ["ema_interpolation_00001.png", "ema_sample_00001_global.png",
                  "ema_sample_00001_local.png"]
    steps = record.get("steps", 0)
    if (rc != 0 or stats["global_step"] != 8 or grids != want_grids or steps != INTERP_CLI_T
            or counts["exact_count_masks"] or counts["fused_degrade_update"] != steps
            or counts["group_norm_silu"] < 71 * 2 * steps or not counts["group_norm_silu_backward"]
            or not same_through_sharded(counts)):
        raise AssertionError(f"[23b] interpolation train CLI: rc {rc}, {stats}, grids {grids}, "
                             f"interpolation {record}, launches {counts}")
    ms = 1e3 * record["seconds"] / steps
    log(f"[23b] train CLI with --interpolation_shift 0.5 (linear+thresholding T={INTERP_CLI_T}): "
        f"2 epochs "
        f"x 4 steps, losses {[round(v, 5) for v in stats['loss_mean_epoch']]}, "
        f"{stats['ms_per_step']:.3f} ms/step; grids {grids}; the interpolation pass: {steps} "
        f"reverse steps of 16 images in {record['seconds']:.2f} s, {ms:.3f} ms a reverse step "
        f"(its sampler and model copy built in the call); launches {counts}")
    return counts, ms


# [24] the reference user's inputs at the flagship's width
LSUN_IMAGES = 160  # more nodes than one leaf page holds: a branch page over two
LSUN_HW = (256, 320)  # LSUN's short side is 256
LSUN_SUBSET = 128  # 2 train steps an epoch at batch 64
LSUN_T = 20  # --ddpm_num_steps of (c)'s cadences and (d)'s serves (200 and 100 before phase 29)
NATIVE_TOL = 1e-5  # native (float32 coordinates) vs the numpy reference (float64)
# kernel-name fragments the profiled epoch must hold (tools/profile_train.py:OWN)
TRACED_KERNELS = {"GroupNorm forward": "gn_fwd_", "GroupNorm backward": "gn_bwd_",
                  "exact-k masks": "kmask_kernel"}
_LEGACY_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def phase_native():
    """[24a] The port's native preprocessing library builds on the card's
    host, and its single-image and batch entry points equal the numpy
    bilinear reference (tests/test_native_preprocess.py's checks)."""
    import numpy as np

    from masked_diffusion_tpu_torch import native
    from masked_diffusion_tpu_torch.data.datasets import _bilinear_resize

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("[24a] the native preprocessing library did not build (g++)")
    seconds = time.perf_counter() - t0
    rng = np.random.default_rng(24)
    img = rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)
    one = native.resize_center_crop_native(img, 16)
    errs = [float(np.abs(one - _bilinear_resize(img.astype(np.float32), 16, 23)[:, 3:19]
                         / 255.0).max())]
    batch = rng.integers(0, 255, (8, 48, 40, 1), dtype=np.uint8)
    many = native.preprocess_batch_native(batch, 16)
    errs += [float(np.abs(many[i] - _bilinear_resize(batch[i].astype(np.float32), 19, 16)[1:17]
                          / 255.0).max()) for i in range(len(batch))]
    if max(errs) > NATIVE_TOL or one.shape != (16, 16, 3) or many.shape != (8, 16, 16, 1):
        raise AssertionError(f"[24a] native vs numpy: max |diff| {max(errs)} (tol {NATIVE_TOL})")
    log(f"[24a] native preprocessing: built and loaded in {seconds:.2f} s (g++) -> "
        f"{os.path.relpath(native.lib_path, ROOT)}; single (37,53,3) and "
        f"batch (8,48,40,1) vs the numpy bilinear reference: max |diff| {max(errs):.3g} "
        f"(tol {NATIVE_TOL})")


def _smooth_jpeg(rng, h: int, w: int) -> bytes:
    """A smooth random field (a few low-frequency waves a channel) as a
    JPEG: JPEG keeps it near its source."""
    import numpy as np
    from PIL import Image

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(3):
            fy, fx = rng.uniform(0.5, 3.0, 2) * 2 * np.pi / np.array([h, w])
            img[..., c] += np.sin(fy * ys + fx * xs + rng.uniform(0, 2 * np.pi))
    img = 127.5 + 40.0 * img
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def lsun_archive(root: str) -> str:
    """[24b] LSUN_IMAGES JPEGs of LSUN_HW x 3 from a seeded generator in
    root/lsun/church_outdoor_train_lmdb/data.mdb (the torchvision-LSUN layout
    the reference reads), written with tools/lmdb_write.py: every value
    larger than a page (an overflow chain each) and a branch page over two
    leaves. Returns root."""
    import numpy as np

    from masked_diffusion_tpu_torch.data.lmdb_reader import LMDBReader
    from masked_diffusion_tpu_torch.tools.lmdb_write import PSIZE, write_lmdb

    rng = np.random.default_rng(2024)
    t0 = time.perf_counter()
    items = {f"lsun{i:06d}".encode(): _smooth_jpeg(rng, *LSUN_HW) for i in range(LSUN_IMAGES)}
    env = write_lmdb(os.path.join(root, "lsun", "church_outdoor_train_lmdb"), items,
                     use_branch=True)
    sizes = [len(v) for v in items.values()]
    with LMDBReader(env) as r:
        back = list(r.items())
    if min(sizes) <= PSIZE or dict(back) != items or len(back) != LSUN_IMAGES:
        raise AssertionError(f"[24b] LSUN archive: JPEG bytes {min(sizes)}..{max(sizes)}, "
                             f"{len(back)} read back")
    log(f"[24b] LSUN archive: {LSUN_IMAGES} JPEGs of {LSUN_HW[0]}x{LSUN_HW[1]}x3, "
        f"{min(sizes)}..{max(sizes)} bytes each (page {PSIZE}: all overflow), "
        f"{os.path.getsize(os.path.join(env, 'data.mdb'))} bytes in data.mdb, written and "
        f"read back in {time.perf_counter() - t0:.2f} s")
    return root


def _trace_reading(path: str):
    """(the train_step epochs and steps, kernel names, summary) of a trace
    file of utils/profiling.trace."""
    import re

    from masked_diffusion_tpu_torch.utils.profiling import read_trace

    tr = read_trace(path)
    step = re.compile(r"^train_step epoch (\d+) step (\d+)$")
    steps = sorted({tuple(int(g) for g in m.groups()) for e in tr["events"]
                    if (m := step.match(str(e.get("name", ""))))})
    kernels = {str(e.get("name", "")) for e in tr["events"] if e.get("cat") == "kernel"}
    return steps, kernels, tr["summary"]


def _legacy_reference(ckpt: str, out: str) -> str:
    """ckpt (the port's checkpoint) rewritten as the reference writes one:
    unet/ and unet_ema/ as diffusion_pytorch_model.bin (torch.save) under the
    pre-0.15 attention names, the EMA hyperparameters in unet_ema/config.json
    (the trainer merged them there), no meta.json and no optimizer/."""
    import shutil

    import torch

    from masked_diffusion_tpu_torch.io.weights import load_diffusers_folder

    for sub in ("unet", "unet_ema"):
        sd, _ = load_diffusers_folder(os.path.join(ckpt, sub))
        legacy = {}
        for k, v in sd.items():
            for new, old in _LEGACY_NAMES.items():
                k = k.replace(f".{new}.", f".{old}.")
            legacy[k] = v
        os.makedirs(os.path.join(out, sub))
        torch.save(legacy, os.path.join(out, sub, "diffusion_pytorch_model.bin"))
        shutil.copy(os.path.join(ckpt, sub, "config.json"), os.path.join(out, sub))
    return out


def _serve_images(argv):
    """main(argv) for --method sample through _run_cli, keeping the images
    generate_images returned. Returns (rc, sample_stats, launches, images)."""
    import masked_diffusion_tpu_torch.sample.generate as generate_mod

    real, kept = generate_mod.generate_images, {}

    def keep(*a, **k):
        kept["out"] = real(*a, **k)
        return kept["out"]

    generate_mod.generate_images = keep
    try:
        rc, stats, counts = _run_cli(argv, "sample_stats")
    finally:
        generate_mod.generate_images = real
    return rc, stats, counts, kept["out"]["images"]


def phase_reference_inputs(workdir: str, smi: str) -> dict:
    """[24] What a user of the reference brings, at the flagship's width:
    (a) the native preprocessing, (b) an LSUN archive, (c) the flagship
    trained on it through the CLI under MDT_NATIVE_PREPROCESS=1 with
    --profile_dir (phase 10's flags, LSUN at 128 images, batch 64, 3 epochs,
    T=20): one trace, of epoch 1's two steps, naming the GroupNorm and
    exact-k kernels; (d) its final checkpoint rewritten into the reference's
    form (.bin, legacy attention names, no meta.json or optimizer/), served
    through --method sample with phase 5's flags (linear + thresholding,
    T=20, two requests of 16 images, the fused branch) and converted by the
    import tool: weights bitwise equal, a resume from it refused; the
    original served at the same seed gives the same images. Returns the
    launches of the CLI runs."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.cli.main_train_masked import main
    from masked_diffusion_tpu_torch.data.datasets import get_dataset
    from masked_diffusion_tpu_torch.io.weights import load_checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "reference_inputs")
    phase_native()
    data_root = lsun_archive(os.path.join(root, "data"))
    prof = os.path.join(root, "prof")
    argv, common = flagship_cli_args(root)
    argv = _with(argv, "--data_name", "lsun", "--dir_dataset", data_root, "--data_set", "church",
                 "--data_subset", "True", "--data_subset_num", str(LSUN_SUBSET),
                 "--batch_size", "64", "--num_epochs", "3", "--profile_dir", prof,
                 "--ddpm_num_steps", str(LSUN_T))
    os.environ["MDT_NATIVE_PREPROCESS"] = "1"
    try:
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        train = read_counts()
    finally:
        del os.environ["MDT_NATIVE_PREPROCESS"]
    sys.stdout.write(buf.getvalue())
    lines = buf.getvalue().splitlines()
    data = json.loads(next(ln for ln in lines if ln.startswith("dataset_stats ")).split(" ", 1)[1])
    stats = json.loads(next(ln for ln in lines if ln.startswith("train_stats ")).split(" ", 1)[1])
    # 2 steps an epoch; the cadence at epochs 1 and 2, each a visuals pass
    # (an exact-k launch) and a fused EMA sample
    if (rc != 0 or data["shape"] != [LSUN_SUBSET, SIZE, SIZE, 3] or data["backend"] != "native"
            or stats["global_step"] != 6 or len(stats["checkpoints"]) != 2
            or not np.isfinite(stats["loss_mean_epoch"]).all()):
        raise AssertionError(f"[24c] LSUN train CLI: rc {rc}, dataset {data}, stats {stats}")
    off = ("tinyhead_attention", "tinyhead_attention_backward", *SPLIT_ONLY, *FP32_ONLY)
    if (train["exact_count_masks"] != 6 + 2 or any(train[k] for k in off)
            or not all(n for k, n in train.items() if k not in off)
            or not same_through_sharded(train)):
        raise AssertionError(f"[24c] LSUN train CLI: launches {train}")
    traces = sorted(os.listdir(prof))
    steps, kernels, summary = _trace_reading(os.path.join(prof, "trace_rank0.json"))
    missing = [what for what, frag in TRACED_KERNELS.items()
               if not any(frag in k for k in kernels)]
    if traces != ["trace_rank0.json"] or steps != [(1, 0), (1, 1)] or missing:
        raise AssertionError(f"[24c] --profile_dir: files {traces}, traced steps {steps}, "
                             f"kernels missing {missing}")
    t0 = time.perf_counter()
    pil = get_dataset(data_root, "lsun", SIZE, "church", True, LSUN_SUBSET)
    pil_s = time.perf_counter() - t0
    if pil.backend != "pil" or pil.data.shape != (LSUN_SUBSET, SIZE, SIZE, 3):
        raise AssertionError(f"[24c] LSUN without native: {pil.backend}, {pil.data.shape}")
    log(f"[24c] LSUN train CLI (phase 10's flags, {LSUN_SUBSET} images, batch 64, 3 epochs x 2 "
        f"steps): dataset {data['shape']} via {data['backend']} in {data['load_s']:.3f} s (PIL: "
        f"{pil_s:.3f} s); losses {[round(v, 5) for v in stats['loss_mean_epoch']]}, "
        f"{stats['ms_per_step']:.3f} ms/step (epoch 2, untraced) on {stats['device']}; launches "
        f"{train}")
    log(f"[24c] --profile_dir: {traces}, steps (epoch, step) {steps}; the traced window "
        f"{summary['wall_ms']:.3f} ms wall, device busy {summary['device_busy_ms']:.3f} ms, "
        f"idle share {summary['device_idle_share']:.4f}, {summary['device_kernels']} kernels; "
        f"GroupNorm forward, backward and exact-k kernels named ({smi})")

    # (d) the final checkpoint in the reference's form, served and imported
    ckpt = stats["checkpoints"][-1]
    reference = _legacy_reference(ckpt, os.path.join(root, "reference", os.path.basename(ckpt)))
    runs, images = [train], {}
    for name, path in (("reference", reference), ("original", ckpt)):
        rc, served, counts, images[name] = _serve_images(
            serve_argv(path, "linear", "thresholding", LSUN_T, os.path.join(root, name)))
        n_steps = served["steps"] * served["batches"]
        if (rc != 0 or not (served["finite"] and served["ema"]) or served["images"] != 32
                or served["batches"] != 2 or counts["fused_degrade_update"] != n_steps
                or counts["exact_count_masks"] or counts["group_norm_silu_backward"]
                or not counts["group_norm_silu"] or not same_through_sharded(counts)):
            raise AssertionError(f"[24d] serve the {name} checkpoint: rc {rc}, {served}, "
                                 f"launches {counts}")
        runs.append(counts)
        log(f"[24d] served the {name} checkpoint ({os.path.relpath(path, root)}, EMA weights): "
            f"{served['images']} images, {served['steps']} steps x {served['batches']} "
            f"batches, {served['ms_per_step']:.3f} ms a reverse step; launches {counts}")
    diff = float(np.abs(images["reference"] - images["original"]).max())
    if diff != 0.0:
        raise AssertionError(f"[24d] the reference-era and the original checkpoint served at "
                             f"one seed differ: max |diff| {diff}")
    t0 = time.perf_counter()
    tool = subprocess.run(
        [sys.executable, "-m", "masked_diffusion_tpu_torch.io.import_torch", reference,
         os.path.join(root, "imported")], cwd=ROOT, capture_output=True, text=True, timeout=300)
    tool_s = time.perf_counter() - t0
    if tool.returncode != 0:
        raise AssertionError(f"[24d] import tool: rc {tool.returncode}\n{tool.stderr[-3000:]}")
    imported = os.path.join(root, "imported", os.path.basename(ckpt))
    with open(os.path.join(imported, "meta.json")) as f:
        meta = json.load(f)
    ours, theirs = load_checkpoint(ckpt), load_checkpoint(imported)
    for i, sub in ((0, "unet"), (1, "unet_ema")):
        if sorted(ours[i]) != sorted(theirs[i]) or not all(
                torch.equal(ours[i][k], theirs[i][k]) for k in ours[i]):
            raise AssertionError(f"[24d] import tool: {sub} weights differ from the original")
    if meta["optimizer_imported"] is not False or meta["global_step"] != 6 or meta["epoch"] != 2:
        raise AssertionError(f"[24d] import tool meta {meta}")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            main(_with(argv, "--profile_dir", "", "--resume_from_checkpoint", imported))
    except ValueError as err:
        if "missing ['optimizer']" not in str(err):
            raise
        refusal = str(err)
    else:
        raise AssertionError("[24d] a resume from the imported checkpoint was not refused")
    seconds = time.perf_counter() - t_phase
    log(f"[24d] import tool: {tool_s:.2f} s (a process of its own), "
        f"{tool.stdout.strip().splitlines()[0]}; unet and unet_ema bitwise equal to the "
        f"original, optimizer_imported false, global_step {meta['global_step']}; resume "
        f"refused: {refusal[:90]}...; the reference-era and the original checkpoint served at "
        f"one seed: max |diff| {diff}; phase 24 took {seconds:.1f} s")
    return {k: sum(run[k] for run in runs) for k in train}, seconds


# [25] the model and sampler switches. The six cells of models/unet.py's
# attention table, (--tinyhead_attention, --attention_chunk), on unet1 at
# 128x128: 11 attention blocks at S = 4096 (16 heads) and S = 1024 (32 heads)
ROUTE_CELLS = ((None, None), (None, 512), (True, None), (True, 512), (False, None),
               (False, 512))
ROUTE_SIZE = 128
ROUTE_BATCH = 8  # the forward's; the forward + backward runs at batch 2
REMAT_STEPS_TIMED = 10
REUSE_K = 2


def phase_remat(smi: str) -> dict:
    """[25a] One flagship train step (bf16, batch 64, log + indexing, AdamW,
    EMA) with and without --remat from the same weights, batch and draws:
    the loss and the clipped gradient within phase 9's limits; launches a
    step: GroupNorm forward 71 + 60 recomputed (30 ResnetBlocks of the down
    and up paths, two norms each) against 71, backward 71 and 71, exact-k 1
    and 1; the peak device memory of each first step, and ms/step over
    REMAT_STEPS_TIMED steps after 2 of warm-up. Returns {remat: (ms, peak
    bytes)}."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.models.unet import GroupNormAct
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from masked_diffusion_tpu_torch.train.step import (
        TrainDraws,
        create_train_state,
        make_train_step,
    )

    sched, select, t_steps = MODES[1]
    batch, hw = B_KERNEL, SIZE * SIZE
    ref_model = _flagship_weights(25)
    norms = sum(isinstance(m, GroupNormAct) for m in ref_model.modules())
    resnets = sum(len(b.resnets) for b in (*ref_model.down_blocks, *ref_model.up_blocks))
    schedule = build_schedule(sched, t_steps, SIZE, select)
    used = schedule.timesteps_for_epoch(0, 10, 1)
    cfg = _train_cfg(sched, select, t_steps, "--mixed_precision", "bf16")
    rng = np.random.default_rng(25)
    img = torch.from_numpy(rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)).cuda()
    draws = TrainDraws(
        timeindex=torch.from_numpy(rng.integers(0, len(used), batch)).cuda(),
        bits=torch.from_numpy(rng.integers(0, 2**32, (batch, hw), dtype=np.uint64)
                              .astype(np.int64)).cuda(),
        uniform=torch.from_numpy(rng.uniform(-1, 1, batch).astype(np.float32)).cuda(),
    )
    torch.backends.cudnn.allow_tf32 = True
    runs = {}
    for remat in (False, True):
        model = build_unet(remat=remat)
        model.load_state_dict(ref_model.state_dict())
        model.cuda()
        lr = build_lr_schedule("cosine", 1e-4, 0, 1000)
        opt = build_optimizer("adamw", model.parameters(), lr, 1.0, 1)
        state = create_train_state(model, opt, use_ema=True)
        step = make_train_step(model, schedule, cfg, opt, used, lr, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss = step(state, img, draws=draws)["train_loss"].item()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        grads = [p.grad.detach().float().clone() for p in model.parameters()]
        want = dict.fromkeys(counts, 0)
        want.update(group_norm_silu=norms + (2 * resnets if remat else 0),
                    group_norm_silu_backward=norms, exact_count_masks=1,
                    exact_count_masks_sharded=1)
        if counts != want:
            raise AssertionError(f"[25a] remat {remat}: launches {counts}, expected {want}")
        gen = torch.Generator().manual_seed(1)
        for _ in range(2):
            step(state, img, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REMAT_STEPS_TIMED):
            step(state, img, gen)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / REMAT_STEPS_TIMED
        runs[remat] = (loss, grads, peak, ms, counts)
        del model, opt, state, step
        torch.cuda.empty_cache()
    (l0, g0, p0, ms0, c0), (l1, g1, p1, ms1, c1) = runs[False], runs[True]
    loss_diff = abs(l1 - l0) / abs(l0)
    grad_diff = (sum(float((a - b).square().sum()) for a, b in zip(g1, g0))
                 / sum(float(b.square().sum()) for b in g0)) ** 0.5
    max_diff = max(float((a - b).abs().max()) for a, b in zip(g1, g0))
    log(f"[25a] flagship train step, bf16, batch {batch}, {sched}+{select} ({smi}): remat vs "
        f"none, loss {l1:.6f} vs {l0:.6f} (rel diff {loss_diff:.3g}, tol {BF16_LOSS_RTOL}), "
        f"gradient rel L2 diff {grad_diff:.3g} (tol {BF16_GRAD_RTOL}), max |diff| {max_diff:.3g}; "
        f"GroupNorm forward launches a step {c1['group_norm_silu']} vs {c0['group_norm_silu']}, "
        f"backward {c1['group_norm_silu_backward']} vs {c0['group_norm_silu_backward']}, exact-k "
        f"{c1['exact_count_masks']} vs {c0['exact_count_masks']}; peak device memory "
        f"{p1 / 2**30:.3f} vs {p0 / 2**30:.3f} GiB; {ms1:.3f} vs {ms0:.3f} ms/step over "
        f"{REMAT_STEPS_TIMED} steps after 2 of warm-up")
    if not (np.isfinite(l1) and loss_diff <= BF16_LOSS_RTOL and grad_diff <= BF16_GRAD_RTOL):
        raise AssertionError(f"[25a] remat: loss rel diff {loss_diff}, gradient {grad_diff}")
    if p1 >= p0:
        raise AssertionError(f"[25a] remat's peak {p1} bytes is not below {p0}")
    return {False: (ms0, p0), True: (ms1, p1)}


def phase_attention_routes() -> dict:
    """[25b] unet1 at 128x128 through each cell of the attention table from
    the same weights: one bf16 forward at batch ROUTE_BATCH, its output
    against the kernel route's and its peak device memory above the weights;
    then a forward and backward at batch 2, every gradient against the
    kernel route's. Limits: relative L2 BF16_GRAD_RTOL (phase 9's gradient
    limit): the routes differ in where bf16 rounds the probabilities (the
    kernel's online softmax, the plain version's fp32 softmax cast once),
    carried through 11 blocks. Tiny-head launches 11 a forward (and 11
    backward launches) where the table says kernel, else 0. The chunked
    routes' peak must sit below the unchunked plain route's. Returns {cell:
    peak bytes}."""
    import torch

    from masked_diffusion_tpu_torch.models.unet import attention_route
    from masked_diffusion_tpu_torch.models.zoo import Model

    dev = torch.device("cuda")
    torch.manual_seed(0)
    ref = Model("unet1", 3, ROUTE_SIZE, ROUTE_SIZE)
    ref.conv_out.reset_parameters()  # random, not zero: the output must depend on it
    per_forward = tinyhead_per_forward(ref.config)
    gen = torch.Generator(device=dev).manual_seed(25)
    x = torch.randn((ROUTE_BATCH, 3, ROUTE_SIZE, ROUTE_SIZE), generator=gen,
                    device=dev).to(torch.bfloat16)
    t = torch.full((ROUTE_BATCH,), 10.0, device=dev)
    outs, grads, peaks = {}, {}, {}

    def rel_l2(a, b):
        return (sum(float((x_ - y).square().sum()) for x_, y in zip(a, b))
                / sum(float(y.square().sum()) for y in b)) ** 0.5

    for tiny, chunk in ROUTE_CELLS:
        cell = f"tinyhead {tiny}, chunk {chunk}"
        model = Model("unet1", 3, ROUTE_SIZE, ROUTE_SIZE, attention_chunk=chunk,
                      tinyhead_attention=tiny)
        model.load_state_dict(ref.state_dict())
        model = model.to(device=dev, dtype=torch.bfloat16)
        route = attention_route(model.config, 64 * 64, 8)
        want = per_forward if route == "kernel" else 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(x, t).float()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peaks[(tiny, chunk)] = torch.cuda.max_memory_allocated() - base
        forward = read_counts()["tinyhead_attention"]
        model.zero_grad(set_to_none=True)
        reset_counts()
        model(x[:2], t[:2]).float().square().mean().backward()
        torch.cuda.synchronize()
        c = read_counts()
        if (forward, c["tinyhead_attention"], c["tinyhead_attention_backward"]) != (want,) * 3:
            raise AssertionError(f"[25b] {cell}: tinyhead launches forward {forward}, with grad "
                                 f"{c['tinyhead_attention']} and {c['tinyhead_attention_backward']}"
                                 f", expected {want} each (S=4096 route {route})")
        outs[(tiny, chunk)] = out
        grads[(tiny, chunk)] = [p.grad.float() for p in model.parameters()]
        key = ROUTE_CELLS[0]
        out_diff = rel_l2([out], [outs[key]])
        grad_diff = rel_l2(grads[(tiny, chunk)], grads[key])
        log(f"[25b] unet1 {ROUTE_SIZE}x{ROUTE_SIZE} bf16, {cell}: route at S=4096 {route}, "
            f"at S=1024 {attention_route(model.config, 32 * 32, 8)}; forward at batch "
            f"{ROUTE_BATCH} {seconds:.3f} s (first call), peak device memory above the weights "
            f"{peaks[(tiny, chunk)] / 2**30:.3f} GiB; tinyhead launches {want} forward and "
            f"backward; against the kernel route: output rel L2 {out_diff:.3g}, max |diff| "
            f"{float((out - outs[key]).abs().max()):.3g}, gradient rel L2 {grad_diff:.3g} "
            f"(limit {BF16_GRAD_RTOL})")
        if not bool(torch.isfinite(out).all()) or out_diff > BF16_GRAD_RTOL or (
                grad_diff > BF16_GRAD_RTOL):
            raise AssertionError(f"[25b] {cell}: output rel L2 {out_diff}, gradient {grad_diff}")
        del model, out
    plain = peaks[(False, None)]
    for cell in ((None, 512), (False, 512)):
        if peaks[cell] >= plain:
            raise AssertionError(f"[25b] chunked {cell} peak {peaks[cell]} bytes is not below "
                                 f"the unchunked plain route's {plain}")
    del outs, grads
    torch.cuda.empty_cache()
    return peaks


def phase_encoder_reuse(workdir: str) -> dict:
    """[25c] --method sample --encoder_reuse REUSE_K through the CLI on phase
    10's checkpoint (batch 16, log + indexing, T = 200), then the same
    request without reuse: kernel 1 once a reverse step, GroupNorm forward
    71 on a refreshing step and 40 on a replaying one (18 up ResnetBlocks x
    2, 3 attention blocks, norm_out), so 71*ceil(n/2) + 40*floor(n/2) over
    n steps. Then the plain branch with K = 2 on CUDA against the CPU path
    (phase 19's harness: batch 2, 10 steps, dependent_prev + boosting +
    indexing). Returns the CLI runs' launches."""
    import glob

    import torch

    from masked_diffusion_tpu_torch.sample.latent import latent_initial

    (ckpt,) = glob.glob(os.path.join(workdir, "train", "**", "checkpoint-epoch-*"),
                        recursive=True)
    _, common = flagship_cli_args(workdir)
    ms, total = {}, {}
    for k in (REUSE_K, 0):
        rc, served, counts = _run_cli(["--method", "sample", "--test_model_path", ckpt,
                                       "--dir_work", os.path.join(workdir, f"reuse{k}"),
                                       *common, "--encoder_reuse", str(k)], "sample_stats")
        n, batches = served["steps"], served["batches"]
        refresh = -(-n // k) if k > 1 else n
        want = {"fused_degrade_update": n * batches, "exact_count_masks": 0,
                "group_norm_silu": batches * (71 * refresh + 40 * (n - refresh)),
                "group_norm_silu_backward": 0, "tinyhead_attention": 0}
        if rc != 0 or not (served["finite"] and served["ema"]) or any(
                counts[key] != v for key, v in want.items()) or not same_through_sharded(counts):
            raise AssertionError(f"[25c] --encoder_reuse {k}: rc {rc}, {served}, launches "
                                 f"{counts}, expected {want}")
        ms[k] = served["ms_per_step"]
        total = {key: total.get(key, 0) + v for key, v in counts.items()}
        log(f"[25c] served phase 10's checkpoint with --encoder_reuse {k}: {served['images']} "
            f"images, {n} steps x {batches} batches, {ms[k]:.3f} ms a reverse step; GroupNorm "
            f"forward launches {counts['group_norm_silu']} (expected "
            f"{want['group_norm_silu']}), fused {counts['fused_degrade_update']}")
    log(f"[25c] --encoder_reuse {REUSE_K}: {ms[REUSE_K]:.3f} ms a reverse step against "
        f"{ms[0]:.3f} exact, the same request in turn")
    latent = latent_initial(torch.Generator().manual_seed(3), 2, 3, SIZE, "uniform",
                            device="cpu")
    what, sched, select, flags = SAMPLING_MODES[1][:4]
    plain_branch_parity(_flagship_weights(19), latent, f"{what}, --encoder_reuse {REUSE_K}",
                        sched, select, flags, False, 10, "[25c]",
                        ("--encoder_reuse", str(REUSE_K)))
    torch.backends.cudnn.allow_tf32 = True
    return total


def phase_switches_cli(workdir: str) -> dict:
    """[25d] unet1 at 128x128, bf16, through the CLI with --remat true
    --tinyhead_attention false --attention_chunk 512 --encoder_reuse 2: one
    epoch of 2 steps, the cadence's sampler at T = 16: exit 0, no tiny-head
    launch, the recomputed norms and the reuse counted, a checkpoint; then
    that checkpoint served without the switches: 11 tiny-head launches a
    reverse step. Returns the launches of both runs."""
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.models.unet import GroupNormAct
    from masked_diffusion_tpu_torch.models.zoo import Model

    common = [
        "--model", "unet1", "--data_name", "synthetic", "--data_size", str(ROUTE_SIZE),
        "--data_subset", "True", "--data_subset_num", "4", "--batch_size", "2",
        "--sample_num", "2", "--mixed_precision", "bf16", "--ddpm_schedule", "log",
        "--ddpm_num_steps", "16", "--select_degrade_pixel", "indexing",
        "--mean_option", "degraded_area", "--mean_area", "image-wise",
        "--shift_type", "1-d_constant", "--momentum_adaptive", "base_momentum",
        "--sampling_mask_dependency", "independent", "--use_wandb", "False",
        "--device", "cuda", "--dir_work", os.path.join(workdir, "switches"),
    ]
    switches = ["--remat", "true", "--tinyhead_attention", "false", "--attention_chunk", "512",
                "--encoder_reuse", str(REUSE_K)]
    rc, stats, train = _run_cli(
        ["--method", "mean_shift", "--num_epochs", "1", "--save_images_epochs", "1",
         "--sampling", "momentum", "--optim", "adamw", "--lr", "1e-4", "--lr_scheduler",
         "cosine", "--lr_warmup_steps", "0", "--use_ema", "True", *switches, *common],
        "train_stats")
    with torch.device("meta"):
        model = Model("unet1", 3, ROUTE_SIZE, ROUTE_SIZE)
    norms = sum(isinstance(m, GroupNormAct) for m in model.modules())
    decode = sum(isinstance(m, GroupNormAct) for m in model.up_blocks.modules()) + 1
    resnets = sum(len(b.resnets) for b in (*model.down_blocks, *model.up_blocks))
    n = train["fused_degrade_update"]  # the cadence's reverse steps
    refresh = -(-n // REUSE_K)
    want = {"tinyhead_attention": 0, "tinyhead_attention_backward": 0,
            "group_norm_silu_backward": 2 * norms, "exact_count_masks": 2 + 1,
            "group_norm_silu": 2 * (norms + 2 * resnets) + norms + refresh * norms
            + (n - refresh) * decode}
    if (rc != 0 or stats["global_step"] != 2 or len(stats["checkpoints"]) != 1 or not n
            or not np.isfinite(stats["loss_mean_epoch"]).all()
            or any(train[k] != v for k, v in want.items()) or not same_through_sharded(train)):
        raise AssertionError(f"[25d] train CLI with the switches: rc {rc}, {stats}, launches "
                             f"{train}, expected {want}")
    (ckpt,) = stats["checkpoints"]
    log(f"[25d] unet1 {ROUTE_SIZE}x{ROUTE_SIZE} trained through the CLI with "
        f"{' '.join(switches)}: losses {[round(v, 5) for v in stats['loss_mean_epoch']]}, "
        f"{stats['ms_per_step']:.3f} ms/step; launches {train} (GroupNorm forward {norms} + "
        f"{2 * resnets} recomputed a step; the cadence {refresh} full and {n - refresh} decode "
        f"forwards)")
    rc, served, serve = _run_cli(["--method", "sample", "--test_model_path", ckpt, *common],
                                 "sample_stats")
    n_steps = served["steps"] * served["batches"]
    per_forward = tinyhead_per_forward(model.config)
    if rc != 0 or not (served["finite"] and served["ema"]) or (
            serve["tinyhead_attention"] != per_forward * n_steps
            or serve["fused_degrade_update"] != n_steps):
        raise AssertionError(f"[25d] served without the switches: rc {rc}, {served}, launches "
                             f"{serve}")
    log(f"[25d] its checkpoint served without the switches: {served['images']} images, "
        f"{served['steps']} steps, {served['ms_per_step']:.3f} ms a reverse step; launches "
        f"{serve} ({per_forward} tinyhead launches a forward)")
    return {k: train[k] + serve[k] for k in train}


# phase 26: the legacy GAN/EBM path (cli/main_train.py) ------------------

LEGACY_BATCH = 128  # the legacy CLI's default --batch_size
LEGACY_LANGEVIN = dict(langevin_length=3, langevin_lr=0.01, langevin_noise_lr=0.001)
# one GAN step, card vs CPU, fp32 with TF32 off, from the same weights and
# draws. Losses: fp32 sums in another order through 3 Langevin steps
# (relative). Gradients and parameter updates, relative L2 over each
# network: the generator's gradient is taken through the updated
# discriminator, where Adam's first step moves each coordinate by about
# +-lr whatever its gradient's size, so coordinates whose gradient is near
# zero may move the other way on the other device; each parameter stays
# within 2 lr of the CPU's.
GAN_LR = 2e-4  # the CLI's --lr_generator_max and --lr_discriminator_max
GAN_LOSS_RTOL = 1e-4
GAN_GRAD_RTOL = 1e-3
GAN_UPDATE_RTOL = 1e-2
LEGACY_FWD_RTOL = 1e-5  # forwards, card vs CPU, fp32 with TF32 off, relative L2
LEGACY_WIDTH, LEGACY_SIZE, LEGACY_FWD_BATCH = 32, 256, 4  # the saliency stack's


def _rel_l2(a, b) -> float:
    import torch

    a, b = (torch.cat([t.detach().float().cpu().reshape(-1) for t in x]) for x in (a, b))
    return float((a - b).norm() / b.norm())


def phase_gan_step(smi: str) -> dict:
    """[26a] One GANTrainer step at the legacy CLI's full widths (dim_feature
    32, dim_latent 100, batch 128, 32x32x3, Adam, 3 Langevin steps,
    weight_reg 0.01) on the card and on the CPU from the same weights,
    batch and injected draws, fp32 with TF32 off: both losses, each
    network's gradient and update; then ms/step on the card over 10 steps
    after 2 of warm-up, and a profiled window of 3 steps (device busy ms,
    idle share, kernels a step). Returns {"ms": ms/step, "profile": ...}."""
    import torch

    from masked_diffusion_tpu_torch.train.gan_trainer import GANTrainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(dim_latent=100, dim_features=32, out_channels=3, total_steps=100,
              lr_g=GAN_LR, lr_d=GAN_LR, weight_reg=0.01, optim_name="adam", seed=26,
              **LEGACY_LANGEVIN)
    cpu, dev = GANTrainer(device="cpu", **kw), GANTrainer(device="cuda", **kw)
    init = {n: {k: v.clone() for k, v in net.state_dict().items()}
            for n, net in (("G", cpu.G), ("D", cpu.D))}
    if _rel_l2(dev.G.parameters(), cpu.G.parameters()) or _rel_l2(dev.D.parameters(),
                                                                  cpu.D.parameters()):
        raise AssertionError("[26a] the same seed made other weights on the card")
    gen = torch.Generator().manual_seed(26)
    real = torch.rand(LEGACY_BATCH, 3, 32, 32, generator=gen)
    z, noise = cpu.draws(LEGACY_BATCH, gen)
    m_dev = dev.step(real.cuda(), z.cuda(), noise.cuda())
    torch.cuda.synchronize()
    m_cpu = cpu.step(real, z, noise)
    losses = {k: (float(m_dev[k]), float(m_cpu[k])) for k in m_cpu}
    loss_diff = max(abs(a - b) / abs(b) for a, b in losses.values())
    out = {}
    for name, a, b in (("G", dev.G, cpu.G), ("D", dev.D, cpu.D)):
        grad = _rel_l2([p.grad for p in a.parameters()], [p.grad for p in b.parameters()])
        upd = _rel_l2([p.detach().cpu() - init[name][k] for k, p in a.named_parameters()],
                      [p.detach() - init[name][k] for k, p in b.named_parameters()])
        far = max(float((p.detach().cpu() - q.detach()).abs().max())
                  for p, q in zip(a.parameters(), b.parameters()))
        out[name] = (grad, upd, far)
    log(f"[26a] GAN step at the legacy CLI's widths (dim_feature 32, dim_latent 100, batch "
        f"{LEGACY_BATCH}, 32x32x3, adam, Langevin {LEGACY_LANGEVIN['langevin_length']}), card "
        f"vs CPU, fp32 TF32 off: losses (card, CPU) {losses}, max rel diff {loss_diff:.3g} "
        f"(tol {GAN_LOSS_RTOL}); gradient / update rel L2 and max |param diff|: "
        + ", ".join(f"{n} {g:.3g} / {u:.3g} / {f:.3g}" for n, (g, u, f) in out.items())
        + f" (tol {GAN_GRAD_RTOL} / {GAN_UPDATE_RTOL} / 2 lr = {2 * GAN_LR:g})")
    if not all(map(math.isfinite, sum(losses.values(), ()))) or loss_diff > GAN_LOSS_RTOL:
        raise AssertionError(f"[26a] losses {losses}")
    for name, (grad, upd, far) in out.items():
        if grad > GAN_GRAD_RTOL or upd > GAN_UPDATE_RTOL or far > 2 * GAN_LR:
            raise AssertionError(f"[26a] {name}: gradient {grad}, update {upd}, max {far}")
    torch.backends.cudnn.allow_tf32 = True
    for _ in range(2):
        dev.step(real.cuda())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        dev.step(real.cuda())
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 10
    from masked_diffusion_tpu_torch.utils.profiling import summarize

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            dev.step(real.cuda())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof_sum = summarize(prof, wall, True)
    top = ", ".join(f"{r['name'][:60]} {r['ms'] / 3:.3f} ms" for r in prof_sum["top_device"][:4])
    log(f"[26a] GAN step on the card ({smi}): {ms:.3f} ms/step over 10 steps after 2 of "
        f"warm-up, batch {LEGACY_BATCH}, TF32 on in cuDNN, the trainer's own draws; a "
        f"profiled window of 3 steps: {prof_sum['wall_ms'] / 3:.3f} ms wall, "
        f"{prof_sum['device_busy_ms'] / 3:.3f} ms device busy a step (idle share "
        f"{prof_sum['device_idle_share']:.4f}), {prof_sum['device_kernels'] / 3:.1f} device "
        f"kernels a step; largest: {top}")
    return {"ms": ms, "profile": prof_sum}


def phase_legacy_forwards(smi: str) -> dict:
    """[26b] The EBGAN models at their sizes (EBGenerator and EBDiscriminator
    at 32x32x1, AutoEncoder at 28x28x1) and the saliency stack at width 32,
    256x256x3 (GeneratorLatent with an 8-d latent, GeneratorBaseLine,
    Descriptor, holistic_attention), batch 4, weights from init_like_flax
    and every PAM/CAM gamma set to 0.5: each forward on the card against
    the CPU, fp32 with TF32 off, within LEGACY_FWD_RTOL relative L2, and
    each forward's device ms (cuda_ms). Returns {name: (rel L2, ms)}."""
    import torch

    from masked_diffusion_tpu_torch.models import ebgan, saliency
    from masked_diffusion_tpu_torch.models.gan import init_like_flax

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(26)
    b, w, s = LEGACY_FWD_BATCH, LEGACY_WIDTH, LEGACY_SIZE
    img = torch.rand(b, 3, s, s, generator=gen) * 2 - 1
    seg = torch.rand(b, 1, s, s, generator=gen)
    cases = {
        "EBGenerator": (ebgan.EBGenerator(), (torch.randn(b, 62, generator=gen),)),
        "EBDiscriminator": (ebgan.EBDiscriminator(),
                            (torch.rand(b, 1, 32, 32, generator=gen) * 2 - 1,)),
        "AutoEncoder": (ebgan.AutoEncoder(), (torch.rand(b, 1, 28, 28, generator=gen),)),
        "GeneratorLatent": (saliency.SaliencyModel("generator", "from_latent", w, 8),
                            (img, torch.randn(b, 8, generator=gen))),
        "GeneratorBaseLine": (saliency.SaliencyModel("generator", "from_image", w), (img,)),
        "Descriptor": (saliency.SaliencyModel("descriptor", width=w), (img, seg)),
    }
    out = {}
    for name, (model, args) in cases.items():
        init_like_flax(model, gen).eval()
        with torch.no_grad():
            for m in model.modules():
                if hasattr(m, "gamma"):
                    m.gamma.fill_(0.5)
            want = model(*args)
            model.cuda()
            dargs = tuple(a.cuda() for a in args)
            got = model(*dargs)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: model(*dargs))[0]
        pairs = list(zip(got, want)) if isinstance(want, tuple) else [(got, want)]
        err = max(_rel_l2([g], [w_]) for g, w_ in pairs)
        out[name] = (err, ms)
    attn, feat = seg, img
    want = saliency.holistic_attention(attn, feat)
    dattn, dfeat = attn.cuda(), feat.cuda()
    got = saliency.holistic_attention(dattn, dfeat)
    out["holistic_attention"] = (_rel_l2([got], [want]), cuda_ms(
        lambda: saliency.holistic_attention(dattn, dfeat))[0])
    log(f"[26b] legacy forwards, batch {b}, card vs CPU, fp32 TF32 off ({smi}), rel L2 and "
        f"device ms: " + ", ".join(f"{k} {e:.3g} {t:.4f} ms" for k, (e, t) in out.items())
        + f" (saliency at width {w}, {s}x{s}; tol {LEGACY_FWD_RTOL})")
    bad = {k: e for k, (e, _) in out.items() if not e <= LEGACY_FWD_RTOL}
    if bad:
        raise AssertionError(f"[26b] forwards off: {bad}")
    torch.backends.cudnn.allow_tf32 = True
    return out


def phase_legacy_cli(workdir: str, smi: str) -> dict:
    """[26c] The legacy entry point on the card (cli/main_train.main):
    synthetic 32x32 (1024 images), batch 128, 2 epochs (16 steps),
    --langevin_length 5, --save_every 1: exit 0, finite losses, two sample
    grids, ms/step from its gan_stats line."""
    from masked_diffusion_tpu_torch.cli.main_train import main

    argv = ["--device", "cuda", "--data_name", "synthetic", "--data_size", "32",
            "--batch_size", str(LEGACY_BATCH), "--epoch_length", "2", "--save_every", "1",
            "--langevin_length", "5", "--langevin_lr", "0.01", "--langevin_noise_lr", "0.001",
            "--dir_work", os.path.join(workdir, "legacy")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    sys.stdout.write(buf.getvalue())
    line = next(ln for ln in buf.getvalue().splitlines() if ln.startswith("gan_stats "))
    stats = json.loads(line.split(" ", 1)[1])
    pngs = [os.path.basename(p) for p in stats["samples"] if os.path.exists(p)]
    if (rc != 0 or stats["steps"] != 16 or pngs != ["gan_sample_00000.png",
                                                   "gan_sample_00001.png"]
            or not all(map(math.isfinite, stats["loss_g"] + stats["loss_d"]))):
        raise AssertionError(f"[26c] legacy CLI: rc {rc}, {stats}")
    log(f"[26c] legacy CLI on the card ({smi}): {stats['steps']} steps in 2 epochs, "
        f"{stats['ms_per_step']:.3f} ms/step (host clock, first step's warm-up included), "
        f"losses G {stats['loss_g']} D {stats['loss_d']}, grids {pngs}")
    return stats


SCAN_STEPS = 8  # (a): one epoch of 8 steps at batch 64 (512 images)
SCAN_CURRICULA = 4  # (b): 4 epochs of 2 steps, each on its own curriculum (3 changes)
SCAN_MEMORY_SLACK = 1.02  # (b): a recapture's peak and reserved bytes within 2% of the first's
SCAN_PROFILED = 4  # (g): steps in each profiled window
SCAN_STREAM_REPS = 8  # (f): backward launches on each of two streams
# the host's calls that put work on the card, by the prefix of their names
HOST_LAUNCHES = ("cudaGraphLaunch", "cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


class _MaskProbe:
    """exact_count_masks wrapped so that every launch also copies its masks
    and counts into row `i` of device buffers and advances `i` (device ops,
    so a CUDA graph replays them too). The wrapper's launch count carries
    over both ways."""

    def __init__(self, steps: int, batch: int, hw: int):
        import torch

        from masked_diffusion_tpu_torch.ops import kmask

        self.kmask, self.orig = kmask, kmask.exact_count_masks
        self.masks = torch.zeros((steps, batch, hw), dtype=torch.float32, device="cuda")
        self.counts = torch.zeros((steps, batch), dtype=torch.int32, device="cuda")
        self.i = torch.zeros(1, dtype=torch.int64, device="cuda")
        orig, probe = self.orig, self

        def recorded(batch, height, width, counts, **kw):
            out = orig(batch, height, width, counts, **kw)
            probe.masks.index_copy_(0, probe.i, out.reshape(1, batch, height * width))
            probe.counts.index_copy_(0, probe.i, counts.reshape(1, batch))
            probe.i.add_(1)
            return out

        self.recorded = recorded

    def __enter__(self):
        self.recorded.launches = self.orig.launches
        self.recorded.__name__ = self.orig.__name__
        self.kmask.exact_count_masks = self.recorded
        self.i.zero_()
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.recorded.launches
        self.kmask.exact_count_masks = self.orig

    def read(self):
        n = int(self.i)
        return self.masks[:n].clone(), self.counts[:n].clone()


def _scan_setup(workdir: str, sched: str, select: str, steps: int, images: int, *extra):
    """(cfg, device, dataset, histogram) of the flagship (phase 10's flags) in
    one schedule mode, one epoch over `images` images, no cadence."""
    from masked_diffusion_tpu_torch.cli.main_train_masked import parse
    from masked_diffusion_tpu_torch.data.datasets import get_dataset
    from masked_diffusion_tpu_torch.data.histogram import compute_mean_histogram

    argv, _ = flagship_cli_args(workdir)
    argv = _with(argv, "--ddpm_schedule", sched, "--select_degrade_pixel", select,
                 "--ddpm_num_steps", str(steps), "--data_subset_num", str(images),
                 "--num_epochs", "1", "--save_images_epochs", "1000", *extra)
    cfg, device = parse(argv)
    data = get_dataset(cfg.dir_dataset, cfg.data_name, cfg.data_size, cfg.data_set,
                       cfg.data_subset, cfg.data_subset_num, seed=cfg.seed)
    return cfg, device, data, compute_mean_histogram(data.data, cfg.sample_num, cfg.mean_area)


_SCAN_MODELS = {}  # the model fields of a config -> its seeded model on the card


def _scan_trainer(cfg, data, hist, device, **changes):
    """A Trainer of cfg with `changes`, on a copy of the model a fresh one
    would build (seeded with cfg.seed): each model is built once a phase."""
    import copy
    import dataclasses

    import torch

    from masked_diffusion_tpu_torch.models.factory import build_model_from_config
    from masked_diffusion_tpu_torch.train.trainer import Trainer

    key = (cfg.seed, cfg.model, cfg.in_channel, cfg.out_channel, cfg.data_size,
           cfg.num_attention, tuple(cfg.block_out_channels or ()), cfg.layers_per_block,
           cfg.remat, cfg.attention_chunk, cfg.tinyhead_attention)
    if key not in _SCAN_MODELS:
        torch.manual_seed(cfg.seed)
        _SCAN_MODELS[key] = build_model_from_config(cfg).to(device)
    return Trainer(dataclasses.replace(cfg, **changes), data, hist,
                   model=copy.deepcopy(_SCAN_MODELS[key]), device=device)


def _full_state(trainer) -> dict:
    """Params, EMA and the optimizer's tensors (AdamW's moments and steps,
    a window's gradient sums) of a trainer, copied to the host."""
    out = _host_state(trainer)
    tensors, _ = trainer.state.optimizer.state_dict()
    out.update({f"o.{k}": v.detach().cpu().clone() for k, v in tensors.items()})
    return out


def _step_losses(trainer) -> list:
    """Wrap the trainer's step and epoch functions so that every step's
    loss is kept (device tensors, read after the run)."""
    kept = []
    get_step, get_epoch = trainer._get_step_fn, trainer._get_epoch_fn

    def step_fn(used):
        fn = get_step(used)

        def step(*a, **k):
            out = fn(*a, **k)
            kept.append(out["train_loss"])
            return out
        return step

    def epoch_fn(used):
        fn = get_epoch(used)

        def epoch(*a, **k):
            keys, mat = fn(*a, **k)
            kept.extend(mat[:, keys.index("train_loss")])
            return keys, mat
        return epoch

    trainer._get_step_fn, trainer._get_epoch_fn = step_fn, epoch_fn
    return kept


def _scan_pair(cfg, device, data, hist, what: str, epochs: int = 1, probe=None):
    """The same run eagerly and with --epoch_scan true from the same initial
    state (a fresh Trainer each, seeded alike): (eager, scan), each a dict
    of the full state, the step losses, the probed masks and counts, the
    launches and the trainer's epoch function (scan)."""
    import torch

    out = []
    for scan in (False, True):
        reset_counts()
        t = _scan_trainer(cfg, data, hist, device, epoch_scan=scan)
        losses = _step_losses(t)
        with probe if probe is not None else contextlib.nullcontext():
            t.train(0, epochs)
            masks = probe.read() if probe is not None else None
        torch.cuda.synchronize()
        out.append({"state": _full_state(t), "losses": [float(v) for v in losses],
                    "means": list(t.loss_mean_epoch), "masks": masks, "counts": read_counts(),
                    "epoch_fn": t._epoch_fn[1] if t._epoch_fn else None,
                    "global_step": t.global_step})
        del t
        _release()
    eager, scan = out
    same = (eager["losses"] == scan["losses"] and eager["means"] == scan["means"]
            and eager["global_step"] == scan["global_step"]
            and all(torch.equal(eager["state"][k], scan["state"][k]) for k in eager["state"]))
    if not same:
        diff = _max_diff(eager["state"], scan["state"])
        raise AssertionError(
            f"[28] {what}: the graphed epoch differs from the eager one: losses "
            f"{eager['losses']} vs {scan['losses']}, max |diff| of the state {diff:.3g}")
    return eager, scan


def _check_masks(what: str, eager, scan, hw: int) -> str:
    """Masks of the replayed kmask launches: the eager run's bit for bit,
    new each step, exactly clip(k, 0, HW) zeros an image."""
    import torch

    (m_e, k_e), (m_s, k_s) = eager["masks"], scan["masks"]
    if m_s.shape[0] < 2 or not (torch.equal(m_e, m_s) and torch.equal(k_e, k_s)):
        raise AssertionError(f"[28] {what}: the replays' masks differ from the eager run's "
                             f"({m_e.shape[0]} vs {m_s.shape[0]} launches)")
    repeats = [j for j in range(m_s.shape[0] - 1) if torch.equal(m_s[j], m_s[j + 1])]
    zeros = (m_s == 0).sum(dim=2)
    want = k_s.to(torch.int64).clamp(0, hw)
    if repeats or not torch.equal(zeros, want):
        raise AssertionError(f"[28] {what}: replays {repeats} repeat the step before, or the "
                             f"zero counts {zeros.tolist()} are not k {want.tolist()}")
    return (f"{m_s.shape[0]} kmask launches, each new, {int(zeros.sum())} degraded pixels "
            f"= sum of k")


def _gn_two_streams() -> float:
    """(f) The GroupNorm backward launched on two streams at once: each
    result bitwise the same call launched alone (the kernel is deterministic),
    and within GN_BWD_TOL (dx) and GN_BWD_SUM_TOL (dscale, dbias) of the
    plain version; each stream's launches use their own arrival counters.
    Returns the largest |dx diff| against the plain version."""
    import torch

    from masked_diffusion_tpu_torch.ops import groupnorm

    gen = torch.Generator(device="cuda").manual_seed(28)
    shapes = ((B_KERNEL, 128, 64, 64, 32), (B_KERNEL, 512, 8, 8, 32))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    worst = 0.0
    for b, c, h, w, g in shapes:
        cases = []
        for _ in streams:
            x = torch.randn((b, c, h, w), generator=gen, device="cuda")
            scale = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
            bias = 0.1 * torch.randn((c,), generator=gen, device="cuda")
            gy = torch.randn((b, c, h, w), generator=gen, device="cuda")
            mean, rstd = groupnorm.group_norm_stats_plain(x, g)
            cases.append((x, scale, bias, gy, mean.contiguous(), rstd.contiguous()))
        alone = [groupnorm.group_norm_silu_backward(*case, g, True) for case in cases]
        torch.cuda.synchronize()
        outs = [[] for _ in streams]
        for _ in range(SCAN_STREAM_REPS):  # both streams' launches in flight together
            for s, case, got in zip(streams, cases, outs):
                s.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(s):
                    got.append(groupnorm.group_norm_silu_backward(*case, g, True))
        torch.cuda.synchronize()
        for case, ref_k, got in zip(cases, alone, outs):
            if not all(torch.equal(a, r) for run in got for a, r in zip(run, ref_k)):
                raise AssertionError(f"[28] (f) {(b, c, h, w, g)}: a launch on one of two "
                                     "streams differs from the same launch alone")
            ref = groupnorm.group_norm_silu_backward_plain(*case, g, True)
            atol, rtol = GN_BWD_TOL["float32"]
            sum_atol = GN_BWD_SUM_TOL[0] * b * h * w
            for a, r, tol in zip(ref_k, ref, ((atol, rtol), (sum_atol, GN_BWD_SUM_TOL[1]),
                                                (sum_atol, GN_BWD_SUM_TOL[1]))):
                if not torch.allclose(a, r, atol=tol[0], rtol=tol[1]):
                    raise AssertionError(f"[28] (f) {(b, c, h, w, g)}: off the plain version "
                                         f"by {float((a - r).abs().max()):.3g}")
            worst = max(worst, float((ref_k[0] - ref[0]).abs().max()))
    return worst


def _profile_window(trainer, epoch: int) -> dict:
    """One epoch of `trainer` under torch.profiler (its first steps warm or
    replayed before): ms a step, the device idle share, and the host's
    launch calls a step by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from masked_diffusion_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        trainer.train(epoch, 1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    summary = profiling.summarize(prof, wall_s, True)
    calls = {}
    for e in prof.events():
        if e.name.startswith(HOST_LAUNCHES):
            calls[e.name] = calls.get(e.name, 0) + 1
    steps = SCAN_PROFILED
    return {"ms": 1e3 * wall_s / steps, "idle": summary["device_idle_share"],
            "busy_ms": summary["device_busy_ms"] / steps,
            "calls": {k: v / steps for k, v in sorted(calls.items())}}


def phase_graphed_epoch(workdir: str, smi: str) -> dict:
    """[28] --epoch_scan true: the train step captured as CUDA graphs and
    replayed once a batch (train/step.py:make_train_epoch), at the
    flagship's width (113.7M parameters, 64x64x3, bf16, batch 64, phase 10's
    flags), held against the eager loop. (f) first, before any capture: the
    GroupNorm backward on two streams at once against its plain version.
    Under deterministic(): (a) one epoch of SCAN_STEPS steps eagerly and
    graphed from the same initial state, in log + indexing (T=4096) and
    linear + thresholding (T=1000): step losses, parameters, EMA and AdamW
    moments bitwise equal; the kmask launches of the replays (probed into
    device buffers) the eager run's bit for bit, each step's new, exactly k
    pixels an image. (b) --gradient_accumulation_steps 2 likewise (two
    graphs: the window's first and closing steps); then 4 epochs of 2 steps
    with --scheduler_num_scale_timesteps 4, a curriculum each: each epoch
    recaptures, and its peak and reserved device memory stay within
    SCAN_MEMORY_SLACK of the first's. (c) the CelebA-HQ config
    (--num_attention 5, batch 32, T=16): 4 steps, the tiny-head forward and
    backward captured, bitwise equal (both kernels deterministic: no
    atomics). (d) 2 epochs of 4 steps graphed (no cadence), uninterrupted
    and SIGTERM'd in-process at global step 6, restored and resumed
    mid-epoch: bitwise equal. Each model is built once and copied
    (_scan_trainer). (e) the CLI with --epoch_scan true, 2 epochs of 4 steps (T=20),
    then its checkpoint served; launches checked. (g) a torch.profiler window of
    SCAN_PROFILED steps eagerly and replayed: host launch calls a step by
    name (one cudaGraphLaunch a replayed step), ms a step and the device's
    idle share, the capture's seconds and the graph pool's bytes. Returns
    the launches of its main-path runs ((a)-(e))."""
    import signal as signals

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    work = os.path.join(workdir, "graphed")
    runs = []
    worst = _gn_two_streams()
    log(f"[28] (f) GroupNorm backward, {SCAN_STREAM_REPS} launches on each of two streams in "
        f"flight together (flagship shapes at batch {B_KERNEL}, fp32): within GN_BWD_TOL of "
        f"the plain version, max |dx diff| {worst:.3g}; each stream's counters its own")

    with deterministic():
        # (a) both schedule modes
        for sched, select, steps in MODES:
            cfg, device, data, hist = _scan_setup(work, sched, select, steps,
                                                  B_KERNEL * SCAN_STEPS)
            probe = _MaskProbe(SCAN_STEPS, B_KERNEL, SIZE * SIZE) if select == "indexing" else None
            eager, scan = _scan_pair(cfg, device, data, hist, f"(a) {select}", probe=probe)
            runs.append(scan["counts"])
            fn = scan["epoch_fn"]
            masks = _check_masks(f"(a) {select}", eager, scan, SIZE * SIZE) if probe else (
                "thresholding: no kmask")
            log(f"[28] (a) {sched} + {select} (T={steps}), {SCAN_STEPS} steps: graphed == eager "
                f"BITWISE (step losses, params, EMA, AdamW moments); {len(fn.graphs)} graph(s) "
                f"captured in {fn.capture_seconds:.3f} s, pool {fn.pool_bytes / 2**20:.1f} MiB; "
                f"{masks}; launches graphed {scan['counts']} vs eager {eager['counts']}")
            if scan["counts"] != eager["counts"]:
                raise AssertionError(f"[28] (a) {select}: launches graphed {scan['counts']} "
                                     f"vs eager {eager['counts']}")

        # (b) accumulation 2, then curriculum changes
        cfg, device, data, hist = _scan_setup(work, "log", "indexing", 4096,
                                              B_KERNEL * SCAN_STEPS,
                                              "--gradient_accumulation_steps", "2")
        eager, scan = _scan_pair(cfg, device, data, hist, "(b) accumulation 2")
        runs.append(scan["counts"])
        kinds = sorted(tuple(int(x) for x in k) for k in scan["epoch_fn"].graphs)
        log(f"[28] (b) --gradient_accumulation_steps 2, {SCAN_STEPS} steps: graphed == eager "
            f"BITWISE; graphs (starts, closes, ema) {kinds}")
        if len(kinds) < 2:
            raise AssertionError(f"[28] (b) accumulation 2 captured {kinds}")
        cfg, device, data, hist = _scan_setup(
            work, "log", "indexing", 4096, B_KERNEL * 2, "--num_epochs", str(SCAN_CURRICULA),
            "--scheduler_num_scale_timesteps", str(SCAN_CURRICULA))
        reset_counts()
        t = _scan_trainer(cfg, data, hist, device, epoch_scan=True)
        peaks, reserved, keys = [], [], []
        for epoch in range(SCAN_CURRICULA):
            torch.cuda.reset_peak_memory_stats()
            t.train(epoch, 1)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            reserved.append(torch.cuda.memory_reserved())
            keys.append(len(t._epoch_fn[0]))
            if not t._epoch_fn[1].graphs:
                raise AssertionError(f"[28] (b) epoch {epoch} captured no graph")
        runs.append(read_counts())
        del t
        _release()
        log(f"[28] (b) {SCAN_CURRICULA} curricula (used timesteps {keys}), each recaptured: "
            f"peak device memory {[round(p / 2**30, 3) for p in peaks]} GiB, reserved "
            f"{[round(r / 2**30, 3) for r in reserved]} GiB ({smi})")
        # a new curriculum makes a new epoch function (Trainer._get_epoch_fn),
        # whose graphs this epoch captured
        if (len(set(keys)) != SCAN_CURRICULA
                or max(peaks[1:]) > SCAN_MEMORY_SLACK * peaks[0]
                or max(reserved[1:]) > SCAN_MEMORY_SLACK * reserved[0]):
            raise AssertionError(f"[28] (b) recaptures: curricula {keys}, peaks {peaks}, "
                                 f"reserved {reserved}")

        # (c) the CelebA-HQ config: the tiny-head kernels inside the graph
        cfg, device, data, hist = _scan_setup(work, "log", "indexing", 16, 32 * 4,
                                              "--num_attention", "5", "--batch_size", "32")
        eager, scan = _scan_pair(cfg, device, data, hist, "(c) CelebA-HQ")
        runs.append(scan["counts"])
        th = (scan["counts"]["tinyhead_attention"], scan["counts"]["tinyhead_attention_backward"])
        if th != (40, 40) or scan["counts"] != eager["counts"]:
            raise AssertionError(f"[28] (c) tiny-head launches {scan['counts']} vs eager "
                                 f"{eager['counts']}, expected 10 forward and 10 backward a step")
        log(f"[28] (c) CelebA-HQ (--num_attention 5, batch 32), 4 steps: graphed == eager "
            f"BITWISE (the tiny-head kernels are deterministic); tiny-head launches {th}")

        # (d) mid-epoch resume of a graphed run
        # no cadence (dirs only where the preemption writes its checkpoint):
        # (e) runs the cadence with the scan on
        cfg, device, data, hist = _scan_setup(work, "log", "indexing", 200, B_KERNEL * 4,
                                              "--num_epochs", "2", "--epoch_scan", "true")
        reset_counts()
        ref_t = _scan_trainer(cfg, data, hist, device)
        ref_t.train(0, 2)
        ref = _full_state(ref_t)
        ref_losses = list(ref_t.loss_mean_epoch)
        runs.append(read_counts())
        del ref_t
        _release()
        reset_counts()
        pre = _scan_trainer(cfg, data, hist, device)
        done = pre._step_done

        def step_done(single):
            if pre.global_step + 1 == PREEMPT_AT:
                signals.raise_signal(signals.SIGTERM)
            return done(single)

        pre._step_done = step_done
        result = pre.train(0, 2, dirs=_run_dirs(cfg, work, "d"))
        if not result["preempted"] or pre.global_step != PREEMPT_AT:
            raise AssertionError(f"[28] (d) SIGTERM at step {PREEMPT_AT}: {result}")
        (path,) = result["checkpoints"]
        del pre, done
        _release()
        res = _scan_trainer(cfg, data, hist, device)
        gs = res.restore(path)
        first, skip = divmod(gs, data.num_batches(cfg.batch_size))
        res.train(first, 2 - first, skip, gs)
        runs.append(read_counts())
        got = _full_state(res)
        if not (all(torch.equal(ref[k], got[k]) for k in ref)
                and res.loss_mean_epoch == ref_losses):
            raise AssertionError(f"[28] (d) resumed graphed run differs: max |diff| "
                                 f"{_max_diff(ref, got):.3g}, losses {res.loss_mean_epoch} vs "
                                 f"{ref_losses}")
        del res
        _release()
        log(f"[28] (d) graphed, 2 epochs of 4 steps: SIGTERM'd at global step {PREEMPT_AT}, "
            f"restored and resumed at epoch {first} step {skip}: BITWISE equal to the "
            f"uninterrupted graphed run (params, EMA, AdamW state, epoch means)")

    # (e) the CLI, at T=20 (the cadence's sampler and the serve: 20 reverse steps)
    argv, common = flagship_cli_args(os.path.join(work, "cli"))
    argv, common = (_with(a, "--ddpm_num_steps", "20") for a in (argv, common))
    rc, stats, counts = _run_cli(argv + ["--epoch_scan", "true"], "train_stats")
    (ckpt,) = stats["checkpoints"]
    if (rc != 0 or stats["global_step"] != 8 or counts["exact_count_masks"] != 8 + 1
            or not np.isfinite(stats["loss_mean_epoch"]).all()):
        raise AssertionError(f"[28] (e) CLI --epoch_scan true: rc {rc}, {stats}, {counts}")
    runs.append(counts)
    rc, served, counts = _run_cli(["--method", "sample", "--test_model_path", ckpt,
                                   "--dir_work", os.path.join(work, "serve"), *common],
                                  "sample_stats")
    if rc != 0 or not (served["finite"] and served["images"] == 16):
        raise AssertionError(f"[28] (e) serve the graphed run's checkpoint: rc {rc}, {served}")
    runs.append(counts)
    log(f"[28] (e) CLI --epoch_scan true (T=20): 2 epochs x 4 steps, losses "
        f"{[round(v, 5) for v in stats['loss_mean_epoch']]}, {stats['ms_per_step']:.3f} ms/step "
        f"(epoch 1, replayed); served {served['images']} images from "
        f"{os.path.basename(ckpt)}")

    # (g) profile: eager and replayed steps
    cfg, device, data, hist = _scan_setup(work, "log", "indexing", 200,
                                          B_KERNEL * SCAN_PROFILED, "--num_epochs", "3")
    prof = {}
    for scan in (False, True):
        t = _scan_trainer(cfg, data, hist, device, epoch_scan=scan)
        t.train(0, 1)  # warm-up and, graphed, the captures
        prof[scan] = _profile_window(t, 1)
        if scan:
            fn = t._epoch_fn[1]
            prof["capture_s"], prof["pool"] = fn.capture_seconds, fn.pool_bytes
        del t
        _release()
    graph_launches = prof[True]["calls"].get("cudaGraphLaunch", 0)
    log(f"[28] (g) a step of the flagship (batch {B_KERNEL}, bf16, log + indexing), "
        f"{SCAN_PROFILED} steps a window, {smi}: eager {prof[False]['ms']:.3f} ms (device busy "
        f"{prof[False]['busy_ms']:.3f} ms, idle share {prof[False]['idle']:.4f}), host calls a "
        f"step {prof[False]['calls']}; graphed {prof[True]['ms']:.3f} ms (device busy "
        f"{prof[True]['busy_ms']:.3f} ms, idle share {prof[True]['idle']:.4f}), host calls a "
        f"step {prof[True]['calls']}; capture {prof['capture_s']:.3f} s, graph pool "
        f"{prof['pool'] / 2**20:.1f} MiB")
    if graph_launches != 1:
        raise AssertionError(f"[28] (g) {graph_launches} cudaGraphLaunch a replayed step")
    _SCAN_MODELS.clear()
    log(f"[28] phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(c[k] for c in runs) for k in runs[0]}


# [29] the trainer's device-data rule and the launch farm (scripts_torch/)
HOSTDATA_STEPS = 3  # (a): steps an epoch at batch 64
HOSTDATA_EPOCHS = 3  # (a): the first warms up; ms/step over the other two
HOSTDATA_COPIES = 20  # (a): batches gathered and copied in to time one
FARM_SCRIPT = os.path.join("scripts_torch", "train", "celeba_hq", "masked_shift_mean",
                           "script_main.sh")
FARM_IMAGES = 64  # MDT_SUBSET (the script's 128): 2 steps an epoch at its batch of 32
FARM_IMAGE_HW = 128  # the synthesized CelebA-HQ files, resized to the script's 64x64
# the script's workload flags cut through MDT_EXTRA_ARGS (its values in brackets)
FARM_CUTS = ("--num_epochs", "2",  # (50000) one cadence, at the last epoch
             "--ddpm_num_steps", "20",  # (4096: 1421 reverse steps a cadence) 20 steps
             "--sample_num", "16")  # (64) the cadence's batch
FARM_RANKS = 2  # gpu_h100_4.sh with MDT_NPROC=2, both ranks on cuda:0 over gloo
FARM_TIMEOUT = 600  # seconds for one script run


def launched_main(out_dir: str, argv) -> int:
    """A farm script's CLI started by phase 29's launcher prefix
    (`chip_smoke.py --launched <dir> -m masked_diffusion_tpu_torch.cli.
    main_train_masked <script's flags>`, one a rank under
    torch.distributed.run): the CLI's main(script's flags) under
    deterministic(), every launch count set to 0 just before. After it,
    <dir>/rank<r>.json holds its counts, the CUDA graphs captured and
    replayed, the calls of make_train_epoch and whether each Trainer.train
    kept the dataset on the card."""
    module = "masked_diffusion_tpu_torch.cli.main_train_masked"
    if argv[:2] != ["-m", module]:
        raise SystemExit(f"--launched runs -m {module}, not {argv[:2]}")
    sys.path.insert(0, ROOT)
    import torch

    import masked_diffusion_tpu_torch.train.trainer as trainer_mod
    from masked_diffusion_tpu_torch.cli.main_train_masked import main

    seen = {}
    capture, replay = torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.replay
    make_epoch, train = trainer_mod.make_train_epoch, trainer_mod.Trainer.train

    def capture_counted(self, *a, **k):
        seen["graphs"] += 1
        return capture(self, *a, **k)

    def replay_counted(self):
        seen["replays"] += 1
        return replay(self)

    def make_epoch_counted(*a, **k):
        seen["epoch_fns"] += 1
        return make_epoch(*a, **k)

    def train_seen(self, *a, **k):
        try:
            return train(self, *a, **k)
        finally:
            seen["data_on_device"].append(self._data_dev is not None)

    torch.cuda.CUDAGraph.capture_begin = capture_counted
    torch.cuda.CUDAGraph.replay = replay_counted
    trainer_mod.make_train_epoch = make_epoch_counted
    trainer_mod.Trainer.train = train_seen
    seen.update(graphs=0, replays=0, epoch_fns=0, data_on_device=[])
    reset_counts()
    with deterministic():
        rc = main(argv[2:])
    if rc != 0:
        return rc
    with open(os.path.join(out_dir, f"rank{os.environ.get('RANK', '0')}.json"), "w") as f:
        json.dump({"counts": read_counts(), **seen}, f)
    return 0


def _hostdata_step_ms(workdir: str, smi: str):
    """(a) The flagship (batch 64, bf16, log + indexing at T=4096) through
    the Trainer API with the dataset on the card (MDT_DEVICE_DATA=1) and
    with each batch copied in from the host (=0), in turns device, host,
    host, device: ms/step over epochs 2-3 of 3 of 3 steps; then one
    batch's gather, pinning and copy (host clock, synchronised) and the
    copy alone on the card (events). Returns (ms/step by path, the
    launches)."""
    import numpy as np
    import torch

    cfg, device, data, hist = _scan_setup(workdir, "log", "indexing", 4096,
                                          B_KERNEL * HOSTDATA_STEPS)
    saved = os.environ.get("MDT_DEVICE_DATA")
    ms = {True: [], False: []}
    reset_counts()
    try:
        for on_device in (True, False, False, True):
            os.environ["MDT_DEVICE_DATA"] = "1" if on_device else "0"
            t = _scan_trainer(cfg, data, hist, device)
            result = t.train(0, HOSTDATA_EPOCHS)
            torch.cuda.synchronize()
            if (t._data_dev is not None) != on_device or t.global_step != (
                    HOSTDATA_EPOCHS * HOSTDATA_STEPS) or not np.isfinite(t.loss_mean_epoch).all():
                raise AssertionError(f"[29a] MDT_DEVICE_DATA={int(on_device)}: dataset on the "
                                     f"card {t._data_dev is not None}, global step "
                                     f"{t.global_step}, losses {t.loss_mean_epoch}")
            ms[on_device].append(result["ms_per_step"])
            if not on_device and len(ms[False]) == 2:
                rows = np.random.default_rng(29).permutation(len(data))[:B_KERNEL]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOSTDATA_COPIES):
                    batch = t._batch(rows)
                torch.cuda.synchronize()
                batch_ms = 1e3 * (time.perf_counter() - t0) / HOSTDATA_COPIES
                if not torch.equal(batch.cpu(), torch.from_numpy(data.data[rows])):
                    raise AssertionError("[29a] a host batch differs from the dataset's rows")
                pinned = torch.from_numpy(data.data[rows]).pin_memory()
                copy_ms = _event_ms(lambda: pinned.to(device, non_blocking=True),
                                    HOSTDATA_COPIES)
            del t
            _release()
    finally:
        if saved is None:
            os.environ.pop("MDT_DEVICE_DATA", None)
        else:
            os.environ["MDT_DEVICE_DATA"] = saved
    counts = read_counts()
    _SCAN_MODELS.clear()
    host_ms = statistics.median(ms[False])
    nbytes = B_KERNEL * data.data[0].nbytes
    log(f"[29a] the flagship (batch {B_KERNEL}, bf16, log + indexing, T=4096), "
        f"{HOSTDATA_EPOCHS} epochs of {HOSTDATA_STEPS} steps through the Trainer, ms/step of "
        f"epochs 2-{HOSTDATA_EPOCHS}, in turns device, host, host, device ({smi}): dataset on "
        f"the card {[round(v, 3) for v in ms[True]]}, batches copied in from the host "
        f"{[round(v, 3) for v in ms[False]]}; a batch ({nbytes} bytes): gathered, pinned and "
        f"copied {batch_ms:.3f} ms (host clock, synchronised; {100 * batch_ms / host_ms:.2f}% "
        f"of the host path's median step), the copy alone {copy_ms:.4f} ms on the card "
        f"({nbytes / copy_ms / 1e6:.2f} GB/s; {100 * copy_ms / host_ms:.3f}% of the step)")
    return ms, counts


def _farm_dataset(root: str) -> str:
    """FARM_IMAGES smooth random PNGs of FARM_IMAGE_HW^2 in the CelebA-HQ
    folder layout the loader scans (<dir>/celeba_hq/train/); the dir."""
    import numpy as np
    from PIL import Image

    folder = os.path.join(root, "celeba_hq", "train")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(29)
    for i in range(FARM_IMAGES):
        small = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
        small.resize((FARM_IMAGE_HW, FARM_IMAGE_HW), Image.BILINEAR).save(
            os.path.join(folder, f"{i:05d}.png"))
    return root


def _farm_run(root: str, tag: str, preset: str, extra=(), **env):
    """The CelebA-HQ script through `preset` (sourced in bash) with `env`,
    the cuts of FARM_CUTS and the `extra` flags in MDT_EXTRA_ARGS, its
    launcher prefixed with this script's --launched counter, which runs the
    CLI as the script calls it. The run's train_stats, each rank's record,
    the checkpoint's tensors and the output's lines up to its train_stats;
    the launch's seconds."""
    from masked_diffusion_tpu_torch.io import checkpoint as ckpt_io

    out = os.path.join(root, tag)
    os.makedirs(out)
    bin_dir = os.path.join(root, "bin")
    full = {k: v for k, v in os.environ.items() if not k.startswith("MDT_")}
    full.update(PATH=f"{bin_dir}{os.pathsep}{full.get('PATH', '')}",
                MDT_DIR_DATASET=os.path.join(root, "dataset"), MDT_SUBSET=str(FARM_IMAGES),
                MDT_EXTRA_ARGS=" ".join((*FARM_CUTS, *extra, "--dir_work",
                                         os.path.join(out, "0"))), **env)
    launcher = f'"$MDT_LAUNCHER {os.path.join(ROOT, "chip_smoke.py")} --launched {out}"'
    cmd = ["bash", "-c", f'source "{os.path.join(ROOT, "scripts_torch", "config", preset)}" '
                         f'&& MDT_LAUNCHER={launcher} bash "{os.path.join(ROOT, FARM_SCRIPT)}"']
    t0 = time.perf_counter()
    rc, output = _run_group(cmd, FARM_TIMEOUT, env=full)
    seconds = time.perf_counter() - t0
    parts = output.split("\ntrain_stats ")
    if rc != 0 or len(parts) != 2:
        raise AssertionError(f"[29] {tag}: rc {rc}, {len(parts) - 1} train_stats lines\n"
                             f"{output[-6000:]}")
    stats = json.loads(parts[1].split("\n", 1)[0])
    ranks = []
    for r in range(stats["ranks"]):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    (ckpt,) = stats["checkpoints"]
    model_sd, ema_sd, (opt, scalars), _ = ckpt_io.load_checkpoint(ckpt)
    return {"stats": stats, "ranks": ranks, "output": parts[0].splitlines(), "scalars": scalars,
            "state": {**{f"p.{k}": v for k, v in model_sd.items()},
                      **{f"e.{k}": v for k, v in ema_sd.items()},
                      **{f"o.{k}": v for k, v in opt.items()}}}, seconds


def _same_run(a: dict, b: dict) -> bool:
    import torch

    return (a["stats"]["loss_mean_epoch"] == b["stats"]["loss_mean_epoch"]
            and a["stats"]["global_step"] == b["stats"]["global_step"]
            and a["scalars"] == b["scalars"] and a["state"].keys() == b["state"].keys()
            and all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"]))


def phase_farm(workdir: str, smi: str) -> dict:
    """[29] The trainer's device-data rule (train/trainer.py:use_device_data)
    and the port's launch farm at the flagship's width: (a) the flagship's
    ms/step with the dataset on the card and with each batch copied in from
    the host, and a batch's copy; (b) scripts_torch/train/celeba_hq/
    masked_shift_mean/script_main.sh through scripts_torch/config/
    gpu_single.sh with MDT_DEVICE_DATA=1, and with MDT_DEVICE_DATA_CAP_MB=0
    and --epoch_scan true (cut by FARM_CUTS), each under deterministic():
    losses, parameters, EMA and AdamW state bitwise equal, no device copy of
    the dataset in the capped run, no graph captured nor make_train_epoch
    called in either; (c) the script through gpu_h100_4.sh at 2 gloo ranks
    sharing cuda:0, each rank running the CLI as the script calls it (the
    same run with --epoch_scan true, which falls back to the loop on more
    than one rank, is held bitwise on the CPU by
    tests/test_torch_port_epoch_scan.py; it ran here too before phase 32
    took the time). Kernels 1, 2, 2b and 3 launched in every run. Returns
    the launches of all runs summed."""
    import torch

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "farm")
    os.makedirs(root)
    ms, counts = _hostdata_step_ms(root, smi)
    total = dict(counts)

    _farm_dataset(os.path.join(root, "dataset"))
    os.makedirs(os.path.join(root, "bin"))
    python = os.path.join(root, "bin", "python")
    with open(python, "w") as f:  # the presets' `python`: this interpreter
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(python, 0o755)
    seconds = {}
    device, seconds["one process, device data"] = _farm_run(
        root, "device", "gpu_single.sh", MDT_DEVICE_DATA="1")
    capped, seconds["one process, capped, --epoch_scan true"] = _farm_run(
        root, "capped_scan", "gpu_single.sh", ("--epoch_scan", "true"),
        MDT_DEVICE_DATA_CAP_MB="0")
    ranked, seconds["2 ranks"] = _farm_run(
        root, "ranks", "gpu_h100_4.sh", MDT_NPROC=str(FARM_RANKS), MDT_DEVICE="cuda:0")
    runs = {"device": device, "capped_scan": capped, "ranks": ranked}
    steps = 2 * FARM_IMAGES // 32
    for tag, run in runs.items():
        stats = run["stats"]
        said = [ln for ln in run["output"] if ln.startswith("epoch_scan: ")]
        why = {"capped_scan": "epoch_scan: the epoch runs step by step: the dataset's"}
        if (stats["global_step"] != steps or len(said) != (tag in why)
                or not all(s.startswith(why[tag]) for s in said)
                or not all(math.isfinite(v) for v in stats["loss_mean_epoch"])):
            raise AssertionError(f"[29] {tag}: {stats}, scan lines {said}")
        for rank in run["ranks"]:
            c = rank["counts"]
            if not (c["fused_degrade_update"] and c["group_norm_silu"]
                    and c["group_norm_silu_backward"] and c["exact_count_masks"]) or (
                    not same_through_sharded(c)) or c["exact_count_masks"] != steps + 1:
                raise AssertionError(f"[29] {tag}: launches {c}: kernels 1, 2, 2b and 3 each "
                                     f"expected, {steps + 1} exact-k")
            if rank["data_on_device"] != [tag == "device"] or rank["graphs"] or rank[
                    "replays"] or rank["epoch_fns"]:
                raise AssertionError(f"[29] {tag}: dataset on the card {rank['data_on_device']}"
                                     f", {rank['graphs']} graphs captured, {rank['replays']} "
                                     f"replays, make_train_epoch {rank['epoch_fns']} times")
            for k, n in c.items():
                total[k] = total.get(k, 0) + n
    if not _same_run(capped, device):
        raise AssertionError(
            f"[29b] the capped run differs from the device-data run: losses "
            f"{capped['stats']['loss_mean_epoch']} vs {device['stats']['loss_mean_epoch']}, "
            f"max |diff| of the state {_max_diff(capped['state'], device['state']):.3g}")
    log(f"[29b] {FARM_SCRIPT} through gpu_single.sh ({FARM_IMAGES} CelebA-HQ-layout images, "
        f"cuts {' '.join(FARM_CUTS)}; deterministic(); {smi}): losses "
        f"{device['stats']['loss_mean_epoch']} bitwise equal, with the parameters, EMA and "
        f"AdamW state, with MDT_DEVICE_DATA=1 (the loop) and with MDT_DEVICE_DATA_CAP_MB=0 "
        f"and --epoch_scan true (no graph, the loop); ms/step (epoch 2) "
        f"{device['stats']['ms_per_step']:.3f} and {capped['stats']['ms_per_step']:.3f}; "
        f"launches of each {device['ranks'][0]['counts']}")
    log(f"[29c] the same through gpu_h100_4.sh, MDT_NPROC={FARM_RANKS}, both ranks on cuda:0 "
        f"(gloo; {smi}), each rank running the CLI as the script calls it: losses "
        f"{ranked['stats']['loss_mean_epoch']}; ms/step a rank (epoch 2) "
        f"{ranked['stats']['ms_per_step']:.3f}; launches per rank "
        f"{[r['counts'] for r in ranked['ranks']]}")
    log(f"[29] seconds of each launch {({k: round(v, 1) for k, v in seconds.items()})}; "
        f"phase 29 took {time.perf_counter() - t_phase:.1f} s")
    del runs, device, capped, ranked
    torch.cuda.empty_cache()
    return total

# [30] the kernels against the JAX package's numbers at the flagship's full width
JAX_REFERENCE = os.path.join(ROOT, "tests", "data", "jax_full_width.npz")


def phase_jax_reference() -> dict:
    """[30] masked_diffusion_tpu_torch/tools/full_width.py on the card: the
    flagship and CelebA-HQ's topology with the seeded weights (held to the
    file's record of them first), each case of tests/data/jax_full_width.npz
    (what the JAX package computed on the CPU) through the normal route, fp32
    with TF32 off and bf16 under autocast, each distance printed beside its
    bound; any miss raises. The launches of each case, counted from 0, must
    be what the case runs: kernel 2 in every norm, 2b in every norm's
    backward, 3 in the indexing step (on its injected bits), 1 in each fused
    reverse step (on its injected bits), 4 in CelebA-HQ's 10 attention
    blocks (its fp32 kernel in fp32). Returns {case: launches}."""
    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.models.unet import GroupNormAct
    from masked_diffusion_tpu_torch.tools import full_width as fw

    ref = fw.load(JAX_REFERENCE)
    counts, case = {}, [None]

    def before(name):
        if case[0] is not None:
            counts[case[0]] = read_counts()
        reset_counts()
        case[0] = name

    try:
        rows = fw.check(ref, "cuda", log=lambda m: log(f"[30] {m}"), before=before)
    finally:
        if case[0] is not None:
            counts[case[0]] = read_counts()
    want = {}
    for name, num_attention in fw.MODELS.items():
        model = build_unet(num_attention=num_attention)
        norms = sum(isinstance(m, GroupNormAct) for m in model.modules())
        for dtype in fw.DTYPES:
            tiny = tinyhead_per_forward(model.config)
            want[f"forward {name} {dtype}"] = dict(
                group_norm_silu=norms, tinyhead_attention=tiny,
                tinyhead_attention_fp32=tiny if dtype == "fp32" else 0)
        if name != "flagship":
            continue
        for mode in fw.MODES:
            k = int(fw.MODES[mode][1] == "indexing")
            for dtype in fw.DTYPES:
                want[f"train {mode} {dtype}"] = dict(
                    group_norm_silu=norms, group_norm_silu_backward=norms, exact_count_masks=k,
                    exact_count_masks_sharded=k)
            steps = fw.REVERSE_STEPS + 1
            want[f"reverse {mode}"] = dict(group_norm_silu=norms * steps,
                                           fused_degrade_update=steps,
                                           fused_degrade_update_sharded=steps)
    for name, expect in want.items():
        expect = {k: expect.get(k, 0) for k in counts[name]}
        if counts[name] != expect:
            raise AssertionError(f"[30] {name}: launches {counts[name]}, expected {expect}")
    total = {k: sum(c[k] for c in counts.values()) for k in read_counts()}
    log(f"[30] {len(rows)} distances within their bounds over {len(counts)} cases, each case's "
        f"launches as expected; launches of the phase {total}")
    return counts


# [31] the reference's default cadence at T=4096: trajectory capture at full width
T4096 = 4096  # --ddpm_num_steps of the reference's default (log + indexing: 1421 reverse steps)
T4096_SAMPLE_NUM = 4  # the cadence's images: the trainer captures the first 4


def phase_t4096_cadence(workdir: str, smi: str) -> dict:
    """[31] The flagship through the CLI with the default sampling flags
    (--sampling base: the EMA sample with trajectory capture of 4 items) at
    log + indexing, --ddpm_num_steps 4096 (1421 reverse steps), one epoch
    of one train step at batch 64, bf16, --sample_num 4: the 11 x 4
    trajectory PNGs, the EMA grids, finite trajectory means in
    metrics.jsonl, kernel 3 once for the step, once for the visuals pass
    and twice a reverse step, the cadence's seconds and the run's peak
    device memory, at least the trajectory's 11 buffers (3.07 GB), and the
    trajectory's last sample_0 bitwise the cadence's images. (The same
    cadence uncaptured, bitwise the captured one, ran here too until phase
    32 took its ~55 s; capture against no capture is held on the CPU by
    tests/test_torch_port_sampler.py. With random weights the 1421 steps
    diverge, so the fused branch, whose sums run in another order, is held
    to the plain one only over the 3-10 steps of phases 4, 19 and 30.)
    Returns the launches of the CLI run."""
    import numpy as np
    import torch

    import masked_diffusion_tpu_torch.train.trainer as trainer_mod
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.sample.loop import TRAJECTORY_FIELDS

    t0 = time.perf_counter()
    argv, _ = flagship_cli_args(os.path.join(workdir, "t4096"))
    i = argv.index("--sampling")
    argv = argv[:i] + argv[i + 2:]
    for flag, value in (("--ddpm_num_steps", str(T4096)), ("--num_epochs", "1"),
                        ("--save_images_epochs", "1"), ("--data_subset_num", "64"),
                        ("--sample_num", str(T4096_SAMPLE_NUM))):
        argv[argv.index(flag) + 1] = value
    reverse = len(build_schedule("log", T4096, SIZE, "indexing").timesteps_for_epoch(0, 1, 1))
    real = trainer_mod.Trainer.sample_ema
    seen = {}

    def recorded(self, generator, *a, **k):
        seen["out"] = real(self, generator, *a, **k)
        return seen["out"]

    cadence = {}
    torch.cuda.reset_peak_memory_stats()
    t_cli = time.perf_counter()
    trainer_mod.Trainer.sample_ema = recorded
    try:
        with _timed_cadence(cadence):
            rc, stats, counts = _run_cli(argv, "train_stats")
    finally:
        trainer_mod.Trainer.sample_ema = real
    t_cli = time.perf_counter() - t_cli
    peak = torch.cuda.max_memory_allocated()
    if rc != 0 or stats["global_step"] != 1 or not np.isfinite(stats["loss_mean_epoch"]).all():
        raise AssertionError(f"[31] train CLI at T={T4096}: rc {rc}, stats {stats}")
    (ckpt,) = stats["checkpoints"]
    run = os.path.dirname(os.path.dirname(ckpt))
    image = os.path.join(run, "train", "image")
    traj = sorted(os.listdir(os.path.join(image, "sample_all_t")))
    want_traj = sorted(f"{f}_00000_item{k}.png" for f in TRAJECTORY_FIELDS for k in range(4))
    grids = sorted(os.listdir(os.path.join(image, "ema_sample_img")))
    if traj != want_traj or grids != ["ema_sample_00000_global.png",
                                      "ema_sample_00000_local.png"]:
        raise AssertionError(f"[31] trajectory PNGs {traj}, EMA grids {grids}")
    with open(os.path.join(run, "log", "metrics.jsonl")) as f:
        means = [r for r in (json.loads(ln) for ln in f) if "ema_sample_t_mean" in r]
    keys = ("ema_sample_mean", "ema_sample_t_mean", "ema_sample_0_mean",
            "ema_sample_shift_t_mean", "ema_sample_0_shift_mean")
    if len(means) != 1 or not all(np.isfinite(means[0][k]) for k in keys):
        raise AssertionError(f"[31] trajectory means in metrics.jsonl: {means}")
    want = {"exact_count_masks": 1 + 1 + 2 * reverse, "fused_degrade_update": 0}
    if cadence.get("steps") != reverse or any(counts[k] != n for k, n in want.items()) or (
            not same_through_sharded(counts) or not counts["group_norm_silu_backward"]):
        raise AssertionError(f"[31] cadence {cadence}, launches {counts}, expected {want} and "
                             f"{reverse} reverse steps")
    images, trajectory = seen["out"]
    buffers = sum(v.numel() * v.element_size() for key, v in trajectory.items() if key != "means")
    if buffers < 11 * reverse * 4 * SIZE * SIZE * 3 * 4 or peak < buffers:
        raise AssertionError(f"[31] trajectory buffers {buffers} bytes, peak {peak}")
    log(f"[31] train CLI at log + indexing T={T4096} with the default sampling flags: the "
        f"captured cadence, {reverse} reverse steps of {T4096_SAMPLE_NUM} images, "
        f"{cadence['seconds']:.2f} s ({1e3 * cadence['seconds'] / reverse:.3f} ms a reverse "
        f"step, up to the images' host copy); the CLI run {t_cli:.1f} s, its 44 trajectory "
        f"PNGs and their host copy included; trajectory means "
        f"{ {k: round(means[0][k], 5) for k in keys} }; the trajectory's 11 buffers "
        f"{buffers / 1e9:.3f} GB, the run's peak device memory {peak / 2**30:.3f} GiB; "
        f"launches {counts}")

    last = trajectory["sample_0"][-1].cpu().numpy()
    if not (np.isfinite(images).all() and np.array_equal(last, images[:4])):
        raise AssertionError(f"[31] the trajectory's last sample_0 vs the cadence's images: max "
                             f"|diff| {np.abs(last - images[:4]).max()}")
    log(f"[31] the trajectory's last sample_0 bitwise the cadence's images (|sample_0| up to "
        f"{np.abs(images).max():.4g}); phase 31 {time.perf_counter() - t0:.1f} s; {smi}")
    del seen, images, trajectory
    _release()
    return counts


def reset_counts() -> None:
    from masked_diffusion_tpu_torch.ops import launches

    launches.set_to({name: 0 for name in launches.wrappers()})


def read_counts() -> dict:
    from masked_diffusion_tpu_torch.ops import launches

    return launches.snapshot()


def same_through_sharded(counts: dict) -> bool:
    """The sampling loop and the train step reach the fused and exact-k
    kernels only through their sharded forms: each launch counts in both."""
    return (counts["fused_degrade_update"] == counts["fused_degrade_update_sharded"]
            and counts["exact_count_masks"] == counts["exact_count_masks_sharded"])


PHASE_SECONDS = {}


def timed_phase(tag: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), its seconds logged on a line of their own and kept
    in PHASE_SECONDS under `tag`."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[tag] = PHASE_SECONDS.get(tag, 0.0) + time.perf_counter() - t0
    log(f"[seconds] {tag}: {time.perf_counter() - t0:.1f} s")
    return out


def kernel_entry(name, route, source, replaces, launches, err, ms, plain_ms, bnd, library_ms):
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}


def check_no_jax() -> None:
    for mod in sorted(sys.modules):
        if mod.split(".")[0] in ("jax", "flax", "masked_diffusion_tpu"):
            raise AssertionError(f"{mod} was imported")


# Main-path phases that two worker processes of this script run, each lane's
# phases in turn, beside the rest of the main path in this process. Each
# eager step leaves the card idle most of the time (phases 18, 24 and 28
# read idle shares of 0.89-0.93), so the lanes' host work overlaps; 18 and
# 27, the two gloo phases, sit in different lanes at different places.
WORKER_LANES = (
    (("[18] two ranks", "ddp"), ("[29] device data and the launch farm", "farm")),
    (("[31] the cadence at T=4096", "t4096"), ("[27] tensor and spatial parallelism", "grid"),
     ("[16b] CelebA-HQ CLI, fp32", "celeba_fp32")),
)
WORKER_PHASES = {
    "celeba_fp32": lambda workdir, smi, perf: phase_celeba_fp32_cli(workdir),
    "ddp": lambda workdir, smi, perf: phase_ddp(os.path.join(workdir, "ranks"), smi, perf),
    "farm": lambda workdir, smi, perf: phase_farm(workdir, smi),
    "t4096": lambda workdir, smi, perf: phase_t4096_cadence(workdir, smi),
    "grid": lambda workdir, smi, perf: phase_grid(os.path.join(workdir, "grid"), smi),
}
WORKER_TIMEOUT = 900  # seconds from a lane's start to its end


def worker_main(spec_path: str) -> int:
    """One lane of WORKER_LANES (`chip_smoke.py --worker <spec.json>`, which
    main() writes): its phases in turn, each timed, then their launches and
    seconds to the spec's `out`. SIGTERM ends it, and a phase's ranks with
    it (_run_group)."""
    import signal

    def stop(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, stop)
    t0 = time.perf_counter()
    sys.path.insert(0, ROOT)
    from masked_diffusion_tpu_torch.ops import build

    with open(spec_path) as f:
        spec = json.load(f)
    global EXP_PER_S, INT_OPS_PER_S
    EXP_PER_S, INT_OPS_PER_S = spec["exp_per_s"], spec["int_ops_per_s"]
    build.load_library()  # phase 1's build, loaded
    runs = {key: timed_phase(tag, WORKER_PHASES[key], spec["workdir"], spec["smi"],
                             spec["flagship_perf"])
            for tag, key in spec["phases"]}
    check_no_jax()
    with open(spec["out"], "w") as f:
        json.dump({"runs": runs, "seconds": PHASE_SECONDS,
                   "wall": time.perf_counter() - t0}, f)
    return 0


def start_workers(workdir: str, smi: str, flagship_perf: dict) -> list:
    """A process a lane of WORKER_LANES, each in a session of its own with
    its output in <workdir>/lane<i>.log; [(lane, spec, log, Popen, start)]."""
    lanes = []
    for i, lane in enumerate(WORKER_LANES):
        spec = {"phases": lane, "workdir": workdir, "smi": smi, "flagship_perf": flagship_perf,
                "exp_per_s": EXP_PER_S, "int_ops_per_s": INT_OPS_PER_S,
                "out": os.path.join(workdir, f"lane{i}.out.json")}
        path = os.path.join(workdir, f"lane{i}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        log_path = os.path.join(workdir, f"lane{i}.log")
        with open(log_path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--worker", path],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
        lanes.append((lane, spec, log_path, proc, time.perf_counter()))
    return lanes


def join_workers(lanes) -> dict:
    """Waits for each lane (WORKER_TIMEOUT from its start), relays its
    output and its own seconds, merges its phases' seconds into
    PHASE_SECONDS and returns their launches by phase; raises if a lane
    failed or ran out of time."""
    import signal

    runs = {}
    for lane, spec, log_path, proc, start in lanes:
        try:
            rc = proc.wait(timeout=max(1.0, WORKER_TIMEOUT - (time.perf_counter() - start)))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGTERM)
            rc = None
        with open(log_path) as f:
            output = f.read()
        sys.stdout.write(output)
        tags = [tag for tag, _ in lane]
        if rc != 0:
            raise AssertionError(f"worker lane {tags}: " + (
                f"no end in {WORKER_TIMEOUT} s" if rc is None else f"rc {rc}")
                + f"\n{output[-6000:]}")
        with open(spec["out"]) as f:
            done = json.load(f)
        PHASE_SECONDS.update(done["seconds"])
        runs.update(done["runs"])
        log(f"[lanes] worker lane {tags}: its process took {done['wall']:.1f} s")
    return runs


def stop_workers(lanes) -> None:
    """SIGTERM to every lane still running (its phases' ranks go with it),
    SIGKILL to one that outlives 60 s."""
    import signal

    for *_, proc, _ in lanes:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGTERM)
    for *_, proc, _ in lanes:
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    smi = timed_phase("[1] environment and build", phase_env)
    tinyhead_err, tinyhead_bwd_err, tinyhead_times, tinyhead_bwd_times, _ = timed_phase(
        "[11] tiny-head kernels", phase_tinyhead)
    large = timed_phase("[12] exact-k at 256x256", phase_exact_k_large)
    fused_err, fused_times, fused_bnd, fused_taken = timed_phase("[2] fused degrade",
                                                                 phase_fused)
    check_plan_coverage("fused", fused_taken | large[3])
    calls = norm_shapes(16)
    gn = timed_phase("[3] GroupNorm forward", phase_groupnorm, calls, 16)
    timed_phase("[4] sampling slice", phase_slice)
    timed_phase("[14] sampling slice, CelebA-HQ topology", phase_slice, "[14]", 5,
                (("log", "indexing", 16, 4),))
    modes = timed_phase("[19] plain branch", phase_sampling_modes)
    timed_phase("[22a] tester selection", phase_tester_selection)
    timed_phase("[22a] tester kernels", phase_tester_kernels, calls)
    timed_phase("[23a] interpolation parity", phase_interpolation_parity)
    kmask = timed_phase("[6] exact-k masks", phase_kmask)
    check_plan_coverage("kmask", kmask[4] | large[4])
    gn_bwd, _ = timed_phase("[7] GroupNorm training", phase_groupnorm_train, calls, B_KERNEL)
    timed_phase("[7] GroupNorm branches", phase_groupnorm_branches)
    timed_phase("[13] GroupNorm at unet6 256x256", phase_groupnorm_train,
                norm_shapes(8, "unet6", 256, "[13]"), 8, "[13]", timed=False)
    split = timed_phase("[32] GroupNorm split modes", phase_split_groupnorm, smi)
    timed_phase("[8] train parity", phase_train_parity)
    timed_phase("[9] bf16 train parity", phase_train_bf16_parity)
    timed_phase("[9] train throughput", phase_train_throughput, smi)
    timed_phase("[30] against the JAX package's numbers", phase_jax_reference)
    zoo_backward = timed_phase("[15] zoo", phase_zoo)
    remat = timed_phase("[25a] remat", phase_remat, smi)
    route_peaks = timed_phase("[25b] attention routes", phase_attention_routes)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    sharded = timed_phase("[18a] sharded kernels", phase_sharded)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
        runs = {}
        runs["flagship"], flagship_perf = timed_phase("[10] train CLI", phase_train_cli,
                                                      workdir)
        t_lanes = time.perf_counter()
        lanes = start_workers(workdir, smi, flagship_perf)
        try:
            # the legacy GAN/EBM path launches none of the kernels: its norms
            # are plain nn.GroupNorm without SiLU, its attentions einsums
            reset_counts()
            gan_step = timed_phase("[26a] GAN step", phase_gan_step, smi)
            legacy_fwd = timed_phase("[26b] legacy forwards", phase_legacy_forwards, smi)
            legacy_cli = timed_phase("[26c] legacy CLI", phase_legacy_cli, workdir, smi)
            runs["legacy"] = read_counts()
            if any(runs["legacy"].values()):
                raise AssertionError(f"[26] the legacy path launched kernels: {runs['legacy']}")
            runs["serve"] = timed_phase("[5] serve", phase_serve, workdir)[0]
            runs["default"], captured_ms = timed_phase("[20] default flags CLI",
                                                       phase_default_cli, workdir, flagship_perf)
            runs["tester"], tester_perf = timed_phase("[22b] tester run", phase_tester_run,
                                                      workdir)
            runs["tester_cli"] = timed_phase("[22c] tester CLI", phase_tester_cli, workdir)
            runs["interp"], interp_ms = timed_phase("[23b] interpolation CLI",
                                                    phase_interpolation_cli, workdir)
            runs["reuse"] = timed_phase("[25c] encoder reuse", phase_encoder_reuse, workdir)
            runs["switches"] = timed_phase("[25d] switches CLI", phase_switches_cli, workdir)
            runs["celeba"] = timed_phase("[16] CelebA-HQ CLI", phase_celeba_cli, workdir)
            runs["unet6"] = timed_phase("[17] unet6 CLI", phase_unet6_cli, workdir)
            runs["preempt"] = timed_phase("[21] preemption", phase_preempt, workdir, smi)
            runs["reference"], reference_seconds = timed_phase(
                "[24] reference inputs", phase_reference_inputs, workdir, smi)
            log(f"[lanes] this process's lane took {time.perf_counter() - t_lanes:.1f} s")
            runs.update(join_workers(lanes))
        finally:
            stop_workers(lanes)
        log(f"[lanes] the three lanes took {time.perf_counter() - t_lanes:.1f} s")
        runs["graphed"] = timed_phase("[28] graphed epoch", phase_graphed_epoch, workdir, smi)
    main_runs = list(runs.values())
    check_no_jax()

    def launches(name):
        return sum(run.get(name, 0) for run in main_runs)

    # the tiny-head entries: per UNet forward (and backward) of the CelebA-HQ
    # config at batch 32, five launches at S=1024 and five at S=256, bf16
    # and fp32
    per_forward = [(shape, 5) for shape in TINYHEAD_SHAPES[:2]]

    def per_step(times, what, name):
        ms = [sum(n * times[(shape, name)][i] for shape, n in per_forward) for i in range(3)]
        terms = times[(per_forward[0][0], name)][3]
        bnd = terms_bound({t: sum(n * times[(shape, name)][3][t] for shape, n in per_forward)
                           for t in terms})
        log(f"[11] tinyhead {what} of the CelebA-HQ config, {name}, batch 32 (5 x S=1024, "
            f"5 x S=256): kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms, SDPA {ms[2]:.4f} ms, "
            f"bound {bnd[0]:.5f} ms ({bnd[2]}, {bnd[0] / ms[0]:.1%} of it)")
        return ms, bnd

    th, th_bound = per_step(tinyhead_times, "forward per UNet forward", "bfloat16")
    thb, thb_bound = per_step(tinyhead_bwd_times, "backward per train step", "bfloat16")
    th32, th32_bound = per_step(tinyhead_times, "forward per UNet forward", "float32")
    thb32, thb32_bound = per_step(tinyhead_bwd_times, "backward per train step", "float32")
    log(f"[11] tinyhead backward launches per train step: CelebA-HQ "
        f"{runs['celeba']['tinyhead_attention_backward'] // 4} (phase 16, 4 steps), at fp32 "
        f"{runs['celeba_fp32']['tinyhead_attention_backward_fp32'] // 2} (phase 16b, 2 "
        f"steps), unet6 256x256 {runs['unet6']['tinyhead_attention_backward'] // 4} (phase "
        f"17, 4 steps), at 128x128 (phase 15) {zoo_backward}")
    kb2 = modes["kmask_b2"]
    log(f"[19/20] exact_count_masks on the main path: {launches('exact_count_masks')} launches, "
        f"{runs['default']['exact_count_masks']} of them in phase 20 (its captured cadence "
        f"{captured_ms:.3f} ms a reverse step, phase 10's fused "
        f"{flagship_perf['cadence_ms']:.3f}); at batch 2, 64x64: {kb2[0]:.4f} ms (plain "
        f"{kb2[1]:.4f}, bound {kb2[2][0]:.5f}); flagship reverse step at batch "
        f"{SAMPLING_TIMED_BATCH}, bf16: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in modes["reverse_ms"].items()))
    log(f"[22/23] the tester at sample_num {TESTER_SAMPLE_NUM}, bf16: "
        + "; ".join(f"{k} {v[0]:.3f} s a round, {v[1]:.3f} ms a reverse step, {v[2]:.2f} "
                    f"images/s" for k, v in tester_perf.items())
        + f"; the interpolation pass at the cadence: {interp_ms:.3f} ms a reverse step; "
        f"{runs['tester']['fused_degrade_update']} fused and "
        f"{runs['tester']['exact_count_masks']} exact-k launches in phase 22b")
    log(f"[24] phase 24 (the reference user's inputs) took {reference_seconds:.1f} s; its "
        f"launches {runs['reference']}")
    log(f"[25] remat: {remat[True][0]:.3f} vs {remat[False][0]:.3f} ms/step, peak "
        f"{remat[True][1] / 2**30:.3f} vs {remat[False][1] / 2**30:.3f} GiB; the attention "
        f"routes' peak GiB above the weights at batch {ROUTE_BATCH}: "
        + ", ".join(f"{c}: {v / 2**30:.3f}" for c, v in route_peaks.items())
        + f"; the switches' main-path launches {runs['reuse']} (25c) and {runs['switches']} "
        f"(25d); phase 25 took "
        f"{sum(v for k, v in PHASE_SECONDS.items() if k.startswith('[25')):.1f} s")
    log(f"[26] the legacy GAN/EBM path: launches {runs['legacy']}; GAN step "
        f"{gan_step['ms']:.3f} ms at batch {LEGACY_BATCH} (device idle share "
        f"{gan_step['profile']['device_idle_share']:.4f}), the CLI "
        f"{legacy_cli['ms_per_step']:.3f} "
        f"ms/step; GeneratorLatent forward at {LEGACY_SIZE}x{LEGACY_SIZE} "
        f"{legacy_fwd['GeneratorLatent'][1]:.4f} ms; phase 26 took "
        f"{sum(v for k, v in PHASE_SECONDS.items() if k.startswith('[26')):.1f} s")
    log("[seconds] " + json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()})
        + f"; the script {time.perf_counter() - t_start:.1f} s")
    log(smi)
    entries = [
        kernel_entry("fused_degrade_update", "cuda",
                     "masked_diffusion_tpu_torch/csrc/fused_degrade.cu",
                     "masked_diffusion_tpu/ops/pallas/fused_degrade.py:209",
                     launches("fused_degrade_update"), fused_err, fused_times["indexing"][0],
                     fused_times["indexing"][1], fused_bnd, None),
        kernel_entry("group_norm_silu", "cuda", "masked_diffusion_tpu_torch/csrc/groupnorm.cu",
                     "masked_diffusion_tpu/ops/pallas/groupnorm.py:158",
                     launches("group_norm_silu"), gn[0], gn[1], gn[2], gn[4], gn[3]),
        kernel_entry("group_norm_silu_backward", "cuda",
                     "masked_diffusion_tpu_torch/csrc/groupnorm.cu",
                     "masked_diffusion_tpu/ops/pallas/groupnorm.py:169",
                     launches("group_norm_silu_backward"), gn_bwd[0], gn_bwd[1], gn_bwd[2],
                     gn_bwd[4], gn_bwd[3]),
        kernel_entry("exact_count_masks", "cuda", "masked_diffusion_tpu_torch/csrc/kmask.cu",
                     "masked_diffusion_tpu/ops/pallas/kmask.py:84",
                     launches("exact_count_masks"), kmask[0], kmask[1], kmask[2], kmask[3], None),
        # bf16 instances: the wrappers' launches less their fp32 kernels'
        kernel_entry("tinyhead_attention", "cuda",
                     "masked_diffusion_tpu_torch/csrc/tinyhead_attention.cu",
                     "masked_diffusion_tpu/ops/pallas/tinyhead_attention.py:99",
                     launches("tinyhead_attention") - launches("tinyhead_attention_fp32"),
                     tinyhead_err["bfloat16"], th[0], th[1], th_bound[:2], th[2]),
        kernel_entry("tinyhead_attention_backward", "cuda",
                     "masked_diffusion_tpu_torch/csrc/tinyhead_attention_bwd.cu",
                     "masked_diffusion_tpu/ops/pallas/tinyhead_attention.py:168",
                     launches("tinyhead_attention_backward")
                     - launches("tinyhead_attention_backward_fp32"),
                     tinyhead_bwd_err["bfloat16"], thb[0], thb[1], thb_bound[:2], thb[2]),
        # fp32 instances: split TF32 on the tensor cores
        kernel_entry("tinyhead_attention_fp32", "cuda",
                     "masked_diffusion_tpu_torch/csrc/tinyhead_attention.cu",
                     "masked_diffusion_tpu/ops/pallas/tinyhead_attention.py:99",
                     launches("tinyhead_attention_fp32"), tinyhead_err["float32"], th32[0],
                     th32[1], th32_bound[:2], th32[2]),
        kernel_entry("tinyhead_attention_backward_fp32", "cuda",
                     "masked_diffusion_tpu_torch/csrc/tinyhead_attention_bwd.cu",
                     "masked_diffusion_tpu/ops/pallas/tinyhead_attention.py:168",
                     launches("tinyhead_attention_backward_fp32"), tinyhead_bwd_err["float32"],
                     thb32[0], thb32[1], thb32_bound[:2], thb32[2]),
        kernel_entry("fused_degrade_update_sharded", "cuda",
                     "masked_diffusion_tpu_torch/csrc/fused_degrade.cu",
                     "masked_diffusion_tpu/ops/pallas/fused_degrade.py:295",
                     launches("fused_degrade_update_sharded"), *sharded["fused"], None),
        kernel_entry("exact_count_masks_sharded", "cuda",
                     "masked_diffusion_tpu_torch/csrc/kmask.cu",
                     "masked_diffusion_tpu/ops/pallas/kmask.py:122",
                     launches("exact_count_masks_sharded"), *sharded["kmask"], None),
        # kernels 2 and 2b in their split modes under --mesh_spatial (a launch pair a
        # count); no library call takes statistics from outside
        kernel_entry("group_norm_split", "cuda", "masked_diffusion_tpu_torch/csrc/groupnorm.cu",
                     "masked_diffusion_tpu/ops/pallas/groupnorm.py:158",
                     launches("group_norm_split"), *split["forward"], None),
        kernel_entry("group_norm_split_backward", "cuda",
                     "masked_diffusion_tpu_torch/csrc/groupnorm.cu",
                     "masked_diffusion_tpu/ops/pallas/groupnorm.py:169",
                     launches("group_norm_split_backward"), *split["backward"], None),
    ]
    idle = [e["name"] for e in entries if not e["launches"]]
    if idle:
        raise AssertionError(f"kernels launched no time on the main-path runs: {idle}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    # `--rank <dir>` is one rank of phase 18 under torch.distributed.run;
    # `--counted <file> <CLI flags>` is phase 21's CLI subprocess; `--grid
    # <dir>` one rank of phase 27; `--launched <dir> -m <CLI module> <flags>`
    # a farm script's CLI (one a rank) in phase 29; `--worker <spec>` a lane
    # of WORKER_LANES
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker_main(sys.argv[2]))
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--counted"]:
        sys.exit(counted_main(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--grid"]:
        sys.exit(grid_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--launched"]:
        sys.exit(launched_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
