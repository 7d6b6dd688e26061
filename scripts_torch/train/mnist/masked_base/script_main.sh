#!/bin/bash
# MNIST base (no-shift) masked diffusion — method=base arm of the CLI
# (main_train_masked.py:327-330), log schedule with exact-count indexing.
# MDT_* env vars override run-scale knobs (defaults = the real workload);
# MDT_EXTRA_ARGS appends raw flags (tests shrink the model through it).
# The PyTorch port's copy of scripts/train/mnist/masked_base/script_main.sh:
# the same workload flags and MDT_* overrides. Source a preset of
# scripts_torch/config/ first: $MDT_LAUNCHER starts the processes
# (default: python, one process on one card), --device is $MDT_DEVICE
# (default cuda; without CUDA the CLI raises) and MDT_EXTRA_ARGS
# appends raw flags.
set -e
cd "$(dirname "$0")/../../../.."

${MDT_LAUNCHER:-python} -m masked_diffusion_tpu_torch.cli.main_train_masked \
    --task "train" \
    --content "mnist_masked" \
    --method "base" \
    --title "base_log" \
    --dir_dataset "${MDT_DIR_DATASET:-/nas2/dataset}" \
    --data_name "mnist" \
    --data_size 32 \
    --data_subset True \
    --data_subset_num "${MDT_DATA_SUBSET_NUM:-1000}" \
    --in_channel 1 \
    --out_channel 1 \
    --batch_size "${MDT_BATCH_SIZE:-128}" \
    --num_epochs "${MDT_NUM_EPOCHS:-10000}" \
    --optim "adamw" \
    --lr 5e-4 \
    --lr_scheduler "cosine" \
    --lr_warmup_steps 500 \
    --use_ema True \
    --ddpm_num_steps "${MDT_DDPM_NUM_STEPS:-500}" \
    --ddpm_schedule "log" \
    --select_degrade_pixel "indexing" \
    --degrade_channel "1-channel" \
    --mean_option "degraded_area" \
    --mean_area "image-wise" \
    --shift_type "non_shift" \
    --sample_latent_shape "data" \
    --momentum_adaptive "base_momentum" \
    --sampling_mask_dependency "independent" \
    --sample_num "${MDT_SAMPLE_NUM:-100}" \
    --save_images_epochs "${MDT_SAVE_IMAGES_EPOCHS:-100}" \
    --mixed_precision "${MDT_MIXED_PRECISION:-bf16}" \
    --device "${MDT_DEVICE:-cuda}" \
    --mesh_data "${MDT_MESH_DATA:--1}" \
    --mesh_model "${MDT_MESH_MODEL:-1}" \
    --tp_min_features "${MDT_TP_MIN_FEATURES:-256}" \
    --mesh_spatial "${MDT_MESH_SPATIAL:-False}" \
    --multihost "${MDT_MULTIHOST:-False}" \
    --use_wandb "${MDT_USE_WANDB:-False}" \
    --use_mlflow False \
    --dir_work "${MDT_DIR_WORK:-.}" \
    ${MDT_EXTRA_ARGS}
