#!/bin/bash
# Flowers-102 base-method workload (reference
# script/train/oxford-flower/masked/script_train_0.sh: 32x32, batch 128,
# lr 1e-4, T=100, 10k epochs. Its ddpm_schedule="log_scale" is unimplemented
# drift (scheduler.py:39-48) — "log" is the implemented schedule.)
# The PyTorch port's copy of scripts/train/flowers102/masked_base/script_main.sh:
# the same workload flags and MDT_* overrides. Source a preset of
# scripts_torch/config/ first: $MDT_LAUNCHER starts the processes
# (default: python, one process on one card), --device is $MDT_DEVICE
# (default cuda; without CUDA the CLI raises) and MDT_EXTRA_ARGS
# appends raw flags.
set -e
cd "$(dirname "$0")/../../../.."

${MDT_LAUNCHER:-python} -m masked_diffusion_tpu_torch.cli.main_train_masked \
    --task "train" \
    --content "flowers_masked" \
    --method "base" \
    --title "base_T100" \
    --dir_dataset "${MDT_DIR_DATASET:-/nas2/dataset}" \
    --data_name "flowers102" \
    --data_size 32 \
    --data_subset True \
    --data_subset_num "${MDT_SUBSET:-1000}" \
    --batch_size 128 \
    --num_epochs 10000 \
    --optim "adamw" \
    --lr 1e-4 \
    --lr_scheduler "cosine" \
    --lr_warmup_steps 500 \
    --use_ema True \
    --ddpm_num_steps 100 \
    --ddpm_schedule "log" \
    --select_degrade_pixel "indexing" \
    --mean_option "degraded_area" \
    --mean_area "image-wise" \
    --sample_latent_shape "data" \
    --sampling "momentum" \
    --momentum_adaptive "base_momentum" \
    --sampling_mask_dependency "independent" \
    --sample_num 100 \
    --save_images_epochs 500 \
    --mixed_precision "${MDT_MIXED_PRECISION:-bf16}" \
    --device "${MDT_DEVICE:-cuda}" \
    --mesh_data "${MDT_MESH_DATA:--1}" \
    --mesh_model "${MDT_MESH_MODEL:-1}" \
    --tp_min_features "${MDT_TP_MIN_FEATURES:-256}" \
    --mesh_spatial "${MDT_MESH_SPATIAL:-False}" \
    --multihost "${MDT_MULTIHOST:-False}" \
    --use_wandb "${MDT_USE_WANDB:-False}" \
    --use_mlflow False \
    ${MDT_EXTRA_ARGS}
