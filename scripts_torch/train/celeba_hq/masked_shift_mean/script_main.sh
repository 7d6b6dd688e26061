#!/bin/bash
# CelebA-HQ base+momentum workload (BASELINE.md row "celeba_hq
# base+momentum": 64x64, batch 32, T=4096 log schedule, lr 3e-4 cosine,
# 50k epochs, 128-2048 image subsets — hyperparameters of
# script/train/celeba_hq/masked_shift_mean/elsa/script_main.sh +
# gpuMulti_config.yaml, whose 4-process DDP is
# scripts_torch/config/gpu_h100_4.sh).
# The PyTorch port's copy of scripts/train/celeba_hq/masked_shift_mean/script_main.sh:
# the same workload flags and MDT_* overrides. Source a preset of
# scripts_torch/config/ first: $MDT_LAUNCHER starts the processes
# (default: python, one process on one card), --device is $MDT_DEVICE
# (default cuda; without CUDA the CLI raises) and MDT_EXTRA_ARGS
# appends raw flags.
set -e
cd "$(dirname "$0")/../../../.."

${MDT_LAUNCHER:-python} -m masked_diffusion_tpu_torch.cli.main_train_masked \
    --task "train" \
    --content "celeba_masked" \
    --method "mean_shift" \
    --title "shift_mean_T4096" \
    --dir_dataset "${MDT_DIR_DATASET:-/nas2/dataset}" \
    --data_name "celeba_hq" \
    --data_size 64 \
    --data_subset True \
    --data_subset_num "${MDT_SUBSET:-128}" \
    --in_channel 3 \
    --out_channel 3 \
    --batch_size 32 \
    --num_epochs 50000 \
    --optim "adamw" \
    --lr 3e-4 \
    --lr_scheduler "cosine" \
    --lr_warmup_steps 500 \
    --use_ema True \
    --ddpm_num_steps 4096 \
    --ddpm_schedule "log" \
    --select_degrade_pixel "indexing" \
    --degrade_channel "1-channel" \
    --mean_option "degraded_area" \
    --mean_area "image-wise" \
    --shift_type "1-d_constant" \
    --sample_latent_shape "data" \
    --sampling "momentum" \
    --momentum_adaptive "base_momentum" \
    --sampling_mask_dependency "independent" \
    --sample_num 64 \
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
