#!/bin/bash
# MetFaces base-method workload (reference
# script/train/metfaces/base/elsa/script_main.sh: method="base", 64x64,
# batch 32, T=1000 sigmoid, lr 3e-4 cosine, EMA on).
# The PyTorch port's copy of scripts/train/metfaces/base/script_main.sh:
# the same workload flags and MDT_* overrides. Source a preset of
# scripts_torch/config/ first: $MDT_LAUNCHER starts the processes
# (default: python, one process on one card), --device is $MDT_DEVICE
# (default cuda; without CUDA the CLI raises) and MDT_EXTRA_ARGS
# appends raw flags.
set -e
cd "$(dirname "$0")/../../../.."

${MDT_LAUNCHER:-python} -m masked_diffusion_tpu_torch.cli.main_train_masked \
    --task "train" \
    --content "metfaces_masked" \
    --method "base" \
    --title "base_sigmoid_T1000" \
    --dir_dataset "${MDT_DIR_DATASET:-/nas2/dataset}" \
    --data_name "metfaces" \
    --data_size 64 \
    --data_subset True \
    --data_subset_num "${MDT_SUBSET:-128}" \
    --batch_size 32 \
    --num_epochs 1000 \
    --optim "adamw" \
    --lr 3e-4 \
    --lr_scheduler "cosine" \
    --lr_warmup_steps 500 \
    --use_ema True \
    --num_attention 1 \
    --ddpm_num_steps 1000 \
    --ddpm_schedule "sigmoid" \
    --select_degrade_pixel "indexing" \
    --mean_option "degraded_area" \
    --mean_area "image-wise" \
    --sample_latent_shape "data" \
    --sampling "momentum" \
    --momentum_adaptive "base_momentum" \
    --sampling_mask_dependency "independent" \
    --sample_num 100 \
    --save_images_epochs 100 \
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
