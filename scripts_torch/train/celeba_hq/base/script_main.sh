#!/bin/bash
# CelebA-HQ "base"-tree workload (reference
# script/train/celeba_hq/base/elsa/script_main.sh: despite the tree name it
# sets method="mean_shift", num_attention=5, T=16 log, lr 3e-5 cosine,
# batch 32, 64x64. Its shift_type="constant" is not among the argparse
# choices (main_train_masked.py:400) and would be rejected — drift;
# "1-d_constant" is the accepted spelling of that behavior.)
# The PyTorch port's copy of scripts/train/celeba_hq/base/script_main.sh:
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
    --title "base_tree_T16_attn5" \
    --dir_dataset "${MDT_DIR_DATASET:-/nas2/dataset}" \
    --data_name "celeba_hq" \
    --data_size 64 \
    --data_subset True \
    --data_subset_num "${MDT_SUBSET:-2048}" \
    --batch_size 32 \
    --num_epochs 500001 \
    --optim "adamw" \
    --lr 3e-5 \
    --lr_scheduler "cosine" \
    --lr_warmup_steps 500 \
    --use_ema True \
    --num_attention 5 \
    --ddpm_num_steps 16 \
    --ddpm_schedule "log" \
    --select_degrade_pixel "indexing" \
    --mean_option "degraded_area" \
    --mean_area "image-wise" \
    --shift_type "1-d_constant" \
    --sample_latent_shape "data" \
    --sampling "momentum" \
    --momentum_adaptive "base_momentum" \
    --sampling_mask_dependency "independent" \
    --sample_num 100 \
    --save_images_epochs 1000 \
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
