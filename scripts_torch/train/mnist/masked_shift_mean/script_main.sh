#!/bin/bash
# MNIST mean-shift workload (BASELINE.md row "MNIST mean-shift":
# 32x32, batch 128, T=248 linear schedule, lr 5e-4 cosine, EMA on —
# hyperparameters of script/train/mnist/masked_shift_mean/pua/script_main2.sh).
# The PyTorch port's copy of scripts/train/mnist/masked_shift_mean/script_main.sh:
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
    --method "mean_shift" \
    --title "shift_mean_T248" \
    --dir_dataset "${MDT_DIR_DATASET:-/nas2/dataset}" \
    --data_name "mnist" \
    --data_size 32 \
    --data_subset True \
    --data_subset_num 1000 \
    --in_channel 1 \
    --out_channel 1 \
    --batch_size 128 \
    --num_epochs 10000 \
    --optim "adamw" \
    --lr 5e-4 \
    --lr_scheduler "cosine" \
    --lr_warmup_steps 500 \
    --use_ema True \
    --ddpm_num_steps 248 \
    --ddpm_schedule "linear" \
    --select_degrade_pixel "thresholding" \
    --degrade_channel "1-channel" \
    --mean_option "degraded_area" \
    --mean_area "image-wise" \
    --shift_type "1-d_constant" \
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
