#!/bin/bash
# Resume the MNIST mean-shift run (BASELINE.md row "MNIST mean-shift":
# 32x32, batch 128, T=248 linear, lr 5e-4 cosine) from its latest
# checkpoint — the reference's script_resume.sh pattern
# (resume_from_checkpoint="latest", main_train_masked.py:250-277).
# The PyTorch port's copy of scripts/train/mnist/masked_shift_mean/script_resume.sh:
# the same workload flags and MDT_* overrides. Source a preset of
# scripts_torch/config/ first: $MDT_LAUNCHER starts the processes
# (default: python, one process on one card), --device is $MDT_DEVICE
# (default cuda; without CUDA the CLI raises) and MDT_EXTRA_ARGS
# appends raw flags.
set -e
cd "$(dirname "$0")/../../../.."

if [ -z "$MDT_CHECKPOINT_DIR" ]; then
    echo "set MDT_CHECKPOINT_DIR to the previous run's checkpoint directory" >&2
    exit 1
fi

${MDT_LAUNCHER:-python} -m masked_diffusion_tpu_torch.cli.main_train_masked \
    --task "train" \
    --content "mnist_masked" \
    --method "mean_shift" \
    --title "shift_mean_T248_resume" \
    --dir_dataset "${MDT_DIR_DATASET:-/nas2/dataset}" \
    --data_name "mnist" \
    --data_size 32 \
    --data_subset True \
    --data_subset_num "${MDT_SUBSET:-1000}" \
    --in_channel 1 \
    --out_channel 1 \
    --batch_size 128 \
    --num_epochs 10000 \
    --optim "adamw" \
    --lr 5e-4 \
    --lr_scheduler "cosine" \
    --use_ema True \
    --ddpm_num_steps 248 \
    --ddpm_schedule "linear" \
    --select_degrade_pixel "thresholding" \
    --mean_option "degraded_area" \
    --shift_type "1-d_constant" \
    --sample_latent_shape "data" \
    --sampling "momentum" \
    --momentum_adaptive "base_momentum" \
    --sampling_mask_dependency "independent" \
    --sample_num 100 \
    --save_images_epochs 500 \
    --resume_from_checkpoint "latest" \
    --output_dir "$MDT_CHECKPOINT_DIR" \
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
