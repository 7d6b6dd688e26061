#!/bin/bash
# Resume the CelebA-HQ run from the latest checkpoint (the reference's
# script_resume.sh pattern: resume_from_checkpoint="latest" + output_dir
# pointing at the previous run's checkpoint tree,
# main_train_masked.py:250-277).
# The PyTorch port's copy of scripts/train/celeba_hq/masked_shift_mean/script_resume.sh:
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
    --content "celeba_masked" \
    --method "mean_shift" \
    --title "shift_mean_T4096_resume" \
    --dir_dataset "${MDT_DIR_DATASET:-/nas2/dataset}" \
    --data_name "celeba_hq" \
    --data_size 64 \
    --data_subset True \
    --data_subset_num "${MDT_SUBSET:-128}" \
    --batch_size 32 \
    --num_epochs 50000 \
    --optim "adamw" \
    --lr 3e-4 \
    --lr_scheduler "cosine" \
    --use_ema True \
    --ddpm_num_steps 4096 \
    --ddpm_schedule "log" \
    --select_degrade_pixel "indexing" \
    --mean_option "degraded_area" \
    --shift_type "1-d_constant" \
    --sample_latent_shape "data" \
    --sampling "momentum" \
    --momentum_adaptive "base_momentum" \
    --sampling_mask_dependency "independent" \
    --sample_num 64 \
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
