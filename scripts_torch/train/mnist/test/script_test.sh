#!/bin/bash
# MNIST diversity evaluation from a trained checkpoint (the reference's
# mnist/test/*/script_test*.sh family: method="test" + test_model_path,
# tester.py:53,86). The reference's ddpm_schedule="log_scale" is drift the
# argparse-era scheduler never implemented (scheduler.py:39-48 handles only
# linear/log/exponential/sigmoid) — "log" is the behavior those runs got.
# The PyTorch port's copy of scripts/train/mnist/test/script_test.sh:
# the same workload flags and MDT_* overrides. Source a preset of
# scripts_torch/config/ first: $MDT_LAUNCHER starts the processes
# (default: python, one process on one card), --device is $MDT_DEVICE
# (default cuda; without CUDA the CLI raises) and MDT_EXTRA_ARGS
# appends raw flags.
set -e
cd "$(dirname "$0")/../../../.."

if [ -z "$MDT_TEST_MODEL_PATH" ]; then
    echo "set MDT_TEST_MODEL_PATH to a checkpoint-epoch-N directory" >&2
    exit 1
fi

${MDT_LAUNCHER:-python} -m masked_diffusion_tpu_torch.cli.main_train_masked \
    --task "train" \
    --content "mnist_masked" \
    --method "test" \
    --title "diversity_eval" \
    --dir_dataset "${MDT_DIR_DATASET:-/nas2/dataset}" \
    --data_name "mnist" \
    --data_size 32 \
    --data_subset True \
    --data_subset_num "${MDT_SUBSET:-2000}" \
    --in_channel 1 \
    --out_channel 1 \
    --ddpm_num_steps 248 \
    --ddpm_schedule "linear" \
    --select_degrade_pixel "thresholding" \
    --mean_option "degraded_area" \
    --shift_type "1-d_constant" \
    --sample_latent_shape "data" \
    --momentum_adaptive "base_momentum" \
    --sample_num 100 \
    --test_model_path "$MDT_TEST_MODEL_PATH" \
    --mixed_precision "${MDT_MIXED_PRECISION:-bf16}" \
    --device "${MDT_DEVICE:-cuda}" \
    --mesh_data "${MDT_MESH_DATA:--1}" \
    --mesh_model "${MDT_MESH_MODEL:-1}" \
    --tp_min_features "${MDT_TP_MIN_FEATURES:-256}" \
    --mesh_spatial "${MDT_MESH_SPATIAL:-False}" \
    --multihost "${MDT_MULTIHOST:-False}" \
    --use_wandb False \
    --use_mlflow False \
    ${MDT_EXTRA_ARGS}
