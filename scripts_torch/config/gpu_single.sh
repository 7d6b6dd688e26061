# Topology preset of the PyTorch port: one card, one process (replaces
# scripts/config/tpu_single.sh and the reference's gpu{0..3}_config.yaml:
# distributed_type 'NO', one process; its fp16 AMP runs as bf16, as in the
# JAX package). CUDA_VISIBLE_DEVICES picks the card.
export MDT_LAUNCHER="python"
export MDT_MESH_DATA=1
export MDT_MESH_MODEL=1
export MDT_MESH_SPATIAL=False
export MDT_MULTIHOST=False
export MDT_MIXED_PRECISION=bf16
