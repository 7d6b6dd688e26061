# Topology preset of the PyTorch port: 4 cards of one node as a grid of 2
# data x 2 model ranks (replaces scripts/config/tpu_v5e_8_tp2.sh). Every
# parameter at least MDT_TP_MIN_FEATURES wide is channel-sharded with its
# AdamW moments and EMA over the model ranks (parallel/tp.py): for runs
# whose parameters and optimizer state outgrow a card (256x256 zoo models);
# plain data parallelism (gpu_h100_4.sh) is faster where the state fits.
# The grid needs 4 processes: MDT_NPROC stays 4.
export MDT_NPROC=4
export MDT_LAUNCHER="python -m torch.distributed.run --standalone --nproc_per_node ${MDT_NPROC}"
export MDT_MESH_DATA=2
export MDT_MESH_MODEL=2
export MDT_TP_MIN_FEATURES=256
export MDT_MESH_SPATIAL=False
export MDT_MULTIHOST=False
export MDT_MIXED_PRECISION=bf16
