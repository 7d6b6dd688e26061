# Topology preset of the PyTorch port: 4 cards of one node, data-parallel
# over NCCL, one process a card under torch.distributed.run (replaces
# scripts/config/tpu_v5e_8.sh and the reference's gpuMulti_config.yaml:
# distributed_type MULTI_GPU, num_processes 4). --batch_size stays the
# global batch, split over the ranks. MDT_NPROC sets the process count
# (default 4); with MDT_DEVICE=cuda:0 the ranks share one card over gloo
# (a check of the path, not a speed-up), with MDT_DEVICE=cpu they run on
# the CPU.
export MDT_NPROC="${MDT_NPROC:-4}"
export MDT_LAUNCHER="python -m torch.distributed.run --standalone --nproc_per_node ${MDT_NPROC}"
export MDT_MESH_DATA=-1   # every rank on the data axis
export MDT_MESH_MODEL=1
export MDT_MESH_SPATIAL=False
export MDT_MULTIHOST=False
export MDT_MIXED_PRECISION=bf16
