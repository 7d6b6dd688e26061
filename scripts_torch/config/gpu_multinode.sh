# Topology preset of the PyTorch port: several nodes of cards, one process
# a card, data-parallel over NCCL (replaces scripts/config/tpu_multihost.sh).
# Run the same script on every node; torch.distributed.run meets the other
# nodes through its c10d rendezvous, set from the environment:
#   MDT_NNODES         number of nodes
#   MDT_RDZV_ENDPOINT  host:port that every node reaches (e.g. node 0's)
#   MDT_RDZV_ID        one id for the job (default mdt)
#   MDT_NPROC          processes (cards) a node (default 4)
# The ranks number nnodes x nproc; --multihost True makes the CLI refuse a
# start without torchrun's WORLD_SIZE.
export MDT_NPROC="${MDT_NPROC:-4}"
export MDT_LAUNCHER="python -m torch.distributed.run --nnodes ${MDT_NNODES:?set MDT_NNODES to the number of nodes} --nproc_per_node ${MDT_NPROC} --rdzv_backend c10d --rdzv_endpoint ${MDT_RDZV_ENDPOINT:?set MDT_RDZV_ENDPOINT to host:port} --rdzv_id ${MDT_RDZV_ID:-mdt}"
export MDT_MESH_DATA=-1   # every rank of every node on the data axis
export MDT_MESH_MODEL=1
export MDT_MESH_SPATIAL=False
export MDT_MULTIHOST=True
export MDT_MIXED_PRECISION=bf16
