# Topology preset of the PyTorch port: 4 cards of one node as a grid of 2
# data x 2 model ranks with SPATIAL partitioning (replaces
# scripts/config/tpu_v5e_8_sp2.sh): the state stays whole on every rank and
# each UNet activation is split along image height over the model ranks
# (parallel/sp.py: halo rows, all-reduced GroupNorm statistics). For images
# whose activations outgrow a card (512x512, or 256x256 with trajectory
# capture or without remat); at smaller sizes the halo traffic only adds
# time: prefer gpu_h100_4.sh or gpu_h100_4_tp2.sh. The image height must
# divide the model ranks (checked at start-up, parallel/sp.py:
# validate_spatial). The grid needs 4 processes: MDT_NPROC stays 4.
export MDT_NPROC=4
export MDT_LAUNCHER="python -m torch.distributed.run --standalone --nproc_per_node ${MDT_NPROC}"
export MDT_MESH_DATA=2
export MDT_MESH_MODEL=2
export MDT_MESH_SPATIAL=True
export MDT_MULTIHOST=False
export MDT_MIXED_PRECISION=bf16
