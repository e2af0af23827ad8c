"""Multi-device SLAM over torch.distributed (counterpart of
isogs_slam_tpu/parallel/): view-parallel mapping (sharded), tile-parallel
rendering and tracking (tile_sharded, track_sharded) and Gaussian-axis
sharding of the iso density (gauss_sharded), on the process group and mesh
of parallel/dist.py."""
