#!/bin/bash
# Run SLAM on all 8 Replica scenes to frame 800, then export splat PLY and
# extract the mesh (counterpart of bash_scripts/run_replica_all_scenes.sh,
# on the card; DEVICE=cpu runs it on the CPU).
set -e
END_AT="${END_AT:-800}"
DEVICE="${DEVICE:-cuda}"
for idx in 0 1 2 3 4 5 6 7; do
  echo "=== Replica scene index $idx ==="
  SPLATAM_SCENE_INDEX=$idx python -m isogs_slam_tpu_torch.scripts.splatam \
      configs/replica/splatam.py --end-at "$END_AT" --device "$DEVICE"
  SPLATAM_SCENE_INDEX=$idx python -m isogs_slam_tpu_torch.scripts.export_ply \
      configs/replica/splatam.py
  SPLATAM_SCENE_INDEX=$idx python -m isogs_slam_tpu_torch.scripts.extract_mesh_fast \
      configs/replica/splatam.py --voxel-size 0.01 --iso-level 0.3 --no-show \
      --device "$DEVICE"
done
