#!/bin/bash
# Mesh-geometry eval across Replica runs (counterpart of
# bash_scripts/run_replica_mesh_eval_all.sh, on the card; DEVICE=cpu runs
# it on the CPU). GT meshes under $GT_MESH_DIR.
GT_MESH_DIR="${GT_MESH_DIR:-./data/Replica/gt_meshes}"
DEVICE="${DEVICE:-cuda}"
for idx in 0 1 2 3 4 5 6 7; do
  scene=$(python -c "print(['room0','room1','room2','office0','office1','office2','office3','office4'][$idx])")
  gt="$GT_MESH_DIR/${scene}.ply"
  [ -f "$gt" ] || { echo "skip $scene (no $gt)"; continue; }
  SPLATAM_SCENE_INDEX=$idx python -m isogs_slam_tpu_torch.scripts.eval_mesh_geometry \
      configs/replica/splatam.py --gt-mesh "$gt" --device "$DEVICE"
done
