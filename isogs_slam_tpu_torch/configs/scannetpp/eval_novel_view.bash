#!/bin/bash
# NVS eval for one ScanNet++ scene (counterpart of
# configs/scannetpp/eval_novel_view.bash, on the card; DEVICE=cpu runs it
# on the CPU): scene index as $1. Run from the repository root.
DEVICE="${DEVICE:-cuda}"
export SCENE=$1
echo "Evaluating scene number ${SCENE} with seed 0"
python3 -u -m isogs_slam_tpu_torch.scripts.eval_novel_view configs/scannetpp/eval_novel_view.py \
    --device "$DEVICE"
