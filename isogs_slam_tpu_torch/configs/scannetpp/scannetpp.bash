#!/bin/bash
# SCENE sweep over the ScanNet++ SLAM eval config (counterpart of
# configs/scannetpp/scannetpp.bash, on the card; DEVICE=cpu runs it on the
# CPU). Run from the repository root.
DEVICE="${DEVICE:-cuda}"
for scene in 0 1; do
    export SCENE=${scene}
    echo "Running scene number ${SCENE} with seed 0"
    python3 -u -m isogs_slam_tpu_torch.scripts.splatam configs/scannetpp/scannetpp_eval.py \
        --device "$DEVICE"
done
