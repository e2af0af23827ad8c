#!/bin/bash
# Seed x scene sweep over the ScanNet eval config (counterpart of
# configs/scannet/scannet.bash, on the card; DEVICE=cpu runs it on the
# CPU): SEED/SCENE_NUM env contract. Run from the repository root.
DEVICE="${DEVICE:-cuda}"
for seed in 0 1 2; do
    export SEED=${seed}
    for scene in 0 1 2 3 4 5; do
        export SCENE_NUM=${scene}
        echo "Running scene number ${SCENE_NUM} with seed ${SEED}"
        python3 -u -m isogs_slam_tpu_torch.scripts.splatam configs/scannet/scannet_eval.py \
            --device "$DEVICE"
    done
done
