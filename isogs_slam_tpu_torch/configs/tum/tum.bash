#!/bin/bash
# Seed x scene sweep over the TUM eval config (counterpart of
# configs/tum/tum.bash, on the card; DEVICE=cpu runs it on the CPU):
# SEED/SCENE_NUM env contract. Run from the repository root.
DEVICE="${DEVICE:-cuda}"
for seed in 0 1 2; do
    export SEED=${seed}
    for scene in 0 1 2 3 4; do
        export SCENE_NUM=${scene}
        echo "Running scene number ${SCENE_NUM} with seed ${SEED}"
        python3 -u -m isogs_slam_tpu_torch.scripts.splatam configs/tum/tum_eval.py \
            --device "$DEVICE"
    done
done
