#!/bin/bash
# Seed x scene sweep over the Replica full-eval config (counterpart of
# configs/replica/replica.bash, on the card; DEVICE=cpu runs it on the
# CPU): SEED/SCENE_NUM env contract. Run from the repository root.
DEVICE="${DEVICE:-cuda}"
for seed in 0 1 2; do
    export SEED=${seed}
    for scene in 0 1 2 3 4 5 6 7; do
        export SCENE_NUM=${scene}
        echo "Running scene number ${SCENE_NUM} with seed ${SEED}"
        python3 -u -m isogs_slam_tpu_torch.scripts.splatam configs/replica/replica_eval.py \
            --device "$DEVICE"
    done
done
