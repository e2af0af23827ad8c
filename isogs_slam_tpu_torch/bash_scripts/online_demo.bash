#!/bin/bash
# Live online SLAM demo (counterpart of bash_scripts/online_demo.bash, on
# the card; DEVICE=cpu runs it on the CPU). With the directory transport no
# sysctl is needed. Pair with a writer pushing frames into $CAPTURE_DIR.
CAPTURE_DIR="${CAPTURE_DIR:-/tmp/live_capture}"
DEVICE="${DEVICE:-cuda}"
python -m isogs_slam_tpu_torch.scripts.iphone_demo configs/iphone/splatam.py \
    --source dir --watch "$CAPTURE_DIR" --device "$DEVICE"
