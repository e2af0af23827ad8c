#!/bin/bash
# Capture an iPhone dataset, run SLAM on it, then visualize (counterpart of
# bash_scripts/nerfcapture.bash, on the card; DEVICE=cpu runs SLAM and the
# viewer on the CPU).
if [ "$#" -ne 1 ]; then
    echo "Usage: isogs_slam_tpu_torch/bash_scripts/nerfcapture.bash <config_file>"
    exit 1
fi
if [ ! -f "$1" ]; then
    echo "Config file not found!"
    exit 1
fi
DEVICE="${DEVICE:-cuda}"
python -m isogs_slam_tpu_torch.scripts.nerfcapture2dataset "$1"
python -m isogs_slam_tpu_torch.scripts.splatam "$1" --device "$DEVICE"
python -m isogs_slam_tpu_torch.viz_scripts.final_recon "$1" --device "$DEVICE"
