#!/bin/bash
# Capture an iPhone NeRFCapture stream to an on-disk dataset (counterpart
# of bash_scripts/nerfcapture2dataset.bash). The directory transport needs
# no sysctl, and the DDS path prints its own guidance when cyclonedds is
# present.
if [ "$#" -ne 1 ]; then
    echo "Usage: isogs_slam_tpu_torch/bash_scripts/nerfcapture2dataset.bash <config_file>"
    exit 1
fi
if [ ! -f "$1" ]; then
    echo "Config file not found!"
    exit 1
fi
python -m isogs_slam_tpu_torch.scripts.nerfcapture2dataset "$1"
