"""iPhone capture trainer config, the port's copy of
configs/iphone/gaussian_splatting.py. That file loads configs/iphone/
splatam.py through the JAX package's config loader; this one loads the
same file through the port's, so the port's CLIs read it without
importing the JAX package. The dict is the root file's, key for key
(primary_device "tpu": pass --device cuda or --device cpu).

Run: python -m isogs_slam_tpu_torch.scripts.splatam \
         isogs_slam_tpu_torch/configs/iphone/gaussian_splatting.py \
         --device cuda
"""
import os

from isogs_slam_tpu_torch.slam.config import load_experiment_config

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

config = load_experiment_config(
    os.path.join(_ROOT, "configs", "iphone", "splatam.py"))
