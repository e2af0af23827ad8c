"""Dataset registry (counterpart of isogs_slam_tpu/datasets/__init__.py).

The file loaders need imageio and PIL, which a machine that only runs the
synthetic scene may lack: they are imported inside their branches, and the
image libraries at a loader's first read."""
from __future__ import annotations

from .dataconfig import load_dataset_config
from .synthetic import SyntheticDataset


def get_dataset(config_dict: dict, basedir: str, sequence: str,
                device="cuda", **kwargs):
    """`device` is where the synthetic scene is rendered; the file loaders
    are host-side numpy."""
    name = config_dict["dataset_name"].lower()
    if name == "replica":
        from .replica import ReplicaDataset
        return ReplicaDataset(config_dict, basedir, sequence, **kwargs)
    if name == "replicav2":
        from .replica import ReplicaV2Dataset
        return ReplicaV2Dataset(config_dict, basedir, sequence, **kwargs)
    if name == "synthetic":
        h = kwargs.get("desired_height", 120)
        w = kwargs.get("desired_width", 160)
        return SyntheticDataset(
            num_frames=kwargs.get("num_frames", 20),
            height=h, width=w, seed=kwargs.get("seed", 0),
            # scene detail scales with resolution so GT images keep
            # texture at any render size (~2500/wall at 120x160)
            n_per_wall=max(2500, (h * w) // 8),
            traj_step=config_dict.get("synthetic_traj_step", 0.012),
            device=device)
    if name == "icl":
        from .icl import ICLDataset
        return ICLDataset(config_dict, basedir, sequence, **kwargs)
    if name == "tum":
        from .tum import TUMDataset
        return TUMDataset(config_dict, basedir, sequence, **kwargs)
    if name == "scannet":
        from .scannet import ScannetDataset
        return ScannetDataset(config_dict, basedir, sequence, **kwargs)
    if name == "scannetpp":
        from .nerfcapture import ScannetPPDataset
        return ScannetPPDataset(basedir, sequence, **kwargs)
    if name == "nerfcapture":
        from .nerfcapture import NeRFCaptureDataset
        return NeRFCaptureDataset(basedir, sequence, **kwargs)
    if name in ("azure", "azurekinect"):
        from .azure import AzureKinectDataset
        return AzureKinectDataset(config_dict, basedir, sequence, **kwargs)
    if name == "record3d":
        from .record3d import Record3DDataset
        return Record3DDataset(config_dict, basedir, sequence, **kwargs)
    if name == "realsense":
        from .record3d import RealsenseDataset
        return RealsenseDataset(config_dict, basedir, sequence, **kwargs)
    if name == "ai2thor":
        from .scannet import Ai2thorDataset
        return Ai2thorDataset(config_dict, basedir, sequence, **kwargs)
    raise ValueError(f"Unknown dataset name {config_dict['dataset_name']}")
