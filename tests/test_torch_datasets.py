"""The port's file dataset loaders against the JAX package's, on the
mini-sequences tests/test_datasets_configs.py writes (the same layouts
and writers): every frame's colour, depth, intrinsics and pose equal, and
the same length, for TUM, ICL-NUIM, ScanNet, AI2Thor, NeRFCapture,
ScanNet++ (train and novel-view split), Azure Kinect (.log, flat and no
odometry), Record3D and RealSense."""
import json

import numpy as np
import pytest

from isogs_slam_tpu.datasets import get_dataset as j_get_dataset
from isogs_slam_tpu_torch.datasets import get_dataset
from test_datasets_configs import (_cam_cfg, _npy_pose_seq, _write_jpg,
                                   _write_png16)


def _tum(root):
    seq = root / "rgbd_dataset_tiny"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rgb, dep, gt = [], [], ["# header"]
    for i in range(3):
        t = 100.0 + i
        _write_jpg(seq / "rgb" / f"{t:.1f}.png", np.full((48, 64, 3),
                                                         50 + 20 * i))
        _write_png16(seq / "depth" / f"{t:.1f}.png",
                     np.full((48, 64), 5000 + 100 * i))
        rgb.append(f"{t:.4f} rgb/{t:.1f}.png")
        dep.append(f"{t + 0.01:.4f} depth/{t:.1f}.png")
        gt.append(f"{t + 0.02:.4f} {0.1 * i} 0 0 0 0 {0.1 * i} 1")
    (seq / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (seq / "depth.txt").write_text("\n".join(dep) + "\n")
    (seq / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    cfg = _cam_cfg() | {"dataset_name": "tum"}
    cfg["camera_params"]["png_depth_scale"] = 5000.0
    return cfg, "rgbd_dataset_tiny", {}


def _icl(root):
    seq = root / "living_room_traj0"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    lines = []
    for i in range(3):
        _write_jpg(seq / "rgb" / f"{i:04d}.png", np.full((48, 64, 3), 40))
        _write_png16(seq / "depth" / f"{i:04d}.png", np.full((48, 64), 3000))
        c2w = np.eye(4)
        c2w[0, 3] = 0.2 * i
        lines += [" ".join(str(x) for x in c2w[r, :4]) for r in range(3)]
        lines.append("")
    (seq / "livingRoom0.gt.sim").write_text("\n".join(lines) + "\n")
    return _cam_cfg() | {"dataset_name": "icl"}, "living_room_traj0", {}


def _scannet_like(root, name, ext):
    seq = root / f"scene_{name}"
    for sub in ("color", "depth", "pose"):
        (seq / sub).mkdir(parents=True)
    for i in range(3):
        _write_jpg(seq / "color" / f"{i}{ext}", np.full((48, 64, 3), 90 + i))
        _write_png16(seq / "depth" / f"{i}.png", np.full((48, 64), 1500))
        c2w = np.eye(4)
        c2w[1, 3] = 0.05 * i
        np.savetxt(seq / "pose" / f"{i}.txt", c2w)
    return _cam_cfg() | {"dataset_name": name}, f"scene_{name}", {}


def _nerfcapture(root):
    seq = root / "cap"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    frames = []
    for i in range(3):
        _write_jpg(seq / "rgb" / f"{i}.png", np.full((48, 64, 3), 70))
        _write_png16(seq / "depth" / f"{i}.png", np.full((48, 64), 13107))
        c2w = np.eye(4)
        c2w[2, 3] = 0.02 * i
        c2w[1, 3] = 0.01 * i
        frames.append({"file_path": f"rgb/{i}.png",
                       "transform_matrix": c2w.tolist()})
    meta = {"h": 48, "w": 64, "fl_x": 50.0, "fl_y": 50.0, "cx": 31.5,
            "cy": 23.5, "frames": frames}
    (seq / "transforms.json").write_text(json.dumps(meta))
    return {"dataset_name": "nerfcapture"}, "cap", {}


def _scannetpp(root, train):
    base = root / "scene_ab1" / "dslr"
    if not base.exists():
        (base / "undistorted_images").mkdir(parents=True)
        (base / "undistorted_depths").mkdir()
        (base / "nerfstudio").mkdir()
        names = [f"DSC{i:05d}.JPG" for i in range(4)]
        frames, test_frames = [], []
        for i, n in enumerate(names):
            _write_jpg(base / "undistorted_images" / n,
                       np.full((48, 64, 3), 100))
            _write_png16(base / "undistorted_depths"
                         / n.replace(".JPG", ".png"),
                         np.full((48, 64), 2000))
            c2w = np.eye(4)
            c2w[0, 3] = 0.1 * i
            entry = {"file_path": n, "transform_matrix": c2w.tolist()}
            (frames if i < 3 else test_frames).append(entry)
        meta = {"h": 48, "w": 64, "fl_x": 50.0, "fl_y": 50.0, "cx": 31.5,
                "cy": 23.5, "frames": frames, "test_frames": test_frames}
        (base / "nerfstudio" / "transforms_undistorted.json").write_text(
            json.dumps(meta))
        (base / "train_test_lists.json").write_text(
            json.dumps({"train": names[:3], "test": names[3:]}))
    return ({"dataset_name": "scannetpp"}, "scene_ab1",
            {"use_train_split": train})


def _azure(root, odom):
    seq = root / "capture0"
    (seq / "color").mkdir(parents=True)
    (seq / "depth").mkdir()
    log_lines, flat_lines = [], []
    for i in range(3):
        _write_jpg(seq / "color" / f"{i:05d}.jpg", np.full((48, 64, 3), 60))
        _write_png16(seq / "depth" / f"{i:05d}.png", np.full((48, 64), 1000))
        c2w = np.eye(4)
        c2w[2, 3] = 0.1 * i
        log_lines.append(f"{i} {i} {i + 1}")
        log_lines.extend(" ".join(str(x) for x in c2w[r]) for r in range(4))
        flat_lines.append(" ".join(str(x) for x in c2w.reshape(-1)))
    (seq / "odometry.log").write_text("\n".join(log_lines) + "\n")
    (seq / "poses_flat.txt").write_text("\n".join(flat_lines) + "\n")
    kw = {"odomfile": odom} if odom else {}
    return _cam_cfg() | {"dataset_name": "azure"}, "capture0", kw


def _npy(root, name, ext):
    _npy_pose_seq(root / "stream0", 3, ext)
    return _cam_cfg() | {"dataset_name": name}, "stream0", {}


FIXTURES = {
    "tum": _tum, "icl": _icl,
    "scannet": lambda r: _scannet_like(r, "scannet", ".jpg"),
    "ai2thor": lambda r: _scannet_like(r, "ai2thor", ".png"),
    "nerfcapture": _nerfcapture,
    "scannetpp_train": lambda r: _scannetpp(r, True),
    "scannetpp_nvs": lambda r: _scannetpp(r, False),
    "azure_log": lambda r: _azure(r, "odometry.log"),
    "azure_flat": lambda r: _azure(r, "poses_flat.txt"),
    "azure_none": lambda r: _azure(r, None),
    "record3d": lambda r: _npy(r, "record3d", ".png"),
    "realsense": lambda r: _npy(r, "realsense", ".jpg"),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_loader_matches_reference(tmp_path, name):
    """Every frame (colour, depth, intrinsics, pose) exactly the JAX
    loader's."""
    cfg, seq, kw = FIXTURES[name](tmp_path)
    kw = dict(kw, desired_height=48, desired_width=64)
    ref = j_get_dataset(cfg, str(tmp_path), seq, **kw)
    got = get_dataset(cfg, str(tmp_path), seq, device="cpu", **kw)
    assert type(got).__name__ == type(ref).__name__
    assert len(got) == len(ref) >= 2
    for i in range(len(ref)):
        for a, b, what in zip(got[i], ref[i], ("color", "depth",
                                               "intrinsics", "pose")):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{what} of frame {i}")
