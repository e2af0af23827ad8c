"""Live RGB-D frame ingest for online SLAM (this package's own copy of
isogs_slam_tpu/ingest/sources.py, which imports nothing of JAX; image
files go through io/images.py, Pillow, in place of imageio: the same bytes
and arrays).

The reference receives NeRFCapture frames over CycloneDDS pub/sub
(scripts/iphone_demo.py:61-94 SplatCaptureFrame IDL, :96-536 capture loop) —
the only inter-process transport in the whole reference (SURVEY.md §2.3).
Here ingest is a `FrameSource` interface with two implementations:

  * DDSSource — the CycloneDDS NeRFCapture receiver (gated: cyclonedds is
    not installed in this environment; constructing it raises with install
    instructions);
  * DirectorySource — a file-watcher source reading NeRFCapture-layout
    frames (rgb/{i}.png, depth/{i}.png, transforms.json entries) as another
    process writes them. This is transport-agnostic (an iPhone can push
    over scp/rsync/http) and drives the same online SLAM loop.

Frames are (color [H,W,3] u8, depth [H,W] f32 meters, c2w [4,4], K [3,3]).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from ..io.images import imread, imwrite

P_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


class FrameSource:
    def next_frame(self, timeout: float = 30.0):
        """Blocking: returns (color, depth, c2w, K) or None on timeout /
        end of stream."""
        raise NotImplementedError

    def close(self):
        pass


class DirectorySource(FrameSource):
    """Reads frames from a NeRFCapture-style capture directory while it is
    being written: rgb/{idx}.png, depth/{idx}.png and a transforms.json
    whose `frames` list grows. A `done` marker file ends the stream."""

    def __init__(self, path: str, poll: float = 0.25,
                 flip_arkit_pose: bool = True):
        self.path = path
        self.poll = poll
        self.flip = flip_arkit_pose
        self.next_idx = 0

    def _meta(self):
        try:
            with open(os.path.join(self.path, "transforms.json")) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def next_frame(self, timeout: float = 30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            meta = self._meta()
            if meta is not None and self.next_idx < len(meta["frames"]):
                fr = meta["frames"][self.next_idx]
                rgb_p = os.path.join(self.path, fr["file_path"])
                dep_p = os.path.join(
                    self.path, fr["file_path"].replace("rgb", "depth"))
                try:
                    color = np.asarray(imread(rgb_p))[:, :, :3]
                    depth_raw = np.asarray(imread(dep_p))
                except (OSError, ValueError):
                    time.sleep(self.poll)   # frame mid-write
                    continue
                scale = float(meta.get("png_depth_scale", 6553.5))
                depth = depth_raw.astype(np.float32) / scale
                c2w = np.array(fr["transform_matrix"], np.float64)
                if self.flip:
                    c2w = P_FLIP @ c2w @ P_FLIP.T
                K = np.array([[meta["fl_x"], 0, meta["cx"]],
                              [0, meta["fl_y"], meta["cy"]],
                              [0, 0, 1.0]])
                self.next_idx += 1
                return color, depth, c2w, K
            if os.path.exists(os.path.join(self.path, "done")):
                return None
            time.sleep(self.poll)
        return None


class DDSSource(FrameSource):  # pragma: no cover - needs cyclonedds
    """CycloneDDS NeRFCapture receiver (reference transport)."""

    def __init__(self, domain_id: int = 0):
        try:
            from cyclonedds.domain import DomainParticipant
            from cyclonedds.sub import DataReader, Subscriber
            from cyclonedds.topic import Topic
        except ImportError as e:
            raise ImportError(
                "cyclonedds is not installed in this environment; use "
                "DirectorySource (any transport that drops frames into a "
                "capture directory) or `pip install cyclonedds` where "
                "networking is available") from e
        from .dds_idl import SplatCaptureFrame
        participant = DomainParticipant(domain_id)
        topic = Topic(participant, "Frames", SplatCaptureFrame)
        self.reader = DataReader(Subscriber(participant), topic)

    def next_frame(self, timeout: float = 30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            sample = self.reader.read_next()
            if sample is None:
                time.sleep(0.01)
                continue
            W, H = int(sample.width), int(sample.height)
            color = np.asarray(sample.image, np.uint8).reshape(H, W, 3)
            if sample.has_depth:
                dw, dh = int(sample.depth_width), int(sample.depth_height)
                depth = (np.frombuffer(
                    bytes(sample.depth_image), np.float16
                ).astype(np.float32).reshape(dh, dw)
                    * float(sample.depth_scale))
            else:
                depth = np.zeros((H, W), np.float32)
            c2w = np.array(sample.transform_matrix,
                           np.float64).reshape(4, 4)
            c2w = P_FLIP @ c2w @ P_FLIP.T   # ARKit -> OpenCV convention
            K = np.array([[sample.fl_x, 0, sample.cx],
                          [0, sample.fl_y, sample.cy], [0, 0, 1.0]])
            return color, depth, c2w, K
        return None


def make_source(kind: str, path: str | None = None, **kw) -> FrameSource:
    if kind == "dir":
        return DirectorySource(path, **kw)
    if kind == "dds":
        return DDSSource(**kw)
    raise ValueError(f"unknown source kind {kind!r} (dir | dds)")


def write_capture_frame(save_path: str, idx: int, color: np.ndarray,
                        depth: np.ndarray, c2w: np.ndarray, K: np.ndarray,
                        png_depth_scale: float = 6553.5):
    """Append one frame to a NeRFCapture-layout capture directory (the
    writer side of DirectorySource; also what nerfcapture2dataset emits).

    `c2w` is OpenCV-convention (what FrameSources return); on disk the
    transforms.json stores ARKit/OpenGL convention exactly like NeRFCapture
    itself, so the `nerfcapture` dataset loader (which conjugates by
    P = diag(1,-1,-1,1)) reads it back correctly."""
    c2w = P_FLIP @ np.asarray(c2w, np.float64) @ P_FLIP.T
    os.makedirs(os.path.join(save_path, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(save_path, "depth"), exist_ok=True)
    imwrite(os.path.join(save_path, "rgb", f"{idx}.png"),
            np.asarray(color, np.uint8))
    d16 = np.clip(np.asarray(depth, np.float64) * png_depth_scale,
                  0, 65535).astype(np.uint16)
    imwrite(os.path.join(save_path, "depth", f"{idx}.png"), d16)

    meta_path = os.path.join(save_path, "transforms.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    else:
        H, W = color.shape[:2]
        meta = {"w": W, "h": H, "fl_x": float(K[0, 0]),
                "fl_y": float(K[1, 1]), "cx": float(K[0, 2]),
                "cy": float(K[1, 2]), "png_depth_scale": png_depth_scale,
                "frames": []}
    meta["frames"].append({
        "file_path": f"rgb/{idx}.png",
        "transform_matrix": np.asarray(c2w, np.float64).tolist()})
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)   # atomic for concurrent readers
