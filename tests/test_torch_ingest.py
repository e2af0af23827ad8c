"""The live capture path in the port: ingest/sources.py,
scripts/nerfcapture2dataset.py and scripts/iphone_demo.py against the JAX
package's on the same capture directories."""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from isogs_slam_tpu.datasets.synthetic import SyntheticDataset as JSynthetic
from isogs_slam_tpu.ingest import sources as jsources
from isogs_slam_tpu.scripts import iphone_demo as jdemo
from isogs_slam_tpu_torch.ingest import sources
from isogs_slam_tpu_torch.scripts import iphone_demo, nerfcapture2dataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONLINE_DEMO = os.path.join(ROOT, "configs", "synthetic", "online_demo.py")
H, W, N_FRAMES = 48, 64, 4
MODS = {"jax": jsources, "torch": sources}

_FRAMES = []


def _frames():
    """(color u8, depth f32 m, c2w OpenCV, K) of the synthetic scene, as a
    phone would send them."""
    if not _FRAMES:
        ds = JSynthetic(num_frames=N_FRAMES, height=H, width=W, seed=0,
                        n_per_wall=2500, traj_step=0.012)
        K = np.asarray(ds.get_cam_K())
        for i in range(N_FRAMES):
            color, depth, _, c2w = (np.asarray(a) for a in ds[i])
            _FRAMES.append((np.clip(color, 0, 255).astype(np.uint8),
                            depth[..., 0], c2w.astype(np.float64), K))
    return _FRAMES


def _write_capture(path, writer="torch", done=True):
    for i, (color, depth, c2w, K) in enumerate(_frames()):
        MODS[writer].write_capture_frame(path, i, color, depth, c2w, K)
    if done:
        open(os.path.join(path, "done"), "w").close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_capture_directory_round_trip(tmp_path, writer):
    """A capture directory written by either package's write_capture_frame
    is byte-equal to the other's and reads back the same through either
    DirectorySource: colour exact, depth within one uint16 quantum
    (1 / 6553.5 m), the ARKit flip undone (c2w within 1e-12), K exact; the
    `done` marker ends the stream."""
    other = "jax" if writer == "torch" else "torch"
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_capture(a, writer)
    _write_capture(b, other)
    for rel in ["transforms.json", "done"] + [
            f"{d}/{i}.png" for d in ("rgb", "depth") for i in range(N_FRAMES)]:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel
    readers = [MODS[m].DirectorySource(a, poll=0.01) for m in MODS]
    for sent in _frames():
        got = [r.next_frame(timeout=1.0) for r in readers]
        for g in got:
            np.testing.assert_array_equal(g[0], sent[0])
            assert np.abs(g[1] - sent[1]).max() <= 1 / 6553.5
            np.testing.assert_allclose(g[2], sent[2], rtol=0, atol=1e-12)
            np.testing.assert_array_equal(g[3], sent[3])
        for x, y in zip(got[0], got[1]):
            np.testing.assert_array_equal(x, y)
    assert [r.next_frame(timeout=1.0) for r in readers] == [None, None]


def test_stream_dataset_matches_reference(tmp_path):
    """The port's StreamDataset gives the JAX one's frames (poses
    normalized to frame 0, intrinsics as a 4x4), and both end the stream
    at `done` with the same IndexError."""
    path = str(tmp_path / "cap")
    _write_capture(path)
    ds = iphone_demo.StreamDataset(sources.DirectorySource(path, poll=0.01),
                                   N_FRAMES + 2, timeout=5.0)
    jds = jdemo.StreamDataset(jsources.DirectorySource(path, poll=0.01),
                              N_FRAMES + 2, timeout=5.0)
    assert len(ds) == len(jds) == N_FRAMES + 2
    for i in range(N_FRAMES):
        for got, want in zip(ds[i], jds[i]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(ds[0][3], np.eye(4), atol=1e-6)
    for d in (ds, jds):
        with pytest.raises(IndexError, match=f"after {N_FRAMES} frames"):
            d[N_FRAMES]


class _SlowSource(sources.FrameSource):
    """Frames i = 0, 1, ... whose colour holds i, each after a short wait;
    None after n. Not thread-safe, like DirectorySource."""

    def __init__(self, n):
        self.n, self.i = n, 0

    def next_frame(self, timeout=30.0):
        if self.i >= self.n:
            return None
        i = self.i
        threading.Event().wait(0.001)
        self.i = i + 1
        c2w = np.eye(4)
        c2w[0, 3] = i + 1.0
        return (np.full((2, 2, 3), i, np.uint8), np.zeros((2, 2)), c2w,
                np.eye(3))


def test_stream_dataset_keeps_order_across_threads():
    """A prefetch thread and the SLAM loop call __getitem__ at once: every
    frame is the source's frame of that index, each pulled once, and frame
    0 is the pose origin (16 threads, a 10 us switch interval)."""
    n = 40
    ds = iphone_demo.StreamDataset(_SlowSource(n), n, timeout=1.0)
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in rng.integers(0, n, 30):
                color, _, _, pose = ds[int(i)]
                assert color[0, 0, 0] == i
                assert pose[0, 3] == i        # normalized: first frame at 1
        except Exception as e:                # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(s,))
                   for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(ds.frames) <= n


def test_make_source_errors_match_reference():
    """An unknown source kind and a missing cyclonedds raise as in the
    reference, with the same text."""
    for mod in MODS.values():
        with pytest.raises(ValueError, match="unknown source kind 'udp'"):
            mod.make_source("udp")
    msgs = []
    for mod in MODS.values():
        with pytest.raises(ImportError) as e:
            mod.make_source("dds")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "DirectorySource" in msgs[0]
    assert isinstance(sources.make_source("dir", path="/x"),
                      sources.DirectorySource)


def test_synthetic_stream_writes_a_capture(tmp_path):
    """nerfcapture2dataset's --demo-synthetic writer fills a capture
    directory that DirectorySource reads to its `done` marker, and the
    capture loop copies a stream into a dataset directory."""
    src = str(tmp_path / "live")
    nerfcapture2dataset.main(["--demo-synthetic", "--save", src,
                              "--n-frames", "3", "--device", "cpu"])
    dst = str(tmp_path / "copy")
    n = nerfcapture2dataset.capture_loop(
        sources.DirectorySource(src, poll=0.01), dst, 5, overwrite=False)
    assert n == 3
    reader = sources.DirectorySource(dst, poll=0.01)
    frames = [reader.next_frame(timeout=1.0) for _ in range(4)]
    assert frames[-1] is None
    assert frames[0][0].shape == (120, 160, 3)


def test_iphone_demo_matches_reference(tmp_path, monkeypatch):
    """Both packages' iphone_demo.main on configs/synthetic/online_demo.py
    over the same pre-written capture (4 frames at 48x64; the first frame
    sets the image size), the port with --device cpu: the same keyframes,
    the final checkpoint, and every camera translation within 2 cm (the
    shipped config's isotropic init and iso loss draw on the device, where
    the packages' draws differ: test_torch_pipeline's shipped_defaults
    tolerance)."""
    cap = str(tmp_path / "cap")
    _write_capture(cap)
    monkeypatch.setenv("ISOGS_NO_COMP_CACHE", "1")
    args = [ONLINE_DEMO, "--source", "dir", "--watch", cap, "--n-frames",
            str(N_FRAMES), "--no-eval", "--timeout", "5"]
    for d in ("jax", "torch"):        # the config's relative workdir
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jslam = jdemo.main(args)
    monkeypatch.chdir(tmp_path / "torch")
    slam = iphone_demo.main(args + ["--device", "cpu"])
    assert slam.device.type == "cpu"
    assert (slam.cam.width, slam.cam.height) == (W, H)
    assert slam.keyframe_time_indices == jslam.keyframe_time_indices
    assert np.abs(slam.cam_trans[:, 1:]).max() > 1e-4
    dt = np.linalg.norm(slam.cam_trans - np.asarray(jslam.cam_trans), axis=0)
    assert dt.max() < 2e-2, dt
    assert os.path.exists(os.path.join(slam.output_dir,
                                       f"params{N_FRAMES - 1}.npz"))


def test_iphone_demo_refuses_the_shipped_device():
    """configs/iphone/online_demo.py says primary_device "tpu": the demo
    stops before it waits on a stream, naming --device."""
    with pytest.raises(ValueError, match="--device cuda"):
        iphone_demo.main([os.path.join(ROOT, "configs", "iphone",
                                       "online_demo.py"), "--source", "dir",
                          "--watch", "/nonexistent"])
