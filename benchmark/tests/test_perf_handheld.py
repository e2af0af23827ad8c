"""The handheld traffic's files: the Kinect v1 depth model, the handheld
path at fr1/desk's speeds, and the files every cell's traffic names."""
import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import plugins, scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRAFFIC = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                      "handheld.json")))
SENSOR, MOTION = TRAFFIC["depth"], TRAFFIC["motion"]
kinect = plugins.load("sensor", "kinect")
handheld = plugins.load("motion", "handheld")


def test_every_traffic_finds_its_sensor():
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in man["workloads"]:
        traffic = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                              w["traffic"] + ".json")))
        if "depth" in traffic:
            assert os.path.exists(os.path.join(
                ROOT, "benchmark", "sensor", traffic["depth"]["kind"] + ".py"))


@pytest.mark.parametrize("z", [0.8, 2.0, 4.0])
def test_kinect_noise_follows_sigma(z):
    """On a flat wall at depth z the noise's spread is sigma(z) =
    0.0012 + 0.0019 (z - 0.4)^2 m (within 3% on 256 x 256 samples, less the
    1/5000 m quantisation's share) and its mean is 0."""
    depth = torch.full((256, 256), z, dtype=torch.float64)
    got = kinect.apply(depth, SENSOR, torch.Generator().manual_seed(3))
    err = (got - z).reshape(-1).double()
    sig = 0.0012 + 0.0019 * (z - 0.4) ** 2
    q = 1.0 / 5000
    assert float(err.std()) == pytest.approx(math.sqrt(sig ** 2 + q * q / 12),
                                             rel=0.03)
    assert abs(float(err.mean())) < 4 * sig / 256


def test_kinect_holes_where_the_rule_says():
    """Out of 0.5-4.5 m, and one pixel either side of a jump of more than
    5% of a pixel's own depth (to a 4-neighbour); nowhere else."""
    z = torch.full((6, 8), 2.0, dtype=torch.float64)
    z[:, 5:] = 2.2          # a 10% step between columns 4 and 5
    z[0, 0] = 0.4           # too near
    z[5, 0] = 4.6           # too far
    z[3, 2] = 2.09          # a 4.5% bump: no edge
    got = kinect.apply(z, SENSOR, torch.Generator().manual_seed(0))
    want = torch.zeros_like(z, dtype=torch.bool)
    want[:, 4:6] = True
    want[0, 0] = want[5, 0] = True
    # the out-of-range pixels' neighbours see a jump of more than 5% too
    want[0, 1] = want[1, 0] = want[4, 0] = want[5, 1] = True
    assert torch.equal(got == 0, want)


def test_kinect_quantises_to_the_png_step():
    depth = 1.0 + 3.0 * torch.rand((64, 64), dtype=torch.float64,
                                   generator=torch.Generator().manual_seed(1))
    got = kinect.apply(depth, SENSOR, torch.Generator().manual_seed(2))
    steps = got * 5000.0
    assert torch.allclose(steps, torch.round(steps), atol=1e-6)


def test_handheld_speed_and_turn():
    """fr1/desk's mean speeds: 0.0138 m and 0.78 deg a frame (within 3%
    over 400 frames); each frame's within the 0.7-1.3 jitter."""
    c2w = handheld.path(MOTION, 400, np.random.RandomState([1, 7]))
    step = np.linalg.norm(np.diff(c2w[:, :3, 3], axis=0), axis=-1)
    R = c2w[:, :3, :3]
    rel = np.einsum("nji,njk->nik", R[:-1], R[1:])
    cos = (np.trace(rel, axis1=1, axis2=2) - 1) / 2
    turn = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    assert step.mean() == pytest.approx(0.0138, rel=0.03)
    assert turn.mean() == pytest.approx(0.78, rel=0.03)
    assert step.min() >= 0.7 * 0.0138 - 1e-9
    assert step.max() <= 1.3 * 0.0138 + 1e-9
    assert turn.min() >= 0.7 * 0.78 - 1e-6
    assert turn.max() <= 1.3 * 0.78 + 1e-6
    # rotations stay rotations
    assert np.allclose(np.einsum("nji,njk->nik", R, R), np.eye(3),
                       atol=1e-9)


def test_handheld_path_depends_only_on_the_start():
    cpu = torch.device("cpu")
    cam = {"width": 16, "height": 12, "fx": 13.0, "fy": 13.0, "cx": 7.5,
           "cy": 5.5}
    tr = dict(TRAFFIC, frames_per_job=3)
    _, da, a = scene.make_frames(cam, tr, 2 ** 33 + 5, 2, cpu)
    _, db, b = scene.make_frames(cam, tr, 17, 2, cpu)
    _, _, c = scene.make_frames(cam, tr, 17, 3, cpu)
    assert np.array_equal(a, b)
    assert not np.allclose(a, c)
    # the seed draws the sensor's noise
    assert not torch.equal(da, db)
    # a longer job walks the same first frames
    long = handheld.path(MOTION, 8, np.random.RandomState([2, 7]))
    short = handheld.path(MOTION, 3, np.random.RandomState([2, 7]))
    assert np.array_equal(long[:3], short)
