"""The frame generator: seeded, and its depth equal to hand-computed
planes."""
import numpy as np
import pytest
import torch

from benchmark import scene

CAM = {"width": 40, "height": 30, "fx": 20.0, "fy": 20.0, "cx": 19.5,
       "cy": 14.5}
ORBIT = {"frames_per_job": 3, "motion": {"kind": "orbit", "step_m": 0.004,
                                         "step_deg": 0.3}}


def test_same_seed_same_frames():
    cpu = torch.device("cpu")
    a = scene.make_frames(CAM, ORBIT, 2 ** 31 + 17, 1, cpu)
    b = scene.make_frames(CAM, ORBIT, 2 ** 31 + 17, 1, cpu)
    c = scene.make_frames(CAM, ORBIT, 5, 1, cpu)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert not np.array_equal(np.asarray(a[0]), np.asarray(c[0]))
    # the path is the start's, whatever the seed
    assert np.allclose(a[2], c[2])


def test_orbit_steps():
    """Each frame moves step_m along the circle (a chord of it) and turns
    the heading by step_deg; the start picks where the circle lies."""
    from benchmark import plugins
    orbit = plugins.load("motion", "orbit")
    n = 6
    c2w = orbit.path(ORBIT["motion"], n, np.random.RandomState([2, 7]))
    step = np.linalg.norm(np.diff(c2w[:, [0, 2], 3], axis=0), axis=-1)
    assert np.allclose(step, 0.004, rtol=1e-4)
    fwd = c2w[:, :3, 2]
    cos = np.sum(fwd[1:, [0, 2]] * fwd[:-1, [0, 2]], -1) / (
        np.linalg.norm(fwd[1:, [0, 2]], axis=-1)
        * np.linalg.norm(fwd[:-1, [0, 2]], axis=-1))
    assert np.allclose(np.degrees(np.arccos(np.clip(cos, -1, 1))), 0.3,
                       atol=1e-4)
    other = orbit.path(ORBIT["motion"], n, np.random.RandomState([3, 7]))
    assert not np.allclose(c2w, other)


def test_unknown_motion_is_refused():
    with pytest.raises(ValueError):
        scene.make_frames(CAM, {"frames_per_job": 1,
                                "motion": {"kind": "no_such_path"}}, 1, 0,
                          torch.device("cpu"))


def test_depth_matches_planes():
    """From the room's centre looking along +z: the centre ray meets the
    far wall (z = 2) at depth 2; a ray below it meets the floor (y = 1.2)
    at depth 1.2 / ((v - cy) / fy)."""
    tex = scene._surface_table(torch.Generator().manual_seed(0), "cpu")
    c2w = torch.eye(4, dtype=torch.float64)
    col, dep = scene.cast(c2w, CAM, tex)
    assert col.shape == (30, 40, 3) and dep.shape == (30, 40)
    # pixel rows 14 and 15 straddle cy = 14.5; columns 19/20 straddle cx
    ray = torch.tensor([(19 - 19.5) / 20.0, (14 - 14.5) / 20.0, 1.0],
                       dtype=torch.float64)
    assert abs(float(dep[14, 19]) - scene.ROOM_HI[2]) < 1e-9
    assert ray[2] == 1.0
    v = 29
    floor = scene.ROOM_HI[1] / ((v - CAM["cy"]) / CAM["fy"])
    assert floor < scene.ROOM_HI[2]
    assert abs(float(dep[v, 20]) - floor) < 1e-9
    assert float(col.min()) >= 0 and float(col.max()) <= 1
