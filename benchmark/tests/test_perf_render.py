"""The plain renderer on one Gaussian against its closed form."""
import math

import torch

from benchmark.reference import render as R

CAM = R.Cam(48, 32, 30.0, 30.0, 23.0, 15.0)


def _one(op_logit=0.0, s=0.01, z=2.0, rgb=(0.2, 0.5, 0.9)):
    means = torch.tensor([[0.0, 0.0, z]])
    quats = torch.tensor([[1.0, 0, 0, 0]])
    ls = torch.full((1, 3), math.log(s))
    lo = torch.tensor([[op_logit]])
    col = torch.tensor([rgb])
    alive = torch.ones(1, dtype=torch.bool)
    rec, rad, val = R.records(means, quats, ls, lo, col, alive,
                              torch.tensor([1.0, 0, 0, 0]), torch.zeros(3),
                              CAM)
    bins = R.bin_tiles(rec, rad, val, CAM)
    return R.render(rec, bins, CAM)


def test_single_gaussian_closed_form():
    s, z = 0.01, 2.0
    img = _one(s=s, z=z)
    op = 0.5
    var = (CAM.fx * s / z) ** 2 + R.LOW_PASS     # EWA + low-pass, pixels^2
    for dx in (0, 1, 2, 3):
        a = op * math.exp(-0.5 * dx * dx / var)
        px = 23 + dx                                 # u = cx at x = 0
        if a < R.ALPHA_MIN:
            assert float(img[5, 15, px]) == 0.0
            continue
        assert abs(float(img[5, 15, px]) - a) < 1e-6        # silhouette
        assert abs(float(img[3, 15, px]) - a * z) < 1e-6    # depth
        assert abs(float(img[4, 15, px]) - a * z * z) < 1e-5
        assert abs(float(img[1, 15, px]) - a * 0.5) < 1e-6  # colour
    assert float(img[5, 0, 0]) == 0.0


def test_alpha_clamp_and_cap():
    img = _one(op_logit=10.0)
    assert abs(float(img[5, 15, 23]) - R.ALPHA_MAX) < 1e-6
