"""The port's tracking refinements that run after the Adam loop, against
the JAX package on the toy scene of tests/test_torch_tracking_opts.py: the
pattern-search fan, the Gauss-Newton depth polish hand-off, and the pyramid
switching both (and Polyak) off at its coarse levels. Tolerances as stated
there, plus each refinement's own step, bounded at each assert."""
import numpy as np
import pytest
import torch

from isogs_slam_tpu_torch.slam import tracking as T
from test_torch_tracking_opts import (ITERS, LR_Q, LR_T, _assert_tracks_close,
                                      _track_both)

# toy sizes: PyTorch's intra-op thread pool buys nothing here and only
# contends with the other test workers
torch.set_num_threads(1)


def test_track_frame_fan_matches_reference():
    """Two rounds of 14 probes after the loop, the translation step seeded
    by hand and the quaternion step from its learning rate: the result
    stays within the plain bound plus one probe step (a near-tie between
    two probes may be decided differently)."""
    eps_t = 0.003
    tres, jres = _track_both(dict(fan_rounds=2, fan_trans_eps=eps_t))
    _assert_tracks_close(tres, jres, extra_q=LR_Q, extra_t=eps_t)


@pytest.mark.parametrize("kw", [dict(gn_iters=2),
                                dict(gn_iters=2, rebin_every_iter=True),
                                dict(gn_iters=1, tile_subsample=2)],
                         ids=["gn", "gn_rebin", "gn_sub2"])
def test_track_frame_gn_polish_matches_reference(kw):
    """The GN hand-off: same acceptance verdict, and the pose within the
    plain bound plus 1e-4 for the polish's 6x6 solves."""
    tres, jres = _track_both(kw)
    assert int(tres.gn_accepted) in (0, 1)
    _assert_tracks_close(
        tres, jres, extra_q=1e-4, extra_t=1e-4,
        first_rtol=3e-4 if "tile_subsample" in kw else 1e-4)


def test_pyramid_switches_refinements_off_at_coarse_levels(monkeypatch):
    """track_frame_pyramid runs GN, fan and Polyak at full resolution only
    and carries tile_subsample through; its result matches the
    reference's."""
    seen = []
    real = T.track_frame

    def spy(*a, **k):
        seen.append(a[9])
        return real(*a, **k)

    monkeypatch.setattr(T, "track_frame", spy)
    kw = dict(pyramid_levels=2, pyramid_iters=2, tile_subsample=2,
              polyak_rho=0.7, fan_rounds=1, gn_iters=1)
    tres, jres = _track_both(kw, pyramid=True)
    coarse, full = seen
    assert (coarse.gn_iters, coarse.fan_rounds, coarse.polyak_rho) == (0, 0,
                                                                       0.0)
    assert coarse.tile_subsample == 2 and coarse.num_iters == 2
    assert (full.gn_iters, full.fan_rounds, full.polyak_rho) == (1, 1, 0.7)
    assert tres.iters_run == int(jres.iters_run) == 2 + ITERS
    np.testing.assert_allclose(tres.quat.numpy(), np.asarray(jres.quat),
                               atol=1e-2 * LR_Q * 5 + LR_Q + 1e-4)
    np.testing.assert_allclose(tres.trans.numpy(), np.asarray(jres.trans),
                               atol=1e-2 * LR_T * 5 + LR_T + 1e-4)
