"""Every opt-in knob of the port's rasterizer, tracker and mapper, each set
in a SLAM that then runs two frames on the CPU (the knobs that still raise
are held in tests/test_torch_pipeline.py)."""
import csv
import os

import numpy as np
import pytest
import torch

from isogs_slam_tpu_torch.slam import pipeline as P
from isogs_slam_tpu_torch.slam.config import inject_defaults
from isogs_slam_tpu_torch.slam.experimental import LOSERS
from test_torch_pipeline import _config, _frames

# toy sizes: PyTorch's intra-op thread pool buys nothing here and only
# contends with the other test workers
torch.set_num_threads(1)

# every opt-in knob of the rasterizer, the tracker and the mapper runs
PORTED = {
    "tracking.gn_iters": 2, "tracking.fan_rounds": 1,
    "tracking.polyak_rho": 0.5, "tracking.early_stop_patience": 1,
    "tracking.tile_subsample": 2, "tracking.rebin_every_iter": True,
    "mapping.tile_subsample": 2, "mapping.lazy_adam": True,
    "mapping.vmap_bins": True, "mapping.force_subset": True,
    "mapping.exact_polish_iters": 1, "mapping.tile_cycle": False,
    "raster.tile_cull": True, "raster.tight_rect": True,
    "mapping.use_gaussian_splatting_densification": True,
    "mapping.iso_pool_refresh_phases": 3, "isogs.knn_pool_size": 0,
}
# knobs that act only on the stripe path
_NEEDS_SUBSET = ("mapping.lazy_adam", "mapping.exact_polish_iters",
                 "mapping.tile_cycle")
# where the SLAM object keeps each knob that is not a field of the same
# name in its tracking / mapping / raster config
_HELD_AS = {
    "mapping.use_gaussian_splatting_densification":
        lambda s: s.mcfg.use_densification,
    "mapping.iso_pool_refresh_phases":
        lambda s: s.config["mapping"]["iso_pool_refresh_phases"],
    "isogs.knn_pool_size": lambda s: s.lcfg_map.iso_pool_size,
}
# densification from the first mapping iteration on, every iteration, at a
# threshold the toy scene's gradients reach
_DENSIFY_NOW = dict(start_after=0, remove_big_after=3000, stop_after=5000,
                    densify_every=1, grad_thresh=1e-7, num_to_split_into=2)


@pytest.mark.parametrize("knob", list(PORTED))
def test_ported_knob_runs_two_frames(tmp_path, knob, capsys):
    """A SLAM built with the knob set runs two frames on the CPU (frame 0:
    init + a mapping phase, frame 1: tracking): finite losses and poses,
    the tracked pose moved off its initialisation, and the knob left its
    trace (a registry warning, the GN verdict, fewer iterations)."""
    cfg = inject_defaults(_config(tmp_path, "p"))
    cfg["mapping"]["num_iters"] = 3
    cfg["tracking"]["num_iters"] = 3
    section, key = knob.split(".")
    cfg[section][key] = PORTED[knob]
    if knob in _NEEDS_SUBSET:
        cfg["mapping"]["tile_subsample"] = 2
    if knob == "mapping.use_gaussian_splatting_densification":
        cfg["mapping"]["densify_dict"] = dict(_DENSIFY_NOW)
    slam = P.SLAM(cfg, dataset=_frames())
    said = capsys.readouterr().out
    assert ("ADJUDICATED LOSER" in said) == ((section, key) in LOSERS)
    held = _HELD_AS.get(knob, lambda s: getattr(
        {"tracking": s.tcfg, "mapping": s.mcfg, "raster": s.rcfg}[section],
        key))
    assert held(slam) == PORTED[knob]
    if knob == "mapping.iso_pool_refresh_phases":
        slam.initialize_first_frame(*_frames()[0][:2])
        pool = slam._phase_iso_pool()
        assert slam._phase_iso_pool() is pool       # kept for 3 phases
        slam._compact()
        assert slam._iso_pool is None               # rows moved
        slam.state = None
    slam.run(end_at=1)
    with open(os.path.join(slam.output_dir, "metrics_log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert {r["stage"] for r in rows} == {"tracking", "mapping"}
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert sum(r["stage"] == "mapping" for r in rows) == 3
    n_track = sum(r["stage"] == "tracking" for r in rows)
    assert n_track == 3 or (knob == "tracking.early_stop_patience"
                            and 1 <= n_track < 3)
    assert np.isfinite(slam.cam_trans[:, :2]).all()
    assert np.abs(slam.cam_trans[:, 1]).max() > 0
    assert all(bool(torch.isfinite(p).all()) for p in slam.state.params)
    if knob == "tracking.gn_iters":
        assert slam.stats["gn_accepted"] in ([0], [1])
    if knob == "tracking.rebin_every_iter":
        assert slam._track_bins is None
    if knob == "mapping.use_gaussian_splatting_densification":
        # at this threshold every row splits into two and the copies that
        # do not fit in the capacity are dropped and counted
        (frame, n_clone, n_split, dropped), = slam.stats["densify_counts"]
        assert frame == 0 and n_clone + n_split > 0
        assert (dropped > 0) == (int(slam.state.hwm) == slam.state.capacity)
    if knob == "mapping.iso_pool_refresh_phases":
        assert slam._iso_pool is not None and slam._iso_pool_age == 1
    if knob == "isogs.knn_pool_size":
        assert slam._iso_pool is None
        assert any(float(r["iso_loss"]) > 0 for r in rows
                   if r["stage"] == "mapping")
