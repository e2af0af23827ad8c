"""What decides `correct`: the plain reference follows the checked job's
first steps from what the job itself produced, and each reading is held
against the cell's limits (benchmark/limits/<cell>.json).

The job is judged on
  * the first frame's mapping phase: the reference builds the first-frame
    map from the frame and follows the whole phase, drawing the job's
    random stream from its seed as the configured steps draw it (the
    init's log-scale perturbation, the iso term's pool and samples); each
    iteration's logged colour, depth and flatness terms are compared
    (`map_loss_gap`: the largest gap relative to the reference's term), and
    so is the phase's update of the map, params0.npz less the first-frame
    map, leaf by leaf (`map_change_gap`: the training measure, the gap of
    the change's norm by the worst leaf);
  * tracking of every frame up to the first mapping frame after the first,
    all of which track against the map the first phase left (params0.npz):
    from the initial pose the configuration derives from the job's own
    earlier poses, the reference runs the whole Adam loop on the pose;
    each iteration's colour and depth terms are compared
    (`track_loss_gap`) and so is the pose kept (`track_pose_mm`: its
    translation gap in mm plus its rotation gap in mrad, against the
    reference's pose after the step the job's own log ranks best);
  * the first densification after the first frame: the pixels the rule
    adds at the job's pose on params0, against the rows of that frame in
    the job's final map (`densify_gap`, relative).
The reference computes in float32 with TF32 off; the control is the same
reference with TF32 on, put in the program's place (`control_readings`).
"""
from __future__ import annotations

import csv
import os
from contextlib import contextmanager

import numpy as np
import torch

from .reference import render as R
from .reference import slam as S

CHECKS = ("map_loss_gap", "map_change_gap", "track_loss_gap",
          "track_pose_mm", "densify_gap")
LEAVES = ("means3D", "unnorm_rotations", "log_scales", "logit_opacities",
          "rgb_colors")


@contextmanager
def tf32(on: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def read_log(job_dir: str) -> dict:
    """metrics_log.csv -> {(frame, stage): [steps, 7] array}."""
    out: dict = {}
    with open(os.path.join(job_dir, "metrics_log.csv")) as f:
        for row in csv.DictReader(f):
            key = (int(row["frame"]), row["stage"])
            out.setdefault(key, []).append(
                [float(row[k]) for k in ("loss", "image_loss", "depth_loss",
                                         "flat_loss", "iso_loss",
                                         "mean_density", "mask_frac")])
    return {k: np.asarray(v) for k, v in out.items()}


def cam_of(spec: dict) -> R.Cam:
    c = spec["camera"]
    return R.Cam(int(c["image_width"]), int(c["image_height"]),
                 float(c["fx"]), float(c["fy"]), float(c["cx"]),
                 float(c["cy"]))


def settings(cfg: dict) -> tuple:
    """The configuration's tracking and mapping settings the reference
    follows (after the runtime defaults the port injects)."""
    tr, mp = cfg["tracking"], cfg["mapping"]
    raster = cfg.get("raster", {})
    k_map = int(raster.get("max_per_tile", 512))
    tc = dict(num_iters=tr["num_iters"], lr_quat=tr["lrs"]["cam_unnorm_rots"],
              lr_trans=tr["lrs"]["cam_trans"],
              use_depth_loss_thres=tr.get("use_depth_loss_thres", False),
              depth_loss_thres=tr.get("depth_loss_thres", 100000),
              sil_thres=tr["sil_thres"],
              sil_norm_render=tr.get("sil_norm_render", True),
              ignore_outlier_depth_loss=tr["ignore_outlier_depth_loss"],
              w_im=tr["loss_weights"]["im"],
              w_depth=tr["loss_weights"]["depth"],
              max_per_tile=int(raster.get("max_per_tile_tracking",
                                          min(256, k_map))),
              bin_margin_px=float(tr.get("bin_margin_px", 8.0)),
              reuse_margin_px=float(tr.get("cross_frame_margin_px", 16.0)))
    lw, lrs, pd = mp["loss_weights"], mp["lrs"], mp["pruning_dict"]
    iso = cfg.get("isogs", {})
    mc = dict(num_iters=mp["num_iters"], w_im=lw["im"], w_depth=lw["depth"],
              w_flat=lw.get("flat", 50.0), w_iso=lw.get("iso", 2.0),
              lrs=[lrs["means3D"], lrs["unnorm_rotations"],
                   lrs["log_scales"], lrs["logit_opacities"],
                   lrs["rgb_colors"]],
              max_per_tile=k_map, iso_k=int(iso.get("k", 16)),
              iso_pool=int(iso.get("knn_pool_size", 32768)),
              iso_sample=int(iso.get("sample_size", 8192)),
              prune_every=pd["prune_every"], prune_stop=pd["stop_after"],
              prune_opacity=pd["removal_opacity_threshold"])
    isect_per = float(raster.get("isect_per_gaussian", 4.0))
    return tc, mc, isect_per


def reference_readings(cfg: dict, spec: dict, frames, params0, poses,
                       job_seed: int, device, tf32_on: bool = False) -> dict:
    """The reference's readings for one job: the first phase's log, the
    tracked frames' logs and poses, the densification count. `frames` =
    (colour [n, H, W, 3] 0..255, depth [n, H, W]) as the job got them;
    params0 the job's map after its first phase; poses (rots [4, n],
    trans [3, n]) the job's estimated trajectory."""
    cam = cam_of(spec)
    tc, mc, isect_per = settings(cfg)
    colour, depth = frames
    rots, trans = poses

    def frame(i):
        im = torch.as_tensor(colour[i], device=device).permute(2, 0, 1) / 255
        d = torch.as_tensor(depth[i], device=device).reshape(1, cam.height,
                                                             cam.width)
        return im.contiguous(), d.contiguous()

    out = {}
    map_every = int(cfg["map_every"])
    first_map = map_every - 1 if map_every > 1 else 1
    with tf32(tf32_on):
        im0, d0 = frame(0)
        g = torch.Generator(device=device).manual_seed(int(job_seed))
        noise = torch.randn((cam.height * cam.width, 3), generator=g,
                            dtype=torch.float32, device=device)
        m0 = S.first_frame_map(im0, d0, cam, noise)
        del noise
        isect_cap = S.isect_capacity(int(m0.means.shape[0] * isect_per))
        granule = int(cfg.get("capacity_granule", 65536))
        capacity = max(granule, -(-int(1.5 * cam.width * cam.height)
                                  // granule) * granule)
        radius = float(d0.max()) / float(cfg["scene_radius_depth_ratio"])
        m1, alive, mlog, drop, n_isect = S.map_phase(
            m0, im0, d0, [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0], cam, mc,
            isect_cap, g, radius, capacity)
        out["map_log"] = mlog
        out["map_change"] = {k: (a[alive] - b[alive]).cpu().numpy()
                             for k, a, b in zip(LEAVES, m1, m0)}
        out["map_start"] = {k: b[alive].cpu().numpy()
                            for k, b in zip(LEAVES, m0)}
        del m0, m1
        if n_isect > 0.75 * isect_cap:
            isect_cap = S.isect_capacity(max(int(n_isect * 1.5),
                                             isect_cap + S.ISECT_GRANULE))
        k_map = mc["max_per_tile"] + (256 if drop > 0.005 else 0)
        m = S.map_from_npz(params0, device)
        tracker = S.Tracker(m, cam, tc, isect_cap)
        out["track"] = {}
        for t in range(1, first_map + 1):
            q0, t0 = S.const_velocity(rots, trans, t)
            imt, dt = frame(t)
            res = tracker.track(q0, t0, imt, dt)
            out["track"][t] = (res["log"], res["quat"].cpu().numpy(),
                               res["trans"].cpu().numpy(), res["poses"])
            out.setdefault("init", {})[t] = (np.asarray(q0), np.asarray(t0))
        _, dd = frame(first_map)
        out["densify"] = S.densify_count(
            m, rots[:, first_map], trans[:, first_map], dd, cam, k_map,
            tracker.isect_cap, cfg["mapping"]["sil_thres"])
    return out


def program_readings(job_dir: str, params0, final, first_map: int) -> dict:
    log = read_log(job_dir)
    out = {"map_log": log[(0, "mapping")][:, [1, 2, 3]], "track": {},
           "map_end": {k: np.asarray(params0[k]) for k in LEAVES}}
    rots, trans = final["cam_unnorm_rots"][0], final["cam_trans"][0]
    for t in range(1, first_map + 1):
        out["track"][t] = (log[(t, "tracking")][:, [0, 1, 2, 6]],
                           rots[:, t], trans[:, t], None)
    out["densify"] = int(np.sum(np.asarray(final["timestep"]) == first_map))
    return out


def _rel_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = min(len(a), len(b))
    if len(a) != len(b):
        return float("inf")
    return float(np.max(np.abs(a[:n] - b[:n]) / np.maximum(np.abs(b[:n]),
                                                            1e-12)))


def _pose_gap_mm(q1, t1, q2, t2):
    """Translation gap (mm) plus rotation gap (mrad) of two poses."""
    q1 = np.asarray(q1, np.float64)
    q2 = np.asarray(q2, np.float64)
    q1, q2 = q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2)
    q2 = q2 if float(np.dot(q1, q2)) >= 0 else -q2
    ang = 4.0 * np.arctan2(np.linalg.norm(q1 - q2), np.linalg.norm(q1 + q2))
    dt = np.asarray(t1, np.float64) - np.asarray(t2, np.float64)
    return 1000.0 * (float(np.linalg.norm(dt)) + float(ang))


def _change_gap(got: dict, ref: dict) -> float:
    """The training measure of the phase's update, by the worst leaf: the
    gap between the norms of the job's change of a leaf over the phase and
    the reference's, against the larger of the reference's norm of that
    leaf and of the median leaf."""
    if "map_change" in got:
        chg = got["map_change"]
    else:
        ends = got["map_end"]
        if any(ends[k].shape != ref["map_start"][k].shape for k in LEAVES):
            return float("inf")     # the phase kept other rows
        chg = {k: ends[k] - ref["map_start"][k] for k in LEAVES}
    rn = {k: float(np.linalg.norm(ref["map_change"][k])) for k in LEAVES}
    med = float(np.median(list(rn.values())))
    return max(abs(float(np.linalg.norm(chg[k])) - rn[k]) / max(rn[k], med,
                                                                1e-30)
               for k in LEAVES)


def compare(got: dict, ref: dict, track_iters: int | None = None) -> dict:
    """The numbers compared: `got` (the program's or the control's
    readings) against the reference's. `track_iters`: the tracking
    iterations whose terms are compared (None: all)."""
    nums = {"map_loss_gap": _rel_gap(got["map_log"].reshape(-1),
                                     ref["map_log"].reshape(-1)),
            "map_change_gap": _change_gap(got, ref)}
    tl, tp = 0.0, 0.0
    for t, (rlog, _, _, rposes) in ref["track"].items():
        glog, gq, gt, _ = got["track"][t]
        # colour and depth terms of every iteration
        n = len(rlog) if track_iters is None else track_iters
        if len(glog) != len(rlog):
            tl = float("inf")
        tl = max(tl, _rel_gap(glog[:n, 1:3].reshape(-1),
                              rlog[:n, 1:3].reshape(-1)))
        # the pose after the step whose loss per masked pixel the job's
        # own log ranks first (its best-candidate rule)
        metric = glog[:, 0] / np.maximum(glog[:, 3], 1e-6)
        i = int(np.argmin(metric))
        if i < len(rposes):
            tp = max(tp, _pose_gap_mm(gq, gt, *rposes[i]))
        else:
            tp = float("inf")
    nums["track_loss_gap"] = tl
    nums["track_pose_mm"] = tp
    nums["densify_gap"] = (abs(got["densify"] - ref["densify"])
                           / max(ref["densify"], 1))
    return nums


def unchanged_state(ref: dict) -> dict:
    """The readings of a job whose steps leave their state unchanged, made
    from the reference's own: every mapping row equal to the first and the
    map as it started, every tracking row equal to the first and the pose
    left at its start, no row added by densification."""
    out = {"map_log": np.repeat(ref["map_log"][:1], len(ref["map_log"]), 0),
           "map_change": {k: np.zeros_like(v)
                          for k, v in ref["map_change"].items()},
           "track": {}, "densify": 0}
    for t, (rlog, _, _, _) in ref["track"].items():
        q0, t0 = ref["init"][t]
        out["track"][t] = (np.repeat(rlog[:1], len(rlog), 0), q0, t0, None)
    return out


def verdict(nums: dict, limits: dict) -> bool:
    return all(np.isfinite(nums[k]) and nums[k] <= limits[k]
               for k in limits)
