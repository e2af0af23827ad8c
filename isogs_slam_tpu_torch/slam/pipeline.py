"""The SLAM run loop: per-frame tracking + densification + keyframe mapping
(counterpart of isogs_slam_tpu/slam/pipeline.py).

Host-side orchestration of the device steps. Per frame:

  1. load RGB-D (host) -> device
  2. constant-velocity pose init
  3. tracking (tracking.track_frame / track_frame_pyramid), on tile lists
     kept across frames until the map is edited (tracking.BinningReuse)
  4. every map_every frames: silhouette densification (pointcloud.
     add_new_gaussians), overlap keyframe selection (keyframes.py), then
     all mapping iterations (mapping.map_frame)
  5. keyframe append every keyframe_every frames
  6. checkpoint + GC on checkpoint_interval, with auto-resume from the
     latest params*.npz

The SLAM object owns its random streams: a numpy RandomState for the host
draws (keyframe selection, the per-iteration keyframe slots) and a
torch.Generator on its device for the device draws (log-scale noise of new
Gaussians, the iso pool and each iteration's iso sample), both made from
config["seed"].
"""
from __future__ import annotations

import csv
import functools
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..core import gaussians as G
from ..core.camera import Camera
from ..datasets import get_dataset, load_dataset_config
from ..io import checkpoints as ckpt_io
from ..ops import _cuda
from ..ops.rasterize import RasterConfig
from ..parallel import dist as pdist
from ..utils.transforms import rotmat_to_quat
from . import keyframes as KF
from .config import inject_defaults
from .losses import LossConfig
from .mapping import MappingConfig, PruneConfig, map_frame
from .pointcloud import add_new_gaussians, initialize_first_frame
from .tracking import (BinningReuse, TrackingConfig, initialize_camera_pose,
                       track_frame, track_frame_pyramid)

LOG_FIELDS = ["frame", "stage", "step", "loss", "image_loss", "depth_loss",
              "flat_loss", "iso_loss", "mean_density", "mask_frac"]

# The reference composites every intersection, so a silent > 0.5% drop of
# true candidates at the per-tile top-K is a deviation in what is rendered:
# the cap escalates by default. Module-level so tests assert the shipped
# default, not a local mirror of it.
ADAPTIVE_MAX_PER_TILE_DEFAULT = True


class _NoMetrics:
    """MetricsCSV of a rank other than 0 (rank 0 alone writes files)."""

    def append_block(self, *args):
        pass


class MetricsCSV:
    """Append-only metrics_log.csv with resume truncation."""

    def __init__(self, output_dir: str, checkpoint_time_idx: int = 0):
        self.path = os.path.join(output_dir, "metrics_log.csv")
        rows = []
        if os.path.exists(self.path) and checkpoint_time_idx > 0:
            try:
                with open(self.path) as f:
                    for row in csv.DictReader(f):
                        try:
                            if int(row.get("frame", -1)) < checkpoint_time_idx:
                                rows.append(row)
                        except ValueError:
                            continue
            except Exception:
                rows = []
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=LOG_FIELDS)
            w.writeheader()
            w.writerows(rows)

    def append_block(self, frame: int, stage: str, log: np.ndarray):
        """log [n_iters, 7] (loss, im, depth, flat, iso, mean_density,
        mask_frac); NaN-loss rows (iterations not run) are skipped."""
        with open(self.path, "a", newline="") as f:
            w = csv.writer(f)
            for step, row in enumerate(np.asarray(log)):
                if np.isnan(row[0]):
                    continue
                w.writerow([frame, stage, step] + [float(x) for x in row])


def _dataset_from_config(config, height, width, device):
    dc = config["data"]
    if "gradslam_data_cfg" not in dc:
        data_cfg = {"dataset_name": dc["dataset_name"]}
        if "synthetic_traj_step" in dc:
            data_cfg["synthetic_traj_step"] = dc["synthetic_traj_step"]
    else:
        data_cfg = load_dataset_config(dc["gradslam_data_cfg"])
    return get_dataset(
        config_dict=data_cfg, basedir=dc.get("basedir", ""),
        sequence=os.path.basename(str(dc.get("sequence", ""))),
        device=device,
        start=dc.get("start", 0), end=dc.get("end", -1),
        stride=dc.get("stride", 1), desired_height=height,
        desired_width=width, relative_pose=True,
        ignore_bad=dc.get("ignore_bad", False),
        use_train_split=dc.get("use_train_split", True),
        num_frames=dc.get("num_frames", -1), seed=config.get("seed", 0))


def primary_device(config) -> torch.device:
    """config["primary_device"] ("cuda" unless set): "cuda" or "cpu"; any
    other (the shipped configs' "tpu") is an error that names the CLIs'
    --device flag."""
    want = str(config.get("primary_device", "cuda"))
    if want.split(":")[0] not in ("cuda", "cpu"):
        raise ValueError(f"primary_device={want!r}: this package runs on "
                         f"'cuda' or, when asked, on 'cpu'; pass --device "
                         f"cuda (or --device cpu) to override the config")
    return resolve_device(want)


def _to_chw_frame(color, depth, device):
    """Dataset (H,W,3) 0..255 + (H,W,1) -> [3,H,W] 0..1, [1,H,W] on
    `device`."""
    im = torch.as_tensor(np.asarray(color, np.float32),
                         device=device).permute(2, 0, 1) / 255.0
    d = torch.as_tensor(np.asarray(depth, np.float32),
                        device=device).permute(2, 0, 1)
    return im.contiguous(), d.contiguous()


def _loss_cfg_tracking(config) -> LossConfig:
    t = config["tracking"]
    w = t["loss_weights"]
    return LossConfig(
        tracking=True, use_sil_for_loss=t["use_sil_for_loss"],
        sil_thres=t["sil_thres"], use_l1=t["use_l1"],
        ignore_outlier_depth_loss=t["ignore_outlier_depth_loss"],
        w_im=w["im"], w_depth=w["depth"], w_flat=0.0, w_iso=0.0,
        calc_iso=False,
        # default on: the unnormalized alpha composite under-estimates
        # depth by the silhouette factor, which biases the tracked pose
        # once the iso regularizer pulls the silhouette below 1; the
        # LossConfig default stays False (library-level reference parity)
        sil_norm_render=t.get("sil_norm_render", True))


def _loss_cfg_mapping(config) -> LossConfig:
    m = config["mapping"]
    w = m["loss_weights"]
    iso_cfg = config.get("isogs", {})
    return LossConfig(
        tracking=False, use_sil_for_loss=m["use_sil_for_loss"],
        sil_thres=m["sil_thres"], use_l1=m["use_l1"],
        ignore_outlier_depth_loss=m["ignore_outlier_depth_loss"],
        w_im=w["im"], w_depth=w["depth"],
        w_flat=w.get("flat", 50.0), w_iso=w.get("iso", 2.0),
        iso_sample_size=iso_cfg.get("sample_size", 8192),
        iso_k=iso_cfg.get("k", 16),
        iso_target=iso_cfg.get("target_saturation", 1.0),
        calc_iso=w.get("iso", 2.0) != 0.0,
        knn_block=iso_cfg.get("knn_block", 8192),
        iso_pool_size=iso_cfg.get("knn_pool_size", 32768))


def _mapping_cfg(config) -> MappingConfig:
    m = config["mapping"]
    lrs = m["lrs"]
    pd = m.get("pruning_dict", {})
    prune = PruneConfig(
        enabled=m.get("prune_gaussians", False),
        start_after=pd.get("start_after", 0),
        remove_big_after=pd.get("remove_big_after", 0),
        stop_after=pd.get("stop_after", 20),
        prune_every=pd.get("prune_every", 20),
        removal_opacity_threshold=pd.get("removal_opacity_threshold", 0.005),
        final_removal_opacity_threshold=pd.get(
            "final_removal_opacity_threshold", 0.005),
        reset_opacities=pd.get("reset_opacities", False),
        reset_opacities_every=pd.get("reset_opacities_every", 500))
    use_dens = m.get("use_gaussian_splatting_densification", False)
    dens = None
    if use_dens:
        from .densify import DensifyConfig
        dd = m.get("densify_dict", {})
        dens = DensifyConfig(
            start_after=dd.get("start_after", 500),
            remove_big_after=dd.get("remove_big_after", 3000),
            stop_after=dd.get("stop_after", 5000),
            densify_every=dd.get("densify_every", 100),
            grad_thresh=dd.get("grad_thresh", 0.0002),
            num_to_split_into=dd.get("num_to_split_into", 2),
            removal_opacity_threshold=dd.get(
                "removal_opacity_threshold", 0.005),
            final_removal_opacity_threshold=dd.get(
                "final_removal_opacity_threshold", 0.005),
            reset_opacities_every=dd.get("reset_opacities_every", 3000),
            # off unless the densify_dict asks (the DensifyConfig default
            # is on, as the offline trainer wants it)
            reset_opacities=dd.get("reset_opacities", False))
    return MappingConfig(
        num_iters=m["num_iters"], lr_means3d=lrs["means3D"],
        lr_rgb_colors=lrs["rgb_colors"],
        lr_unnorm_rotations=lrs["unnorm_rotations"],
        lr_logit_opacities=lrs["logit_opacities"],
        lr_log_scales=lrs["log_scales"], prune=prune,
        use_densification=use_dens, densify=dens,
        tile_subsample=int(m.get("tile_subsample", 1)),
        tile_cycle=bool(m.get("tile_cycle", True)),
        lazy_adam=bool(m.get("lazy_adam", False)),
        force_subset=bool(m.get("force_subset", False)),
        vmap_bins=bool(m.get("vmap_bins", False)),
        exact_polish_iters=int(m.get("exact_polish_iters", 0)),
        # 0 (default) = margin-free phase binnings: the mapping loss
        # composites exactly what eval and tracking render
        bin_margin_px=float(m.get("bin_margin_px", 0.0)))


def _tracking_cfg(config) -> TrackingConfig:
    t = config["tracking"]
    return TrackingConfig(
        num_iters=t["num_iters"], lr_quat=t["lrs"]["cam_unnorm_rots"],
        lr_trans=t["lrs"]["cam_trans"],
        use_depth_loss_thres=t.get("use_depth_loss_thres", False),
        depth_loss_thres=t.get("depth_loss_thres", 100000),
        lr_decay=t.get("lr_decay", 1.0),
        gn_iters=t.get("gn_iters", 0),
        gn_damping=t.get("gn_damping", 1e-3),
        gn_phot_tol=t.get("gn_phot_tol", 0.05),
        tile_subsample=int(t.get("tile_subsample", 1)),
        pyramid_levels=t.get("pyramid_levels", 1),
        pyramid_iters=t.get("pyramid_iters", 0),
        pyramid_lr_scale=t.get("pyramid_lr_scale", 1.0),
        fan_rounds=int(t.get("fan_rounds", 0)),
        fan_trans_eps=t.get("fan_trans_eps", 0.0),
        fan_quat_eps=t.get("fan_quat_eps", 0.0),
        polyak_rho=float(t.get("polyak_rho", 0.0)),
        early_stop_patience=int(t.get("early_stop_patience", 0)),
        bin_margin_px=t.get("bin_margin_px", 8.0),
        rebin_every_iter=t.get("rebin_every_iter", False),
        reuse_binning=t.get("reuse_binning", True),
        cross_frame_margin_px=t.get("cross_frame_margin_px", 16.0))


class SLAM:
    """Stateful SLAM runner (construct once, call run()).

    The device is config["primary_device"]: "cuda" (the default) or "cpu".
    `dataset` (optional) injects a pre-built frame source instead of
    constructing one from the config. A stream cannot be re-decoded at
    other resolutions, so separate tracking/densification resolutions are
    rejected loudly and the main stream is used for all phases.
    """

    def __init__(self, config: dict, dataset=None):
        self.config = inject_defaults(config)
        cfg = self.config
        self.device = primary_device(cfg)
        if pdist.world_size() > 1:
            self.device = pdist.rank_device(self.device)
        # rank 0 alone writes files and progress lines
        self.is_main = pdist.is_main()
        from .experimental import warn_experimental
        warn_experimental(cfg)

        r = cfg["raster"]
        self.rcfg = RasterConfig(max_per_tile=r["max_per_tile"],
                                 isect_per_gaussian=r["isect_per_gaussian"],
                                 tile_chunk=r["tile_chunk"],
                                 tile_cull=r.get("tile_cull", False),
                                 cull_q_slack=r.get("cull_q_slack", 1.5),
                                 tight_rect=r.get("tight_rect", False))
        # tracking composites against a mature map whose transmittance
        # saturates after ~10-20 Gaussians; a smaller per-tile cap halves
        # the gather/backward traffic with no pose-accuracy effect
        self.rcfg_track = self.rcfg._replace(
            max_per_tile=r.get("max_per_tile_tracking",
                               min(256, r["max_per_tile"])))
        # demand-driven intersection capacity (RasterConfig.max_isect_cap):
        # seeded from the first frame's row count, grown geometrically from
        # the observed per-binning n_isect
        self._adaptive_isect = bool(r.get("adaptive_isect_cap", True))
        self.lcfg_track = _loss_cfg_tracking(cfg)
        self.lcfg_map = _loss_cfg_mapping(cfg)
        self.tcfg = _tracking_cfg(cfg)
        self.mcfg = _mapping_cfg(cfg)

        self.output_dir = os.path.join(cfg["workdir"], cfg["run_name"])
        self.eval_dir = os.path.join(self.output_dir, "eval")
        os.makedirs(self.eval_dir, exist_ok=True)

        dc = cfg["data"]
        self._injected_dataset = dataset is not None
        if self._injected_dataset:
            self.dataset = dataset
        else:
            self.dataset = _dataset_from_config(
                cfg, dc["desired_image_height"], dc["desired_image_width"],
                self.device)
        self.num_frames = dc.get("num_frames", -1)
        if self.num_frames == -1:
            self.num_frames = len(self.dataset)

        # separate-resolution tracking / densification datasets
        want_track_res = (
            dc["tracking_image_height"] != dc["desired_image_height"]
            or dc["tracking_image_width"] != dc["desired_image_width"])
        want_dens_res = (
            dc["densification_image_height"] != dc["desired_image_height"]
            or dc["densification_image_width"]
            != dc["desired_image_width"])
        if self._injected_dataset and (want_track_res or want_dens_res):
            print("[pipeline] WARNING: separate tracking/densification "
                  "resolutions are not available for an injected stream "
                  "dataset; using the stream resolution for all phases.")
            want_track_res = want_dens_res = False
        self.tracking_dataset = None
        if want_track_res:
            self.tracking_dataset = _dataset_from_config(
                cfg, dc["tracking_image_height"], dc["tracking_image_width"],
                self.device)
        self.densify_dataset = None
        if want_dens_res:
            self.densify_dataset = _dataset_from_config(
                cfg, dc["densification_image_height"],
                dc["densification_image_width"], self.device)

        # cameras
        color0, _, intrinsics0, pose0 = self.dataset[0]
        H, W = color0.shape[0], color0.shape[1]
        self.intrinsics = np.asarray(intrinsics0)[:3, :3]
        self.cam = Camera.from_intrinsics(self.intrinsics, W, H)
        self.first_frame_w2c = np.linalg.inv(np.asarray(pose0, np.float64))
        if self.tracking_dataset is not None:
            tc, _, ti, _ = self.tracking_dataset[0]
            self.tracking_cam = Camera.from_intrinsics(
                np.asarray(ti)[:3, :3], tc.shape[1], tc.shape[0])
        else:
            self.tracking_cam = self.cam
        if self.densify_dataset is not None:
            dcol, _, di, _ = self.densify_dataset[0]
            self.densify_cam = Camera.from_intrinsics(
                np.asarray(di)[:3, :3], dcol.shape[1], dcol.shape[0])
            self.densify_intrinsics = np.asarray(di)[:3, :3]
        else:
            self.densify_cam = self.cam
            self.densify_intrinsics = self.intrinsics

        # host-side camera trajectory [4,T], [3,T] (cam_unnorm_rots/trans)
        T = self.num_frames
        self.cam_rots = np.tile(np.array([1, 0, 0, 0], np.float32)[:, None],
                                (1, T))
        self.cam_trans = np.zeros((3, T), np.float32)

        self.granule = cfg["capacity_granule"]
        self.state: G.MapState | None = None
        max_kf = T // max(cfg["keyframe_every"], 1) + 3
        self.kf = KF.KeyframeLibrary(max_kf, H, W, self.device)
        self.gt_w2c_all: list[np.ndarray] = []
        self.keyframe_time_indices: list[int] = []
        seed = int(cfg.get("seed", 0))
        self.rng = np.random.RandomState(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        from ..utils.logging_utils import RunLogger
        self.logger = RunLogger(cfg)
        self.stats = {"tracking_iter_time": [], "tracking_frame_time": [],
                      "mapping_iter_time": [], "mapping_frame_time": [],
                      "gn_accepted": []}
        # what the run's adaptive sizing did: [(frame, old, new)] each
        self.events = {"max_per_tile": [], "isect_cap": [], "capacity": [],
                       "compactions": []}
        self._frame = 0
        # cross-phase iso-KNN pool (_phase_iso_pool) and its age in phases
        self._iso_pool = None
        self._iso_pool_age = 0
        self.online_eval = None
        self._compact_every = cfg.get("compact_every", 50)
        # multi-device mapping over the ranks of the process group
        # (config["parallel"]["map_views"]): B keyframe views per Adam step,
        # one per rank (parallel/sharded.py). The device count is the world
        # size; at world size 1 the B = 1 view phase still runs, as the
        # reference builds a 1-device mesh
        par = cfg.get("parallel", {})
        world = pdist.world_size()
        self._map_views = int(par.get("map_views", 0))
        self._mv_mesh = self._mv_phase = None
        if self._map_views > 1:
            if self._map_views > world:
                print(f"[parallel] map_views {self._map_views} > "
                      f"{world} devices; clamping")
                self._map_views = world
            self._mv_mesh = pdist.make_mesh(self._map_views, self.device)
            self._build_mv_phase()
        # multi-device tracking over the ranks
        # (config["parallel"]["track_tiles"]): the whole per-frame Adam
        # pose loop runs with the compositing tiles sharded
        # (parallel/track_sharded.py); programs are cached per (camera,
        # rcfg, lcfg, tcfg) so pyramid levels and isect-cap growth get
        # their own
        self._track_tiles = int(par.get("track_tiles", 0))
        self._tt_mesh = None
        self._tt_cache = {}
        if self._track_tiles > 1:
            if self._track_tiles > world:
                print(f"[parallel] track_tiles {self._track_tiles} > "
                      f"{world} devices; clamping")
                self._track_tiles = world
            self._tt_mesh = pdist.make_mesh(self._track_tiles, self.device)
        # the whole world, for the collectives of the serial paths at
        # world size > 1 (rank 0's results broadcast) and the replicas'
        # check
        self._world_mesh = (pdist.make_mesh(None, self.device)
                            if world > 1 else None)
        # cross-frame tracking tile-list cache; invalidated on every map
        # edit (densify / mapping / compaction / growth). The tile-sharded
        # tracker bins at the initial pose itself every frame, so the
        # cache is a serial-path feature
        self._track_bins = (BinningReuse(
            self.tracking_cam, self.rcfg_track,
            margin_px=self.tcfg.cross_frame_margin_px,
            slack_px=self.tcfg.bin_margin_px)
            if self.tcfg.reuse_binning and not self.tcfg.rebin_every_iter
            and self._tt_mesh is None
            else None)

    # ------------------------------------------------------------- helpers
    def _sync(self):
        """Wait for the device before the host clock is read."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_chw_frame(self, color, depth):
        return _to_chw_frame(color, depth, self.device)

    def _build_mv_phase(self):
        """(Re)build the view-parallel mapping phase on the current raster
        config (at start, isect-cap growth and the K escalation)."""
        if self._mv_mesh is not None:
            from ..parallel.sharded import make_multiview_map_phase
            self._mv_phase = make_multiview_map_phase(
                self._mv_mesh, self.cam, self.rcfg, self.lcfg_map,
                self.mcfg)

    def _broadcast_state(self):
        """Rank 0's map state on every rank: after a serial mapping phase at
        world size > 1 (its iso loss scatters with atomics, and the stripe
        routes below the crossover add rows with index_add_, so two ranks
        need not round alike)."""
        if self._world_mesh is None:
            return
        st = self.state
        for t in (*st.params, st.alive, st.timestep, st.max_2d_radius,
                  st.means2d_grad_accum, st.denom, st.hwm, st.scene_radius):
            if torch.is_tensor(t):
                pdist.broadcast_(t, self._world_mesh)

    def replica_max_diff(self) -> float:
        """max over ranks of |x - rank 0's x| over the map state, the last
        mapping phase's Adam moments, the poses and the keyframe buffer's
        poses: 0.0 when the replicas are equal bit for bit (0.0 at world
        size 1)."""
        if self._world_mesh is None:
            return 0.0
        st = self.state
        ts = [*st.params, st.alive, st.max_2d_radius, st.hwm,
              torch.as_tensor(self.cam_rots), torch.as_tensor(self.cam_trans),
              self.kf.quats, self.kf.trans]
        opt = getattr(self._mv_phase, "last_opt", None)
        if opt is not None:
            ts += [*opt.mu, *opt.nu]
        return pdist.replica_max_diff(ts, self._world_mesh)

    def _pose(self, time_idx):
        q = self.cam_rots[:, time_idx]
        q = q / np.linalg.norm(q)
        return (torch.as_tensor(q, dtype=torch.float32, device=self.device),
                torch.as_tensor(self.cam_trans[:, time_idx],
                                dtype=torch.float32, device=self.device))

    def _est_w2c(self, time_idx) -> np.ndarray:
        from ..eval.eval_helpers import est_w2c
        return est_w2c(self, time_idx)

    def _map_changed(self):
        """Invalidate caches keyed on map rows (tracking tile lists)."""
        if self._track_bins is not None:
            self._track_bins.invalidate()

    def _invalidate_iso_pool(self):
        """Row indices changed (compaction / growth): a kept cross-phase
        iso pool would point at other Gaussians."""
        self._iso_pool = None
        self._iso_pool_age = 0

    def _phase_iso_pool(self):
        """The iso-KNN pool kept across mapping.iso_pool_refresh_phases
        phases (1, the default: map_frame builds one every phase, and this
        returns None). Rows are alive-masked when the loss reads them, so
        a kept pool only leaves newly added rows out of the sample until
        the next rebuild."""
        refresh = int(self.config["mapping"].get("iso_pool_refresh_phases",
                                                 1))
        lcfg = self.lcfg_map
        if refresh <= 1 or not (lcfg.calc_iso and lcfg.iso_pool_size > 0):
            return None
        if self._iso_pool is None or self._iso_pool_age >= refresh:
            from .mapping import build_phase_iso_pool
            self._iso_pool = build_phase_iso_pool(
                self.state.params, self.state.alive, lcfg,
                generator=self.gen)
            self._iso_pool_age = 0
        self._iso_pool_age += 1
        return self._iso_pool

    def _compact(self):
        self._map_changed()
        self._invalidate_iso_pool()
        self.state = G.compact(self.state)
        self.events["compactions"].append(self._frame)

    def _ensure_capacity(self, needed_extra: int):
        used = int(self.state.hwm)
        cap = self.state.capacity
        if used + needed_extra > cap:
            # compaction re-packs pruned rows and lowers hwm; prefer it
            # when it frees enough
            n_alive = int(self.state.num_alive())
            if n_alive < used and n_alive + needed_extra <= cap:
                self._compact()
                return
            # otherwise grow geometrically
            new_cap = G.round_capacity(max(used + needed_extra,
                                           2 * cap), self.granule)
            print(f"[capacity] {cap} -> {new_cap} (hwm {used})")
            self._map_changed()
            self._invalidate_iso_pool()
            self.state = G.grow_capacity(self.state, new_cap)
            self.events["capacity"].append((self._frame, cap, new_cap))

    def _set_isect_cap(self, rows: int):
        """Round `rows` up to a coarse granule and re-point both raster
        configs at it; tile lists made under the old cap are dropped."""
        g = 1 << 18
        cap = max(g, (rows + g - 1) // g * g)
        if cap == self.rcfg.max_isect_cap:
            return
        old = self.rcfg.max_isect_cap
        if old:
            print(f"[isect-cap] {old} -> {cap}")
        self.events["isect_cap"].append((self._frame, old, cap))
        self.rcfg = self.rcfg._replace(max_isect_cap=cap)
        self.rcfg_track = self.rcfg_track._replace(max_isect_cap=cap)
        if self._track_bins is not None:
            self._track_bins.rcfg = self.rcfg_track  # captured at construction
            self._track_bins.invalidate()
        self._build_mv_phase()

    def _note_isect_demand(self, observed_peak: int):
        """Grow the isect cap when a binning's true demand (n_isect is
        counted before the clamp) approaches capacity. 0.75 trigger + 1.5x
        growth keeps >= 33% headroom for frame-to-frame demand drift."""
        if not self._adaptive_isect:
            return
        cap = self.rcfg.max_isect_cap
        if cap and observed_peak > cap:
            print(f"[isect-cap] WARNING: demand {observed_peak} exceeded "
                  f"capacity {cap}: intersections were truncated this "
                  f"phase (capacity grows now)")
        if cap and observed_peak > 0.75 * cap:
            self._set_isect_cap(max(int(observed_peak * 1.5),
                                    cap + (1 << 18)))

    def _init_isect_cap(self):
        if self._adaptive_isect and self.rcfg.max_isect_cap == 0:
            self._set_isect_cap(
                int(int(self.state.hwm) * self.rcfg.isect_per_gaussian))

    # --------------------------------------------------------------- init
    def initialize_first_frame(self, color, depth):
        self.initialize_first_frame_from(*self._to_chw_frame(color, depth))
        self._init_isect_cap()

    def initialize_first_frame_from(self, im, d):
        n_px = int(self.densify_cam.width * self.densify_cam.height)
        capacity = G.round_capacity(int(n_px * 1.5), self.granule)
        self.state = initialize_first_frame(
            im, d, self.densify_cam, capacity,
            self.config["scene_radius_depth_ratio"],
            gaussian_distribution=self.config["gaussian_distribution"],
            generator=self.gen, device=self.device)

    # ------------------------------------------------------------ resume
    def try_resume(self) -> int:
        cfg = self.config
        if getattr(self, "_resumed_at", None) is not None:
            return self._resumed_at   # idempotent: run() calls this too
        self._resumed_at = 0
        if not cfg.get("load_checkpoint", False):
            return 0
        want = cfg.get("checkpoint_time_idx", 0)
        if want < 0:
            frame, path = ckpt_io.latest_checkpoint(self.output_dir)
            if frame is None:
                return 0
        else:
            frame = want
            path = os.path.join(self.output_dir, f"params{frame}.npz")
            if not os.path.exists(path):
                return 0
        print(f"[Checkpoint] Resuming from frame {frame}")
        data = ckpt_io.load_checkpoint(path)
        n = data["means3D"].shape[0]
        capacity = G.round_capacity(int(n * 1.25), self.granule)
        dev = self.device

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        st = G.empty_state(capacity, dev)
        rows = G.GaussianParams(
            means3d=f32(data["means3D"]), rgb_colors=f32(data["rgb_colors"]),
            unnorm_rotations=f32(data["unnorm_rotations"]),
            logit_opacities=f32(data["logit_opacities"]),
            log_scales=f32(data["log_scales"]))
        st = G.append_rows(st, rows,
                           torch.ones(n, dtype=torch.bool, device=dev), 0)
        if "timestep" in data:
            ts = torch.zeros(capacity, device=dev)
            ts[:n] = f32(data["timestep"])[:n]
            st = st._replace(timestep=ts)
        self.cam_rots = np.asarray(data["cam_unnorm_rots"])[0]
        self.cam_trans = np.asarray(data["cam_trans"])[0]
        # scene radius from first frame depth
        _, depth0, _, _ = self.dataset[0]
        self.state = st._replace(scene_radius=torch.tensor(
            float(np.max(depth0)) / self.config["scene_radius_depth_ratio"],
            dtype=torch.float32, device=dev))
        kf_path = os.path.join(self.output_dir,
                               f"keyframe_time_indices{frame}.npy")
        kf_times = (np.load(kf_path).tolist() if os.path.exists(kf_path)
                    else [])
        # replay gt poses + keyframes
        for t in range(frame):
            color, depth, _, pose = self.dataset[t]
            self.gt_w2c_all.append(np.linalg.inv(np.asarray(pose,
                                                            np.float64)))
            if t in kf_times:
                im, d = self._to_chw_frame(color, depth)
                q, tr = self._pose(t)
                self.kf.add_keyframe(t, im, d, q, tr, self._est_w2c(t))
                self.keyframe_time_indices.append(t)
        self._resumed_at = frame
        self._init_isect_cap()
        return frame

    # ----------------------------------------------------------- tracking
    def track(self, time_idx, im, depth):
        cfg = self.config
        if time_idx > 0:
            q0, t0 = initialize_camera_pose(
                torch.as_tensor(self.cam_rots), torch.as_tensor(self.cam_trans),
                time_idx, cfg["tracking"]["forward_prop"])
            self.cam_rots[:, time_idx] = q0.numpy()
            self.cam_trans[:, time_idx] = t0.numpy()
        if time_idx == 0:
            return None
        if cfg["tracking"]["use_gt_poses"]:
            gt_w2c = self.gt_w2c_all[-1]
            self.cam_rots[:, time_idx] = rotmat_to_quat(torch.as_tensor(
                gt_w2c[:3, :3], dtype=torch.float32)).numpy()
            self.cam_trans[:, time_idx] = gt_w2c[:3, 3]
            return None
        q0 = torch.as_tensor(self.cam_rots[:, time_idx], device=self.device)
        t0 = torch.as_tensor(self.cam_trans[:, time_idx], device=self.device)
        binning = (self._track_bins.get(self.state.params, self.state.alive,
                                        q0, t0)
                   if self._track_bins is not None else None)
        if self._tt_mesh is not None:
            base_fn = self._sharded_tracker
            tracker = (functools.partial(track_frame_pyramid,
                                         track_fn=base_fn)
                       if self.tcfg.pyramid_levels > 1 else base_fn)
        else:
            tracker = (track_frame_pyramid if self.tcfg.pyramid_levels > 1
                       else track_frame)
        res = tracker(self.state.params, self.state.alive, q0, t0,
                      im, depth, self.tracking_cam, self.rcfg_track,
                      self.lcfg_track, self.tcfg, binning=binning)
        if self._tt_mesh is None and self._world_mesh is not None:
            # every rank tracked alone: rank 0's pose on every rank (the
            # tile-sharded tracker's is the same everywhere by construction)
            pose = torch.cat([res.quat, res.trans]).contiguous()
            pdist.broadcast_(pose, self._world_mesh)
            res = res._replace(quat=pose[:4], trans=pose[4:])
        self.cam_rots[:, time_idx] = res.quat.cpu().numpy()
        self.cam_trans[:, time_idx] = res.trans.cpu().numpy()
        if binning is not None:
            # grow AFTER the frame so the just-used binning and the rcfg
            # it was built with stay consistent
            self._note_isect_demand(int(binning.n_isect))
        if self.tcfg.gn_iters > 0 and res.gn_accepted is not None:
            self.stats["gn_accepted"].append(int(res.gn_accepted))
        return res

    def _sharded_tracker(self, params, alive, q0, t0, im, depth, cam,
                         rcfg, lcfg, tcfg, binning=None):
        """track_frame-signature dispatcher to the tile-sharded tracking
        program (parallel/track_sharded.py), built lazily per (camera,
        rcfg, lcfg, tcfg): pyramid levels and adaptive isect-cap growth
        each get their own cached program. The cross-frame binning cache is
        a serial-path feature (the sharded program bins itself)."""
        assert binning is None, \
            "parallel.track_tiles is incompatible with reuse_binning"
        key = (cam, rcfg, lcfg, tcfg)
        fn = self._tt_cache.get(key)
        if fn is None:
            from ..parallel.track_sharded import make_tracking_frame_sharded
            fn = make_tracking_frame_sharded(self._tt_mesh, cam, rcfg, lcfg,
                                             tcfg)
            self._tt_cache[key] = fn
        return fn(params, alive, q0, t0, im, depth)

    # ------------------------------------------------------ densification
    def densify(self, time_idx, im, depth):
        self._ensure_capacity(
            int(self.densify_cam.width * self.densify_cam.height))
        q, t = self._pose(time_idx)
        self._map_changed()
        self.state = add_new_gaussians(
            self.state, im, depth, q, t, float(time_idx),
            self.densify_cam, self.rcfg,
            sil_thres=self.config["mapping"]["sil_thres"],
            gaussian_distribution=self.config["gaussian_distribution"],
            generator=self.gen)

    # ----------------------------------------------------------- mapping
    def map(self, time_idx, im, depth):
        cfg = self.config
        num_iters = cfg["mapping"]["num_iters"]
        if num_iters <= 0:
            return None
        # keyframe selection
        k = cfg["mapping_window_size"] - 2
        depth_np = depth[0].cpu().numpy()
        selected = KF.keyframe_selection_overlap(
            depth_np, self._est_w2c(time_idx), self.intrinsics,
            self.kf.w2cs[:-1] if len(self.kf) else [], k, self.rng,
            self.cam.width, self.cam.height)
        slots = [int(s) for s in selected]
        if len(self.kf) > 0:
            slots.append(len(self.kf) - 1)      # always the last keyframe
        slots.append(self.kf.current_slot)      # the current frame
        q, t = self._pose(time_idx)
        self.kf.set_current(im, depth, q, t)

        sel_ids = [self.kf.time_indices[s] if s != self.kf.current_slot
                   else time_idx for s in slots]
        print(f"\nSelected Keyframes at Frame {time_idx}: {sel_ids}")
        self.last_selected = sel_ids

        if self._mv_phase is not None:
            return self._map_multiview(slots, num_iters)

        # the keyframe of each iteration; map_frame bins each distinct
        # sampled slot once and indexes the library directly
        rand = self.rng.randint(0, len(slots), size=num_iters)
        iter_slots = [slots[int(r)] for r in rand]
        self._map_changed()
        self.state, log, bin_stats = map_frame(
            self.state, self.kf.colors, self.kf.depths, self.kf.quats,
            self.kf.trans, iter_slots, self.cam, self.rcfg, self.lcfg_map,
            self.mcfg, generator=self.gen, iso_pool=self._phase_iso_pool())
        self._broadcast_state()
        self._check_tile_cap(bin_stats)
        if bin_stats.shape[0] > 3:
            n_clone, n_split, dropped = (int(x) for x in bin_stats[3:6])
            self.stats.setdefault("densify_counts", []).append(
                (time_idx, n_clone, n_split, dropped))
            if n_clone or n_split or dropped:
                print(f"[densify] frame {time_idx}: {n_clone} cloned, "
                      f"{n_split} split, {dropped} rows dropped at capacity "
                      f"{self.state.capacity}")
        return log

    def _map_multiview(self, slots: list, num_iters: int):
        """Multi-device mapping phase: B keyframe views per Adam step, one
        per rank (parallel/sharded.py). num_iters counts view renders, so
        one phase does ceil(num_iters / B) steps. The steps' keyframes are
        drawn from the pipeline's numpy RNG (the same on every rank), the
        phase's device draws from a seed drawn from its torch generator
        (the same on every rank)."""
        B = self._map_views
        n_steps = -(-num_iters // B)
        step_slots = np.empty((n_steps, B), np.int64)
        for s in range(n_steps):
            if len(slots) >= B:
                pick = self.rng.permutation(len(slots))[:B]
            else:
                pick = self.rng.randint(0, len(slots), size=B)
            step_slots[s] = [slots[int(i)] for i in pick]
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self.gen,
                                 device=self.device))
        self._map_changed()
        self.state, log, bin_stats = self._mv_phase(
            self.state, self.kf.colors, self.kf.depths, self.kf.quats,
            self.kf.trans, step_slots, seed)
        self._check_tile_cap(bin_stats)
        return log

    def _check_tile_cap(self, bin_stats):
        """The reference composites every intersection; the per-tile top-K
        keeps the front-most max_per_tile. Margin-only candidates rank
        last (dropping them is by design) but dropped true candidates are
        a real deviation: warn, and by default escalate the cap
        (config raster.adaptive_max_per_tile)."""
        stats = np.asarray(torch.as_tensor(bin_stats).cpu())
        dropped, total = int(stats[0]), int(stats[1])
        if stats.shape[0] > 2:
            self._note_isect_demand(int(stats[2]))
        frac = dropped / max(total, 1)
        self.stats.setdefault("tile_cap_dropped_frac", []).append(frac)
        if frac <= 0.005:
            return
        K = self.rcfg.max_per_tile
        if (self.config["raster"].get("adaptive_max_per_tile",
                                      ADAPTIVE_MAX_PER_TILE_DEFAULT)
                and K < 1024):
            new_k = min(1024, K + 256)
            print(f"[raster] {frac:.1%} true candidates dropped at "
                  f"max_per_tile={K}; escalating to {new_k}")
            self.rcfg = self.rcfg._replace(max_per_tile=new_k)
            self.events["max_per_tile"].append((self._frame, K, new_k))
            self._build_mv_phase()
        elif not getattr(self, "_warned_tile_cap", False):
            self._warned_tile_cap = True
            print(f"[raster] WARNING: {frac:.1%} of true-footprint "
                  f"intersections exceed max_per_tile={K} and are not "
                  f"composited (the reference composites all). Raise "
                  f"raster.max_per_tile or set "
                  f"raster.adaptive_max_per_tile=True if eval metrics "
                  f"lag the reference.")

    # ------------------------------------------------------------- run
    def run(self, end_at: int | None = None) -> dict:
        trace_dir = self.config.get("profile_trace_dir")
        if not trace_dir:
            return self._run(end_at)
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            out = self._run(end_at)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"[profile] trace written to {path}")
        return out

    def _run(self, end_at: int | None = None) -> dict:
        cfg = self.config
        start_frame = self.try_resume()
        metrics = (MetricsCSV(self.output_dir, start_frame) if self.is_main
                   else _NoMetrics())
        end_frame = self.num_frames - 1
        if end_at is not None:
            end_frame = min(int(end_at), end_frame)
        if start_frame > end_frame:
            print(f"[End-At] Nothing to do (start {start_frame} > end "
                  f"{end_frame}).")
            return {}

        # overlap frame loading with device work
        # (data.prefetch_depth frames of lookahead; 0 disables)
        depth_pf = cfg["data"].get("prefetch_depth", 4)
        prefetchers = []
        if depth_pf > 0:
            from ..datasets.prefetch import Prefetcher
            main_ds = Prefetcher(self.dataset, depth_pf)
            prefetchers.append(main_ds)
            track_ds = (Prefetcher(self.tracking_dataset, depth_pf)
                        if self.tracking_dataset is not None else None)
            dens_ds = (Prefetcher(self.densify_dataset, depth_pf)
                       if self.densify_dataset is not None else None)
            prefetchers += [p for p in (track_ds, dens_ds) if p is not None]
        else:
            main_ds = self.dataset
            track_ds = self.tracking_dataset
            dens_ds = self.densify_dataset
        try:
            return self._frame_loop(cfg, metrics, start_frame, end_frame,
                                    main_ds, track_ds, dens_ds)
        finally:
            for p in prefetchers:
                p.close()

    def _frame_loop(self, cfg, metrics, start_frame, end_frame,
                    main_ds, track_ds, dens_ds) -> dict:
        for time_idx in range(start_frame, end_frame + 1):
            self._frame = time_idx
            color, depth, _, gt_pose = main_ds[time_idx]
            gt_w2c = np.linalg.inv(np.asarray(gt_pose, np.float64))
            self.gt_w2c_all.append(gt_w2c)
            im, d = self._to_chw_frame(color, depth)

            if time_idx == 0 and self.state is None:
                if dens_ds is not None:
                    dcol, ddep, _, _ = dens_ds[0]
                    self.initialize_first_frame_from(
                        *self._to_chw_frame(dcol, ddep))
                else:
                    self.initialize_first_frame(color, depth)

            # tracking
            if track_ds is not None and time_idx > 0:
                tcol, tdep, _, _ = track_ds[time_idx]
                tim, td = self._to_chw_frame(tcol, tdep)
            else:
                tim, td = im, d
            self._sync()
            t0 = time.time()
            res = self.track(time_idx, tim, td)
            self._sync()
            t1 = time.time()
            if res is not None:
                iters = int(res.iters_run)
                log = res.loss_log.cpu().numpy()
                metrics.append_block(time_idx, "tracking", log)
                self.logger.log_block(time_idx, "tracking", log)
                mask_frac = log[max(iters - 1, 0), 6]
                if mask_frac < 0.01:
                    print(f"[tracking] WARNING frame {time_idx}: loss mask "
                          f"covers {mask_frac:.2%} of pixels: silhouette "
                          f"never exceeds sil_thres="
                          f"{self.lcfg_track.sil_thres}; pose is frozen at "
                          f"its initialization. Lower tracking.sil_thres "
                          f"or reduce the iso weight.")
                self.stats["tracking_iter_time"].append(
                    (t1 - t0) / max(iters, 1))
                self.stats.setdefault("tracking_iters_run", []).append(iters)
                self.stats.setdefault("tracking_mask_frac", []).append(
                    float(mask_frac))
            self.stats["tracking_frame_time"].append(t1 - t0)

            # densification + mapping
            if time_idx == 0 or (time_idx + 1) % cfg["map_every"] == 0:
                if cfg["mapping"]["add_new_gaussians"] and time_idx > 0:
                    if dens_ds is not None:
                        dcol, ddep, _, _ = dens_ds[time_idx]
                        dim, dd = self._to_chw_frame(dcol, ddep)
                    else:
                        dim, dd = im, d
                    self.densify(time_idx, dim, dd)
                self._sync()
                t2 = time.time()
                mlog = self.map(time_idx, im, d)
                self._sync()
                t3 = time.time()
                if mlog is not None:
                    mlog = mlog.cpu().numpy()
                    metrics.append_block(time_idx, "mapping", mlog)
                    self.logger.log_block(time_idx, "mapping", mlog)
                    self.stats["mapping_iter_time"].append(
                        (t3 - t2) / max(cfg["mapping"]["num_iters"], 1))
                self.stats["mapping_frame_time"].append(t3 - t2)
                # periodic compaction of pruned rows
                if (time_idx + 1) % self._compact_every == 0:
                    self._compact()

            # keyframe append
            if (((time_idx == 0)
                 or ((time_idx + 1) % cfg["keyframe_every"] == 0)
                 or (time_idx == self.num_frames - 2))
                    and (not np.isinf(gt_w2c).any())
                    and (not np.isnan(gt_w2c).any())
                    and len(self.kf) < self.kf.max_keyframes):
                q, t = self._pose(time_idx)
                self.kf.add_keyframe(time_idx, im, d, q, t,
                                     self._est_w2c(time_idx))
                self.keyframe_time_indices.append(time_idx)

            # global progress report; a failure triggers an emergency
            # checkpoint
            if self.is_main and (
                    (time_idx + 1) % cfg["report_global_progress_every"] == 0
                    or time_idx == end_frame):
                try:
                    self.report_progress(time_idx, im, d)
                except Exception as e:
                    print(f"[progress] report failed ({e}); saving "
                          f"emergency checkpoint")
                    try:
                        self.save_checkpoint(time_idx)
                    except Exception:
                        pass

            # checkpoint
            if (cfg["save_checkpoints"]
                    and time_idx % cfg["checkpoint_interval"] == 0):
                self.save_checkpoint(time_idx)

        if self._world_mesh is not None:
            d = self.replica_max_diff()
            self.stats["replica_max_abs_diff"] = d
            if self.is_main:
                print(f"[parallel] replicas: max |x - rank 0's x| over the "
                      f"map, the Adam moments, the poses and the keyframe "
                      f"poses of {self._world_mesh.world} ranks = {d!r}")
        if self.online_eval is not None:
            try:
                self.online_eval.finalize()
            except Exception as e:
                print(f"[online eval] finalize failed: {e}")
        self.write_runtime_stats(end_frame)
        if (cfg["save_checkpoints"]
                and end_frame % cfg["checkpoint_interval"] != 0):
            self.save_checkpoint(end_frame)
        return self.stats

    def report_progress(self, time_idx: int, im, d):
        """Online evaluation of the current frame at its estimated pose:
        PSNR / MS-SSIM / depth RMSE+L1 / pose errors / running ATE, with
        txt + qualitative-figure artifacts under <run>/eval_online/."""
        if self.online_eval is None:
            from ..eval.online import OnlineEvaluator
            self.online_eval = OnlineEvaluator(
                self.output_dir, self.config["mapping"]["sil_thres"],
                logger=self.logger,
                save_qual=self.config.get("eval_online_save_qual", True))
        m = self.online_eval.eval_frame(self, time_idx, im, d)
        n_alive = int(self.state.num_alive())
        print(f"[progress] frame {time_idx}: PSNR {m['online/psnr']:.2f} "
              f"dB, MS-SSIM {m['online/ms_ssim']:.3f}, depth L1 "
              f"{m['online/depth_l1']*100:.2f} cm, ATE "
              f"{m['online/ate_rmse']*100:.2f} cm, {n_alive} Gaussians")
        self.logger.log({"progress/num_gaussians": n_alive})

    # --------------------------------------------------------- checkpoint
    def gauss_params_numpy(self):
        """Alive rows as the reference's params dict (compacted), and their
        creation timesteps."""
        st = G.compact(self.state)
        n = int(st.hwm)
        p = st.params

        def host(a):
            return a[:n].cpu().numpy()

        return {
            "means3D": host(p.means3d),
            "rgb_colors": host(p.rgb_colors),
            "unnorm_rotations": host(p.unnorm_rotations),
            "logit_opacities": host(p.logit_opacities),
            "log_scales": host(p.log_scales),
        }, host(st.timestep)

    def save_checkpoint(self, time_idx: int):
        if not self.is_main:
            return
        params, timestep = self.gauss_params_numpy()
        dc = self.config["data"]
        ckpt_io.save_checkpoint(
            self.output_dir, time_idx, params, self.cam_rots[None],
            self.cam_trans[None], timestep, self.intrinsics,
            self.first_frame_w2c, dc["desired_image_width"],
            dc["desired_image_height"], self.gt_w2c_all,
            self.keyframe_time_indices)

    def write_runtime_stats(self, final_frame: int):
        # each rank's kernel launch counts so far (the CUDA wrappers'
        # counters; empty on the CPU), gathered for rank 0 to write
        launches = (pdist.gather_object(dict(_cuda.LAUNCHES),
                                        self._world_mesh)
                    if self._world_mesh is not None
                    else [dict(_cuda.LAUNCHES)])
        if not self.is_main:
            return
        s = self.stats

        def mean(xs):
            return float(np.mean(xs)) if xs else 0.0

        d = {
            "Average Tracking/Iteration Time (ms)":
                mean(s["tracking_iter_time"]) * 1000,
            "Average Tracking/Frame Time (s)": mean(s["tracking_frame_time"]),
            "Average Mapping/Iteration Time (ms)":
                mean(s["mapping_iter_time"]) * 1000,
            "Average Mapping/Frame Time (s)": mean(s["mapping_frame_time"]),
            "Final Frame": int(final_frame),
        }
        if s.get("tracking_iters_run"):
            d["Average Tracking Iterations Run"] = mean(
                s["tracking_iters_run"])
        caps = s.get("tile_cap_dropped_frac", [])
        if caps:
            d["Tile-Cap True-Drop Frac (max)"] = float(np.max(caps))
            d["Tile-Cap True-Drop Frac (mean)"] = float(np.mean(caps))
            d["Tile-Cap Phases > 0.5%"] = int(np.sum(np.asarray(caps)
                                                     > 0.005))
        if s["gn_accepted"]:
            d["GN Polish Acceptance Rate"] = mean(s["gn_accepted"])
        if self._track_bins is not None:
            d["Tracking Binning Rebins"] = self._track_bins.n_rebins
            d["Tracking Binning Reuses"] = self._track_bins.n_reuses
        if self._world_mesh is not None:
            m = self._world_mesh
            d["World Size"] = m.world
            d["Backend"] = m.backend
            d["Map Views"] = self._map_views
            d["Track Tiles"] = self._track_tiles
            d["Replica Max Abs Diff"] = s.get("replica_max_abs_diff")
        if any(launches):
            d["Kernel Launches (per rank)"] = launches
        with open(os.path.join(self.output_dir, "runtime_stats.json"),
                  "w") as f:
            json.dump(d, f, indent=2)
        with open(os.path.join(self.output_dir, "runtime_stats.txt"),
                  "w") as f:
            for k, v in d.items():
                f.write(f"{k}: {v}\n")
        print(json.dumps(d, indent=2))


def rgbd_slam(config: dict, end_at: int | None = None) -> SLAM:
    """Reference-named entry point (scripts/splatam.py rgbd_slam)."""
    slam = SLAM(config)
    slam.run(end_at=end_at)
    return slam
