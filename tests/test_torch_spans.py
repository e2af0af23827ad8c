"""The port's span tracer (isogs_slam_tpu_torch/utils/spans.py): nesting,
per-thread stacks, self time, the off mode and the export's clock."""
import threading
import time

import pytest

from isogs_slam_tpu_torch.utils import spans


def _by_name(table):
    return {n: i for i, n in enumerate(table["name"])}


def test_nesting_and_parents():
    tr = spans.Tracer()
    with spans.use(tr):
        tr.frame = 3
        with spans.span("a"):
            with spans.span("b"):
                with spans.span("c"):
                    pass
            with spans.span("d"):
                pass
        with spans.span("e"):
            pass
    t = tr.table()
    assert t["name"] == ["a", "b", "c", "d", "e"]
    assert t["parent"] == [-1, 0, 1, 0, -1]
    assert t["frame"] == [3] * 5
    for i, p in enumerate(t["parent"]):
        assert t["start_ns"][i] <= t["end_ns"][i]
        if p >= 0:
            assert t["start_ns"][p] <= t["start_ns"][i]
            assert t["end_ns"][i] <= t["end_ns"][p]
    assert tr.totals()["a"][1] == 1 and spans.current() is None


def test_second_thread_takes_the_owners_innermost_span():
    """A thread with no open span of its own (autograd's device thread)
    opens its spans under the owner thread's innermost open span; its own
    nested spans stack on its own stack."""
    tr = spans.Tracer()

    def backward():
        with spans.span("render.composite_bwd"):
            with spans.span("inner"):
                pass

    with spans.use(tr), spans.span("mapping.backward"):
        th = threading.Thread(target=backward)
        th.start()
        th.join()
    t = tr.table()
    i = _by_name(t)
    assert t["parent"][i["render.composite_bwd"]] == i["mapping.backward"]
    assert t["parent"][i["inner"]] == i["render.composite_bwd"]
    assert t["tid"][i["render.composite_bwd"]] != t["owner"]
    assert t["tid"][i["mapping.backward"]] == t["owner"]


def test_self_time_is_duration_less_covered_children():
    tr = spans.Tracer()
    with spans.use(tr):
        for _ in range(2):
            with spans.span("frame"):
                with spans.span("tracking"):
                    time.sleep(0.002)
                with spans.span("sync.loss_log"):   # not a stage: glue
                    time.sleep(0.001)
                with spans.span("mapping"):
                    with spans.span("checkpoint"):  # not the frame's child
                        time.sleep(0.001)
                time.sleep(0.001)
    tot = tr.totals()
    want = tot["frame"][0] - tot["tracking"][0] - tot["mapping"][0]
    assert tr.self_seconds("frame") == pytest.approx(want, rel=1e-9)
    assert tr.self_seconds("frame") >= 0.004
    s = tr.summary()
    assert s["frames"] == 2 and s["syncs"] == 2 and not s["fine"]
    assert s["frame_self_s"] == pytest.approx(want, rel=1e-9)


def test_off_mode_records_nothing():
    tr = spans.Tracer()
    assert spans.current() is None
    assert spans.span("x") is spans.NOOP and spans.fine("y") is spans.NOOP
    with spans.use(tr):
        assert tr.fine is False
        assert spans.fine("y") is spans.NOOP    # fine spans off
        with spans.fine("y"):
            pass
        tr.fine = True
        with spans.fine("z"):
            pass

    @spans.fine_call("w")
    def f(a, b=1):
        return a + b

    assert f(2, b=3) == 5                       # no tracer: not recorded
    with spans.use(tr):
        assert f(1) == 2
    assert tr.table()["name"] == ["z", "w"]


def test_start_run_reads_the_profiler_once():
    from torch.profiler import ProfilerActivity, profile
    tr = spans.Tracer()
    tr.start_run()
    assert not tr.fine and tr.profiler is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.start_run()
        own = spans.Tracer()
        own.start_run(own_profiler=True)
    assert tr.fine and not tr.annotate
    assert tr.profiler is prof.profiler           # kept for the join
    assert own.fine and own.annotate and own.profiler is None


def test_epoch_export_is_within_a_millisecond_of_time_ns():
    tr = spans.Tracer()
    with spans.use(tr):
        before = time.time_ns()
        with spans.span("x"):
            pass
        after = time.time_ns()
    t = tr.table()
    assert before - 1_000_000 <= t["start_ns"][0] <= after + 1_000_000
    assert before - 1_000_000 <= t["end_ns"][0] <= after + 1_000_000


def test_counters_add_host_numbers_into_the_summary():
    tr = spans.Tracer()
    spans.count("tracking.iters", 5)          # no tracer: not recorded
    with spans.use(tr):
        spans.count("tracking.iters", 200)
        spans.count("tracking.iters", 400)
        spans.count("tracking.doubled")
    assert tr.counters == {"tracking.iters": 600, "tracking.doubled": 1}
    s = tr.summary()
    assert s["counters"] == tr.counters and s["counters"] is not tr.counters
    assert spans.Tracer().summary()["counters"] == {}


def _pose_loop(thres):
    """adam_pose_loop on an L1 bowl whose depth term stays at 1.0, with
    the depth-loss rule's threshold `thres`."""
    import torch

    from isogs_slam_tpu_torch.slam import losses as L
    from isogs_slam_tpu_torch.slam import tracking as T

    def loss_fn(pose):
        q, t = pose
        loss = (q - torch.tensor([1.0, 0.01, 0.0, 0.0])).abs().sum() \
            + t.abs().sum()
        z = loss * 0.0
        return loss, L.LossOutputs(loss=loss, im=loss, depth=z + 1.0,
                                   flat=z, iso=z, mean_density=z,
                                   radii=None, n_overflow=None,
                                   mask_frac=z + 1.0)
    cfg = T.TrackingConfig(num_iters=3, lr_quat=1e-3, lr_trans=1e-3,
                           use_depth_loss_thres=True, depth_loss_thres=thres)
    return T.adam_pose_loop(loss_fn, (torch.tensor([1.0, 0, 0, 0]),
                                      torch.zeros(3)), cfg)


@pytest.mark.parametrize("thres,iters", [(0.5, 6), (2.0, 3)],
                         ids=["doubled", "met"])
def test_pose_loop_counts_the_doubled_budget(thres, iters):
    """The depth-loss rule's doubling is counted once, from the host bool
    the loop holds; the loop reads the card no more often for it."""
    tr = spans.Tracer()
    with spans.use(tr):
        fin = _pose_loop(thres)
    assert fin.it == iters
    assert tr.counters.get("tracking.doubled", 0) == int(iters == 6)
    assert tr.totals()["sync.depth_thres"][1] == 1


def test_outlier_mask_span_only_under_a_profiler():
    """loss.outlier_mask is a fine span inside loss.photometric, opened
    only where outlier depth is ignored and fine spans are on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from isogs_slam_tpu_torch.slam import losses as L
    g = torch.Generator().manual_seed(0)
    im, gt_im = torch.rand((3, 6, 5), generator=g), torch.rand((3, 6, 5))
    d = 1 + torch.rand((1, 6, 5), generator=g)
    sil = torch.ones((6, 5))
    lcfg = L.LossConfig(tracking=True, use_sil_for_loss=True, sil_thres=0.9,
                        use_l1=True, ignore_outlier_depth_loss=True,
                        w_im=0.5, w_depth=1.0)

    def names(cfg, under_profiler):
        tr = spans.Tracer()
        if under_profiler:
            with profile(activities=[ProfilerActivity.CPU]):
                tr.start_run()
                with spans.use(tr):
                    L._photometric_terms(im, d, sil, d * d, gt_im, d, cfg)
        else:
            tr.start_run()
            with spans.use(tr):
                L._photometric_terms(im, d, sil, d * d, gt_im, d, cfg)
        t = tr.table()
        return [(n, t["name"][p] if p >= 0 else None)
                for n, p in zip(t["name"], t["parent"])]
    assert names(lcfg, False) == []
    assert ("loss.outlier_mask", "loss.photometric") in names(lcfg, True)
    off = lcfg._replace(ignore_outlier_depth_loss=False)
    assert names(off, True) == [("loss.photometric", None)]


def test_run_counts_its_tracking_iterations(tmp_path):
    """A SLAM run counts the iterations each tracked frame ran (none on
    frame 0) and the frames whose budget doubled, in its summary and in
    runtime_stats.json, beside the span totals."""
    import json
    import os

    from isogs_slam_tpu_torch.datasets.synthetic import SyntheticDataset
    from isogs_slam_tpu_torch.slam.pipeline import SLAM
    ds = SyntheticDataset(num_frames=3, height=32, width=40, seed=0,
                          n_per_wall=400, device="cpu")
    cfg = dict(
        workdir=str(tmp_path), run_name="counters", seed=0,
        primary_device="cpu", map_every=1, keyframe_every=5,
        mapping_window_size=5, scene_radius_depth_ratio=2,
        mean_sq_dist_method="projective", gaussian_distribution="isotropic",
        load_checkpoint=False, checkpoint_time_idx=0, save_checkpoints=False,
        checkpoint_interval=50, use_wandb=False, capacity_granule=8192,
        report_global_progress_every=100, eval_online_save_qual=False,
        isogs=dict(sample_size=256, k=8, target_saturation=1.0,
                   knn_pool_size=1024),
        data=dict(dataset_name="synthetic", basedir="", sequence="t",
                  desired_image_height=32, desired_image_width=40, start=0,
                  end=-1, stride=1, num_frames=3, prefetch_depth=0),
        tracking=dict(
            use_gt_poses=False, forward_prop=True, num_iters=2,
            use_sil_for_loss=True, sil_thres=0.99, use_l1=True,
            ignore_outlier_depth_loss=True, use_depth_loss_thres=True,
            depth_loss_thres=1e-9, loss_weights=dict(im=0.5, depth=1.0),
            lrs=dict(cam_unnorm_rots=0.002, cam_trans=0.002)),
        mapping=dict(
            num_iters=2, add_new_gaussians=True, sil_thres=0.5, use_l1=True,
            use_sil_for_loss=False, ignore_outlier_depth_loss=False,
            loss_weights=dict(im=0.5, depth=1.0, flat=50.0, iso=2.0),
            lrs=dict(means3D=0.0001, rgb_colors=0.0025,
                     unnorm_rotations=0.001, logit_opacities=0.05,
                     log_scales=0.001),
            prune_gaussians=False))
    slam = SLAM(cfg, dataset=ds)
    slam.run()
    # on the CPU every binning takes the eager chain (kernel pair Q's plain
    # version), 13 binnings in this run, and each mapping phase's iso pool
    # the hash KNN's (kernel K's plain version), 3 phases
    want = {"tracking.iters": 8, "tracking.doubled": 2,
            "render.bin.eager": 13, "iso.knn.eager": 3}
    assert spans.FINISHED[-1]["counters"] == want
    assert slam.stats["tracking_iters_run"] == [4, 4]
    with open(os.path.join(slam.output_dir, "runtime_stats.json")) as f:
        rs = json.load(f)
    assert rs["Counters"] == want and "tracking" in rs["Spans"]
