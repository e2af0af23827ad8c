"""tum.handheld on the CPU: the parts only the TUM deployment reaches,
held to the plain reference (benchmark/reference/slam.py).

A whole run of the cell at a toy size comes out correct, and does not
with Kinect holes counted as valid depth in the photometric terms. (At
that size no rendered pixel passes tracking's silhouette threshold of
0.99, so the pose loop moves nothing, and a fault in it cannot show:
the check's tracking numbers are set on the card at the cell's size.) The
tracking loss's masks and terms with outlier depth ignored equal the
reference's on seeded renders with planted outliers and holes, for an
even pixel count (where the median is the mean of the two middle values)
and an odd one. A job whose depth loss stays above depth_loss_thres runs
twice num_iters pose iterations, as the reference's tracker does, and the
port's tracer counts them."""
import copy

import numpy as np
import pytest
import torch

from benchmark import judge, run
from benchmark.reference import slam as S

W, H = 48, 32
SEED = 2 ** 31 + 7


def _shrink(frames=3):
    cam = run.cell_spec("tum.handheld")["spec"]["camera"]
    s = W / cam["image_width"]
    return {"camera": {"image_width": W, "image_height": H,
                       "fx": cam["fx"] * s, "fy": cam["fy"] * s,
                       "cx": (cam["cx"] + 0.5) * s - 0.5,
                       "cy": (cam["cy"] + 0.5) * s - 0.5},
            "traffic": {"frames_per_job": frames, "warmup_frames": 2,
                        "sequences": 1}}


def _holes_valid(monkeypatch):
    """The photometric terms take a hole (depth 0) for a valid pixel: its
    depth is raised to the smallest positive float, so it passes every
    `gt_depth > 0` test and its error is the rendered depth."""
    from isogs_slam_tpu_torch.slam import losses
    orig = losses._photometric_terms

    def holes_in(im, depth, silhouette, depth_sq, gt_im, gt_depth, lcfg):
        tiny = torch.finfo(gt_depth.dtype).tiny
        gt_depth = torch.where(gt_depth > 0, gt_depth,
                               torch.full_like(gt_depth, tiny))
        return orig(im, depth, silhouette, depth_sq, gt_im, gt_depth, lcfg)
    monkeypatch.setattr(losses, "_photometric_terms", holes_in)


@pytest.mark.parametrize("fault", [None, _holes_valid],
                         ids=["sound", "holes_valid"])
def test_cell_at_toy_size(fault, monkeypatch, tmp_path):
    import tempfile
    # run.run works under the temporary directory: a test's own, so that
    # a run in another test process does not clear it
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    torch.set_num_threads(4)
    if fault is not None:
        fault(monkeypatch)
    out = run.run("tum.handheld", SEED, 0.0, False, torch.device("cpu"),
                  _shrink())
    assert out["correct"] is (fault is None), out["checks"]
    assert out["failed"] == 0


def _render(h, w, seed):
    """A seeded [6, h, w] tracking render (colour, depth, depth^2,
    silhouette) and its frame, with planted depth outliers and holes."""
    g = torch.Generator().manual_seed(seed)
    d = 1.0 + 2.0 * torch.rand((1, h, w), generator=g)
    im = torch.rand((3, h, w), generator=g)
    sil = 0.995 + 0.005 * torch.rand((h, w), generator=g)
    sil[0, : w // 3] = 0.5                     # under sil_thres 0.99
    img = torch.cat([im * sil, d * sil, (d * d + 0.01) * sil, sil[None]])
    gt_d = d + 0.01 * torch.randn((1, h, w), generator=g)
    gt_d.view(-1)[1::7] += 2.0                  # outliers
    gt_d.view(-1)[3::11] = 0.0                  # holes
    gt_im = torch.rand((3, h, w), generator=g)
    return img, gt_im, gt_d


def _tum_loss_configs():
    from isogs_slam_tpu_torch.slam import pipeline
    from isogs_slam_tpu_torch.slam.config import inject_defaults
    cfg = inject_defaults(run.cell_spec("tum.handheld")["spec"]["config"])
    tc, _, _ = judge.settings(cfg)
    return pipeline._loss_cfg_tracking(cfg), tc


@pytest.mark.parametrize("h,w", [(8, 6), (7, 5)], ids=["even", "odd"])
def test_outlier_mask_and_terms_match_reference(h, w):
    from isogs_slam_tpu_torch.slam import losses
    lcfg, tc = _tum_loss_configs()
    assert lcfg.ignore_outlier_depth_loss and tc["ignore_outlier_depth_loss"]
    img, gt_im, gt_d = _render(h, w, 11)
    n = h * w
    i = -1
    if n % 2 == 0:
        # an error between 10 x the lower middle value and 10 x the mean
        # of the two middle values, on a pixel whose error ranks above
        # both (so the middle values stay): the median's rule decides it
        err = (torch.abs(gt_d - img[3:4] / img[5:6]) * (gt_d > 0)
               ).reshape(-1)
        s, order = torch.sort(err)
        lo, mid = 10 * s[n // 2 - 1], 5 * (s[n // 2 - 1] + s[n // 2])
        assert lo < mid
        planted = set(range(1, n, 7)) | set(range(3, n, 11))
        i = next(int(j) for j in order[n // 2 + 1:]
                 if int(j) not in planted and int(j) >= w)
        gt_d.view(-1)[i] = (img[3].reshape(-1)[i] / img[5].reshape(-1)[i]
                            + (lo + mid) / 2)
    im, d, d2, sil = img[0:3], img[3:4], img[4:5], img[5]
    li, ld, mask = losses._photometric_terms(im, d, sil, d2, gt_im, gt_d,
                                             lcfg)
    _, ri, rd, rfrac = S.tracking_loss(img, gt_im, gt_d, tc)
    # the outliers, the holes and the low-silhouette pixels are left out
    out = mask.reshape(-1)
    assert not out[1::7].any() and not out[3::11].any()
    assert not mask[0, 0, : w // 3].any()
    if i >= 0:
        assert bool(out[i])             # kept by the mean of the middles
    assert float(mask.float().mean()) == float(rfrac)
    assert float(lcfg.w_im * li) == pytest.approx(float(ri), rel=1e-6)
    assert float(lcfg.w_depth * ld) == pytest.approx(float(rd), rel=1e-6)


@pytest.mark.parametrize("thres,doubled", [(1e-9, True), (1e9, False)],
                         ids=["doubled", "not_doubled"])
def test_doubling_rule_matches_reference(thres, doubled):
    """A short job of the cell's configuration (3 pose iterations, 2
    mapping iterations) under a depth-loss threshold that every frame
    misses, or none: the port's iterations run on frame 1 equal the
    reference tracker's, from the same map and start, and the tracer
    counts them and the doubled frames."""
    import tempfile

    from benchmark.jobs import FrameSource, final_checkpoint, run_job
    from isogs_slam_tpu_torch.slam.config import inject_defaults
    from isogs_slam_tpu_torch.utils import spans
    torch.set_num_threads(4)
    c = run.cell_spec("tum.handheld")
    sh = _shrink(frames=2)
    spec = dict(c["spec"], camera=dict(c["spec"]["camera"], **sh["camera"]))
    cfg = copy.deepcopy(spec["config"])
    cfg["tracking"].update(num_iters=3, depth_loss_thres=thres)
    cfg["mapping"]["num_iters"] = 2
    traffic = dict(c["traffic"], **sh["traffic"])
    dev = torch.device("cpu")
    seqs, _ = run.make_sequences(spec, traffic, SEED, dev, 1)
    _, col, dep, c2w = seqs[0]
    cam = spec["camera"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1]], np.float32)
    with tempfile.TemporaryDirectory() as base:
        job = run_job(cfg, FrameSource(col, dep, c2w, K), base, "job", 5,
                      "cpu")
        counters = spans.FINISHED[-1]["counters"]
        log = judge.read_log(job["dir"])
        with np.load(f"{job['dir']}/params0.npz") as d:
            p0 = {k: d[k] for k in d.files}
        with np.load(final_checkpoint(job["dir"])) as d:
            fin = {k: d[k] for k in d.files}
    ref = judge.reference_readings(
        inject_defaults(cfg), spec, (col, dep[..., 0]), p0,
        (fin["cam_unnorm_rots"][0], fin["cam_trans"][0]), 5, dev)
    want = 6 if doubled else 3
    assert len(ref["track"][1][0]) == want
    assert len(log[(1, "tracking")]) == want
    assert counters["tracking.iters"] == want
    assert counters.get("tracking.doubled", 0) == int(doubled)
