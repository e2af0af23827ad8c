"""A run with its timed path broken underneath comes out not correct.

Each case drives `run.run` on the CPU (the kernels' plain versions) at a
toy size of replica.orbit, skipping only the look for a card, with one
fault planted in the program: a step that returns its state unchanged
(the Adam step of tracking and of mapping together, and of tracking
alone, so that the pose stays at its constant-velocity start), half of
the batch left out
(half of the frame's depth dropped, the depth mean taken over the rest),
and an answer altered where it is produced (the compositing forward's
output shifted). The cell runs on one chip, so it has no exchange between
chips to leave out. The sound run comes out correct."""
import pytest
import torch

from benchmark import run

W, H = 96, 64


def _shrink():
    cam = run.cell_spec("replica.orbit")["spec"]["camera"]
    s = W / cam["image_width"]
    return {"camera": {"image_width": W, "image_height": H,
                       "fx": cam["fx"] * s, "fy": cam["fy"] * s,
                       "cx": (cam["cx"] + 0.5) * s - 0.5,
                       "cy": (cam["cy"] + 0.5) * s - 0.5},
            "traffic": {"frames_per_job": 5, "warmup_frames": 2,
                        "sequences": 1}}


def _unchanged(monkeypatch):
    from isogs_slam_tpu_torch.core import optim
    monkeypatch.setattr(optim, "step",
                        lambda params, grads, state, lrs, **kw:
                        (params, state))


def _tracking_unchanged(monkeypatch):
    from types import SimpleNamespace

    from isogs_slam_tpu_torch.core import optim
    from isogs_slam_tpu_torch.slam import tracking
    monkeypatch.setattr(tracking, "optim", SimpleNamespace(
        init=optim.init,
        step=lambda params, grads, state, lrs, **kw: (params, state)))


def _half_batch(monkeypatch):
    from isogs_slam_tpu_torch.slam import losses
    orig = losses._photometric_terms

    def half(im, depth, silhouette, depth_sq, gt_im, gt_depth, lcfg):
        gt_depth = gt_depth.clone()
        gt_depth[..., gt_depth.shape[-2] // 2:, :] = 0
        return orig(im, depth, silhouette, depth_sq, gt_im, gt_depth, lcfg)
    monkeypatch.setattr(losses, "_photometric_terms", half)


def _altered(monkeypatch):
    from isogs_slam_tpu_torch.ops import composite
    orig = composite.composite_fwd_plain

    def shifted(*a, **kw):
        out, final_t = orig(*a, **kw)
        return out + 1e-3, final_t
    monkeypatch.setattr(composite, "composite_fwd_plain", shifted)


@pytest.mark.parametrize("fault", [None, _unchanged, _tracking_unchanged,
                                   _half_batch, _altered])
def test_fault_is_not_correct(fault, monkeypatch):
    torch.set_num_threads(4)
    if fault is not None:
        fault(monkeypatch)
    out = run.run("replica.orbit", 2 ** 31 + 7, 0.0, False,
                  torch.device("cpu"), _shrink())
    assert out["correct"] is (fault is None), out["checks"]
