"""The port's evaluation metrics against the JAX package on the same
inputs (numpy, from a seed): MS-SSIM, PSNR, ATE, LPIPS."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.eval import metrics as JM
from isogs_slam_tpu.eval.lpips_jax import LPIPSAlex as JLPIPS
from isogs_slam_tpu.ops import ssim as JS
from isogs_slam_tpu_torch.eval import metrics as M
from isogs_slam_tpu_torch.eval.lpips import LPIPSAlex
from isogs_slam_tpu_torch.ops import ssim as S


def _smooth_pair(h, w, noise, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.2, 0.8, size=(3, h, w)).astype(np.float32)
    k = np.ones(9, np.float32) / 9.0
    for c in range(3):
        for ax in (0, 1):
            gt[c] = np.apply_along_axis(
                lambda r: np.convolve(r, k, mode="same"), ax, gt[c])
    ren = gt + rng.normal(0, noise, gt.shape).astype(np.float32)
    return ren.astype(np.float32), gt


def _pairs():
    rng = np.random.default_rng(1)
    return {
        # five scales, odd sizes (the 2x2 pool floors)
        "random": (rng.uniform(0, 1, (3, 181, 203)).astype(np.float32),
                   rng.uniform(0, 1, (3, 181, 203)).astype(np.float32)),
        "near_equal": _smooth_pair(192, 256, 0.01),
        "equal": (_smooth_pair(192, 256, 0.0)[1],) * 2,
        # fewer scales fit: weights renormalized
        "small": _smooth_pair(48, 64, 0.05, seed=2),
        "masked": tuple(a * (np.arange(200)[None, None, :] > 40)
                        for a in _smooth_pair(176, 200, 0.02, seed=3)),
    }


@pytest.mark.parametrize("name", list(_pairs()))
def test_ms_ssim_matches_reference(name):
    """|delta| <= 1e-5 against the JAX function, and never above 1."""
    a, b = _pairs()[name]
    ref = float(JS.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(S.ms_ssim(torch.tensor(a), torch.tensor(b)))
    assert abs(got - ref) <= 1e-5, (got, ref)
    assert 0.0 <= got <= 1.0 + 1e-6
    if name == "equal":
        assert abs(got - 1.0) < 1e-5


def test_ms_ssim_dtype_invariant():
    """bf16-rounded inputs are computed in f32: the same value as their f32
    copies, bounded by 1, and within input quantization of the f32 pair."""
    ren, gt = _smooth_pair(256, 320, 0.01)
    v32 = float(S.ms_ssim(torch.tensor(ren), torch.tensor(gt)))
    r16 = torch.tensor(ren).to(torch.bfloat16)
    g16 = torch.tensor(gt).to(torch.bfloat16)
    v16 = float(S.ms_ssim(r16, g16))
    assert v16 == float(S.ms_ssim(r16.float(), g16.float()))
    assert 0.0 <= v32 <= 1.0 + 1e-5 and 0.0 <= v16 <= 1.0 + 1e-5
    assert abs(v16 - v32) < 5e-3
    ref16 = float(JS.ms_ssim(jnp.asarray(ren, jnp.bfloat16),
                             jnp.asarray(gt, jnp.bfloat16)))
    assert abs(v16 - ref16) <= 1e-5


def test_psnr_and_ate_match_reference():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 40, 50)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    assert M.psnr(a, b) == pytest.approx(JM.psnr(a, b), abs=1e-9)
    assert float(S.psnr(torch.tensor(a), torch.tensor(b))) == pytest.approx(
        float(JS.psnr(jnp.asarray(a), jnp.asarray(b))), abs=1e-4)

    def traj(n, noise):
        out = []
        for i in range(n):
            m = np.eye(4)
            ang = 0.1 * i
            m[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                         [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
            m[:3, 3] = [0.1 * i, 0.05 * i * i, 0.3] + noise * rng.normal(
                size=3)
            out.append(m)
        return out

    gt, est = traj(12, 0.0), traj(12, 0.01)
    assert M.evaluate_ate(gt, est) == pytest.approx(JM.evaluate_ate(gt, est),
                                                    abs=1e-9)
    R, t, err = M.horn_align(np.stack([g[:3, 3] for g in gt]).T,
                             np.stack([e[:3, 3] for e in est]).T)
    Rj, tj, errj = JM.horn_align(np.stack([g[:3, 3] for g in gt]).T,
                                 np.stack([e[:3, 3] for e in est]).T)
    np.testing.assert_allclose(R, Rj, atol=1e-12)
    np.testing.assert_allclose(t, tj, atol=1e-12)
    np.testing.assert_allclose(err, errj, atol=1e-12)


def test_lpips_random_matches_reference(tmp_path, monkeypatch):
    """The same seed gives bit-equal weights in both packages, and the
    distance agrees within 1e-4 relative (f32 convolutions in another
    summation order)."""
    jnet = JLPIPS.random(0)
    tnet = LPIPSAlex.random(0, device="cpu")
    assert set(tnet.params) == set(jnet.params)
    for k, v in jnet.params.items():
        np.testing.assert_array_equal(tnet.params[k].numpy(), np.asarray(v),
                                      err_msg=k)
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 96, 128)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ref, got = jnet(a, b), tnet(a, b)
    assert got > 0 and got == pytest.approx(ref, rel=1e-4)
    assert tnet(a, a) == pytest.approx(0.0, abs=1e-7)
    assert LPIPSAlex.random(1, device="cpu")(a, b) != got

    # the metrics front end: the variant's label, the seeded fallback, NaN
    # when the fallback is switched off, and an exported .npz
    monkeypatch.delenv("ISOGS_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("ISOGS_LPIPS_FALLBACK", raising=False)
    assert M.lpips_variant() == JM.lpips_variant() == "rand-alexnet"
    assert M.lpips(a, b, device="cpu") == pytest.approx(got, rel=1e-6)
    monkeypatch.setenv("ISOGS_LPIPS_FALLBACK", "none")
    assert M.lpips_variant() == "none"
    assert np.isnan(M.lpips(a, b, device="cpu"))
    path = str(tmp_path / "w.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in
                      JLPIPS.random(3).params.items()})
    monkeypatch.setenv("ISOGS_LPIPS_WEIGHTS", path)
    assert M.lpips_variant() == "alex"
    assert M.lpips(a, b, device="cpu") == pytest.approx(
        JLPIPS(path)(a, b), rel=1e-4)
