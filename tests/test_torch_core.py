"""The PyTorch port's core modules against the JAX package: camera,
transforms, map state, Adam and the state converter.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.core import gaussians as JG
from isogs_slam_tpu.core import optim as JO
from isogs_slam_tpu.core.camera import Camera as JCamera
from isogs_slam_tpu.slam import tracking as JTR
from isogs_slam_tpu.utils import transforms as JT
from isogs_slam_tpu_torch.core import convert
from isogs_slam_tpu_torch.core import gaussians as G
from isogs_slam_tpu_torch.core import optim as O
from isogs_slam_tpu_torch.core.camera import TILE, Camera
from isogs_slam_tpu_torch.slam import tracking as TR
from isogs_slam_tpu_torch.utils import transforms as T


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_camera_matches_reference():
    K = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]])
    c, j = (Camera.from_intrinsics(K, 1200, 680),
            JCamera.from_intrinsics(K, 1200, 680))
    assert TILE == 16
    for f in ("tiles_x", "tiles_y", "num_tiles", "tanfovx", "tanfovy", "fx",
              "fy", "cx", "cy"):
        assert getattr(c, f) == getattr(j, f), f
    assert (c.tiles_x, c.tiles_y, c.num_tiles) == (75, 43, 3225)
    np.testing.assert_array_equal(c.intrinsics_matrix(),
                                  j.intrinsics_matrix())


def test_transforms_match_reference():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    q2 = rng.normal(size=(50, 4)).astype(np.float32)
    q[0] = 0.0                                   # the all-zero dead row
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(T.normalize(torch.tensor(q))),
                               np.asarray(JT.normalize(q)), **tol)
    np.testing.assert_allclose(
        _np(T.quat_mult(torch.tensor(q), torch.tensor(q2))),
        np.asarray(JT.quat_mult(q, q2)), **tol)
    R = np.asarray(JT.quat_to_rotmat(q2))
    np.testing.assert_allclose(_np(T.quat_to_rotmat(torch.tensor(q2))), R,
                               **tol)
    np.testing.assert_allclose(_np(T.rotmat_to_quat(torch.tensor(R))),
                               np.asarray(JT.rotmat_to_quat(R)), **tol)
    cq, ct = q2[3], rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(
        _np(T.pose_to_w2c(T.normalize(torch.tensor(cq)), torch.tensor(ct))),
        np.asarray(JT.pose_to_w2c(JT.normalize(cq), ct)), **tol)
    means = rng.normal(size=(50, 3)).astype(np.float32)
    mc, rc = T.transform_to_frame(torch.tensor(means), torch.tensor(q2),
                                  torch.tensor(cq), torch.tensor(ct),
                                  gaussians_grad=False, camera_grad=True)
    jm, jr = JT.transform_to_frame(means, q2, cq, ct, False, True)
    np.testing.assert_allclose(_np(mc), np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(rc), np.asarray(jr), **tol)


def test_transform_gradient_flags_detach():
    """gaussians_grad / camera_grad become .detach(): the pose gradient of
    a tracking transform matches JAX's, the means get none."""
    rng = np.random.default_rng(1)
    means = rng.normal(size=(20, 3)).astype(np.float32)
    rots = rng.normal(size=(20, 4)).astype(np.float32)
    cq = np.array([0.9, 0.1, -0.2, 0.05], np.float32)
    ct = np.array([0.1, -0.3, 0.2], np.float32)

    def jloss(q, t):
        m, r = JT.transform_to_frame(means, rots, q, t, False, True)
        return jnp.sum(m ** 2) + jnp.sum(r * 0.5)

    gq, gt = jax.grad(jloss, argnums=(0, 1))(cq, ct)
    tm = torch.tensor(means, requires_grad=True)
    tq = torch.tensor(cq, requires_grad=True)
    tt = torch.tensor(ct, requires_grad=True)
    m, r = T.transform_to_frame(tm, torch.tensor(rots), tq, tt,
                                gaussians_grad=False, camera_grad=True)
    (m ** 2).sum().add((r * 0.5).sum()).backward()
    assert tm.grad is None
    np.testing.assert_allclose(_np(tq.grad), np.asarray(gq), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(tt.grad), np.asarray(gt), rtol=1e-5,
                               atol=1e-5)


def _rows(rng, n):
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    d = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    noise = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, cols, d, noise


def test_gaussian_rows_append_prune_match_reference():
    rng = np.random.default_rng(2)
    C = 64
    pts, cols, d, noise = _rows(rng, 40)
    valid = rng.uniform(size=40) < 0.7
    jrows = JG.new_gaussian_rows(pts, cols, d)
    jrows = jrows._replace(log_scales=jrows.log_scales + 0.01 * noise)
    js = JG.append_rows(JG.empty_state(C), jrows, valid, 3)
    trows = G.new_gaussian_rows(torch.tensor(pts), torch.tensor(cols),
                                torch.tensor(d), torch.tensor(noise))
    ts = G.append_rows(G.empty_state(C, device="cpu"), trows,
                       torch.tensor(valid), 3)
    # a second append overflows the capacity: rows past C are dropped
    js = JG.append_rows(js, jrows, np.ones(40, bool), 4)
    ts = G.append_rows(ts, trows, torch.ones(40, dtype=torch.bool), 4)
    remove = rng.uniform(size=C) < 0.2
    js = JG.prune(js, remove)
    ts = G.prune(ts, torch.tensor(remove))
    ref = convert.state_to_arrays(convert.state_from_arrays(js, "cpu"))
    got = convert.state_to_arrays(ts)
    assert int(got["hwm"]) == int(np.asarray(js.hwm)) == C
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert int(ts.num_alive()) == int(np.asarray(js.num_alive()))
    assert G.round_capacity(816000) == JG.round_capacity(816000) == 851968


def test_adam_matches_reference():
    """Several steps at the mapping eps (1e-15) with per-leaf lrs."""
    rng = np.random.default_rng(3)
    shapes = [(30, 3), (30, 1), (30, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lrs = (1e-3, 5e-2, 2.5e-3)
    jp, js = tuple(jnp.asarray(p) for p in params), None
    js = JO.init(jp)
    tp = tuple(torch.tensor(p) for p in params)
    ts = O.init(tp)
    for i in range(4):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        jp, js = JO.step(jp, tuple(jnp.asarray(x) for x in g), js,
                         tuple(jnp.float32(x) for x in lrs), eps=1e-15)
        tp, ts = O.step(tp, tuple(torch.tensor(x) for x in g), ts, lrs,
                        eps=1e-15)
    assert ts.count == int(js.count) == 4
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_state_converter_round_trip():
    rng = np.random.default_rng(4)
    pts, cols, d, _ = _rows(rng, 10)
    js = JG.append_rows(JG.empty_state(16),
                        JG.new_gaussian_rows(pts, cols, d),
                        np.ones(10, bool), 0)
    ts = convert.state_from_arrays(js, "cpu")
    assert isinstance(ts.params, G.GaussianParams)
    assert ts.alive.dtype == torch.bool and int(ts.hwm) == 10
    back = convert.state_to_arrays(ts)
    np.testing.assert_array_equal(back["means3d"], np.asarray(
        js.params.means3d))
    np.testing.assert_array_equal(back["alive"], np.asarray(js.alive))


def test_entry_points_need_cuda_unless_cpu_is_asked():
    """Entry points default to the card; without one they raise unless the
    caller asks for the CPU."""
    from isogs_slam_tpu_torch import resolve_device
    from isogs_slam_tpu_torch.datasets.synthetic import SyntheticDataset
    from isogs_slam_tpu_torch.slam.pointcloud import initialize_first_frame
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cam = Camera(width=32, height=16, fx=20.0, fy=20.0, cx=16.0, cy=8.0)
    im = np.zeros((3, 16, 32), np.float32)
    d = np.ones((1, 16, 32), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_first_frame(im, d, cam, 1024, 3.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.empty_state(16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticDataset(num_frames=1, height=16, width=32)
    assert resolve_device("cpu").type == "cpu"
    st = initialize_first_frame(im, d, cam, 1024, 3.0, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    assert int(st.num_alive()) == 16 * 32


@pytest.mark.parametrize("time_idx,forward_prop", [(1, True), (3, True),
                                                   (3, False)])
def test_initialize_camera_pose_matches_reference(time_idx, forward_prop):
    """Constant-velocity pose init (forward propagation from the two last
    poses), and the copy of the last pose at the start or when it is off."""
    rng = np.random.default_rng(5)
    rots = rng.normal(size=(4, 6)).astype(np.float32)
    trans = rng.normal(size=(3, 6)).astype(np.float32)
    jq, jt = JTR.initialize_camera_pose(jnp.asarray(rots), jnp.asarray(trans),
                                        time_idx, forward_prop)
    tq, tt = TR.initialize_camera_pose(torch.tensor(rots),
                                       torch.tensor(trans), time_idx,
                                       forward_prop)
    np.testing.assert_allclose(_np(tq), np.asarray(jq), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=1e-6,
                               atol=1e-7)
