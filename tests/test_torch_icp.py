"""The port's Gauss-Newton depth polish (slam/icp.py) against the JAX
package's: the exp map and increment, back-projection, normals, the masked
median, image gradients, the 6x6 solve, and gn_depth_polish on a toy scene.

torch.linalg.eigh and XLA's eigh may return eigenvectors of opposite sign;
the step V (inv * V^T b) does not depend on it, so steps are compared, not
eigenvectors. Tolerances: elementwise helpers 1e-6; the solve 1e-4 of the
step's size; the polished pose 1e-4 (a few f32 roundings of a 6x6 solve of
sums over ~3000 pixels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.datasets.synthetic import SyntheticDataset
from isogs_slam_tpu.ops import rasterize as JR
from isogs_slam_tpu.slam import icp as JI
from isogs_slam_tpu.slam import pointcloud as JP
from isogs_slam_tpu.core.camera import Camera as JCamera
from isogs_slam_tpu.utils.transforms import rotmat_to_quat
from isogs_slam_tpu.utils.transforms import transform_to_frame as j_ttf
from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.ops import rasterize as R
from isogs_slam_tpu_torch.slam import icp as I
from isogs_slam_tpu_torch.slam import pointcloud as P
from isogs_slam_tpu_torch.slam.tracking import bin_at_pose
# toy sizes: PyTorch's intra-op thread pool buys nothing here and only
# contends with the other test workers
torch.set_num_threads(1)


def test_exp_map_and_increment_match_reference():
    rng = np.random.default_rng(0)
    for scale in (0.3, 1e-3, 1e-8, 0.0):
        om = (rng.normal(size=3) * scale).astype(np.float32)
        np.testing.assert_allclose(I._exp_quat(torch.tensor(om)).numpy(),
                                   np.asarray(JI._exp_quat(jnp.asarray(om))),
                                   atol=1e-7)
    q = rng.normal(size=4).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    d = (rng.normal(size=6) * 0.05).astype(np.float32)
    tq, tt = I.apply_increment(torch.tensor(q), torch.tensor(t),
                               torch.tensor(d))
    jq, jt = JI.apply_increment(jnp.asarray(q), jnp.asarray(t),
                                jnp.asarray(d))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)


def test_grid_helpers_match_reference():
    """backproject_grid, normals_from_points (borders never ok, holes
    spread to their neighbours) and _image_grads: 1e-6, masks exactly."""
    rng = np.random.default_rng(1)
    H, W = 20, 28
    cam = dict(width=W, height=H, fx=30.0, fy=31.0, cx=13.5, cy=9.5)
    depth = (2.0 + 0.3 * rng.normal(size=(H, W))).astype(np.float32)
    tp = I.backproject_grid(torch.tensor(depth), Camera(**cam))
    jp = JI.backproject_grid(jnp.asarray(depth), JCamera(**cam))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    valid = rng.uniform(size=(H, W)) > 0.1
    tn, tok = I.normals_from_points(tp, torch.tensor(valid))
    jn, jok = JI.normals_from_points(jp, jnp.asarray(valid))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not tok[0].any() and not tok[-1].any()
    assert not tok[:, 0].any() and not tok[:, -1].any()
    ok = tok.numpy()
    np.testing.assert_allclose(tn.numpy()[ok], np.asarray(jn)[ok], atol=1e-5)
    assert (np.sum(tn.numpy() * tp.numpy(), -1)[ok] <= 0).all()
    im = rng.uniform(size=(3, H, W)).astype(np.float32)
    for a, b in zip(I._image_grads(torch.tensor(im)),
                    JI._image_grads(jnp.asarray(im))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


@pytest.mark.parametrize("n_masked", [0, 1, 6, 7, 40])
def test_masked_median_matches_reference(n_masked):
    """Element cnt // 2 of the sorted masked values: for an even count the
    upper of the two middle values, which torch.median would not give; 0
    for an empty mask."""
    rng = np.random.default_rng(n_masked)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    mask = np.zeros(40, bool)
    mask[rng.permutation(40)[:n_masked]] = True
    mask = mask.reshape(5, 8)
    got = float(I._masked_median(torch.tensor(x), torch.tensor(mask)))
    ref = float(JI._masked_median(jnp.asarray(x), jnp.asarray(mask)))
    assert got == ref
    if n_masked:
        assert got == np.sort(x[mask])[n_masked // 2]


@pytest.mark.parametrize("case", ["full_rank", "wall", "no_eigencut"])
def test_gn_solve_matches_reference(case):
    """The damped step against the reference's, 1e-4 of its size. "wall":
    a rank-3 normal matrix (a plane fills the view), where the eigencut
    zeroes the unobserved directions instead of damping them."""
    rng = np.random.default_rng(3)
    if case == "wall":
        n = np.array([0.0, 0.0, -1.0])
        Y = np.concatenate([rng.uniform(-1, 1, size=(200, 2)),
                            np.full((200, 1), 2.0)], axis=1)
        J = np.concatenate([np.cross(Y, n), np.tile(n, (200, 1))], axis=1)
    else:
        J = rng.normal(size=(200, 6)) * np.array([2, 2, 2, 1, 1, 1.0])
    r = rng.normal(size=200) * 0.01
    JtJ = (J.T @ J).astype(np.float32)
    Jtr = (J.T @ r).astype(np.float32)
    kw = dict(iters=1, eig_floor=0.0 if case == "no_eigencut" else 1e-4)
    got = I.gn_solve(torch.tensor(JtJ), torch.tensor(Jtr),
                     I.GNConfig(**kw)).numpy()
    ref = np.asarray(JI.gn_solve(jnp.asarray(JtJ), jnp.asarray(Jtr),
                                 JI.GNConfig(**kw)))
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())
    if case == "wall":
        # in-plane translations and the rotation about the normal: no step
        assert np.abs(got[[2, 3, 4]]).max() < 1e-3 * np.abs(got).max()


H, W, CAP, K = 48, 64, 8192, 4096


def _toy():
    ds = SyntheticDataset(num_frames=2, height=H, width=W, n_per_wall=400,
                          traj_step=0.05)
    frames = []
    for i in range(2):
        color, depth, _, pose = ds[i]
        w2c = np.linalg.inv(np.asarray(pose, np.float64))
        q = np.asarray(rotmat_to_quat(jnp.asarray(w2c[:3, :3], jnp.float32)))
        frames.append(((color.transpose(2, 0, 1) / 255.0).astype(np.float32),
                       depth.transpose(2, 0, 1).astype(np.float32),
                       q.astype(np.float32), w2c[:3, 3].astype(np.float32)))
    c = ds.cam
    cam = Camera(width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx,
                 cy=c.cy)
    k0 = jax.random.PRNGKey(0)
    js = jax.jit(lambda im, d: JP.initialize_first_frame(
        im, d, c, CAP, k0, 3.0))(*frames[0][:2])
    ts = P.initialize_first_frame(
        *frames[0][:2], cam, CAP, 3.0,
        perturb=np.array(jax.random.normal(k0, (H * W, 3))), device="cpu")
    return frames, c, cam, js, ts


@pytest.mark.parametrize("phot_weight", [0.0, 0.3])
def test_gn_depth_polish_matches_reference(phot_weight):
    """Three GN iterations from a pose 1 cm / 0.2 degrees off on a frozen
    slot table: the polished pose within 1e-4 of the reference's, the
    costs within 1e-3 relative, and the cost fell."""
    frames, jcam, cam, js, ts = _toy()
    im1, d1, q1, t1 = frames[1]
    q0 = q1 + np.array([0.0, 0.002, -0.001, 0.001], np.float32)
    t0 = t1 + np.array([0.01, -0.004, 0.006], np.float32)
    jproj = JR.project_gaussians(
        *j_ttf(js.params.means3d, js.params.unnorm_rotations,
               jnp.asarray(q0), jnp.asarray(t0), gaussians_grad=False,
               camera_grad=False),
        js.params.log_scales, js.alive, jcam, margin_px=8.0)
    jb = JR.bin_gaussians(jproj, jcam, JR.RasterConfig(max_per_tile=K,
                                                       backend="xla"))
    jraw = JR.gather_raw_table(js.params, jb.tile_gauss)
    rcfg = R.RasterConfig(max_per_tile=K)
    tb = bin_at_pose(ts.params, ts.alive, torch.tensor(q0), torch.tensor(t0),
                     8.0, cam, rcfg)
    traw = R.gather_raw_table(ts.params, tb.tile_gauss)
    kw = dict(iters=3, phot_weight=phot_weight)
    jq, jt, jc0, jc1 = jax.jit(
        lambda raw, cnt: JI.gn_depth_polish(
            raw, cnt, jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(d1),
            jcam, JR.RasterConfig(max_per_tile=K, backend="xla"),
            JI.GNConfig(**kw), gt_im=jnp.asarray(im1)))(jraw, jb.tile_count)
    tq, tt, tc0, tc1 = I.gn_depth_polish(
        traw, tb.tile_count, torch.tensor(q0), torch.tensor(t0),
        torch.tensor(d1), cam, rcfg, I.GNConfig(**kw),
        gt_im=torch.tensor(im1))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-3)
    np.testing.assert_allclose(float(tc1), float(jc1), rtol=1e-3)
    assert float(tc1) < float(tc0)
    assert np.linalg.norm(tt.numpy() - t0) > 1e-3       # the pose moved
