"""Shared visualization helpers: checkpoint loading, offscreen rendering,
depth colormaps, trajectory figures (counterpart of
isogs_slam_tpu/viz_scripts/common.py).

The reference viewers drive an interactive Open3D window; without Open3D
these tools render offscreen through this package's rasterizer (kernel A on
the card) and write PNG frames / MP4s / trajectory plots instead. When
Open3D is importable the interactive path is used.

Files go through Pillow (io/images.py). The depth colormap is matplotlib's
"turbo" as a table of its own (the same bytes), so only the trajectory
figure needs matplotlib; an MP4 needs imageio with ffmpeg, and without
them the frames are written as PNGs, as the reference does without ffmpeg.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

from ..core import gaussians as G
from ..core.camera import Camera
from ..io.checkpoints import latest_checkpoint, load_checkpoint
from ..io.images import imwrite
from ..ops.rasterize import RasterConfig, render_rgbd_sil
from ..utils.transforms import (pose_to_w2c, rotmat_to_quat,
                                transform_to_frame)

# matplotlib's "turbo" colormap (256 entries), each entry's RGB as
# (colour * 255).astype(uint8): what the reference's colorize_depth writes
_TURBO = np.frombuffer(bytes.fromhex("".join((
    '30123b31154232184a341b51351e5836215f37236538266c3929723a2c793b2f7f3c3285'
    '3c358b3d37913e3a963f3d9c4040a14043a64145ab4148b0424bb5434eba4350be4353c2'
    '4456c74458cb455bce455ed24560d64563d94666dd4668e0466be3466de64670e84673eb'
    '4675ed4678f0467af2467df4467ff64682f84584f94587fb4589fc448cfd438efd4291fe'
    '4193fe4096fe3f98fe3e9bfe3c9dfd3ba0fc39a2fc38a5fb36a8f934aaf833acf631aff5'
    '2fb1f32db4f12bb6ef2ab9ed28bbeb26bde925c0e623c2e421c4e120c6df1ec9dc1dcbda'
    '1ccdd71bcfd41ad1d219d3cf18d5cc18d7ca17d9c717dac417dcc217debf18e0bd18e1ba'
    '19e3b81ae4b61be5b41de7b11ee8af20e9ac22eba924eca627eda329eea02cef9d2ff09a'
    '32f19735f39438f4913bf48d3ff58a42f68746f7834af8804df97c51f97955fa7659fb72'
    '5dfb6f61fc6c65fc6869fd656dfd6271fd5f74fe5c78fe597cfe5680fe5384fe5087fe4d'
    '8bfe4b8efe4892fe4695fe4498fe429bfd409efd3ea1fc3da4fc3ba6fb3aa9fb39acfa37'
    'aef937b1f836b3f835b6f735b9f534bbf434bef334c0f233c3f133c5ef33c8ee33caed33'
    'cdeb34cfea34d1e834d4e735d6e535d8e335dae236dde036dfde36e1dc37e3da37e5d838'
    'e7d738e8d538ead339ecd139edcf39efcd39f0cb3af2c83af3c63af4c43af6c23af7c039'
    'f8be39f9bc39f9ba38fab737fbb537fbb336fcb035fcae34fdab33fda932fda631fda330'
    'fea12ffe9e2efe9b2dfe982cfd952bfd9229fd8f28fd8c27fc8926fc8624fb8323fb8022'
    'fa7d20fa7a1ff9771ef8741cf7711bf76e1af66b18f56817f46516f36315f26014f15d13'
    'ef5a11ee5810ed550fec520eea500de94d0de84b0ce6490be5460ae3440ae24209e04008'
    'de3e08dd3c07db3a07d93806d73606d63405d43205d23005d02f04ce2d04cb2b03c92903'
    'c72803c52602c32402c02302be2102bb1f01b91e01b61c01b41b01b11901ae1801ac1601'
    'a91501a61401a31201a011019d10019a0e01970d01940c01910b018e0a018b0901870801'
    '8407018106027d05027a0402'))), np.uint8).reshape(256, 3)


def have_open3d() -> bool:
    try:
        import open3d  # noqa: F401
        return True
    except Exception:
        return False


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def load_scene(result_dir: str, checkpoint: str | None = None,
               return_sh: bool = False, device="cuda"):
    """Checkpoint -> (MapState on `device`, cam Camera, est_w2cs [T,4,4],
    gt_w2cs, path[, sh_flat]). With return_sh=True a 6th element is
    appended: the capacity-padded [cap, 48] deg-3 SH coefficients when the
    checkpoint carries a `sh_coeffs_flat` with nonzero higher bands
    (external 3DGS checkpoints), else None (SLAM checkpoints store raw RGB;
    their SH0 export roundtrips to the same colours)."""
    if checkpoint:
        path = (checkpoint if os.path.isabs(checkpoint)
                else os.path.join(result_dir, checkpoint))
    else:
        final = os.path.join(result_dir, "params.npz")
        if os.path.exists(final):
            path = final
        else:
            _, path = latest_checkpoint(result_dir)
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint under {result_dir}")
    data = load_checkpoint(path)

    n = data["means3D"].shape[0]
    st = G.empty_state(G.round_capacity(n, 4096), device=device)
    dev = st.alive.device

    def rows(key):
        return torch.as_tensor(np.asarray(data[key], np.float32),
                               device=dev)

    st = G.append_rows(st, G.GaussianParams(
        means3d=rows("means3D"), rgb_colors=rows("rgb_colors"),
        unnorm_rotations=rows("unnorm_rotations"),
        logit_opacities=rows("logit_opacities"),
        log_scales=rows("log_scales")),
        torch.ones(n, dtype=torch.bool, device=dev), 0)

    K = np.asarray(data["intrinsics"])[:3, :3]
    W = int(data["org_width"])
    H = int(data["org_height"])
    cam = Camera.from_intrinsics(K, W, H)

    rots = np.asarray(data["cam_unnorm_rots"])[0]       # [4,T]
    trans = np.asarray(data["cam_trans"])[0]            # [3,T]
    est = []
    for t in range(rots.shape[1]):
        q = rots[:, t]
        nq = np.linalg.norm(q)
        if nq == 0:
            est.append(np.eye(4))
            continue
        est.append(pose_to_w2c(torch.as_tensor(q / nq),
                               torch.as_tensor(trans[:, t])).numpy())
    gt = data.get("gt_w2c_all_frames")
    out = (st, cam, np.stack(est), (np.asarray(gt) if gt is not None
                                    else None), path)
    if return_sh:
        sh = data.get("sh_coeffs_flat")
        if sh is not None and np.abs(np.asarray(sh)[:, 3:]).max() > 0:
            pad = st.capacity - sh.shape[0]
            out = out + (torch.as_tensor(
                np.pad(np.asarray(sh, np.float32), ((0, pad), (0, 0))),
                device=dev),)
        else:
            out = out + (None,)
    return out


def make_render_fn(cam: Camera, rcfg: RasterConfig):
    """render(params, alive, quat, trans) -> (im [3,H,W], depth [1,H,W],
    sil [H,W]) of a map at a w2c pose, without gradients, on the device of
    the map's tensors."""
    @torch.no_grad()
    def go(params, alive, quat, tr):
        mc, qc = transform_to_frame(params.means3d, params.unnorm_rotations,
                                    quat, tr, gaussians_grad=False,
                                    camera_grad=False)
        im, depth, sil, _, _ = render_rgbd_sil(
            mc, qc, params.log_scales, params.logit_opacities,
            params.rgb_colors, alive, cam, rcfg)
        return im, depth, sil
    return go


def render_w2c(fn, state, w2c: np.ndarray, sh_flat=None, sh_deg: int = 3):
    """Render one pose. sh_flat [cap, 48] (from load_scene return_sh):
    view-dependent deg-`sh_deg` SH colours are evaluated per Gaussian for
    this pose (an [N]-elementwise pre-pass) and substituted for the stored
    rgb."""
    q = rotmat_to_quat(torch.as_tensor(np.asarray(w2c[:3, :3]),
                                       dtype=torch.float32)).numpy()
    q = q / np.linalg.norm(q)
    dev = state.alive.device
    params = state.params
    if sh_flat is not None:
        from ..ops.sh import sh_colors_for_pose
        center = torch.as_tensor(-w2c[:3, :3].T @ w2c[:3, 3],
                                 dtype=torch.float32, device=dev)
        params = params._replace(rgb_colors=sh_colors_for_pose(
            sh_flat, params.means3d, center, sh_deg))
    return fn(params, state.alive,
              torch.as_tensor(q, dtype=torch.float32, device=dev),
              torch.as_tensor(w2c[:3, 3], dtype=torch.float32, device=dev))


def colorize_depth(depth, d_min=None, d_max=None) -> np.ndarray:
    """[H,W] -> [H,W,3] uint8 through the turbo colormap."""
    d = np.asarray(_np(depth), np.float64)
    d_min = d_min if d_min is not None else np.percentile(d[d > 0], 2) \
        if (d > 0).any() else 0.0
    d_max = d_max if d_max is not None else np.percentile(d[d > 0], 98) \
        if (d > 0).any() else 1.0
    norm = np.clip((d - d_min) / max(d_max - d_min, 1e-9), 0, 1)
    # matplotlib's lookup: floor(x * N), x == 1 -> N - 1, NaN -> black
    x = norm * 256.0
    x[x == 256.0] = 255.0
    bad = np.isnan(x)
    out = _TURBO[np.where(bad, 0.0, x).astype(np.int64)]
    out[bad] = 0
    out[d <= 0] = 0
    return out


def frame_to_uint8(im) -> np.ndarray:
    return (np.clip(_np(im), 0, 1).transpose(1, 2, 0)
            * 255).astype(np.uint8)


def save_video_or_frames(frames: list, out_base: str, fps: int = 10):
    """An MP4 through imageio-ffmpeg where both are installed, else a PNG
    directory."""
    try:
        import imageio.v2 as imageio
        imageio.mimsave(out_base + ".mp4", frames, fps=fps)
        print(f"[viz] wrote {out_base}.mp4 ({len(frames)} frames)")
        return out_base + ".mp4"
    except Exception:
        os.makedirs(out_base, exist_ok=True)
        for i, f in enumerate(frames):
            imwrite(os.path.join(out_base, f"{i:05d}.png"), f)
        print(f"[viz] ffmpeg unavailable; wrote {len(frames)} PNGs to "
              f"{out_base}/")
        return out_base


def plot_trajectory(est_w2cs, gt_w2cs, out_path: str,
                    keyframe_indices=None):
    """3D trajectory figure with camera positions (matplotlib): the
    offscreen stand-in for the Open3D frustum / lineset view."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    cams = np.stack([np.linalg.inv(w)[:3, 3] for w in est_w2cs])
    ax.plot(cams[:, 0], cams[:, 1], cams[:, 2], "b-", label="estimated",
            linewidth=1.5)
    if gt_w2cs is not None:
        ok = [w for w in gt_w2cs if np.isfinite(w).all()]
        if ok:
            g = np.stack([np.linalg.inv(w)[:3, 3] for w in ok])
            ax.plot(g[:, 0], g[:, 1], g[:, 2], "g--", label="ground truth",
                    linewidth=1.0)
    if keyframe_indices is not None and len(keyframe_indices):
        kf = cams[np.asarray(keyframe_indices, int)]
        ax.scatter(kf[:, 0], kf[:, 1], kf[:, 2], c="r", s=12,
                   label="keyframes")
    ax.set_title("Camera trajectory")
    ax.legend()
    plt.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    print(f"[viz] wrote {out_path}")
