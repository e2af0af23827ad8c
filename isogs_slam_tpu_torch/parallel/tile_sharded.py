"""Tile-parallel rasterization over the ranks of a mesh (counterpart of
isogs_slam_tpu/parallel/tile_sharded.py).

Every rank holds the full (replicated) Gaussian table; projection and
binning run replicated, and each rank composites its contiguous block of
tiles through kernel A on the virtual single-row grid of the tile-subset
renders (tiles_x = the shard's tile count, u and v shifted by the shard's
origins). The tile axis is padded to a multiple of the mesh size with
empty tiles. The image and final_T are all-gathered. Backward: each rank
runs kernel B on its own tiles and folds the slot gradients into the
table's rows (ops/rasterize.py::composite_table: through the expansion
positions and kernel C, in f32); the partial row gradients are
all-reduced.
"""
from __future__ import annotations

import torch

from ..core.camera import Camera
from ..ops.rasterize import (RasterConfig, bin_gaussians, composite_table,
                             project_table, tiles_to_image)
from .dist import (Mesh, all_gather_shards_grad, make_mesh,
                   replicated_inputs, shard_range)

TILE_AXIS = "tile"


def make_tile_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    return make_mesh(n_devices, device)


def render_tiles_sharded(mesh: Mesh, means_cam, quats_cam, log_scales,
                         logit_opacities, features, alive, cam: Camera,
                         cfg: RasterConfig):
    """Differentiable render with the compositing tile axis sharded over
    the mesh's ranks (features [N, F], F in 1..4 as the kernels take).
    Returns (image [F, H, W], final_T [H, W]) as the unsharded path
    (ops/rasterize.render) does, on every rank."""
    F = features.shape[-1]
    T = cam.num_tiles
    table, proj = project_table(means_cam, quats_cam, log_scales,
                                logit_opacities, features, alive, cam)
    binning = bin_gaussians(proj, cam, cfg, emit_exp=True)
    (table,) = replicated_inputs([table], mesh)

    lo, hi, per = shard_range(T, mesh)
    dev = table.device
    if hi > lo:
        ids = torch.arange(lo, hi, device=dev)
        real = ids < T
        # padding tiles point at tile 0 with count 0: they composite
        # nothing and their slots carry no gradient
        sel = torch.where(real, ids, torch.zeros_like(ids))
        counts = torch.where(real, binning.tile_count[sel],
                             torch.zeros_like(binning.tile_count[sel]))
        out, final_t = composite_table(table, F, binning, cam, cfg, sel=sel,
                                       counts=counts)
    else:
        # a rank outside the mesh: no tiles; zeros keep the graph
        out = table.new_zeros((per, 256, F)) + 0.0 * table.sum()
        final_t = table.new_zeros((per, 256))
    tiles_out = all_gather_shards_grad(out, mesh)[:T]
    tiles_t = all_gather_shards_grad(final_t, mesh)[:T, :, None]
    h, w = cam.height, cam.width
    return (tiles_to_image(tiles_out, cam.tiles_x)[:, :h, :w],
            tiles_to_image(tiles_t, cam.tiles_x)[0, :h, :w])
