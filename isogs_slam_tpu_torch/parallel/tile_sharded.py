"""Tile-parallel rasterization over the ranks of a mesh (counterpart of
isogs_slam_tpu/parallel/tile_sharded.py).

Every rank holds the full (replicated) Gaussian table; projection and
binning run replicated, and each rank composites its contiguous block of
tiles through kernel A on the virtual single-row grid of the tile-subset
renders (tiles_x = the shard's tile count, u and v shifted by the shard's
origins). The tile axis is padded to a multiple of the mesh size with
empty tiles. The image and final_T are all-gathered. Backward: each rank
runs kernel B on its own tiles and writes the slot gradients into the
table's rows through the expansion positions and kernel C; the partial row
gradients are all-reduced.
"""
from __future__ import annotations

import torch

from ..core.camera import Camera
from ..ops.rasterize import (RasterConfig, _GatherRowsSegreduce, _TileGrid,
                             _raster_table, _tiles_to_image,
                             _virtual_row_shift, bin_gaussians,
                             composite_gdata, project_gaussians)
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
    opacity = torch.sigmoid(logit_opacities[:, 0])
    proj = project_gaussians(means_cam, quats_cam, log_scales, alive, cam)
    binning = bin_gaussians(proj, cam, cfg, emit_exp=True)
    (table,) = replicated_inputs([_raster_table(proj, opacity, features)],
                                 mesh)

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
        gdata = _GatherRowsSegreduce.apply(
            table, binning.tile_gauss[sel], binning.slot_exp_pos[sel],
            binning.exp_offsets, cfg.max_isect(table.shape[0]), None, False)
        gdata = gdata + _virtual_row_shift(sel, cam, gdata.shape[-1],
                                           gdata.dtype)
        out, final_t = composite_gdata(gdata, counts,
                                       _TileGrid(num_tiles=per, tiles_x=per),
                                       cfg, F)
    else:
        # a rank outside the mesh: no tiles; zeros keep the graph
        out = table.new_zeros((per, 256, F)) + 0.0 * table.sum()
        final_t = table.new_zeros((per, 256))
    tiles_out = all_gather_shards_grad(out, mesh)[:T]
    tiles_t = all_gather_shards_grad(final_t, mesh)[:T]
    return (_tiles_to_image(tiles_out, cam),
            _tiles_to_image(tiles_t[..., None], cam)[0])
