"""The port's mesh stack against the JAX package on the CPU: the density
grid, marching tetrahedra and the mesh utilities, file I/O, geometry
metrics, the software z-buffer, the two known reference defects, and the
extract -> eval CLI pair with export_ply and synth_gt_mesh.

The same numpy inputs, made from a seed, go through both packages; the
port runs with device="cpu". Tolerances are stated at each assert.

The density grid cannot be held to the reference at 1e-5 of its max in
general: the quadratic form is evaluated on the reference's absolute-
coordinate lift, whose products cancel by 3-6 orders of magnitude, so two
f32 summation orders (XLA's and PyTorch's) differ by more than that
(1e-5-4e-5 on the toy maps below, 4e-3 at room coordinates). Where 1e-5
is out of reach, both packages are held to a float64 evaluation of the
same truncated sum (density.density_reference) at one stated tolerance,
which shows the port is no worse than the reference.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from isogs_slam_tpu.mesh import density as JD
from isogs_slam_tpu.mesh import geometry_eval as JG
from isogs_slam_tpu.mesh import marching as JM
from isogs_slam_tpu.mesh import meshio as JIO
from isogs_slam_tpu.mesh import zbuffer as JZ
from isogs_slam_tpu.scripts import eval_mesh_geometry as JEVAL
from isogs_slam_tpu.scripts import export_ply as JEXP
from isogs_slam_tpu.scripts import extract_mesh_fast as JEXT
from isogs_slam_tpu.tools import synth_gt_mesh as JGT
from isogs_slam_tpu_torch.datasets.synthetic import make_room_gaussians
from isogs_slam_tpu_torch.io.checkpoints import save_checkpoint
from isogs_slam_tpu_torch.mesh import density as D
from isogs_slam_tpu_torch.mesh import geometry_eval as G
from isogs_slam_tpu_torch.mesh import marching as M
from isogs_slam_tpu_torch.mesh import meshio as IO
from isogs_slam_tpu_torch.mesh import zbuffer as Z
from isogs_slam_tpu_torch.scripts import eval_mesh_geometry as EVAL
from isogs_slam_tpu_torch.scripts import export_ply as EXP
from isogs_slam_tpu_torch.scripts import extract_mesh_fast as EXT
from isogs_slam_tpu_torch.tools import synth_gt_mesh as GT

# toy sizes: PyTorch's intra-op thread pool buys nothing here and only
# contends with the other test workers
torch.set_num_threads(1)

# grid max relative error against f64 near the origin (|p| <= ~1.5 m),
# where the cancellation of the lift leaves 1e-5-4e-5 in either package
F64_TOL_TOY = 1e-4


def _cloud(n, seed, spread=0.3, center=(0.0, 0.0, 0.0), smin=0.02,
           smax=0.12, aniso=True):
    """Gaussian map: normal means, uniform scales (the third one thin when
    anisotropic), random rotations and opacities."""
    rng = np.random.default_rng(seed)
    ls = np.log(rng.uniform(smin, smax, (n, 3)))
    if aniso:
        ls[:, 2] = np.log(smin / 3)
    return {"means3D": (rng.normal(size=(n, 3)) * spread
                        + center).astype(np.float32),
            "log_scales": ls.astype(np.float32),
            "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
            "logit_opacities": rng.normal(0.5, 1.0, (n, 1)
                                          ).astype(np.float32)}


def _wall_patch(n, seed, center):
    """A 0.5 m wall patch of 3-10 mm flakes (clamped to voxel / 2 by the
    mesh path), as the SLAM map holds them metres from the origin."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(-0.25, 0.25, (n, 3))
    m[:, 2] = rng.normal(0, 0.005, n)
    return {"means3D": (m + center).astype(np.float32),
            "log_scales": np.log(rng.uniform(0.003, 0.01, (n, 3))
                                 ).astype(np.float32),
            "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
            "logit_opacities": rng.normal(1.0, 1.0, (n, 1)
                                          ).astype(np.float32)}


def _f64_grid(params, spec, min_scale):
    """density_reference at every voxel, one block at a time."""
    out = np.zeros(spec.dims)
    B = spec.block
    for b in np.ndindex(*spec.block_dims):
        sl = tuple(slice(i * B, min((i + 1) * B, d))
                   for i, d in zip(b, spec.dims))
        ii = np.stack(np.meshgrid(*[np.arange(s.start, s.stop) for s in sl],
                                  indexing="ij"), -1).reshape(-1, 3)
        pos = np.asarray(spec.origin) + ii * np.asarray(spec.spacing)
        out[sl] = D.density_reference(
            pos, params["means3D"], params["log_scales"],
            params["unnorm_rotations"], params["logit_opacities"],
            min_scale).reshape(out[sl].shape)
    return out


def _both_densities(params, **kw):
    """(JAX grid, port grid, spec, JAX stdout, port stdout)."""
    fj, ft = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(fj):
        dj, sj = JD.compute_density(params, **kw)
    with contextlib.redirect_stdout(ft):
        dt, st = D.compute_density(params, device="cpu", **kw)
    # the same grid: dims, origin, spacing, block
    assert tuple(st) == tuple(sj)
    assert dt.shape == dj.shape == tuple(st.dims)
    return dj, dt, st, fj.getvalue(), ft.getvalue()


# ------------------------------------------------------------------ density
DENSITY_CASES = {
    # name: (params, voxel, min_scale_limit, extra kwargs, port vs JAX 1e-5)
    "one_iso": (_cloud(1, 1, spread=0.1, aniso=False), 0.05, 0.0, {}, True),
    "three_aniso": (_cloud(3, 2, spread=0.2), 0.04, 0.0, {}, False),
    "flakes_iso": (_cloud(200, 3, aniso=False), 0.06, 0.0, {}, False),
    "flakes_aniso_half_voxel": (_cloud(200, 4), 0.06, 0.03, {}, False),
    # small caps force the growth loop: five rounds in both packages
    "growth": (_cloud(300, 6, aniso=False), 0.06, 0.0,
               dict(max_per_block=8, isect_per_gaussian=1.0), True),
}


@pytest.mark.parametrize("case", list(DENSITY_CASES))
def test_density_matches_reference(case):
    """compute_density: the same grid spec and growth messages (rounds and
    overflow counts) as the reference; the grid within 1e-5 of its max of
    the reference's where two f32 summation orders allow it, and within
    F64_TOL_TOY of an f64 evaluation in both packages everywhere."""
    params, vox, msl, kw, exact = DENSITY_CASES[case]
    dj, dt, spec, out_j, out_t = _both_densities(
        params, voxel_size=vox, padding=0.3, min_scale_limit=msl, **kw)
    assert out_t == out_j
    if case == "growth":
        assert out_t.count("growing max_isect") == 5
    ref = _f64_grid(params, spec, max(1e-5, msl))
    scale = np.abs(ref).max()
    assert scale > 0.1
    if exact:
        np.testing.assert_allclose(dt / scale, dj / scale, atol=1e-5)
    np.testing.assert_allclose(dj / scale, ref / scale, atol=F64_TOL_TOY)
    np.testing.assert_allclose(dt / scale, ref / scale, atol=F64_TOL_TOY)


def test_density_f64_tolerance_at_room_scale():
    """A wall patch 4.4 m from the origin (the synthetic room's farthest
    corner) at the mesh path's 2 cm voxel: both packages within
    D.DENSITY_F64_RTOL of the grid's max of the f64 evaluation (the JAX
    grid measured 4.8e-3, the port's 4.0e-3): the tolerance the card's
    smoke run holds the full-size grid to."""
    params = _wall_patch(3000, 7, (1.8, -1.8, 3.6))
    dj, dt, spec, out_j, out_t = _both_densities(
        params, voxel_size=0.02, padding=0.1, min_scale_limit=0.01)
    assert out_t == out_j
    ref = _f64_grid(params, spec, 0.01)
    scale = np.abs(ref).max()
    err_j = np.abs(dj - ref).max() / scale
    err_t = np.abs(dt - ref).max() / scale
    assert err_j < D.DENSITY_F64_RTOL, err_j
    assert err_t < D.DENSITY_F64_RTOL, err_t


def test_density_far_from_origin_defect_reproduced():
    """The reference's known defect (the lift's f32 rounding, ADVICE.md
    density.py:229), not fixed in the port: flakes 45 m from the origin
    put both grids off the f64 evaluation by over 1% of the max, and the
    two errors are of one order of magnitude (ratio within 10)."""
    params = _cloud(40, 5, spread=0.2, center=(30.0, -20.0, 25.0),
                    smin=0.01, smax=0.03)
    dj, dt, spec, _, _ = _both_densities(params, voxel_size=0.03,
                                         padding=0.3, min_scale_limit=0.015)
    ref = _f64_grid(params, spec, 0.015)
    scale = np.abs(ref).max()
    err_j = np.abs(dj - ref).max() / scale
    err_t = np.abs(dt - ref).max() / scale
    assert err_j > 1e-2 and err_t > 1e-2, (err_j, err_t)
    assert 0.1 < err_t / err_j < 10.0, (err_j, err_t)
    # still finite and bounded by the total opacity (the PSD clamp)
    assert np.isfinite(dt).all() and dt.max() <= len(dt) + 40


def test_density_shard_devices_not_ported():
    """shard_devices > 1 was refused here until the port had parallel/;
    without a process group it now clamps to the world size (1) and runs
    the serial pass, as the reference clamps to its devices
    (tests/test_torch_parallel.py runs it on two ranks)."""
    info = {}
    d2, _ = D.compute_density(_cloud(4, 0), device="cpu", shard_devices=2,
                              info=info)
    d0, _ = D.compute_density(_cloud(4, 0), device="cpu")
    assert info["shard_devices"] == 1
    np.testing.assert_array_equal(d2, d0)


# ----------------------------------------------------------------- marching
def _sphere_field(n=40, center=(0.0, 0.0, 0.0)):
    lin = np.linspace(-1.2, 1.2, n)
    X, Y, Z_ = np.meshgrid(lin, lin, lin, indexing="ij")
    d = -np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2
                 + (Z_ - center[2]) ** 2)
    return d, (lin[1] - lin[0],) * 3


def _sphere_mesh(mod, r=0.5, n=40, center=(0.0, 0.0, 0.0)):
    d, sp = _sphere_field(n, center)
    return mod.marching_tetrahedra(d, -r, spacing=sp, origin=(-1.2,) * 3,
                                   use_native=False)


def test_marching_and_mesh_utils_match_reference():
    """The JAX package's density grid of a flake map through both
    packages' marching_tetrahedra(use_native=False), largest_component,
    vertex_normals, face_normals and mesh_stats: identical outputs."""
    params = _cloud(300, 11, spread=0.4)
    dens, spec = JD.compute_density(params, voxel_size=0.05, padding=0.3)
    vj, fj = JM.marching_tetrahedra(dens, 0.5, spacing=spec.spacing,
                                    origin=spec.origin, use_native=False)
    vt, ft = M.marching_tetrahedra(dens, 0.5, spacing=spec.spacing,
                                   origin=spec.origin, use_native=False)
    assert len(fj) > 500
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    lvj, lfj = JM.largest_component(vj, fj)
    lvt, lft = M.largest_component(vt, ft)
    np.testing.assert_array_equal(lvt, lvj)
    np.testing.assert_array_equal(lft, lfj)
    np.testing.assert_array_equal(M.vertex_normals(lvt, lft),
                                  JM.vertex_normals(lvj, lfj))
    np.testing.assert_array_equal(M.face_normals(lvt, lft),
                                  JM.face_normals(lvj, lfj))
    assert M.mesh_stats(lvt, lft) == JM.mesh_stats(lvj, lfj)
    # two spheres: the largest component drops the small one in both
    v1, f1 = _sphere_mesh(M, r=0.4)
    v2, f2 = _sphere_mesh(M, r=0.15, center=(0.7, 0.7, 0.7))
    v = np.concatenate([v1, v2])
    f = np.concatenate([f1, f2 + len(v1)])
    for a, b in zip(M.largest_component(v, f), JM.largest_component(v, f)):
        np.testing.assert_array_equal(a, b)
    assert len(M.largest_component(v, f)[1]) == len(f1)


def test_marching_sanitizes_nonfinite_grid_like_reference():
    """inf / NaN corners next to the isosurface: finite vertices, and the
    same mesh as the reference's (tests/test_mesh_nonfinite.py's input)."""
    n = 24
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    g = np.exp(-(xs[:, None, None] ** 2 + xs[None, :, None] ** 2
                 + xs[None, None, :] ** 2) * 4.0) * 2.0
    g[n // 2, n // 2, n // 2] = np.inf
    g[n // 2 + 1, n // 2, n // 2] = np.nan
    vt, ft = M.marching_tetrahedra(g, 1.0, use_native=False)
    vj, fj = JM.marching_tetrahedra(g, 1.0, use_native=False)
    assert vt.shape[0] > 0 and np.isfinite(vt).all()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)


def test_sample_surface_defect_reproduced():
    """The reference's known defect (ADVICE.md marching.py:310), not fixed
    in the port: when every face is degenerate, the fallback weights all
    faces alike, NaN vertices included, so points can be NaN. Both
    packages return the same points, NaN at the same places; a mixed mesh
    gives finite points in both."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                      [np.nan, np.nan, np.nan]], np.float32)
    degenerate = np.array([[0, 1, 1], [0, 1, 3], [2, 2, 2]], np.int32)
    pt = M.sample_surface(verts, degenerate, 256, np.random.default_rng(3))
    pj = JM.sample_surface(verts, degenerate, 256, np.random.default_rng(3))
    np.testing.assert_array_equal(pt, pj)          # NaN == NaN here
    assert np.isnan(pt).any() and np.isfinite(pt).any()
    mixed = np.array([[0, 1, 2], [0, 1, 1], [0, 1, 3]], np.int32)
    pt = M.sample_surface(verts, mixed, 256)
    np.testing.assert_array_equal(pt, JM.sample_surface(verts, mixed, 256))
    assert np.isfinite(pt).all()


# ------------------------------------------------------------------- meshio
def test_mesh_files_byte_equal_and_read_back(tmp_path):
    """PLY (binary, with normals, with colours, ascii), OBJ (with and
    without normals), STL and the point-cloud PLY written by both packages
    are byte-equal; read_ply round-trips the binary and ascii files."""
    v, f = _sphere_mesh(M, r=0.5, n=24)
    vn = M.vertex_normals(v, f)
    cols = np.random.default_rng(0).uniform(0, 300, v.shape)
    props = {"x": v[:, 0], "y": v[:, 1], "z": v[:, 2], "opacity": vn[:, 0]}
    writes = {
        "bin.ply": lambda m, p: m.write_ply_mesh(p, v, f, vertex_normals=vn),
        "col.ply": lambda m, p: m.write_ply_mesh(p, v, f,
                                                 vertex_colors=cols),
        "asc.ply": lambda m, p: m.write_ply_mesh(p, v[:50], f[:20],
                                                 vertex_normals=vn[:50],
                                                 binary=False),
        "n.obj": lambda m, p: m.write_obj(p, v, f, vertex_normals=vn),
        "plain.obj": lambda m, p: m.write_obj(p, v, f),
        "m.stl": lambda m, p: m.write_stl(p, v, f),
        "pts.ply": lambda m, p: m.write_ply_points(p, props),
        "pts_asc.ply": lambda m, p: m.write_ply_points(p, props,
                                                       binary=False),
    }
    for name, write in writes.items():
        pt, pj = tmp_path / ("t_" + name), tmp_path / ("j_" + name)
        write(IO, str(pt))
        write(JIO, str(pj))
        assert pt.read_bytes() == pj.read_bytes(), name
    back = IO.read_ply(str(tmp_path / "t_bin.ply"))
    np.testing.assert_array_equal(back["vertices"], v)
    np.testing.assert_array_equal(back["faces"], f)
    np.testing.assert_array_equal(back["properties"]["vertex"]["nx"],
                                  vn[:, 0].astype(np.float64))
    back_a = IO.read_ply(str(tmp_path / "t_asc.ply"))
    np.testing.assert_allclose(back_a["vertices"], v[:50], atol=1e-6)
    np.testing.assert_array_equal(back_a["faces"], f[:20])
    pts = IO.read_ply(str(tmp_path / "t_pts.ply"))
    assert pts["faces"] is None
    np.testing.assert_array_equal(pts["vertices"], v)


# ------------------------------------------------------------ geometry eval
def test_geometry_eval_matches_reference():
    """evaluate_mesh_geometry on the same meshes and seed: the same dict
    (1e-6 relative), for an identical and an offset prediction."""
    v, f = _sphere_mesh(M, r=0.5)
    for off in (0.0, 0.05):
        pred = v + np.array([off, 0.0, 0.0], np.float32)
        mt = G.evaluate_mesh_geometry(pred, f, v, f, num_samples=4000,
                                      seed=2)
        mj = JG.evaluate_mesh_geometry(pred, f, v, f, num_samples=4000,
                                       seed=2)
        assert mt.keys() == mj.keys()
        for k in mt:
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-6, err_msg=k)


# ----------------------------------------------------------------- z-buffer
W_Z, H_Z, F_Z = 80, 64, 60.0
K_Z = np.array([[F_Z, 0, W_Z / 2], [0, F_Z, H_Z / 2], [0, 0, 1]])


def _on_edge(verts, faces, pixels):
    """For each (y, x) pixel: does its centre lie within 1e-4 px of a
    projected face edge (where f32 edge functions of two evaluation orders
    may disagree on coverage)?"""
    u = F_Z * verts[:, 0] / verts[:, 2] + K_Z[0, 2] - 0.5
    v = F_Z * verts[:, 1] / verts[:, 2] + K_Z[1, 2] - 0.5
    out = []
    for y, x in pixels:
        near = False
        for a, b in ((0, 1), (1, 2), (2, 0)):
            ax, ay = u[faces[:, a]], v[faces[:, a]]
            dx, dy = u[faces[:, b]] - ax, v[faces[:, b]] - ay
            ln2 = dx * dx + dy * dy + 1e-12
            t = ((x - ax) * dx + (y - ay) * dy) / ln2
            d = np.abs(dx * (y - ay) - dy * (x - ax)) / np.sqrt(ln2)
            near |= bool(np.any((d < 1e-4) & (t > -1e-6) & (t < 1 + 1e-6)))
        out.append(near)
    return np.array(out)


def test_zbuffer_matches_reference(capsys):
    """render_mesh_depth of a marching-tets sphere at 80x64 (the setup of
    tests/test_mesh.py's z-buffer test): depth equal to the reference's
    within 1e-5 relative except at pixels whose centre lies exactly on a
    projected edge (5 of 740 here, on one diagonal edge: the reference's
    f32 edge functions leave a crack there and the back of the sphere
    shows through, the port's cover it); the same coverage mask; no
    footprint warning."""
    verts, faces = _sphere_mesh(M, r=0.5, n=48)
    verts = verts + np.array([0.0, 0.0, 2.0], verts.dtype)
    w2c = np.eye(4)
    dt = Z.render_mesh_depth(verts, faces, w2c, K_Z, W_Z, H_Z, chunk=16384,
                             device="cpu")
    dj = JZ.render_mesh_depth(verts, faces, w2c, K_Z, W_Z, H_Z, chunk=16384)
    assert "[zbuffer]" not in capsys.readouterr().out
    both = (dt > 0) & (dj > 0)
    assert both.sum() > 500
    np.testing.assert_array_equal(dt > 0, dj > 0)
    off = np.abs(dt - dj) > 1e-5 * dj
    assert off.sum() <= 5, np.argwhere(off)
    assert _on_edge(verts, faces, np.argwhere(off)).all()
    np.testing.assert_allclose(dt[both & ~off], dj[both & ~off], rtol=1e-5)


def test_zbuffer_footprint_cap_warns_like_reference(capsys):
    """A face wider than `cap` pixels is filled partially and counted: the
    same warning and the same depth in both packages."""
    verts = np.array([[-0.5, -0.4, 2.0], [0.6, -0.3, 2.2],
                      [0.0, 0.5, 1.8]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    dt = Z.render_mesh_depth(verts, faces, np.eye(4), K_Z, W_Z, H_Z,
                             chunk=64, device="cpu")
    out_t = capsys.readouterr().out
    dj = JZ.render_mesh_depth(verts, faces, np.eye(4), K_Z, W_Z, H_Z,
                              chunk=64)
    out_j = capsys.readouterr().out
    assert "1 faces exceeded the 8px footprint cap" in out_t
    assert out_t == out_j
    assert (dt > 0).sum() == (dj > 0).sum() > 10
    np.testing.assert_allclose(dt, dj, rtol=1e-5)


# --------------------------------------------------------------------- CLIs
def _write_config(cfg, path):
    with open(path, "w") as f:
        f.write(f"config = {cfg!r}\n")
    return str(path)


def _room_run(root, name):
    """A run directory holding params1.npz: the synthetic room's own
    Gaussians (800 per wall), saved by the port's save_checkpoint; and a
    config pointing at it (48x64 synthetic frames, primary_device cuda)."""
    pts, cols, quats, log_scales, logit_op = make_room_gaussians(
        np.random.default_rng(0), 800)
    cfg = dict(workdir=str(root), run_name=name, seed=0,
               primary_device="cuda",
               data=dict(dataset_name="synthetic", basedir="",
                         sequence="synthetic_room", desired_image_height=48,
                         desired_image_width=64, start=0, end=-1, stride=1,
                         num_frames=6))
    n = pts.shape[0]
    save_checkpoint(
        os.path.join(str(root), name), 1,
        {"means3D": pts, "rgb_colors": cols, "unnorm_rotations": quats,
         "logit_opacities": logit_op, "log_scales": log_scales},
        np.tile([[1.0], [0], [0], [0]], (1, 2)), np.zeros((3, 2)),
        np.zeros(n), np.eye(3), np.eye(4), 64, 48, [], [0])
    return _write_config(cfg, root / f"{name}.py")


def test_extract_and_eval_clis_match_reference(tmp_path, capsys):
    """extract_mesh_fast.main with --device cpu writes the reference's
    file set (mesh_thickened_1.{ply,obj,stl,txt}) with equal vertex and
    face counts, the same density stats (F64_TOL_TOY relative) and vertices
    within 1e-4 m (but 4 of 195,744 coordinates, where a cell edge joins
    two nearly equal densities and 1e-5 of the grid moves the crossing;
    those within a voxel); eval_mesh_geometry.main --render-eval --device
    cpu on
    one mesh gives the reference's geometry metrics (equal) and render-
    eval depth (1e-5 relative); without --device the card is required;
    --shard-devices 2 without a process group clamps to one rank and
    writes the same mesh (it named parallel/ until the port had it)."""
    cfg_t = _room_run(tmp_path, "port")
    cfg_j = _room_run(tmp_path, "jax")
    args = ["--voxel-size", "0.1", "--iso-level", "1.0"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EXT.main([cfg_t] + args)
    ply_s = EXT.main([cfg_t, "--device", "cpu", "--shard-devices", "2",
                      "--output", "sharded.ply"] + args)
    ply_t = EXT.main([cfg_t, "--device", "cpu"] + args)
    np.testing.assert_array_equal(IO.read_ply(ply_s)["faces"],
                                  IO.read_ply(ply_t)["faces"])
    ply_j = JEXT.main([cfg_j] + args)
    run_t, run_j = tmp_path / "port", tmp_path / "jax"
    assert os.path.basename(ply_t) == os.path.basename(ply_j) \
        == "mesh_thickened_1.ply"
    names = {p for p in os.listdir(run_t) if p.startswith("mesh")}
    assert names == {p for p in os.listdir(run_j) if p.startswith("mesh")}
    assert names == {f"mesh_thickened_1.{e}"
                     for e in ("ply", "obj", "stl", "txt")}
    mt, mj = IO.read_ply(ply_t), IO.read_ply(ply_j)
    assert mt["faces"].shape == mj["faces"].shape and len(mt["faces"]) > 500
    np.testing.assert_array_equal(mt["faces"], mj["faces"])
    dv = np.abs(mt["vertices"] - mj["vertices"])
    assert (dv > 1e-4).sum() <= 4 and dv.max() < 0.1, dv.max()
    for ext in ("obj", "stl"):
        assert abs(os.path.getsize(run_t / f"mesh_thickened_1.{ext}")
                   - os.path.getsize(run_j / f"mesh_thickened_1.{ext}")) \
            <= (0 if ext == "stl" else len(mt["vertices"]))

    def stats_line(run):
        lines = (run / "mesh_thickened_1.txt").read_text().splitlines()
        return eval(lines[-1].replace("null", "None"))
    st, sj = stats_line(run_t), stats_line(run_j)
    assert st["dims"] == sj["dims"]
    for k in ("density_min", "density_max", "density_mean"):
        np.testing.assert_allclose(st[k], sj[k], rtol=F64_TOL_TOY, atol=1e-9)

    gt = str(tmp_path / "gt.ply")
    GT.main(["--out", gt, "--subdiv", "24"])
    ev = ["--gt-mesh", gt, "--pred-mesh", ply_j, "--num-samples", "3000",
          "--render-eval", "--render-every", "3", "--render-max-frames",
          "2"]
    capsys.readouterr()
    rt = EVAL.main([cfg_t, "--device", "cpu"] + ev)
    rj = JEVAL.main([cfg_j] + ev)
    assert "[zbuffer]" not in capsys.readouterr().out
    for k in ("accuracy", "completion", "chamfer_distance", "f_score",
              "precision", "recall", "hausdorff_95", "completion_ratio"):
        assert rt[k] == rj[k], k
    assert 0 < rt["accuracy"] < 0.5        # 18 cm blobs: a thick shell
    assert rt["render_eval"]["frames"] == rj["render_eval"]["frames"] \
        == [0, 3]
    for k in ("depth_l1_cm", "depth_rmse_cm", "mean_overlap"):
        np.testing.assert_allclose(rt["render_eval"][k],
                                   rj["render_eval"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert rt["render_eval"]["mean_overlap"] > 0.3
    assert os.path.exists(run_t / "mesh_geometry_eval.json")
    # the port's own mesh is found by name and scored too
    rt2 = EVAL.main([cfg_t, "--gt-mesh", gt, "--num-samples", "3000"])
    np.testing.assert_allclose(rt2["accuracy"], rj["accuracy"], rtol=1e-2)


def test_export_ply_and_gt_mesh_byte_equal(tmp_path):
    """export_ply.main writes the reference's splat PLY byte for byte, and
    synth_gt_mesh.main the reference's ground-truth room."""
    cfg_t = _room_run(tmp_path, "port")
    cfg_j = _room_run(tmp_path, "jax")
    out_t, out_j = EXP.main([cfg_t]), JEXP.main([cfg_j])
    assert os.path.basename(out_t) == "splat_1.ply"
    with open(out_t, "rb") as a, open(out_j, "rb") as b:
        assert a.read() == b.read()
    gt_t, gt_j = tmp_path / "gt_t.ply", tmp_path / "gt_j.ply"
    assert GT.main(["--out", str(gt_t), "--subdiv", "5"]) == 0
    JGT.main(["--out", str(gt_j), "--subdiv", "5"])
    assert gt_t.read_bytes() == gt_j.read_bytes()
    m = IO.read_ply(str(gt_t))
    assert m["faces"].shape == (5 * 2 * 25, 3)
