"""Bench for the compositing kernels (csrc/composite.cu) on one NVIDIA card:
times build variants of the kernel source against each other on the main
path's inputs, and counts how sparse those inputs are.

Run from the repository root (it takes the inputs from chip_smoke.py):

    python -m isogs_slam_tpu_torch.tools.composite_lab VARIANT [VARIANT ...]
    python -m isogs_slam_tpu_torch.tools.composite_lab --stats

A VARIANT is a comma-separated list of: a macro to define (`NAME` or
`NAME=VALUE`), the word `fmad` (build with FMA contraction, without
-fmad=false), or a path ending in .cu (another source with the same C
interface); the empty string "" is the package's kernel as built. Each
variant is compiled on its own, run forward and backward at K = 256 (f32
gradient) and K = 512 (bf16 gradient), held against the plain versions
(largest output error, pixels over chip_smoke.py's tolerance, largest
gradient error over its column's max) and timed with CUDA events (mean of
20 launches). Compare variants only within one call.

--stats prints, per input: the share of (slot, 8x4 pixel block) cells that
pass the kernels' block cull, the share that hold an included pair, the
included pixels per such cell, and how often a warp's include loop runs per
batch of 16 and of 32 slots (the largest count of included slots over a
block's 32 pixels).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from ..ops import _cuda
from ..ops import composite as comp


def _inputs(dev):
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    ds, cam, capacity, rcfg, rcfg_track = cs.scene(dev, n_frames=1)
    frames = [cs.load_frame(ds, i, dev) for i in range(2)]
    g_tr, b_tr, g_map, b_map = cs.composite_inputs(frames, cam, capacity,
                                                   rcfg, rcfg_track, dev)
    return cam.tiles_x, (("track", g_tr, b_tr.tile_count, torch.float32),
                         ("map", g_map, b_map.tile_count, torch.bfloat16))


def _build(spec: str, out_dir: str, idx: int) -> ctypes.CDLL:
    parts = [x for x in spec.split(",") if x]
    source = str(_cuda.CSRC / "composite.cu")
    flags = list(_cuda.NVCC_FLAGS)
    for x in parts:
        if x.endswith(".cu"):
            source = x
        elif x == "fmad":
            flags.remove("-fmad=false")
        else:
            flags.append(f"-D{x}")
    out = os.path.join(out_dir, f"libcomposite_{idx}.so")
    r = subprocess.run([_cuda.nvcc()] + flags + ["-o", out, source],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {spec!r}:\n{r.stdout}{r.stderr}")
    lines = (r.stdout + r.stderr).splitlines()
    for i, line in enumerate(lines):       # the F = 4 kernels' resources
        if "Compiling" in line and "Li4E" in line:
            used = next((u for u in lines[i + 1:i + 4] if "Used" in u), "")
            print(f"  {line.split('composite_')[-1][:28]}: {used.strip()}")
    lib = ctypes.CDLL(out)
    for fn, args in _cuda.SIGNATURES["composite"].items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def time_variants(specs, dev):
    tiles_x, inputs = _inputs(dev)
    rng = torch.Generator(device=dev).manual_seed(1)
    ref = {}
    with tempfile.TemporaryDirectory() as tmp:
        for idx, spec in enumerate(specs):
            print(f"variant {idx} {spec!r}")
            lib = _build(spec, tmp, idx)
            for tag, g, cnt, bdt in inputs:
                T, K, C = g.shape
                out = torch.empty((T, comp.P, 5), device=dev)
                ft = torch.empty((T, comp.P), device=dev)
                last = torch.empty((T, comp.P), dtype=torch.int32,
                                   device=dev)
                tend = torch.empty((T, comp.P), device=dev)
                dg = torch.empty((T, K, C), dtype=bdt, device=dev)
                if tag not in ref:
                    gout = torch.randn(out.shape, generator=rng, device=dev)
                    dfin = torch.randn(ft.shape, generator=rng, device=dev)
                    ref[tag] = (gout, dfin) + comp.composite_fwd_plain(
                        g, cnt, 4, tiles_x, 3, chunk=32) + (
                        comp.composite_bwd_plain(g, cnt, gout, dfin, 4,
                                                 tiles_x, 3, chunk=32),)
                gout, dfin, out_p, ft_p, dg_p = ref[tag]
                stream = _cuda.stream_ptr()

                def fwd():
                    return lib.composite_fwd(
                        g.data_ptr(), cnt.data_ptr(), T, K, 4, 3, tiles_x,
                        out.data_ptr(), ft.data_ptr(), last.data_ptr(),
                        tend.data_ptr(), stream)

                def bwd():
                    return lib.composite_bwd(
                        g.data_ptr(), cnt.data_ptr(), T, K, 4, 3, tiles_x,
                        gout.data_ptr(), dfin.data_ptr(), last.data_ptr(),
                        tend.data_ptr(), int(bdt == torch.bfloat16),
                        dg.data_ptr(), stream)

                _cuda.check(fwd(), "composite_fwd")
                _cuda.check(bwd(), "composite_bwd")
                torch.cuda.synchronize()
                err_o = (out - out_p).abs()
                tol = 1e-5 * max(1.0, float(out_p.abs().max()))
                bad = int((err_o > tol).any(-1).sum()
                          + ((ft - ft_p).abs() > 1e-5).sum())
                rel = float(((dg.float() - dg_p.to(bdt).float()).abs()
                             .amax(dim=(0, 1))
                             / dg_p.abs().amax(dim=(0, 1))).max())
                print(f"  [{tag} K={K}] fwd {_ms(fwd):.4f} ms (max err "
                      f"{float(err_o.max()):.1e}, pixels over tol {bad}); "
                      f"bwd {bdt} {_ms(bwd):.4f} ms (err / column max "
                      f"{rel:.1e})")


def sparsity_stats(dev, chunk=64):
    tiles_x, inputs = _inputs(dev)
    pix = torch.arange(comp.P, device=dev)
    block = ((pix // comp.TILE) // comp.BH) * (comp.TILE // comp.BW) \
        + (pix % comp.TILE) // comp.BW
    order = torch.argsort(block * comp.P + pix)     # pixels block by block
    nblk, per = comp.P // 32, 32
    for tag, g, cnt, _ in inputs:
        T, K, _ = g.shape
        ox, oy = comp._origins(T, tiles_x, dev)
        slots = passed = active = incl = 0
        iters = {16: 0, 32: 0}
        batches = {16: 0, 32: 0}
        for s in range(0, T, chunk):
            gg, cc = g[s:s + chunk], cnt[s:s + chunk]
            _, alpha, contrib = comp._pair_alpha(gg, cc, ox[s:s + chunk],
                                                 oy[s:s + chunk])
            include = comp._transmittance(alpha, contrib)[3]
            ok = comp.block_cull_pass(gg, ox[s:s + chunk], oy[s:s + chunk])
            valid = torch.arange(K, device=dev)[None, :] < cc[:, None]
            ok = ok[:, :, order].reshape(-1, K, nblk, per)[..., 0]
            inc = include[:, :, order].reshape(-1, K, nblk, per)
            slots += int(valid.sum())
            passed += int((ok & valid[..., None]).sum())
            active += int(inc.any(-1).sum())
            incl += int(inc.sum())
            for bs in (16, 32):
                lanes = inc.reshape(inc.shape[0], K // bs, bs, nblk,
                                    per).sum(2)
                iters[bs] += int(lanes.amax(-1).sum())
                batches[bs] += int(((cc + bs - 1) // bs).sum()) * nblk
        print(f"[{tag} K={K}] slots {slots}; cells passing the cull "
              f"{passed / (nblk * slots):.4f}; cells with an included pair "
              f"{active / (nblk * slots):.4f}; included pixels per such "
              f"cell {incl / active:.2f}; include-loop runs per warp and "
              f"batch of 16 slots {iters[16] / batches[16]:.2f}, of 32 "
              f"slots {iters[32] / batches[32]:.2f}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("composite_lab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    if argv and argv[0] == "--stats":
        sparsity_stats(dev)
    else:
        time_variants(argv or [""], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
