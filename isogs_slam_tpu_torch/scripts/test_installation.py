"""Installation / environment check of the PyTorch/CUDA package (counterpart
of isogs_slam_tpu/scripts/test_installation.py):

    python -m isogs_slam_tpu_torch.scripts.test_installation [--device cpu]

Checks, on --device (the card unless `--device cpu`): the card by name and
power limit, a differentiable render through the compositing kernels A
(forward) and B (backward) and the segment reduce C, the flat and iso
losses with hash KNN, mesh extraction, the native library (optional), and
config loading. Exits non-zero when any check fails.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

KERNELS = ("composite_fwd", "composite_bwd", "segreduce")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   help="device the checks run on (cuda or cpu)")
    args = p.parse_args(argv)
    ok = True

    def check(name, fn):
        nonlocal ok
        try:
            msg = fn()
            print(f"  [OK]   {name}" + (f" — {msg}" if msg else ""))
        except Exception as e:
            ok = False
            print(f"  [FAIL] {name}: {e.__class__.__name__}: {e}")

    print("== isogs_slam_tpu_torch installation check ==")
    dev = torch.device(args.device)

    def _device():
        from .. import resolve_device
        d = resolve_device(args.device)
        if d.type != "cuda":
            return (f"torch {torch.__version__}, device {d} (the kernels' "
                    f"plain PyTorch versions)")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        return (f"torch {torch.__version__} cuda {torch.version.cuda}, "
                f"{torch.cuda.device_count()} card(s); {smi}")
    check("device", _device)

    def _render():
        from ..core.camera import Camera
        from ..ops import _cuda
        from ..ops.rasterize import RasterConfig, render_rgbd_sil
        rng = np.random.default_rng(0)
        n = 500
        means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        means[:, 2] += 2.5
        means = torch.tensor(means, device=dev, requires_grad=True)
        quats = torch.tensor([1.0, 0, 0, 0], device=dev).repeat(n, 1)
        logs = torch.full((n, 3), float(np.log(0.08)), device=dev)
        ops = torch.ones((n, 1), device=dev)
        rgb = torch.tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32,
                           device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        cam = Camera(width=64, height=48, fx=48., fy=48., cx=31.5, cy=23.5)
        cfg = RasterConfig(max_per_tile=128, tile_chunk=12)
        before = dict(_cuda.LAUNCHES)
        im, d, s, _, _ = render_rgbd_sil(means, quats, logs, ops, rgb,
                                         alive, cam, cfg)
        v = torch.sum(im) + torch.sum(d)
        (g,) = torch.autograd.grad(v, means)
        v = float(v.detach())
        assert np.isfinite(v) and bool(torch.isfinite(g).all())
        if dev.type != "cuda":
            return f"loss={v:.2f}, plain versions on {dev}"
        ran = {k: sum(c - before.get(key, 0)
                      for key, c in _cuda.LAUNCHES.items()
                      if key.startswith(k)) for k in KERNELS}
        missing = [k for k, c in ran.items() if c <= 0]
        assert not missing, f"kernels not launched: {missing}"
        return f"loss={v:.2f}, kernel launches {ran}"
    check("differentiable render (fwd+bwd)", _render)

    def _losses():
        from ..ops.iso_loss import flat_loss, iso_surface_loss
        rng = np.random.default_rng(0)
        n = 2000
        means = torch.tensor(rng.uniform(-1, 1, (n, 3)),
                             dtype=torch.float32, device=dev)
        quats = torch.tensor([1.0, 0, 0, 0], device=dev).repeat(n, 1)
        logs = torch.full((n, 3), float(np.log(0.05)), device=dev)
        ops = torch.zeros((n, 1), device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        f = flat_loss(logs, alive)
        il, _ = iso_surface_loss(
            means, quats, logs, ops, alive, None, sample_size=256, k=8,
            generator=torch.Generator(device=dev).manual_seed(0))
        assert np.isfinite(float(f)) and np.isfinite(float(il))
        return f"flat={float(f):.4f}, iso={float(il):.4f}"
    check("IsoGS losses (flat + iso with hash KNN)", _losses)

    def _mesh():
        from ..mesh.marching import marching_tetrahedra
        lin = np.linspace(-1, 1, 24)
        X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
        dens = np.exp(-(X**2 + Y**2 + Z**2) / 0.2)
        v, f = marching_tetrahedra(dens, 0.5, (lin[1] - lin[0],) * 3,
                                   (-1,) * 3)
        assert len(f) > 100
        return f"{len(v)} verts / {len(f)} faces"
    check("mesh extraction", _mesh)

    def _native():
        from ..native_ext import available
        return "built" if available() else \
            "not built (optional; run native/build.sh)"
    check("native library", _native)

    def _configs():
        from ..slam.config import inject_defaults, load_experiment_config
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cfg = load_experiment_config(
            os.path.join(root, "configs", "replica", "splatam.py"))
        inject_defaults(cfg)
        return f"replica config OK (scene {cfg['run_name']})"
    check("experiment configs", _configs)

    print("\nAll checks passed." if ok else "\nSome checks FAILED.")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
