"""PyTorch/CUDA port of isogs_slam_tpu (Gaussian-splatting SLAM).

The module layout mirrors the JAX package (`core/`, `ops/`, `slam/`,
`utils/`, `datasets/`) so each function has an obvious counterpart. The
per-tile compositing forward/backward and the segment reduce are CUDA C++
kernels for Hopper (`csrc/`), built with nvcc at first use; every other
step is plain PyTorch.

Float32 matrix products and convolutions stay true f32 on the card: the
SSIM band-matrix filter and the KNN distances are computed with matmuls,
and TF32 would bring back the rounding bias the reference removed from its
SSIM (ops/ssim.py).
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; without a
    card the caller must ask for the CPU explicitly (the CPU runs the
    kernels' plain PyTorch versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev
