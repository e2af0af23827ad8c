"""LPIPS (AlexNet variant) in PyTorch (counterpart of
isogs_slam_tpu/eval/lpips_jax.py).

The network only: weights come from an .npz export pointed to by
$ISOGS_LPIPS_WEIGHTS (keys conv{0..4}_w (OIHW), conv{0..4}_b, lin{0..4}_w
[1, C, 1, 1]; `python -m isogs_slam_tpu_torch.eval.lpips --export out.npz`
writes one on a machine that has the `lpips` package), or from
`LPIPSAlex.random(seed)`, which draws them with numpy's default_rng exactly
as the JAX class does, so one seed gives one network in both packages.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

# AlexNet feature extractor: (out_ch, kernel, stride, pad), with a 3x3
# max-pool (stride 2) after convs 0 and 1
_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
          (256, 3, 1, 1), (256, 3, 1, 1)]
# ImageNet scaling used by lpips.LPIPS (its internal ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPSAlex:
    """Callable: (img1, img2) [C,H,W] in [0,1] -> LPIPS distance."""

    def __init__(self, weights_path: str, device="cuda"):
        data = np.load(weights_path)
        for i in range(5):
            for k in (f"conv{i}_w", f"conv{i}_b", f"lin{i}_w"):
                if k not in data:
                    raise KeyError(f"{weights_path} missing {k}")
        self._set({k: np.asarray(v) for k, v in data.items()}, device)

    def _set(self, params: dict, device):
        self.device = resolve_device(device)
        self.params = {k: torch.as_tensor(np.asarray(v, np.float32),
                                          device=self.device)
                       for k, v in params.items()}

    @classmethod
    def random(cls, seed: int = 0, device="cuda") -> "LPIPSAlex":
        """Untrained fallback: the same AlexNet topology with seeded
        He-normal conv weights and uniform (1/C) linear heads. Values are
        not comparable to pretrained-AlexNet LPIPS and are labeled
        `rand-alexnet` wherever reported."""
        rng = np.random.default_rng(seed)
        obj = cls.__new__(cls)
        params = {}
        in_ch = 3
        for i, (out_ch, k, _, _) in enumerate(_CONVS):
            fan_in = in_ch * k * k
            params[f"conv{i}_w"] = rng.normal(
                0.0, np.sqrt(2.0 / fan_in),
                (out_ch, in_ch, k, k)).astype(np.float32)
            params[f"conv{i}_b"] = np.zeros((out_ch,), np.float32)
            params[f"lin{i}_w"] = np.full((1, out_ch, 1, 1), 1.0 / out_ch,
                                          np.float32)
            in_ch = out_ch
        obj._set(params, device)
        return obj

    def _features(self, x):
        # [1,3,H,W] in [-1,1] -> list of 5 feature maps
        shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
        scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
        x = (x - shift) / scale
        feats = []
        for i, (_, _, stride, pad) in enumerate(_CONVS):
            x = torch.relu(F.conv2d(x, self.params[f"conv{i}_w"],
                                    self.params[f"conv{i}_b"],
                                    stride=stride, padding=pad))
            feats.append(x)
            if i in (0, 1):
                x = F.max_pool2d(x, 3, 2)
        return feats

    @torch.no_grad()
    def __call__(self, img1, img2) -> float:
        a = torch.as_tensor(img1, dtype=torch.float32, device=self.device)
        b = torch.as_tensor(img2, dtype=torch.float32, device=self.device)
        fa = self._features(a[None] * 2.0 - 1.0)
        fb = self._features(b[None] * 2.0 - 1.0)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / torch.sqrt(torch.sum(xa * xa, dim=1, keepdim=True)
                                 + 1e-10)
            nb = xb / torch.sqrt(torch.sum(xb * xb, dim=1, keepdim=True)
                                 + 1e-10)
            w = self.params[f"lin{i}_w"].reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum((na - nb) ** 2 * w, dim=1))
        return float(total)


def export_lpips_weights(out_path: str):  # pragma: no cover
    """Run on a machine with the `lpips` package to produce the npz."""
    import lpips as lpips_pkg  # type: ignore
    net = lpips_pkg.LPIPS(net="alex")
    out = {}
    convs = [m for m in net.net.modules()
             if m.__class__.__name__ == "Conv2d"]
    for i, c in enumerate(convs[:5]):
        out[f"conv{i}_w"] = c.weight.detach().numpy()
        out[f"conv{i}_b"] = c.bias.detach().numpy()
    for i, lin in enumerate([net.lin0, net.lin1, net.lin2, net.lin3,
                             net.lin4]):
        out[f"lin{i}_w"] = lin.model[-1].weight.detach().numpy()
    np.savez(out_path, **out)
    print(f"wrote {out_path}")


if __name__ == "__main__":  # pragma: no cover
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--export", type=str, required=True)
    export_lpips_weights(p.parse_args().export)
