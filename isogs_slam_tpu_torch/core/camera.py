"""Pinhole camera + static rasterizer geometry (counterpart of
isogs_slam_tpu/core/camera.py; numpy only).

u = fx*x/z + cx, v = fy*y/z + cy (OpenCV convention, the same pixel model
the back-projection uses).
"""
from __future__ import annotations

import dataclasses

import numpy as np

TILE = 16  # rasterizer tile edge in pixels


@dataclasses.dataclass(frozen=True)
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    near: float = 0.01
    far: float = 100.0

    @property
    def tiles_x(self) -> int:
        return (self.width + TILE - 1) // TILE

    @property
    def tiles_y(self) -> int:
        return (self.height + TILE - 1) // TILE

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def tanfovx(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tanfovy(self) -> float:
        return self.height / (2.0 * self.fy)

    @staticmethod
    def from_intrinsics(K, width: int, height: int, near: float = 0.01,
                        far: float = 100.0) -> "Camera":
        K = np.asarray(K)
        return Camera(width=int(width), height=int(height),
                      fx=float(K[0, 0]), fy=float(K[1, 1]),
                      cx=float(K[0, 2]), cy=float(K[1, 2]),
                      near=near, far=far)

    def scaled(self, width: int, height: int) -> "Camera":
        """Rescale intrinsics to a new resolution (dataset-layer
        semantics)."""
        sx = width / self.width
        sy = height / self.height
        return Camera(width=width, height=height,
                      fx=self.fx * sx, fy=self.fy * sy,
                      cx=self.cx * sx, cy=self.cy * sy,
                      near=self.near, far=self.far)

    def intrinsics_matrix(self) -> np.ndarray:
        K = np.eye(3, dtype=np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = self.fx, self.fy, self.cx, self.cy
        return K


def setup_camera(w: int, h: int, k, w2c=None, near: float = 0.01,
                 far: float = 100.0) -> Camera:
    """The reference's `setup_camera` signature: a Camera from the
    intrinsics `k` (3x3 array or tensor, on any device). `w2c` is taken
    for signature parity only: the renderer consumes camera-frame
    Gaussians, and the pose is applied by transform_to_frame."""
    k = np.asarray(k.detach().cpu() if hasattr(k, "detach") else k)
    return Camera(width=int(w), height=int(h), fx=float(k[0][0]),
                  fy=float(k[1][1]), cx=float(k[0][2]), cy=float(k[1][2]),
                  near=near, far=far)
