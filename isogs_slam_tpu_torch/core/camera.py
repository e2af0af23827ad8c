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

    def intrinsics_matrix(self) -> np.ndarray:
        K = np.eye(3, dtype=np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = self.fx, self.fy, self.cx, self.cy
        return K
