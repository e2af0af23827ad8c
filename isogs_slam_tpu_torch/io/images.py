"""Image files through Pillow (PIL is imported at first use).

The JAX package reads and writes its JPEG and PNG files with imageio, whose
plugin for these formats is Pillow: the same calls here write the same
bytes (JPEG at a given quality, 8-bit RGB and 16-bit grey PNG) and decode
to the same arrays, so the port needs Pillow alone.
"""
from __future__ import annotations

import numpy as np


def imread(path: str) -> np.ndarray:
    """[H, W] or [H, W, C] array of the file's pixels, in its own dtype
    (uint8, or uint16 for a 16-bit grey PNG); palette images are expanded
    to RGB(A), as imageio does."""
    from PIL import Image
    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        return np.asarray(im)


def imwrite(path: str, image: np.ndarray, quality: int | None = None):
    """Write `image` (uint8 [H, W, 3] or [H, W], or uint16 [H, W]); the
    format follows the file's extension; `quality` is JPEG's."""
    from PIL import Image
    kw = {} if quality is None else {"quality": int(quality)}
    Image.fromarray(np.asarray(image)).save(path, **kw)
