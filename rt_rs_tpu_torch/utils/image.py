"""PNG image IO (counterpart of ``rt_rs_tpu/utils/image.py``).

Row 0 of the array is texture row ``y = 0``, matching the
storage-texture coordinates of ``compute.wgsl:284-293``.
"""

from __future__ import annotations

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write an ``[H, W, 3] uint8`` image."""
    from PIL import Image

    Image.fromarray(image, mode="RGB").save(path)


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))
