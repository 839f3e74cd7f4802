"""PNG image IO and the golden comparison (counterpart of
``rt_rs_tpu/utils/image.py``).

Row 0 of the array is texture row ``y = 0``, matching the
storage-texture coordinates of ``compute.wgsl:284-293``.

:func:`golden_diff_ok` differs from the JAX package's on purpose: there,
``allow_edge_flips`` drops the small-diff fraction bound once the strict
check fails, so an image whose pixels are half off by 1 passes
(ADVICE.md r5); here the pixels that are not edge flips must still keep
under that bound.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray) -> bytes:
    """An ``[H, W, 3] uint8`` image as PNG bytes, with the standard
    library only: 8-bit RGB, every scanline with filter 0 (none)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] uint8 image, got {image.dtype} {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    return (
        PNG_SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an ``[H, W, 3] uint8`` image (:func:`encode_png`)."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def golden_diff_ok(
    img: np.ndarray,
    golden: np.ndarray,
    *,
    allow_edge_flips: bool = False,
    edge_px_frac: float = 0.005,
) -> tuple[bool, str]:
    """Compare a render against a golden image -> ``(ok, detail)``.

    The strict criterion: at most 2 levels off in any channel, and fewer
    than 2% of the values off at all.  With ``allow_edge_flips`` a
    budget (``edge_px_frac`` of the pixels) of pixels more than 2 levels
    off passes if each lies on a contrast edge of the golden (some
    8-neighbour of the golden matches the rendered value within 2
    levels: the render took the other side of a real boundary), and the
    other pixels still hold the 2% bound on values off."""
    img = img.astype(np.int64)
    golden = golden.astype(np.int64)
    diff = np.abs(img - golden)
    detail = f"max {diff.max()} ({(diff > 0).mean():.2%} px)"
    if diff.max() <= 2 and (diff > 0).mean() < 0.02:
        return True, detail
    if not allow_edge_flips:
        return False, detail
    flipped = diff.max(axis=-1) > 2
    rest = diff[~flipped]
    if rest.size and not (rest > 0).mean() < 0.02:
        return False, detail + f", {(rest > 0).mean():.2%} of the other values off"
    bad = np.argwhere(flipped)
    if len(bad) > edge_px_frac * diff.shape[0] * diff.shape[1]:
        return False, detail + f", {len(bad)} flipped px over budget"
    for y, x in bad:
        neigh = golden[max(y - 1, 0) : y + 2, max(x - 1, 0) : x + 2].reshape(-1, 3)
        if not (np.abs(neigh - img[y, x]).max(axis=-1) <= 2).any():
            return False, detail + f", non-edge divergence at ({y},{x})"
    return True, detail + f", {len(bad)} edge flips OK"
