"""rt_rs_tpu_torch's image and animation helpers (``utils/image.py``,
``utils/animation.py``) against the JAX package's.

``golden_diff_ok`` gives the JAX function's verdict on every case of
``tests/test_image_utils.py``; on one case it is meant to differ: in
edge-flip mode the JAX function drops the small-diff fraction bound, so
an image whose pixels are half off by one level passes there (ADVICE.md
r5), and the port keeps the bound.  ``write_png`` needs no PIL: its
files are read back through PIL here and must equal their input.  The
orbit GIF is PIL's palette encoding of the frames, so it is held to
``write_gif`` of the ``render_image`` sequence at the same cameras,
byte for byte.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from rt_rs_tpu.utils import image as jimage
from rt_rs_tpu_torch import Config, Renderer, Resolution
from rt_rs_tpu_torch.scene.camera import ORBIT_RATE
from rt_rs_tpu_torch.scene.presets import torus_scene
from rt_rs_tpu_torch.utils import animation, image

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)


def _golden():
    g = np.zeros((8, 8, 3), np.uint8)
    g[:4] = [200, 90, 90]  # bright top half, hard edge at row 4
    return g


def _set(y, x, value):
    def edit(img):
        img[y, x] = value
        return img

    return edit


def _row(y, value):
    def edit(img):
        img[y] = value
        return img

    return edit


EDGE = dict(allow_edge_flips=True, edge_px_frac=0.05)
# tests/test_image_utils.py's cases: name -> (edit of the golden, kwargs, verdict)
CASES = {
    "strict_equal": (lambda img: img, {}, True),
    "rounding_jitter": (_set(0, 0, [202, 92, 88]), {}, True),
    "edge_flip_without_flag": (_set(3, 5, 0), {}, False),
    "edge_flip_with_flag": (_set(3, 5, 0), EDGE, True),
    "interior_divergence": (_set(1, 5, 0), EDGE, False),
    "wrong_color_on_edge": (_set(3, 5, [0, 255, 0]), EDGE, False),
    "flip_budget": (_row(3, 0), EDGE, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_golden_diff_ok_verdicts_match_jax(case):
    edit, kw, verdict = CASES[case]
    img = edit(_golden())
    ours, detail = image.golden_diff_ok(img, _golden(), **kw)
    theirs, jdetail = jimage.golden_diff_ok(img, _golden(), **kw)
    assert ours == theirs == verdict
    assert detail == jdetail


def test_small_diff_bound_kept_in_edge_flip_mode():
    """The documented divergence: half the pixels 1 level off and no
    flipped pixel.  The JAX function accepts it in edge-flip mode ("0
    edge flips OK"); the port rejects it, as its strict check does."""
    g = np.full((16, 16, 3), 100, np.uint8)
    img = g.copy()
    img[::2] += 1  # every other row: 50% of the pixels off by 1
    assert not image.golden_diff_ok(img, g)[0]
    assert jimage.golden_diff_ok(img, g, **EDGE) == (True, "max 1 (50.00% px), 0 edge flips OK")
    ok, detail = image.golden_diff_ok(img, g, **EDGE)
    assert not ok and "50.00% of the other values off" in detail
    # A real edge flip beside a few 1-level differences still passes.
    img = _golden()
    img[3, 5] = 0
    img[6, 0] = 1
    assert image.golden_diff_ok(img, _golden(), **EDGE)[0]


@pytest.mark.parametrize("shape", [(1, 1), (23, 37), (64, 48)])
def test_write_png_reads_back_through_pil(tmp_path, shape):
    img = np.random.default_rng(shape[0]).integers(0, 256, (*shape, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    image.write_png(str(path), img)
    back = np.asarray(Image.open(path))
    assert back.dtype == np.uint8 and back.shape == img.shape
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(image.read_png(str(path)), img)
    assert path.read_bytes()[:8] == image.PNG_SIGNATURE


def test_write_png_refuses_other_images(tmp_path):
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8)):
        with pytest.raises(ValueError):
            image.write_png(str(tmp_path / "x.png"), bad)


def _renderer():
    return Renderer(
        torus_scene(segments=(24, 12)),
        config=Config(resolution=Resolution.sized(24, 16)),
        handler="pbvh",
        device="cpu",
    )


def test_render_orbit_gif_is_the_render_image_sequence(tmp_path):
    frames = 6
    r = _renderer()
    times = animation.render_orbit_gif(r, str(tmp_path / "sub" / "orbit.gif"), frames=frames)
    assert len(times) == frames and all(t > 0 for t in times)

    ref = _renderer()
    mult = 2.0 * np.pi / frames / ORBIT_RATE
    seq = []
    for _ in range(frames):
        seq.append(ref.render_image())
        ref.orbit(mult)
    assert r.camera == ref.camera
    animation.write_gif(str(tmp_path / "ref.gif"), seq)
    gif = (tmp_path / "sub" / "orbit.gif").read_bytes()
    assert gif == (tmp_path / "ref.gif").read_bytes()
    decoded = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(tmp_path / "ref.gif"))]
    assert len(decoded) == frames and decoded[0].shape == seq[0].shape
    # The palette encoding moves each colour by a few levels at most.
    assert max(np.abs(d.astype(int) - s).max() for d, s in zip(decoded, seq)) <= 16
    assert len({s.tobytes() for s in seq}) == frames  # the camera moved


def test_write_gif_refuses_no_frames(tmp_path):
    with pytest.raises(ValueError):
        animation.write_gif(str(tmp_path / "x.gif"), [])
