"""The plain reference against the frozen NumPy oracle (a copy of the
repository's ``tests/oracle.py``) at a tiny size, and the control: the
reference in bfloat16, in the program's place, comes out not correct."""

import types

import numpy as np
import torch

from rtbench import check, scenes, spec
from rtbench.reference import Reference, orbit_camera
from rtbench.tests.oracle_np import FastOracle

W, H = 12, 9


def frame(name, dtype=torch.float32, angle=0.7):
    config = spec.config(spec.benchmark(), name)
    scene = scenes.build(config)
    pos = orbit_camera(scene.camera_pos, scene.camera_at, angle)
    ref = Reference(scene, config["compute"], "cpu", dtype)
    (colors,) = ref.frames([(pos, scene.camera_at, np.arange(W * H))], W, H)
    return scene, config, pos, colors.reshape(H, W, 3)


def test_reference_matches_the_oracle():
    scene, config, pos, mine = frame("teatime")
    cfg = types.SimpleNamespace(**config["compute"])
    cam = tuple(np.float32(v) for v in pos)
    oracle = FastOracle(scene, cfg).render(W, H, cam, scene.camera_at)
    assert (oracle.max(-1) > 0).mean() > 0.3  # the frame is not empty
    assert np.abs(mine - oracle).max() < 2e-5


def test_reference_blocks_do_not_change_the_frame(monkeypatch):
    from rtbench import reference

    _, _, _, whole = frame("teatime")
    monkeypatch.setattr(reference, "PAIRS_PER_BLOCK", 1500)  # many ray and triangle blocks
    _, _, _, blocked = frame("teatime")
    assert np.array_equal(whole, blocked)


def test_control_is_not_correct():
    """The control at a size a test run holds: the bfloat16 reference in
    the program's place fails the teatime cells' limits."""
    _, _, _, want = frame("teatime")
    _, _, _, got = frame("teatime", torch.bfloat16)
    values, _ = check.numbers([(got.reshape(-1, 3), want.reshape(-1, 3))])
    for cell in ("teatime.orbit_1080", "teatime.orbit_384"):
        ok, _ = check.verdict(values, spec.limits(cell))
        assert not ok


def test_the_reference_against_itself_is_correct():
    _, _, _, want = frame("teatime")
    values, _ = check.numbers([(want.reshape(-1, 3), want.reshape(-1, 3))])
    assert values == {"bad_px": 0.0, "worst_frame": 0.0}
