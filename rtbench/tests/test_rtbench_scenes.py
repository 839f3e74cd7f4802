"""The frozen scene arithmetic equals the program's presets bit for bit
(today: the presets may change later, the frozen copy may not)."""

import pytest

from rtbench import scenes, spec

# configuration -> the preset it was frozen from
PRESETS = {"teatime": lambda p: p.torus_scene(), "teapots3": lambda p: p.torus_row(3)}
FIELDS = (
    "vert_pos", "vert_norm", "prim_indices", "prim_material", "light_pos",
    "light_strength", "mat_color", "mat_albedo", "mat_spec",
)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_frozen_scene_equals_preset(name):
    from rt_rs_tpu_torch.scene import presets

    config = spec.config(spec.benchmark(), name)
    mine = scenes.build(config)
    theirs = PRESETS[name](presets)
    for f in FIELDS:
        a, b = getattr(mine, f), getattr(theirs, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert mine.camera_pos == tuple(theirs.camera.pos)
    assert mine.camera_at == tuple(theirs.camera.at)
    assert mine.num_prims == config["triangles"]
    assert len(mine.light_strength) == len(config["lights"]["strength"])
    assert config["compute"]["bounces"] == config["bounces"]
