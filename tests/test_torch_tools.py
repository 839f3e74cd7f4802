"""rt_rs_tpu_torch's CLI tools (``tools/``) and mesh presets against the
JAX package's.

Every input is written by the tests (the bundled meshes and scenes live
in the absent reference checkout): OBJ text and scene JSON of small
torus scenes.  ``construct``'s scene JSON and ``precompute``'s
checkpoints (the host build, and the LBVH of ``--device`` built on the
CPU) equal the JAX tools' byte for byte, the JAX tools on the CPU.
``debug_tree`` prints the same text and counts the same violations.
``load --out`` renders through the kernels' twins (``--device cpu``):
its PNG is held to the JAX ``load`` PNG within one level on at most
0.1% of the values (the frames agree within 2e-5, the repo's frame
rule, so a value may round to the other level); every case here is
equal.  ``--bands`` / ``--shards`` on ``--device cuda`` exit naming
the device count when there are too few cards, and render nothing (they
render on CPU ranks in tests/test_torch_parallel.py).  ``mesh_scene``, ``tiled_teapots`` and ``golden_set`` pack
equal to the JAX functions given the same directories.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rt_rs_tpu.bvh import BvhData as JaxBvhData
from rt_rs_tpu.scene import Scene as JaxScene
from rt_rs_tpu.scene import presets as jpresets
from rt_rs_tpu.tools import construct as jconstruct
from rt_rs_tpu.tools import debug_tree as jdebug_tree
from rt_rs_tpu.tools import load as jload
from rt_rs_tpu.tools import precompute as jprecompute
from rt_rs_tpu_torch.bvh import BvhData, build_bvh
from rt_rs_tpu_torch.scene import Scene, presets
from rt_rs_tpu_torch.scene.presets import ghost_scene, torus_scene
from rt_rs_tpu_torch.tools import construct, debug_tree, demo, load, precompute
from rt_rs_tpu_torch.utils.image import read_png

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# load's PNG against the JAX tool's: at most this share of the values
# one level off, none more.
PNG_OFF_SHARE = 1e-3

TETRA = """
v 0 0 0
v 1.5 0 0
v 0 1.25 0
v 0 0 0.75
vn 0 0 -1
vn 0.577350 0.577350 0.577350
f 1//1 3//1 2//1
f 1 2 4
f 1 4 3
f 2//2 3//2 4//2
"""
# a quad and a pentagon (fan triangulation) and a degenerate face
FANS = """
v 0 0 0
v 2 0 0
v 2 1.5 0
v 0 1.5 0.25
v 3 0 1
v 4 1 1
v 3.5 2 1.5
v 2.5 2 1
v 2 1 0.7
v 5 5 5
f 1 2 3 4
f 5 6 7 8 9
f 10 10 10
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory) -> pathlib.Path:
    """OBJ files and scene JSON of a small torus scene."""
    d = tmp_path_factory.mktemp("tools")
    (d / "tetra.obj").write_text(TETRA)
    (d / "fans.obj").write_text(FANS)
    torus_scene(segments=(24, 12)).save(str(d / "torus.json"))
    return d


@pytest.fixture
def jax_stdout(monkeypatch):
    """A buffer for the JAX debug_tree's text: its printers take
    ``out=sys.stdout`` as a default, bound to the stream of the moment
    the module was imported, so the test sets it."""
    buf = io.StringIO()
    for fn in (jdebug_tree.debug_aabb, jdebug_tree.debug_rf_aabb, jdebug_tree.check_tree):
        monkeypatch.setattr(fn, "__defaults__", fn.__defaults__[:-1] + (buf,))
    return buf


def _same_text(a: pathlib.Path, b: pathlib.Path) -> None:
    assert a.read_bytes() == b.read_bytes()


PICKS = [
    [],
    ["--handler-naive"],
    ["--handler-bvh"],
    ["--handler-bvh", "0.5"],
    ["--handler-bvh", "{path}"],
    ["--handler-bvh-rf"],
    ["--handler-bvh-rf", "0.1"],
    ["--handler-pbvh"],
    ["--handler-pbvh", "0.25"],
    ["--handler-naive", "--handler-bvh"],
    ["--handler-bvh", "/nope/missing"],
    ["--handler-pbvh", "not-a-number"],
]


@pytest.mark.parametrize("argv", PICKS, ids=[" ".join(a) or "none" for a in PICKS])
def test_pick_handler_matches_jax(files, argv):
    argv = [a.format(path=files / "torus.json") for a in argv]

    def pick(tool):
        try:
            return tool.pick_handler(tool.build_parser().parse_args(argv))
        except SystemExit as e:
            return ("exit", str(e.code))

    assert pick(load) == pick(jload)


CONSTRUCT = {
    "default_orbit": [
        "--model", "{d}/tetra.obj", "default",
        "--light", "10", "10", "-10", "1.5",
        "--camera-pos", "0", "0", "-10", "0", "0", "0", "--camera-orbit",
    ],
    "materials_fixed": [
        "--model", "{d}/tetra.obj", "0", "--model", "{d}/fans.obj", "1",
        "--material", "0.2", "0.4", "0.6", "1", "0.5", "0", "8",
        "--material", "0.9", "0.9", "0.1", "1", "0", "0.5", "32",
        "--light", "50", "0", "0", "1.8", "--light", "0", "50", "0", "1.2",
        "--camera-pos", "5", "2", "-7", "0.5", "0", "0", "--camera-fixed",
    ],
    "no_light_mixed": [
        "--model", "{d}/fans.obj", "default", "--model", "{d}/tetra.obj", "0",
        "--camera-pos", "0", "3", "-9", "0", "0", "0", "--camera-orbit",
    ],
}


@pytest.mark.parametrize("case", sorted(CONSTRUCT))
def test_construct_json_byte_equal(files, tmp_path, case):
    argv = [a.format(d=files) for a in CONSTRUCT[case]]
    assert construct.main(["--out", str(tmp_path / "ours.json"), *argv]) == 0
    assert jconstruct.main(["--out", str(tmp_path / "jax.json"), *argv]) == 0
    _same_text(tmp_path / "ours.json", tmp_path / "jax.json")
    Scene.load(str(tmp_path / "ours.json"))


def test_construct_bad_material_index(files, tmp_path, capsys):
    argv = ["--out", str(tmp_path / "x.json"), "--model", str(files / "tetra.obj"), "red",
            "--camera-pos", "0", "0", "-5", "0", "0", "0", "--camera-orbit"]
    assert construct.main(argv) == jconstruct.main(argv) == 1
    assert not (tmp_path / "x.json").exists()


@pytest.mark.parametrize(
    "argv",
    [["--eps", "0.02", "--item-count", "2"], ["--eps", "0.5", "--item-count", "4"],
     ["--device", "--torch-device", "cpu"]],
    ids=["eps0.02_items2", "eps0.5_items4", "device"],
)
def test_precompute_checkpoint_byte_equal(files, tmp_path, capsys, argv):
    scene = str(files / "torus.json")
    assert precompute.main(["--scene", scene, "--out", str(tmp_path / "ours.bvh.json"), *argv]) == 0
    ours_line = capsys.readouterr().out.replace("ours", "?")
    jargv = [a for a in argv if a not in ("--torch-device", "cpu")]
    assert jprecompute.main(["--scene", scene, "--out", str(tmp_path / "jax.bvh.json"), *jargv]) == 0
    assert ours_line == capsys.readouterr().out.replace("jax", "?")
    _same_text(tmp_path / "ours.bvh.json", tmp_path / "jax.bvh.json")
    data = BvhData.load(str(tmp_path / "ours.bvh.json"))
    assert debug_tree.check_tree(data, Scene.load(scene)) == 0


def test_precompute_needs_item_count_on_the_host(files, tmp_path):
    with pytest.raises(SystemExit):
        precompute.main(["--scene", str(files / "torus.json"), "--out", str(tmp_path / "x.json")])


DEBUG = {
    "scene": ["--scene", "{d}/torus.json"],
    "scene_rf": ["--scene", "{d}/torus.json", "--rf"],
    "scene_check": ["--scene", "{d}/torus.json", "--check"],
    "bvh": ["--bvh", "{b}"],
    "bvh_rf": ["--bvh", "{b}", "--rf"],
    "bvh_check": ["--bvh", "{b}", "--check"],
}


@pytest.mark.parametrize("case", sorted(DEBUG))
def test_debug_tree_prints_like_jax(files, tmp_path, capsys, jax_stdout, case):
    bvh = tmp_path / "t.bvh.json"
    precompute.main(["--scene", str(files / "torus.json"), "--out", str(bvh), "--item-count", "2"])
    capsys.readouterr()
    argv = [a.format(d=files, b=bvh) for a in DEBUG[case]]
    rc = debug_tree.main(argv)
    ours = capsys.readouterr().out
    assert rc == jdebug_tree.main(argv) == 0
    assert ours == jax_stdout.getvalue()
    assert "check: 0 violations" in ours if case.endswith("check") else ours.count("\n") > 10


def test_debug_tree_counts_violations_like_jax(files, jax_stdout):
    scene = Scene.load(str(files / "torus.json"))
    jscene = JaxScene.load(str(files / "torus.json"))
    data = build_bvh(scene, eps=0.02, target_item_count=2)
    jdata = JaxBvhData.from_json(data.to_json())
    leaf = int(np.nonzero(data.item_count > 0)[0][0])
    node = int(np.nonzero(data.item_count == 0)[0][-1])
    counts = data.item_count.copy()
    counts[leaf] -= 1
    fst = data.fst.copy()
    fst[node] = 0  # a child link back to the root
    for bad, flagged in (
        (dataclasses.replace(data, item_count=counts), True),
        (dataclasses.replace(data, indices=np.zeros_like(data.indices)), True),
        (dataclasses.replace(data, fst=fst), False),
    ):
        jbad = JaxBvhData.from_json(bad.to_json())
        for sc, jsc in ((None, None), (scene, jscene)):
            ours = io.StringIO()
            n = debug_tree.check_tree(bad, sc, out=ours)
            assert n == jdebug_tree.check_tree(jbad, jsc)
            assert n > 0 or not flagged
            assert ours.getvalue() == jax_stdout.getvalue()
            jax_stdout.seek(0)
            jax_stdout.truncate()
    assert debug_tree.check_tree(data, scene, out=io.StringIO()) == 0
    assert jdebug_tree.check_tree(jdata, jscene) == 0


def _pngs_agree(ours: np.ndarray, ref: np.ndarray) -> int:
    d = np.abs(ours.astype(int) - ref.astype(int))
    assert ours.shape == ref.shape and d.max() <= 1
    assert (d > 0).mean() <= PNG_OFF_SHARE
    return int((d > 0).sum())


LOADS = {
    "pbvh": ["--handler-pbvh"],
    "bvh": ["--handler-bvh"],
    "bvh_path": ["--handler-bvh", "{b}"],
    "rf_bvh": ["--handler-bvh-rf"],
    "dynamic": ["--dynamic"],
}


@pytest.mark.parametrize("case", sorted(LOADS))
def test_load_png_matches_jax(files, tmp_path, case):
    bvh = tmp_path / "t.bvh.json"
    precompute.main(["--scene", str(files / "torus.json"), "--out", str(bvh), "--item-count", "2"])
    argv = ["--path", str(files / "torus.json"), "--width", "32", "--height", "24", "--frames", "2"]
    argv += [a.format(b=bvh) for a in LOADS[case]]
    assert load.main([*argv, "--out", str(tmp_path / "ours.png"), "--device", "cpu"]) == 0
    assert jload.main([*argv, "--out", str(tmp_path / "jax.png")]) == 0
    ours, ref = read_png(str(tmp_path / "ours.png")), read_png(str(tmp_path / "jax.png"))
    assert ours.shape == (24, 32, 3) and ours.any()
    assert _pngs_agree(ours, ref) == 0


def test_load_parser_matches_jax():
    """The port's ``load`` takes the JAX tool's options, with the same
    defaults, and adds only ``--device``."""
    def options(parser):
        return {
            a.dest: (tuple(a.option_strings), a.default, a.nargs, a.choices)
            for a in parser._actions if a.dest != "help"
        }

    ours, ref = options(load.build_parser()), options(jload.build_parser())
    assert set(ours) - set(ref) == {"device"} and set(ref) <= set(ours)
    assert {k: ours[k] for k in ref} == ref
    assert ours["device"][1] == "cuda"


def test_load_refuses_bands_and_shards(files, tmp_path, capsys, monkeypatch):
    """More ranks than cards on ``--device cuda``: the JAX tool's exit
    when the mesh exceeds its devices, naming the count."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "x.png"
    for flags, n in (
        (["--bands", "2"], 2), (["--shards", "2"], 2), (["--bands", "2", "--shards", "2"], 4),
    ):
        with pytest.raises(SystemExit) as e:
            load.main(["--path", str(files / "torus.json"), "--handler-pbvh", "--device", "cuda",
                       "--out", str(out), *flags])
        assert f"needs {n} devices; torch sees 1 CUDA device(s)" in str(e.value.code)
    assert not out.exists()
    assert "handler:" not in capsys.readouterr().out  # nothing was built


def test_load_benchmark_writes_chart(files, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rc = load.main([
        "--path", str(files / "torus.json"), "--width", "16", "--height", "16",
        "--benchmark", "--bench-frames", "20", "--device", "cpu",
    ])
    assert rc == 0
    assert (tmp_path / "benchmark.png").exists()
    assert "avg frame time over 20 frames" in capsys.readouterr().out


def test_load_gif_and_profile(files, tmp_path, capsys):
    """The GIF through the blank handler (``render_orbit_gif``'s frames
    are held in tests/test_torch_image_utils.py); the profile of one
    naive frame."""
    gif, prof = tmp_path / "o.gif", tmp_path / "prof"
    argv = ["--path", str(files / "torus.json"), "--width", "16", "--height", "12", "--device", "cpu"]
    assert load.main([*argv, "--gif", str(gif), "--frames", "24"]) == 0
    assert gif.read_bytes()[:6] == b"GIF89a"
    assert "(24 frames" in capsys.readouterr().out
    assert load.main([*argv, "--handler-naive", "--frames", "1", "--profile", str(prof)]) == 0
    assert (prof / "trace.json").stat().st_size > 0


def test_load_runs_as_a_module(files, tmp_path):
    """``python -m rt_rs_tpu_torch.tools.load`` (how the card's smoke run
    profiles it), and the demo tool, both with ``--device cpu``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = tmp_path / "m.png"
    proc = subprocess.run(
        [sys.executable, "-m", "rt_rs_tpu_torch.tools.load", "--path", str(files / "torus.json"),
         "--handler-pbvh", "--width", "16", "--height", "12", "--out", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    assert read_png(str(out)).shape == (12, 16, 3)
    small = tmp_path / "small.json"
    torus_scene(segments=(8, 4)).save(str(small))
    assert demo.main(["--path", str(small), "--out", str(tmp_path / "d.png"), "--frames", "1",
                      "--device", "cpu"]) == 0
    assert read_png(str(tmp_path / "d.png")).shape == (480, 640, 3)


@pytest.fixture(scope="module")
def reference_dirs(tmp_path_factory):
    """A meshes directory with the four MESH_VIEWS names (small OBJs; the
    cessna one with a degenerate face) and a scenes directory with a
    teatime.json."""
    d = tmp_path_factory.mktemp("reference")
    meshes, scenes = d / "meshes", d / "scenes"
    meshes.mkdir()
    scenes.mkdir()
    for name, text in (("dodecahedron", TETRA), ("magnolia", FANS), ("shuttle", TETRA),
                       ("cessna", FANS)):
        (meshes / f"{name}.obj").write_text(text)
    torus_scene(segments=(12, 6)).save(str(scenes / "teatime.json"))
    return str(meshes), str(scenes)


def _packs_equal(ours: Scene, theirs) -> None:
    assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())  # NaN normals too
    a, b = ours.pack(device="cpu"), theirs.pack()
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "no_negative_materials":
            assert x == y
            continue
        x, y = x.cpu().numpy(), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f.name


def test_mesh_presets_pack_like_jax(reference_dirs):
    meshes, scenes = reference_dirs
    assert presets.MESH_VIEWS == jpresets.MESH_VIEWS
    for name in presets.MESH_VIEWS:
        for lights in (True, False):
            (ours, nb), (theirs, jb) = (
                presets.mesh_scene(name, meshes, lights=lights),
                jpresets.mesh_scene(name, meshes, lights=lights),
            )
            assert nb == jb
            _packs_equal(ours, theirs)
    for n in (1, 3):
        _packs_equal(presets.tiled_teapots(n, scenes), jpresets.tiled_teapots(n, scenes))
    ours, theirs = presets.golden_set(meshes, scenes), jpresets.golden_set(meshes, scenes)
    assert sorted(ours) == sorted(theirs) == ["cessna", "ghost", "shuttle", "teapots3"]
    for name in ours:
        assert ours[name][1] == theirs[name][1]
        _packs_equal(ours[name][0], theirs[name][0])
    _packs_equal(ghost_scene(-1), jpresets.ghost_scene(-1))


NEW_MODULES = (
    "rt_rs_tpu_torch.timing",
    "rt_rs_tpu_torch.tools.construct",
    "rt_rs_tpu_torch.tools.debug_tree",
    "rt_rs_tpu_torch.tools.demo",
    "rt_rs_tpu_torch.tools.load",
    "rt_rs_tpu_torch.tools.precompute",
    "rt_rs_tpu_torch.utils.animation",
    "rt_rs_tpu_torch.utils.image",
    "rt_rs_tpu_torch.web",
    "rt_rs_tpu_torch.web.__main__",
)


def test_port_imports_neither_jax_nor_the_jax_package():
    """No import line of the port or of chip_smoke.py names jax or
    rt_rs_tpu, and importing the tools, timing, web and utils modules
    in a fresh interpreter loads neither."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|rt_rs_tpu)(\.|\s|$)", re.M)
    files = sorted((ROOT / "rt_rs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders
    code = (
        "import importlib, sys\n"
        f"for m in {NEW_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'rt_rs_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
