"""rt_rs_tpu_torch's web viewer (``web/``): the cases of
``tests/test_web.py`` (live updates, error recovery, pacing, the
unloaded start), on scenes written into a temporary directory and
rendered with ``device="cpu"``, and the viewer against the JAX
package's through the same posts.  Every request has a timeout, and
every renderer the viewer builds stays on the state's device.
"""

from __future__ import annotations

import io
import json
import os
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from rt_rs_tpu.web import WebState as JaxWebState
from rt_rs_tpu.web import make_server as jax_make_server
from rt_rs_tpu_torch.config import Config, Resolution
from rt_rs_tpu_torch.scene.presets import torus_scene
from rt_rs_tpu_torch.web import WebState, make_server

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

TIMEOUT = 120
DEFAULT_PRIMS = 66  # torus_scene(segments=(8, 4)): 64 + the floor's 2


@pytest.fixture(scope="module")
def scenes_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    torus_scene(segments=(8, 4)).save(str(d / "default.json"))
    torus_scene(segments=(12, 6), floor_y=-2.0).save(str(d / "teatime.json"))
    (d / "default.bvh.json").write_text("{}")  # a checkpoint, not a scene
    return d


@pytest.fixture(scope="module")
def server(scenes_dir):
    state = WebState(str(scenes_dir / "default.json"), handler="naive", size=(32, 24), device="cpu")
    srv = make_server(state, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", state
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=TIMEOUT) as r:
        return r.status, r.read()


def _post(base, path, body=b"{}"):
    req = urllib.request.Request(base + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, r.read()


def _decode(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def _status(base) -> dict:
    return json.loads(_get(base, "/status")[1])


def test_index_and_scenes(server):
    base, _ = server
    status, body = _get(base, "/")
    assert status == 200 and b"rt_rs_tpu_torch viewer" in body
    names = json.loads(_get(base, "/scenes")[1])
    assert names == ["default", "teatime"]  # bvh checkpoints are not scenes


def test_frame_png(server):
    base, state = server
    status, body = _get(base, "/frame.png")
    assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
    frame = _decode(body)
    assert frame.shape == (24, 32, 3) and frame.any()
    np.testing.assert_array_equal(frame, state.renderer.render_image())
    s = _status(base)
    assert s["handler"] == "Naive" and s["frame_ms"] > 0


def test_scene_switch_and_failure_recovery(server):
    base, state = server
    # An unknown scene: the next frame keeps the old scene, with a note
    # (web.rs:128-139).
    _post(base, "/scene?name=does_not_exist")
    _get(base, "/frame.png")
    assert "failed to load scene" in _status(base)["note"]
    assert state.renderer.scene.num_prims == DEFAULT_PRIMS
    # A valid switch loads, renders the new scene and clears the note.
    _post(base, "/scene?name=teatime")
    frame = _decode(_get(base, "/frame.png")[1])
    assert state.renderer.scene.num_prims == 2 * 12 * 6 + 2
    np.testing.assert_array_equal(frame, state.renderer.render_image())
    assert _status(base)["note"] == ""
    _post(base, "/scene?name=default")
    _get(base, "/frame.png")
    assert state.renderer.scene.num_prims == DEFAULT_PRIMS


def test_config_update(server):
    base, state = server
    _post(base, "/config", json.dumps({"bounces": 1}).encode())
    _get(base, "/frame.png")
    assert state.renderer.config.compute.bounces == 1
    assert state.renderer.config.compute.t_max == 1000.0  # partial update keeps defaults
    _post(base, "/config", json.dumps({"bounces": 4}).encode())
    _get(base, "/frame.png")


def test_viewport_update(server):
    base, state = server
    _post(base, "/viewport", json.dumps({"width": 16, "height": 12}).encode())
    status, body = _get(base, "/frame.png")
    assert status == 200 and _decode(body).shape == (12, 16, 3)
    assert state.renderer.width == 16 and state.renderer.height == 12
    assert state.renderer.device == torch.device("cpu")


def test_viewport_bounds_rejected(server):
    base, state = server
    w0, h0 = state.renderer.width, state.renderer.height
    for bad in ({"width": 0, "height": 240}, {"width": 320, "height": -8},
                {"width": 65536, "height": 240}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/viewport", json.dumps(bad).encode())
        assert e.value.code == 400
    _get(base, "/frame.png")
    assert (state.renderer.width, state.renderer.height) == (w0, h0)


def test_malformed_bodies_rejected(server):
    base, _ = server
    for path, body in (("/config", b"not json"), ("/viewport", b"{}"), ("/key", b"[1]")):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, path, body)
        assert e.value.code == 400


def test_orbit_keys(server):
    base, state = server
    cam_before = state.renderer.camera.pos
    _post(base, "/key", json.dumps({"key": "left", "pressed": True}).encode())
    _get(base, "/frame.png")
    _get(base, "/frame.png")
    _post(base, "/key", json.dumps({"key": "left", "pressed": False}).encode())
    assert state.renderer.camera.pos != cam_before


def test_config_survives_viewport_and_scene_switch(server):
    base, state = server
    _post(base, "/config", json.dumps({"bounces": 3}).encode())
    _get(base, "/frame.png")
    assert state.renderer.config.compute.bounces == 3
    _post(base, "/viewport", json.dumps({"width": 20, "height": 16}).encode())
    _get(base, "/frame.png")
    assert state.renderer.config.compute.bounces == 3
    _post(base, "/scene?name=default")
    _get(base, "/frame.png")
    assert state.renderer.config.compute.bounces == 3
    assert state.renderer.device == torch.device("cpu")


def test_scene_name_traversal_rejected(server):
    base, _ = server
    bad = urllib.parse.quote("../../etc/passwd")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, f"/scene?name={bad}", b"")
    assert e.value.code == 400


def test_unloaded_start(scenes_dir):
    """scene_path=None starts unloaded (Scene::Unloaded): black frames
    until a scene is picked, then a normal load."""
    with pytest.raises(ValueError):
        WebState(None, device="cpu")
    state = WebState(None, scene_dir=str(scenes_dir), handler="naive", size=(16, 12), device="cpu")
    assert state.renderer.scene.is_unloaded
    img = _decode(state.render_frame_png())
    assert img.shape == (12, 16, 3) and (img == 0).all()
    state._pending_scene = "default"
    state.render_frame_png()
    assert not state.renderer.scene.is_unloaded
    assert state.renderer.scene.num_prims == DEFAULT_PRIMS


def test_frame_pacing_gate(scenes_dir):
    """Requests faster than the configured fps get the cached frame
    without a render; pending updates force one."""
    state = WebState(
        str(scenes_dir / "default.json"), handler="naive", size=(16, 12),
        config=Config(resolution=Resolution.sized(16, 12), fps=1), device="cpu",
    )
    png1 = state.render_frame_png()
    ms1 = state.frame_ms
    png2 = state.render_frame_png()  # within the 1 fps window
    assert png2 is png1 and state.frame_ms == ms1
    state._pending_config = {"bounces": 1}
    state.render_frame_png()
    assert state.renderer.config.compute.bounces == 1


def test_default_handler_is_pbvh(scenes_dir):
    state = WebState(str(scenes_dir / "default.json"), size=(16, 12), device="cpu")
    assert state.handler == "pbvh" and state.renderer.stats.name == "Packet-BVH"
    frame = _decode(state.render_frame_png())
    np.testing.assert_array_equal(frame, state.renderer.render_image())


def _serve(state):
    srv = make_server(state, port=0) if isinstance(state, WebState) else jax_make_server(state, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread, f"http://127.0.0.1:{srv.server_address[1]}"


def test_viewer_matches_jax(scenes_dir):
    """The port's viewer and the JAX package's, the naive handler at
    32x24 on the same scene files, through the same mailbox posts: a
    config update, a viewport change, a scene switch and a bad scene
    name.  After each, both serve the same frame and the same status
    (all but the measured ``frame_ms``)."""
    states = [
        WebState(str(scenes_dir / "default.json"), handler="naive", size=(32, 24), device="cpu"),
        JaxWebState(str(scenes_dir / "default.json"), handler="naive", size=(32, 24)),
    ]
    served = [_serve(s) for s in states]
    steps = [
        ("start", None, b""),
        ("config", "/config", json.dumps({"bounces": 1}).encode()),
        ("viewport", "/viewport", json.dumps({"width": 24, "height": 16}).encode()),
        ("scene switch", "/scene?name=teatime", b""),
        ("bad scene name", "/scene?name=does_not_exist", b""),
    ]
    try:
        for what, path, body in steps:
            frames, status = [], []
            for _, _, base in served:
                if path is not None:
                    _post(base, path, body)
                frames.append(_decode(_get(base, "/frame.png")[1]))
                status.append(_status(base))
            ours, ref = frames
            assert ours.shape == ref.shape and ours.any(), what
            np.testing.assert_array_equal(ours, ref, err_msg=what)
            assert all(s.pop("frame_ms") > 0 for s in status), what
            assert status[0] == status[1], what
        assert "failed to load scene 'does_not_exist'" in status[0]["note"]
        assert ours.shape == (16, 24, 3) and states[0].renderer.scene.num_prims == 2 * 12 * 6 + 2
    finally:
        for srv, thread, _ in served:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=TIMEOUT)
    assert not any(thread.is_alive() for _, thread, _ in served)
