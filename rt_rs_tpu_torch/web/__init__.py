"""Interactive web viewer (counterpart of ``rt_rs_tpu/web/__init__.py``).

The reference ships a WASM build driven by a JS shell
(``src/lib/web.rs``, ``js/index.js``): the canvas renders in-browser
and the page pushes config / scene / viewport updates into static
mailboxes that the event loop applies between frames
(web.rs:38-59, 115-148).  Here a small HTTP server takes its place: the
browser polls ``/frame.png`` while POSTing the same three update kinds,
and frames render on the renderer's device (``cuda`` unless the caller
names another).

Behaviour kept from the reference:

* updates are mailboxes applied between frames (never mid-frame);
* a scene or viewport that fails to load keeps the previous one live
  and surfaces a DOM note (web.rs:128-139, state/mod.rs:228-290); the
  device is never switched;
* requests faster than the configured fps get the previous frame
  (the reference's ``scheduler.ready()`` gate, state/mod.rs:653-657);
* viewport resizes are debounced 300 ms client-side (js/index.js:16-30);
* arrow keys drive the orbit camera controller (camera.rs:139-165).

Renders run in the server's request threads, one at a time under
``WebState.lock``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs

from rt_rs_tpu_torch.config import ComputeConfig, Config, Resolution
from rt_rs_tpu_torch.renderer import Renderer
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.timing import DefaultScheduler
from rt_rs_tpu_torch.utils.image import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>rt_rs_tpu_torch</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:1rem; }
img { image-rendering:pixelated; width:640px; border:1px solid #444; }
button { margin-right:.5rem; }
#note { color:#f66; }
</style></head><body>
<h3>rt_rs_tpu_torch viewer</h3>
<div id="scenes"></div>
<p><img id="frame" alt="frame"></p>
<div>status: <span id="status">-</span> <span id="note"></span></div>
<script>
const frame = document.getElementById('frame');
const note = document.getElementById('note');
// Fixed-timestep pacing (mod.rs:324-417 parity): target the server's
// configured fps; a slow frame just starts the next one immediately
// (the accumulator's death-spiral guard collapses to "never sleep
// negative time" since we only ever render one frame per iteration).
async function loop() {
  let fps = 60;
  let url = null;
  for (;;) {
    const t0 = performance.now();
    // One transient failure (server busy in a recompile after a
    // scene/viewport POST) must not kill the polling loop.
    try {
      const r = await fetch('/frame.png?t=' + Date.now());
      const next = URL.createObjectURL(await r.blob());
      frame.src = next;
      if (url) URL.revokeObjectURL(url);  // one live blob, not one/frame
      url = next;
      const s = await (await fetch('/status')).json();
      fps = s.fps || fps;
      document.getElementById('status').textContent =
        `${s.handler} (${s.size} B) ${s.frame_ms.toFixed(1)} ms`;
      note.textContent = s.note || '';
    } catch (e) {
      note.textContent = 'fetch failed: ' + e;
    }
    const wait = 1000 / fps - (performance.now() - t0);
    if (wait > 0) await new Promise(res => setTimeout(res, wait));
  }
}
// scene buttons (js/index.js:32-58 parity)
fetch('/scenes').then(r => r.json()).then(names => {
  const div = document.getElementById('scenes');
  for (const n of names) {
    const b = document.createElement('button');
    b.textContent = n;
    b.onclick = () => fetch('/scene?name=' + n, {method:'POST'});
    div.appendChild(b);
  }
});
// orbit keys (camera.rs:139-165 parity)
addEventListener('keydown', e => keyev(e, true));
addEventListener('keyup', e => keyev(e, false));
function keyev(e, pressed) {
  const k = {ArrowLeft:'left', ArrowRight:'right'}[e.key];
  if (k) fetch('/key', {method:'POST',
    body: JSON.stringify({key:k, pressed})});
}
// resize debounce 300ms (js/index.js:16-30 parity: the reference
// posts window.innerWidth/innerHeight)
let t = null;
addEventListener('resize', () => {
  clearTimeout(t);
  t = setTimeout(() => fetch('/viewport', {method:'POST',
    body: JSON.stringify({width: window.innerWidth,
                          height: window.innerHeight})}), 300);
});
loop();
</script></body></html>
"""


class WebState:
    """Renderer + mailboxes (the ``static mut WEB_STATE`` analogue)."""

    def __init__(
        self,
        scene_path: str | None,
        scene_dir: str | None = None,
        handler: str = "pbvh",
        size: tuple[int, int] = (320, 240),
        config: Config | None = None,
        device: str = "cuda",
    ):
        """``scene_path=None`` starts the viewer unloaded (the wasm
        app's ``Scene::Unloaded`` start state, web.rs:115-148 +
        scene/mod.rs:16-27): a black placeholder frame until the user
        picks a scene; ``scene_dir`` is then required.  Every renderer
        the viewer builds renders on ``device``."""
        if scene_path is None and scene_dir is None:
            raise ValueError("scene_dir is required when starting unloaded")
        self.scene_dir = Path(scene_dir or Path(scene_path).parent)
        self.handler = handler
        self.device = device
        self.config = config or Config(resolution=Resolution.sized(*size))
        self.size = size
        self.lock = threading.Lock()
        self.note = ""
        self.frame_ms = 0.0
        self._keys = {"left": False, "right": False}
        self._last_frame_time = time.perf_counter()
        # Requests arriving faster than the configured fps are answered
        # with the previous frame instead of a new render.
        self.scheduler = DefaultScheduler(fps=self.config.fps)
        self._cached_png: bytes | None = None

        self._pending_scene: str | None = None
        self._pending_config: dict | None = None
        self._pending_viewport: tuple[int, int] | None = None

        scene = Scene.unloaded() if scene_path is None else Scene.load(scene_path)
        self.renderer = self._renderer(scene, size)

    def _renderer(self, scene: Scene, size: tuple[int, int]) -> Renderer:
        return Renderer(
            scene, config=self.config, handler=self.handler, size=size, device=self.device
        )

    # -- mailbox appliers (web.rs:115-148) -----------------------------

    def _apply_updates(self) -> None:
        # Rebuilds carry live config updates forward (update_config
        # changes renderer.config, not self.config).
        self.config = self.renderer.config
        if self._pending_viewport is not None:
            w, h = self._pending_viewport
            self._pending_viewport = None
            try:
                self.renderer = self._renderer(self.renderer.scene, (w, h))
                self.size = (w, h)
                self.note = ""
            except Exception as e:  # noqa: BLE001 - keep the old viewport (web.rs:128-139)
                self.note = f"viewport update failed: {e}"
        if self._pending_config is not None:
            data = self._pending_config
            self._pending_config = None
            try:
                self.renderer.update_config(ComputeConfig.from_json(data))
                self.note = ""
            except Exception as e:  # noqa: BLE001 - surfaced as the DOM note
                self.note = f"config update failed: {e}"
        if self._pending_scene is not None:
            name = self._pending_scene
            self._pending_scene = None
            path = self.scene_dir / f"{name}.json"
            try:
                self.renderer = self._renderer(Scene.load(str(path)), self.size)
                self.note = ""
            except Exception as e:  # noqa: BLE001 - keep the old scene (state/mod.rs:263-287)
                self.note = f"failed to load scene {name!r}: {e}"

    def render_frame_png(self) -> bytes:
        with self.lock:
            # Pacing: a new frame only when the scheduler is ready, else
            # the cached one.  Pending updates (and held orbit keys)
            # force a render: a cached frame must never mask an applied
            # update.
            has_updates = (
                self._pending_scene is not None
                or self._pending_config is not None
                or self._pending_viewport is not None
                or any(self._keys.values())
            )
            if self._cached_png is not None and not has_updates and not self.scheduler.ready():
                return self._cached_png
            self._apply_updates()
            # Orbit keys: dt-scaled like the event loop
            # (mod.rs:342-353 + camera.rs:168-204).
            now = time.perf_counter()
            dt = min((now - self._last_frame_time) * 1000.0, 100.0)
            self._last_frame_time = now
            ctrl = self.renderer.camera_controller
            ctrl.left = self._keys["left"]
            ctrl.right = self._keys["right"]
            updated = ctrl.update(self.renderer.camera, dt)
            if updated is not None:
                self.renderer.camera = updated

            t0 = time.perf_counter()
            image = self.renderer.render_image()
            self.frame_ms = (time.perf_counter() - t0) * 1e3
            self.scheduler.frame_done()
            self._cached_png = encode_png(image)
            return self._cached_png

    def status(self) -> dict:
        return {
            "handler": self.renderer.stats.name,
            "size": self.renderer.stats.size,
            "frame_ms": self.frame_ms,
            "fps": self.config.fps,
            "note": self.note,
        }

    def scenes(self) -> list[str]:
        return sorted(
            p.stem for p in self.scene_dir.glob("*.json") if not p.name.endswith(".bvh.json")
        )


def make_server(state: WebState, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif path == "/frame.png":
                self._send(200, state.render_frame_png(), "image/png")
            elif path == "/status":
                self._send(200, json.dumps(state.status()).encode(), "application/json")
            elif path == "/scenes":
                self._send(200, json.dumps(state.scenes()).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b"{}"
            path, _, query = self.path.partition("?")
            try:
                # Mailbox writes hold the render lock: the server runs
                # POSTs concurrently with render_frame_png, whose
                # read-then-clear of _pending_* would otherwise lose an
                # update landing between the two.
                if path == "/scene":
                    name = parse_qs(query).get("name", [""])[0]
                    # Scene names are bare file stems; reject anything
                    # that could escape the scene directory.
                    if not name.replace("-", "").replace("_", "").isalnum():
                        self._send(400, b"invalid scene name", "text/plain")
                        return
                    with state.lock:
                        state._pending_scene = name
                elif path == "/config":
                    data = json.loads(body)
                    with state.lock:
                        state._pending_config = data
                elif path == "/viewport":
                    data = json.loads(body)
                    w, h = int(data["width"]), int(data["height"])
                    # Bounded at ingest: huge frames would exhaust memory,
                    # zero or negative ones would fail the rebuild.
                    if not (1 <= w <= 4096 and 1 <= h <= 4096):
                        self._send(400, b"viewport out of range [1, 4096]", "text/plain")
                        return
                    with state.lock:
                        state._pending_viewport = (w, h)
                elif path == "/key":
                    data = json.loads(body)
                    key = data.get("key")
                    if key in ("left", "right"):
                        with state.lock:
                            state._keys[key] = bool(data.get("pressed"))
                else:
                    self._send(404, b"not found", "text/plain")
                    return
                self._send(200, b"ok", "text/plain")
            except (ValueError, KeyError, TypeError, AttributeError) as e:  # a malformed body
                self._send(400, str(e).encode(), "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def serve(
    scene_path: str | None,
    scene_dir: str | None = None,
    host: str = "127.0.0.1",
    port: int = 8080,
    handler: str = "pbvh",
    size: tuple[int, int] = (320, 240),
    device: str = "cuda",
) -> None:
    """Run the viewer (blocking): ``python -m rt_rs_tpu_torch.web``.
    ``scene_path=None`` starts unloaded (needs ``scene_dir``)."""
    state = WebState(scene_path, scene_dir=scene_dir, handler=handler, size=size, device=device)
    server = make_server(state, host, port)
    print(f"rt_rs_tpu_torch viewer on http://{host}:{server.server_address[1]}/")
    try:
        server.serve_forever()
    finally:
        server.server_close()
