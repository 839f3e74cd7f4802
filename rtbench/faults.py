"""Faults planted in the program's timed path, to show that the
comparison catches them (``rtbench/tests`` on the CPU, ``calibrate.py``
on the card).  Each ``plant_*`` patches the program before a renderer
is built (a chained dispatch's graph captures the patched code) and
returns the function that undoes it.  ``half_batch`` and ``altered``
patch ``shade.render_tiled``, the tiled frame of ``Renderer`` and of
``DynamicRenderer`` alike.  A renderer has no batch mean and, on one
card, no exchange between chips, so those faults do not apply.
"""

from __future__ import annotations

# What a planted alteration adds to the red channel of the rows it hits.
ALTERATION = 0.02


def _patch(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    return lambda: setattr(owner, name, old)


def plant_stale_state():
    """A step that returns its state unchanged: the orbit inside a
    chained dispatch (``orbit_f32``) and the host's orbit step
    (``Renderer.orbit``, ``DynamicRenderer.orbit``) leave the camera
    where it was."""
    from rt_rs_tpu_torch import renderer

    undo = [
        _patch(renderer, "orbit_f32", lambda pos, at, mult: pos.clone()),
        _patch(renderer.Renderer, "orbit", lambda self, mult: None),
        _patch(renderer.DynamicRenderer, "orbit", lambda self, mult: None),
    ]
    return lambda: [u() for u in undo]


def plant_stale_geometry():
    """Geometry left as it was first given: every chained dispatch of a
    ``DynamicRenderer`` renders the vertex arrays of the first dispatch
    (its frame ``j`` those of the first dispatch's frame ``j``)."""
    from rt_rs_tpu_torch.renderer import DynamicRenderer

    run_chain = DynamicRenderer._run_chain
    first: list[tuple] = []

    def stale_chain(self, k, orbit_mult, vert_pos, vert_norm):
        if not first:
            first.append((vert_pos, vert_norm))
        return run_chain(self, k, orbit_mult, *first[0])

    return _patch(DynamicRenderer, "_run_chain", stale_chain)


def _wrap_frame(change):
    """Patch the tiled frame path so that ``change(frame)`` edits each
    frame [H, W, 3] where it is produced."""
    from rt_rs_tpu_torch.ops import shade

    inner = shade.render_tiled

    def render_tiled(*args, **kwargs):
        frame = inner(*args, **kwargs).clone()
        change(frame)
        return frame

    return _patch(shade, "render_tiled", render_tiled)


def plant_half_batch():
    """Half of the batch left out: the lower half of every frame's rows
    is never rendered (left black)."""

    def drop(frame):
        frame[frame.shape[0] // 2 :] = 0.0

    return _wrap_frame(drop)


def plant_altered():
    """An answer altered where it is produced: every eighth row of each
    frame comes out with :data:`ALTERATION` more red."""

    def alter(frame):
        frame[::8, :, 0] += ALTERATION

    return _wrap_frame(alter)


# Faults that only a cell whose traffic kind gives geometry can have.
GEOMETRY_FAULTS = ("stale_geometry",)

FAULTS = {
    "stale_state": plant_stale_state,
    "stale_geometry": plant_stale_geometry,
    "half_batch": plant_half_batch,
    "altered": plant_altered,
}
