"""Bounce batches of a ``torus_scene`` frame for the shading kernels' tests.

Bounce 0 (the primaries) and bounce 1 (their reflections) of a 128x96
frame through pbvh's tiled entries, as the bounce loop hands them to the
shading kernels: each ray's pid (0 for a dead ray), rays and hit
distance, and its subgroups' flags, with one live subgroup forced dead.
Beside them, the [32, T, r] plane of rows that pbvh's rows mode emits
for the same rays, which the TPU kernels take and the frame no longer
makes.  Light sets of k = 1-4: the scene's two lights, then a headlight
first, then a fourth light of strength 0.  The shadow verdicts of a
batch under a light set come from the handler's closest-hit (``sh_id``
the hit prim) or any-hit (blocked) entry on shade_pre's shadow rays.

Imports no JAX: the card's tests use it too.
"""

from __future__ import annotations

import dataclasses

import torch

from rt_rs_tpu_torch import ComputeConfig, Config, Renderer, Resolution
from rt_rs_tpu_torch.ops import shade, shade_tile
from rt_rs_tpu_torch.scene.presets import torus_scene

SIZE = (128, 96)
RAY_TILE = 256
CFG = ComputeConfig()
HEADLIGHT = 1.5
EXTRA_LIGHT = (0.0, 25.0, 5.0, 0.0)  # strength 0: never lights a ray


@dataclasses.dataclass
class Batch:
    """One bounce's shading inputs (CPU tensors)."""

    bounce: int
    pid: torch.Tensor  # [T, r] int32, 0 for a dead ray
    payload: torch.Tensor  # [8, T, r]
    t: torch.Tensor  # [T, r]
    active: torch.Tensor  # [T, r] bool
    live_sg: torch.Tensor  # [T / 8] int32, one live subgroup forced dead
    emitted: torch.Tensor  # [32, T, r]: the rows mode's plane for these rays


def renderer() -> Renderer:
    return Renderer(
        torus_scene(), config=Config(resolution=Resolution.sized(*SIZE)), handler="pbvh",
        device="cpu",
    )


def _live(active: torch.Tensor) -> torch.Tensor:
    sub = shade_tile.SUBGROUP
    return active.reshape(-1, sub * active.shape[1]).any(dim=1).to(torch.int32)


def lights(r: Renderer, k: int) -> torch.Tensor:
    """The light set of ``k`` (1-4) lights -> [k, 4]."""
    scene = torch.cat([r.arrays.light_pos, r.arrays.light_strength[:, None]], dim=1)
    if k <= 2:
        return scene[:k].contiguous()
    pos = torch.tensor(r.camera.pos, dtype=torch.float32)
    head = torch.cat([pos, torch.tensor([HEADLIGHT])])[None]
    out = torch.cat([head, scene, torch.tensor([EXTRA_LIGHT])])
    return out[:k].contiguous()


def bounce_batches(r: Renderer) -> list[Batch]:
    """Bounces 0 and 1 of ``r``'s frame (pbvh, emit-branch entries)."""
    intersect_fn, rows_fn, _ = r._bound(r.handler)
    pos = torch.tensor(r.camera.pos, dtype=torch.float32)
    payload, valid, _ = shade.camera_ray_tiles(
        pos, torch.tensor(r.camera.at, dtype=torch.float32), *SIZE, RAY_TILE, block=r.block
    )
    batches = []
    active = valid
    for bounce in range(2):
        kw = {"refine": True} if bounce else {}
        t, pid = intersect_fn(payload, active, **kw)
        t_rows, pid_rows, emitted = rows_fn(payload, active, **kw)
        assert torch.equal(t, t_rows) and torch.equal(pid, pid_rows)
        pid = torch.where(active, pid, 0)
        active = active & (pid != 0) & (t < CFG.t_max) & (t > CFG.t_min)
        pid = torch.where(active, pid, 0).contiguous()
        live_sg = _live(active)
        lit = live_sg.nonzero()[:, 0]
        live_sg[lit[len(lit) // 2]] = 0  # a live subgroup, forced dead
        batches.append(Batch(bounce, pid, payload.contiguous(), t.contiguous(), active, live_sg, emitted))
        # the next bounce's rays: shade_pre's reflections (live subgroups)
        _, _, _, payload = shade_tile.shade_pre(
            r.arrays.shade_table, pid, payload, t, _live(active), lights(r, 2), emit_next=True
        )
    return batches


def shadows(r: Renderer, b: Batch, light_set: torch.Tensor, blocked_mode: bool):
    """(sh_t, sh_id_f, caps) [k, T, r] of batch ``b`` under ``light_set``:
    the any-hit verdict as 1.0 / 0.0 in ``blocked_mode``, else the
    closest hit's distance and prim."""
    intersect_fn, _, anyhit_fn = r._bound(r.handler)
    sh, caps, masks, _ = shade_tile.shade_pre(
        r.arrays.shade_table, b.pid, b.payload, b.t, _live(b.active), light_set, emit_next=False
    )
    k, n_tiles = light_set.shape[0], b.t.shape[0]
    sh_valid = (b.active[None] & (masks > 0)).reshape(k * n_tiles, -1)
    kw = dict(t_cap=caps.reshape(k * n_tiles, -1), refine=True)
    if blocked_mode:
        blocked = anyhit_fn(sh, sh_valid, **kw).reshape(caps.shape).float()
        return blocked, blocked, caps
    st, sid = intersect_fn(sh, sh_valid, **kw)
    return st.reshape(caps.shape), sid.reshape(caps.shape).float(), caps
