"""Synthetic inputs of kernel D (``shade_tile.shade_post``), from one numpy seed.

The CPU tests hold the twin against the JAX package's ``shade_post`` on
these cases, and ``chip_smoke.py`` holds the kernel against the twin on
them, so both make the same arrays from the same seed.  A case fixes the
ray tile ``r`` (256: the resident tiles; 128: ``"dma"`` and the flat
adapter), the light count ``k``, the subgroups' liveness (all, none,
alternating, a single live subgroup), ``blocked_mode`` and the tile count
``T`` (a multiple of 8); ``first_bounce`` follows ``k``, so both ways
occur.  Each ray's hit row lies at its pid in a shade table of one row
a ray (pids a seeded permutation, row 0 zeros).  The rays hit a
well-shaped triangle (unit legs at right angles)
inside it, with corner normals near the face normal, as real hits on a
smooth mesh do: the JAX kernel runs on XLA:CPU, which
contracts multiplies and adds into FMAs, and an ill-conditioned hit
would turn those last-place differences into more than the 2e-6 at
which the tests hold the twin against it (the card's kernel equals the
twin bit for bit whatever the data).  Materials and lights lie in the
presets' ranges (albedo.y and .z up to 0.5, spec powers 0 and 1-10,
lights 30-50 units out).  Every 37th ray has a NaN direction, and the shadow distances include
rays at exactly ``T_MIN``, ``T_MAX`` and the ray's cap, where the strict
comparisons of the verdict decide.  The third light of ``k = 3`` has
strength 0.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

RAYS = (256, 128)
LIGHTS = (1, 2, 3)
LIVENESS = ("all", "none", "alternating", "single")
T_MIN, T_MAX = 0.01, 1000.0
SEED = 14


@dataclasses.dataclass(frozen=True)
class PostCase:
    r: int
    k: int
    liveness: str
    blocked_mode: bool
    tiles: int

    @property
    def first_bounce(self) -> bool:
        return self.k % 2 == 1

    @property
    def name(self) -> str:
        mode = "blocked" if self.blocked_mode else "closest"
        return f"r={self.r} k={self.k} T={self.tiles} {self.liveness} {mode}"


def cases(tiles: tuple[int, ...] = (32,)) -> list[PostCase]:
    """Every combination of RAYS, LIGHTS, LIVENESS, both ``blocked_mode``
    values and ``tiles``."""
    return [
        PostCase(r, k, live, blocked, t)
        for r, k, live, blocked, t in itertools.product(
            RAYS, LIGHTS, LIVENESS, (True, False), tiles
        )
    ]


def live_words(liveness: str, n_sg: int) -> np.ndarray:
    """live_sg [n_sg] int32 for a liveness pattern."""
    if liveness == "all":
        w = np.ones(n_sg)
    elif liveness == "none":
        w = np.zeros(n_sg)
    elif liveness == "alternating":
        w = (np.arange(n_sg) % 2 == 0).astype(np.float64)
    elif liveness == "single":
        w = np.zeros(n_sg)
        w[n_sg // 2] = 1
    else:
        raise ValueError(f"unknown liveness {liveness!r}")
    return w.astype(np.int32)


def _unit(rng, n: int) -> np.ndarray:
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def post_arrays(case: PostCase, seed: int = SEED) -> tuple[tuple[np.ndarray, ...], dict]:
    """-> (table, pid, payload, t, active_f, sh_t, sh_id_f, caps,
    live_sg, lights) as float32 / int32 arrays, shade_post's arguments,
    and its keyword arguments."""
    rng = np.random.default_rng([seed, case.r, case.k, case.tiles])
    T, r, k = case.tiles, case.r, case.k
    n = T * r
    # well-shaped triangles: a, then b and c one unit away at right angles
    a = rng.normal(size=(n, 3)) * 2.0
    e1 = _unit(rng, n)
    e2 = np.cross(e1, _unit(rng, n))
    e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
    b, c = a + e1, a + e2
    w = rng.uniform(0.1, 1.0, (n, 3))
    w /= w.sum(axis=1, keepdims=True)
    hit = w[:, :1] * b + w[:, 1:2] * c + w[:, 2:] * a
    # o + d t exact in f32 (d on a 2^-12 grid, t on 2^-4, o on 2^-16), so
    # that no contraction of it into an FMA can move the hit point
    d = np.round(_unit(rng, n) * 4096.0) / 4096.0
    t = rng.integers(8, 128, n) / 16.0
    o = np.round((hit - d * t[:, None]) * 65536.0) / 65536.0
    d[::37] = np.nan
    rows = rng.random((32, n))
    # corners in the shade table's column order: b, c, a; then their normals
    rows[0:9] = np.concatenate([b, c, a], axis=1).T
    # smooth-shading normals: the face normal, each corner's tilted a little
    face = np.cross(e1, e2) * np.where(rng.random((n, 1)) < 0.5, -1.0, 1.0)
    rows[9:18] = np.concatenate([face + 0.05 * _unit(rng, n) for _ in range(3)], axis=1).T
    # materials in the presets' ranges: colour, albedo.x up to 1, albedo.y
    # and .z up to 0.5, spec powers 0 and 1-10
    rows[22:24] *= 0.5
    rows[24] = rng.choice([0.0, 1.0, 4.0, 10.0], n)
    payload = np.zeros((8, n))
    payload[0:3], payload[3:6] = o.T, d.T
    payload[6] = rng.integers(1, 1000, n)
    active = (rng.random(n) < 0.85).astype(np.float64)
    # lights 30-50 units out, as the presets' (LIGHT_POS, LIGHT_STRENGTH)
    pos = _unit(rng, k) * rng.uniform(30.0, 50.0, (k, 1))
    lights = np.concatenate([pos, rng.uniform(0.5, 1.6, (k, 1))], axis=1)
    if k == 3:
        lights[2, 3] = 0.0
    caps = rng.uniform(0.1, 30.0, (k, n))
    if case.blocked_mode:
        sh_t = (rng.random((k, n)) < 0.5).astype(np.float64)
        sh_id = sh_t.copy()
    else:
        sh_id = np.where(rng.random((k, n)) < 0.6, rng.integers(1, 1000, (k, n)), 0)
        sh_t = rng.uniform(-1.0, 40.0, (k, n))
        idx = np.arange(n)
        sh_t[:, idx % 7 == 1] = np.float32(T_MIN)
        sh_t[:, idx % 11 == 2] = np.float32(T_MAX)
        at_cap = idx % 13 == 3
        sh_t[:, at_cap] = caps[:, at_cap].astype(np.float32)
        sh_id[:, (idx % 7 == 1) | (idx % 11 == 2) | at_cap] = 7
    f32 = lambda x, *shape: np.ascontiguousarray(x, dtype=np.float32).reshape(shape)  # noqa: E731
    pid = rng.permutation(n) + 1
    table = np.zeros((n + 1, 32))
    table[pid] = rows.T
    arrays = (
        f32(table, n + 1, 32), pid.astype(np.int32).reshape(T, r), f32(payload, 8, T, r),
        f32(t, T, r), f32(active, T, r),
        f32(sh_t, k, T, r), f32(sh_id, k, T, r), f32(caps.astype(np.float32), k, T, r),
        live_words(case.liveness, T // 8), f32(lights, k, 4),
    )
    kw = dict(
        first_bounce=case.first_bounce, t_min=T_MIN, t_max=T_MAX,
        blocked_mode=case.blocked_mode,
    )
    return arrays, kw


def post_args(case: PostCase, device, seed: int = SEED) -> tuple[tuple[torch.Tensor, ...], dict]:
    """:func:`post_arrays` as torch tensors on ``device``."""
    arrays, kw = post_arrays(case, seed)
    return tuple(torch.from_numpy(x).to(device) for x in arrays), kw
