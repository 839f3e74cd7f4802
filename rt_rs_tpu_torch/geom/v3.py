"""Small vec3 helpers — the ``V3Ops`` trait surface
(``src/lib/geom/v3.rs:7-18``) for ad-hoc host-side use.  Copied from
``rt_rs_tpu/geom/v3.py``.

CAUTION: these are convenience f64 forms and must NOT replace the
parity-critical math in the production CPU paths.  The OBJ import and
BVH build deliberately reimplement cross/normalize/angle inline in
**f32 with the reference's exact operation order and no clamping**
(``rt_rs_tpu/scene/__init__.py:240-261``, ``bvh/builder.py``) — the
bit-for-bit ``teatime.bvh.json`` / OBJ-import invariants depend on
that.  ``angle`` here clamps to [-1, 1] and guards a zero denominator,
which the reference does not; "deduplicating" the f32 copies through
this module would silently break the pinned invariants.
"""

from __future__ import annotations

import numpy as np

Vec3 = np.ndarray  # shape (3,) float


def cross(a: Vec3, b: Vec3) -> Vec3:
    return np.cross(a, b)


def dot(a: Vec3, b: Vec3) -> float:
    return float(np.dot(a, b))


def mag(a: Vec3) -> float:
    return float(np.sqrt(np.dot(a, a)))


def normalize(a: Vec3) -> Vec3:
    return np.asarray(a, dtype=np.float64) / mag(a)


def angle(at: Vec3, fst: Vec3, snd: Vec3) -> float:
    """Interior angle at ``at`` of triangle (at, fst, snd).

    Matches ``V3Ops::angle`` (``src/lib/geom/v3.rs:74-79``):
    ``acos(ab·ac / (|ab||ac|))``.
    """
    ab = np.asarray(fst, dtype=np.float64) - at
    ac = np.asarray(snd, dtype=np.float64) - at
    denom = mag(ab) * mag(ac)
    if denom == 0.0:
        return 0.0
    return float(np.arccos(np.clip(np.dot(ab, ac) / denom, -1.0, 1.0)))
