"""Per-bounce shading over component-major ray tiles.

Counterpart of ``rt_rs_tpu/ops/pallas/shade_tile.py``.  A bounce's
shading runs as two kernels split at the intersect calls:

* :func:`shade_pre` — kernel C (csrc/shade_pre.cu), replacing
  ``_shade_pre_kernel``: hit point and normal, the shadow ray, cap and
  contribution mask per light, and the reflected continuation ray;
* :func:`shade_post` — kernel D (csrc/shade_post.cu), replacing
  ``_shade_post_kernel``: shadow verdicts and the Blinn/Phong colour
  contribution;
* :func:`shade_bounce` — kernel F (csrc/shade_bounce.cu), replacing
  ``_shade_bounce_kernel``: shade_post of bounce b and shade_pre of
  bounce b + 1 in one launch (``trace_tiled(fuse_bounce=True)``).  The
  three kernels share their per-ray bodies (csrc/shade_body.cuh).

All follow the TPU kernels' subgroup rule: a subgroup of 8 tiles with
no live ray writes zeros; a live subgroup computes every lane.  Each
takes a bounce's hits as ``pid`` and reads a hit's shade row from the
scene's resident shade table at ``table[pid]`` (the TPU kernels take
the rows as a [32, T, r] plane that the intersect call emits; on the
card the row is an indexed load).  The plain-PyTorch twins
(``*_reference``) take that plane and compute the same f32 operations
in the same order; CPU tensors run the twin on ``table_rows(table,
pid)``, CUDA tensors the kernel.
"""

from __future__ import annotations

import torch

from rt_rs_tpu_torch import tracing
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops.packet_trace import _f32

SUBGROUP = 8  # tiles per liveness subgroup
# Kernel D's rays per block (POST_RAYS in csrc/shade_post.cu): its grid is
# T / SUBGROUP * ceil(SUBGROUP * r / POST_RAYS) blocks of POST_RAYS threads.
POST_RAYS = 128


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)``, the square root and the quotient each correctly
    rounded: XLA:CPU's ``rsqrt`` without FMA contraction (the stored JAX
    frames), and the shading kernels' ``1.0f / sqrtf`` (IEEE under the
    build's flags), so the twins equal the kernels on the card and the
    glue's rays and normals (``shade._rsqrt``) are the same bits on the
    card as on the CPU.  Each device reaches it through another torch
    call: the CPU's ``torch.rsqrt`` rounds so, but its vectorised
    ``torch.sqrt`` is one ULP off on some values, while CUDA's
    ``torch.sqrt`` is correctly rounded and its ``torch.rsqrt`` is the
    approximate ``rsqrtf``."""
    if x.is_cuda:
        return _f32(1.0, x.device) / torch.sqrt(x)
    return torch.rsqrt(x)


def _hit_normal(rows, payload, t):
    """at + interpolated unit normal, op for op ``_hit_normal`` of the
    JAX package (corner rotation baked into the column order)."""
    ox, oy, oz, dx, dy, dz = payload[0:6]
    hx = ox + dx * t
    hy = oy + dy * t
    hz = oz + dz * t
    bx, by, bz = rows[0], rows[1], rows[2]
    cx, cy, cz = rows[3], rows[4], rows[5]
    ax, ay, az = rows[6], rows[7], rows[8]
    v0x, v0y, v0z = bx - ax, by - ay, bz - az
    v1x, v1y, v1z = cx - ax, cy - ay, cz - az
    v2x, v2y, v2z = hx - ax, hy - ay, hz - az
    d00 = v0x * v0x + v0y * v0y + v0z * v0z
    d01 = v0x * v1x + v0y * v1y + v0z * v1z
    d11 = v1x * v1x + v1y * v1y + v1z * v1z
    d20 = v2x * v0x + v2y * v0y + v2z * v0z
    d21 = v2x * v1x + v2y * v1y + v2z * v1z
    denom = d00 * d11 - d01 * d01
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    vv = (d11 * d20 - d01 * d21) / denom
    ww = (d00 * d21 - d01 * d20) / denom
    uu = 1.0 - vv - ww
    nx = rows[9] * vv + rows[12] * ww + rows[15] * uu
    ny = rows[10] * vv + rows[13] * ww + rows[16] * uu
    nz = rows[11] * vv + rows[14] * ww + rows[17] * uu
    rn = _rsqrt(nx * nx + ny * ny + nz * nz)
    return (hx, hy, hz), (nx * rn, ny * rn, nz * rn)


def table_rows(table: torch.Tensor, pid: torch.Tensor) -> torch.Tensor:
    """The hits' rows of the shade table as the twins' component-major
    plane: ``table`` [P + 1, 32], ``pid`` [T, r] -> [32, T, r],
    contiguous (torch's CPU kernels may round a strided operand's pow or
    sqrt otherwise than a contiguous one's)."""
    return table[pid.reshape(-1).to(torch.int64)].T.reshape(32, *pid.shape).contiguous()


def _check_table(table, dev) -> None:
    """The shade table: [P + 1, 32] f32, 16-byte aligned (the kernels
    read a row as 16-byte vectors)."""
    cuda.check("table", table, torch.float32, (table.shape[0], 32), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: must be 16-byte aligned (the kernels read 16-byte vectors)")


def _live_mask(live_sg: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """[T, 1] bool: the tile's subgroup holds a live ray."""
    return (live_sg != 0).repeat_interleave(SUBGROUP)[:n_tiles, None]


def _count_bounce(bounce: int | None, active_f, live_sg) -> None:
    """On the CPU, while tracing counts: bounce ``bounce``'s shaded rays
    (``active_f`` set in a live subgroup) and ray slots, as kernels D
    and F count them."""
    dev = active_f.device
    if bounce is None or not tracing.counting(dev):
        return
    live = tracing.bounce_counter(bounce)
    shaded = (active_f > 0.0) & _live_mask(live_sg, active_f.shape[0])
    tracing.add(dev, live, shaded.sum())
    tracing.add(dev, live.replace("live_rays", "slots"), active_f.numel())


def _side_offset(side: torch.Tensor) -> torch.Tensor:
    dev = side.device
    return torch.where(side < 0.0, _f32(-0.001, dev), _f32(0.001, dev))


def shade_pre_reference(rows, payload, t, pid_f, live_sg, lights, emit_next: bool):
    """Plain-PyTorch twin of kernel C (see :func:`shade_pre`), on the
    hits' rows as a plane (``rows = table_rows(table, pid)``) and ``pid_f
    = pid`` in f32."""
    n_tiles = t.shape[0]
    live = _live_mask(live_sg, n_tiles)
    zero = torch.zeros((), dtype=torch.float32, device=t.device)
    (hx, hy, hz), (nx, ny, nz) = _hit_normal(rows, payload, t)
    dx, dy, dz = payload[3], payload[4], payload[5]
    spec_pow = rows[24]
    sh, caps, masks = [], [], []
    for li in range(lights.shape[0]):
        lx, ly, lz, ls = lights[li, 0], lights[li, 1], lights[li, 2], lights[li, 3]
        ddx, ddy, ddz = lx - hx, ly - hy, lz - hz
        s = ddx * ddx + ddy * ddy + ddz * ddz
        dist = torch.sqrt(s)
        inv = _rsqrt(s)
        ux, uy, uz = ddx * inv, ddy * inv, ddz * inv
        side = ux * nx + uy * ny + uz * nz
        off = _side_offset(side)
        sh.append(
            torch.stack(
                [hx + off * nx, hy + off * ny, hz + off * nz, ux, uy, uz, pid_f, dist]
            )
        )
        caps.append(dist)
        # Zero-contribution cull, in shade_post's specular op order.
        eux, euy, euz = -ux, -uy, -uz
        den = eux * nx + euy * ny + euz * nz
        rfx = eux - 2.0 * den * nx
        rfy = euy - 2.0 * den * ny
        rfz = euz - 2.0 * den * nz
        sdot = (-rfx) * dx + (-rfy) * dy + (-rfz) * dz
        need = (ls > 0.0) & ((side > 0.0) | (sdot > 0.0) | (spec_pow <= 0.0))
        masks.append(need.to(torch.float32))
    sh_pay = torch.where(live.repeat(len(sh), 1), torch.cat(sh, dim=1), zero)
    caps_t = torch.where(live, torch.stack(caps), zero)
    masks_t = torch.where(live, torch.stack(masks), zero)
    nxt = None
    if emit_next:
        dn = dx * nx + dy * ny + dz * nz
        rx = dx - 2.0 * dn * nx
        ry = dy - 2.0 * dn * ny
        rz = dz - 2.0 * dn * nz
        rr = _rsqrt(rx * rx + ry * ry + rz * rz)
        rx, ry, rz = rx * rr, ry * rr, rz * rr
        rside = rx * nx + ry * ny + rz * nz
        roff = _side_offset(rside)
        z = torch.zeros_like(rx)
        nxt = torch.stack(
            [hx + roff * nx, hy + roff * ny, hz + roff * nz, rx, ry, rz, z, z]
        )
        nxt = torch.where(live, nxt, zero)
    return sh_pay, caps_t, masks_t, nxt


def shade_pre(table, pid, payload, t, live_sg, lights, emit_next: bool):
    """Kernel C (csrc/shade_pre.cu).

    table [P + 1, 32] (the scene's shade table), pid [T, r] int32 (the
    hits; 0 for a dead ray), payload [8, T, r], t [T, r] f32, live_sg
    [T / 8] int32, lights [k, 4] (pos, strength; headlight first) ->
    (sh_pay [8, k * T, r], caps [k, T, r], masks [k, T, r] 1.0/0.0,
    next [8, T, r] or None).  ``sh_pay`` holds light k's shadow rays
    in tiles k*T..(k+1)*T: the JAX package's per-light payloads
    concatenated along the tile axis, which is the shadow batch the
    any-hit call takes.  A mask of 0 means the light cannot change the
    ray's colour whatever the shadow verdict."""
    if not t.is_cuda:
        return twin("shade_pre", table, pid, payload, t, live_sg, lights, emit_next)
    n_tiles, r = t.shape
    k = lights.shape[0]
    dev = t.device
    _check_table(table, dev)
    cuda.check("pid", pid, torch.int32, (n_tiles, r), dev)
    cuda.check("payload", payload, torch.float32, (8, n_tiles, r), dev)
    cuda.check("t", t, torch.float32, (n_tiles, r), dev)
    cuda.check("live_sg", live_sg, torch.int32, (n_tiles // SUBGROUP,), dev)
    cuda.check("lights", lights, torch.float32, (k, 4), dev)
    if n_tiles % SUBGROUP:
        raise ValueError(f"tile count {n_tiles} not a multiple of {SUBGROUP}")
    sh_pay = torch.empty((8, k * n_tiles, r), dtype=torch.float32, device=dev)
    caps = torch.empty((k, n_tiles, r), dtype=torch.float32, device=dev)
    masks = torch.empty((k, n_tiles, r), dtype=torch.float32, device=dev)
    nxt = (
        torch.empty((8, n_tiles, r), dtype=torch.float32, device=dev)
        if emit_next
        else None
    )
    cuda.call(
        "shade_pre", "rt_shade_pre",
        table.data_ptr(), pid.data_ptr(), payload.data_ptr(), t.data_ptr(),
        live_sg.data_ptr(), lights.data_ptr(), k, n_tiles, r, int(emit_next),
        sh_pay.data_ptr(), caps.data_ptr(), masks.data_ptr(), cuda.ptr(nxt),
    )
    return sh_pay, caps, masks, nxt


def shade_post_reference(
    rows, payload, t, active_f, sh_t, sh_id_f, caps, live_sg, lights, *,
    first_bounce: bool, t_min: float, t_max: float, blocked_mode: bool = False,
):
    """Plain-PyTorch twin of kernel D (see :func:`shade_post`), on the
    hits' rows as a plane (``rows = table_rows(table, pid)``)."""
    dev = t.device
    live = _live_mask(live_sg, t.shape[0])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    (hx, hy, hz), (nx, ny, nz) = _hit_normal(rows, payload, t)
    dx, dy, dz = payload[3], payload[4], payload[5]
    spec_pow = rows[24]
    diffuse = torch.zeros_like(t)
    spec = torch.zeros_like(t)
    for li in range(lights.shape[0]):
        lx, ly, lz, ls = lights[li, 0], lights[li, 1], lights[li, 2], lights[li, 3]
        ddx, ddy, ddz = lx - hx, ly - hy, lz - hz
        s = ddx * ddx + ddy * ddy + ddz * ddz
        inv = _rsqrt(s)
        ux, uy, uz = ddx * inv, ddy * inv, ddz * inv
        if blocked_mode:
            shadowed = sh_t[li] > 0.0
        else:
            st = sh_t[li]
            shadowed = (
                (sh_id_f[li] != 0.0)
                & (st < _f32(t_max, dev))
                & (st > _f32(t_min, dev))
                & (st < caps[li])
            )
        lit = (~shadowed) & (ls > 0.0)
        # diffuse (compute.wgsl:160-166)
        dterm = ls * torch.maximum(zero, ux * nx + uy * ny + uz * nz)
        # specular via reflect(-u, n) (compute.wgsl:168-175)
        eux, euy, euz = -ux, -uy, -uz
        den = eux * nx + euy * ny + euz * nz
        rx = eux - 2.0 * den * nx
        ry = euy - 2.0 * den * ny
        rz = euz - 2.0 * den * nz
        sdot = (-rx) * dx + (-ry) * dy + (-rz) * dz
        sterm = torch.pow(torch.maximum(zero, sdot), spec_pow) * ls
        diffuse = diffuse + torch.where(lit, dterm, zero)
        spec = spec + torch.where(lit, sterm, zero)
    da = diffuse * rows[21]
    sa = spec * rows[22]
    active = (active_f > 0.0) & live
    out = []
    for c in range(3):
        contrib = rows[18 + c] * da + sa
        if not first_bounce:  # albedo.z attenuation (compute.wgsl:258-265)
            contrib = contrib * rows[23]
        out.append(torch.where(active, contrib, zero))
    return torch.stack(out)


def shade_post(
    table, pid, payload, t, active_f, sh_t, sh_id_f, caps, live_sg, lights, *,
    first_bounce: bool, t_min: float, t_max: float, blocked_mode: bool = False,
    bounce: int | None = None,
):
    """Kernel D (csrc/shade_post.cu) -> colour contribution [3, T, r].

    table [P + 1, 32] (the scene's shade table), pid [T, r] int32 (the
    hits; 0 for a dead ray), payload [8, T, r] (this bounce's rays), t /
    active_f [T, r] f32, sh_t / sh_id_f / caps [k, T, r] f32 (in
    ``blocked_mode`` sh_t is the any-hit mask as 1.0/0.0 and sh_id_f is
    not read), live_sg [T / 8] int32, lights [k, 4].  ``bounce``: the
    bounce whose rays it shades, counted while tracing is on
    (``tracing.py``: ``live_rays.b``, ``slots.b``); None counts nothing."""
    kw = dict(
        first_bounce=first_bounce, t_min=t_min, t_max=t_max,
        blocked_mode=blocked_mode,
    )
    if not t.is_cuda:
        _count_bounce(bounce, active_f, live_sg)
        return twin(
            "shade_post", table, pid, payload, t, active_f, sh_t, sh_id_f, caps, live_sg,
            lights, **kw,
        )
    n_tiles, r = t.shape
    k = lights.shape[0]
    dev = t.device
    _check_table(table, dev)
    cuda.check("pid", pid, torch.int32, (n_tiles, r), dev)
    cuda.check("payload", payload, torch.float32, (8, n_tiles, r), dev)
    cuda.check("t", t, torch.float32, (n_tiles, r), dev)
    cuda.check("active_f", active_f, torch.float32, (n_tiles, r), dev)
    cuda.check("sh_t", sh_t, torch.float32, (k, n_tiles, r), dev)
    cuda.check("sh_id_f", sh_id_f, torch.float32, (k, n_tiles, r), dev)
    cuda.check("caps", caps, torch.float32, (k, n_tiles, r), dev)
    cuda.check("live_sg", live_sg, torch.int32, (n_tiles // SUBGROUP,), dev)
    cuda.check("lights", lights, torch.float32, (k, 4), dev)
    if n_tiles % SUBGROUP:
        raise ValueError(f"tile count {n_tiles} not a multiple of {SUBGROUP}")
    out = torch.empty((3, n_tiles, r), dtype=torch.float32, device=dev)
    counter = None if bounce is None else tracing.bounce_counter(bounce)
    cuda.call(
        "shade_post", "rt_shade_post",
        table.data_ptr(), pid.data_ptr(), payload.data_ptr(), t.data_ptr(),
        active_f.data_ptr(), sh_t.data_ptr(), sh_id_f.data_ptr(), caps.data_ptr(),
        live_sg.data_ptr(), lights.data_ptr(), k, n_tiles, r,
        int(first_bounce), int(blocked_mode), float(t_min), float(t_max),
        out.data_ptr(), *tracing.kernel_args(dev, counter),
    )
    return out


def shade_bounce_reference(
    rows, payload, t, active_f, sh_t, sh_id_f, caps,
    rows2, payload2, t2, pid2_f, live_sg2, lights, *,
    first_bounce: bool, t_min: float, t_max: float, emit_next: bool,
    blocked_mode: bool = False,
):
    """Plain-PyTorch twin of kernel F: :func:`shade_post_reference` of
    bounce b, then :func:`shade_pre_reference` of bounce b + 1."""
    color = shade_post_reference(
        rows, payload, t, active_f, sh_t, sh_id_f, caps, live_sg2[0], lights,
        first_bounce=first_bounce, t_min=t_min, t_max=t_max,
        blocked_mode=blocked_mode,
    )
    return (color, *shade_pre_reference(rows2, payload2, t2, pid2_f, live_sg2[1], lights, emit_next))


def shade_bounce(
    table, pid, payload, t, active_f, sh_t, sh_id_f, caps,
    pid2, payload2, t2, live_sg2, lights, *,
    first_bounce: bool, t_min: float, t_max: float, emit_next: bool,
    blocked_mode: bool = False, bounce: int | None = None,
):
    """Kernel F (csrc/shade_bounce.cu): :func:`shade_post` of bounce b
    and :func:`shade_pre` of bounce b + 1 in one launch -> (color [3,
    T, r], sh_pay [8, k * T, r], caps [k, T, r], masks [k, T, r], next
    [8, T, r] or None).

    The first eight arguments are shade_post's for bounce b, ``pid2``
    [T, r] int32, ``payload2`` [8, T, r] and ``t2`` [T, r] shade_pre's
    for bounce b + 1, on the same ``table``; ``live_sg2`` [2, T / 8]
    int32 holds the two bounces' subgroup flags (row 0: b, row 1: b +
    1).  ``bounce`` (b) is counted as :func:`shade_post` counts it."""
    kw = dict(
        first_bounce=first_bounce, t_min=t_min, t_max=t_max,
        emit_next=emit_next, blocked_mode=blocked_mode,
    )
    if not t.is_cuda:
        _count_bounce(bounce, active_f, live_sg2[0])
        return twin(
            "shade_bounce", table, pid, payload, t, active_f, sh_t, sh_id_f, caps,
            pid2, payload2, t2, live_sg2, lights, **kw,
        )
    n_tiles, r = t.shape
    k = lights.shape[0]
    dev = t.device
    _check_table(table, dev)
    cuda.check("pid", pid, torch.int32, (n_tiles, r), dev)
    cuda.check("pid2", pid2, torch.int32, (n_tiles, r), dev)
    for name, x, shape in (
        ("payload", payload, (8, n_tiles, r)),
        ("t", t, (n_tiles, r)),
        ("active_f", active_f, (n_tiles, r)),
        ("sh_t", sh_t, (k, n_tiles, r)),
        ("sh_id_f", sh_id_f, (k, n_tiles, r)),
        ("caps", caps, (k, n_tiles, r)),
        ("payload2", payload2, (8, n_tiles, r)),
        ("t2", t2, (n_tiles, r)),
        ("lights", lights, (k, 4)),
    ):
        cuda.check(name, x, torch.float32, shape, dev)
    cuda.check("live_sg2", live_sg2, torch.int32, (2, n_tiles // SUBGROUP), dev)
    if n_tiles % SUBGROUP:
        raise ValueError(f"tile count {n_tiles} not a multiple of {SUBGROUP}")
    color = torch.empty((3, n_tiles, r), dtype=torch.float32, device=dev)
    sh_pay = torch.empty((8, k * n_tiles, r), dtype=torch.float32, device=dev)
    caps_out = torch.empty((k, n_tiles, r), dtype=torch.float32, device=dev)
    masks = torch.empty((k, n_tiles, r), dtype=torch.float32, device=dev)
    nxt = (
        torch.empty((8, n_tiles, r), dtype=torch.float32, device=dev)
        if emit_next
        else None
    )
    counter = None if bounce is None else tracing.bounce_counter(bounce)
    cuda.call(
        "shade_bounce", "rt_shade_bounce",
        *(x.data_ptr() for x in (
            table, pid, payload, t, active_f, sh_t, sh_id_f, caps, pid2, payload2, t2,
        )),
        live_sg2.data_ptr(), lights.data_ptr(),
        k, n_tiles, r, int(first_bounce), int(blocked_mode), int(emit_next),
        float(t_min), float(t_max), color.data_ptr(), sh_pay.data_ptr(),
        caps_out.data_ptr(), masks.data_ptr(), cuda.ptr(nxt),
        *tracing.kernel_args(dev, counter),
    )
    return color, sh_pay, caps_out, masks, nxt


def twin(name: str, *args, **kw):
    """The twin of kernel ``name`` (``"shade_pre"``, ``"shade_post"`` or
    ``"shade_bounce"``) on that wrapper's arguments, on their device:
    the plane-reading ``*_reference`` with each pid's rows gathered as
    ``table_rows(table, pid)`` (and, for the pre half, the pid as f32)."""
    if name == "shade_pre":
        table, pid, *rest = args
        pre = (table_rows(table, pid), *rest[:2], pid.to(torch.float32), *rest[2:])
        return shade_pre_reference(*pre, **kw)
    if name == "shade_post":
        table, pid, *rest = args
        return shade_post_reference(table_rows(table, pid), *rest, **kw)
    table, pid, *post, pid2, payload2, t2, live_sg2, lights = args
    return shade_bounce_reference(
        table_rows(table, pid), *post, table_rows(table, pid2), payload2, t2,
        pid2.to(torch.float32), live_sg2, lights, **kw,
    )
