"""rt_rs_tpu_torch's shading twins against the JAX package's shading
kernels (``shade_pre`` / ``shade_post``, interpret mode).

The inputs are real frame state: a 64x48 ``torus_scene`` frame's
primary hits (and its shadow verdicts) from the port; the JAX kernels
take the hits' rows as a plane, ours each hit's pid and the shade table.  Outputs are
compared on active rays at atol 2e-6: the twins round every op
separately and use torch's rsqrt / pow, the JAX kernels run through
XLA:CPU, whose rsqrt, pow and contractions round differently in the
last place.  Shadow-ray origins and light distances reach magnitudes of
~55, where one ULP (3.8e-6) exceeds that atol, so ray and distance
outputs also get rtol 2.4e-7 (2 ULP); the contribution masks must be
equal and the colours meet atol 2e-6 alone.  The post twin is also
held at atol 2e-6 on every ray of the seeded synthetic cases that
chip_smoke.py holds kernel D to (``experiments/post_cases.py``).

The wrappers reading ``table[pid]`` are also held, bit for bit, to the
plane-reading twins on a plane gathered from the table, on the bounce
batches of ``tests/torch_bounce_batches.py`` (dead rays with pid 0, a
dead subgroup, k = 1-4 lights, both shadow modes, first bounce or not),
and to the twins on the plane the rows mode emits, on live rays.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_rs_tpu.ops.pallas import shade_tile as jst
from rt_rs_tpu_torch import ComputeConfig, Config, Renderer, Resolution
from rt_rs_tpu_torch.experiments import post_cases
from rt_rs_tpu_torch.ops import cuda, shade, shade_tile
from rt_rs_tpu_torch.scene.presets import torus_scene
from tests import torch_bounce_batches as bb

# pytest-xdist runs several test processes at once; torch's default of
# one OpenMP thread per core in each of them oversubscribes the CPUs,
# and the spinning threads slowed these tests about tenfold.
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

ATOL = 2e-6
RAY_RTOL = 2.4e-7  # 2 ULP of float32


def frame_state(headlight: float):
    """Bounce 0 of a 64x48 frame: (renderer, table, pid, payload, t,
    active, live_sg, lights); pid is 0 for a dead ray."""
    cfg = Config(
        compute=ComputeConfig(camera_light_source=headlight),
        resolution=Resolution.sized(64, 48),
    )
    r = Renderer(torus_scene(), config=cfg, handler="pbvh", device="cpu")
    pos = torch.tensor(r.camera.pos, dtype=torch.float32)
    payload, valid, _ = shade.camera_ray_tiles(
        pos, torch.tensor(r.camera.at, dtype=torch.float32), 64, 48, 256, block=r.block
    )
    t, pid = r._bound(r.handler)[0](payload, valid)
    pid = torch.where(valid, pid, 0)
    active = valid & (pid != 0) & (t < cfg.compute.t_max) & (t > cfg.compute.t_min)
    pid = torch.where(active, pid, 0)
    live_sg = active.reshape(-1, 8 * 256).any(dim=1).to(torch.int32)
    lights = [r.arrays.light_pos, r.arrays.light_strength[:, None]]
    lights = torch.cat(lights, dim=1)
    if headlight > 0:
        lights = torch.cat([torch.cat([pos, torch.tensor([headlight])])[None], lights])
    return r, r.arrays.shade_table, pid, payload, t, active, live_sg, lights.contiguous()


def _j(x):
    return jnp.asarray(x.numpy())


def close_on(ours, ref, active, what, rtol=0.0):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(
        ours[..., active], ref[..., active], rtol=rtol, atol=ATOL, err_msg=what
    )


@pytest.mark.parametrize("headlight", [0.0, 1.5])
def test_shade_pre_matches_jax(headlight):
    _, table, pid, payload, t, active, live_sg, lights = frame_state(headlight)
    a = active.numpy()
    assert a.sum() > 2000  # most of the 3,072 pixels hit the scene
    sh, caps, masks, nxt = shade_tile.shade_pre(
        table, pid, payload, t, live_sg, lights, emit_next=True
    )
    jsh, jcaps, jmasks, jnxt = jst.shade_pre(
        _j(shade_tile.table_rows(table, pid)), _j(payload), _j(t), _j(pid.float()), _j(live_sg), _j(lights),
        emit_next=True, interpret=True,
    )
    k = lights.shape[0]
    jsh = jnp.concatenate(list(jsh), axis=1)
    close_on(sh, jsh, np.tile(a, (k, 1)), "shadow rays", rtol=RAY_RTOL)
    close_on(caps, jnp.stack(list(jcaps)), a, "caps", rtol=RAY_RTOL)
    np.testing.assert_array_equal(masks.numpy()[:, a], np.stack([np.asarray(m) for m in jmasks])[:, a])
    close_on(nxt, jnxt, a, "reflection rays", rtol=RAY_RTOL)
    # Dead subgroups write zeros; the cull mask drops some shadow rays.
    dead = ~live_sg.bool().repeat_interleave(8)
    assert not sh.reshape(8, k, -1, 256)[:, :, dead].any()
    assert 0.0 < masks.numpy()[:, a].mean() < 1.0


@pytest.mark.parametrize("blocked_mode", [True, False])
@pytest.mark.parametrize("first_bounce", [True, False])
def test_shade_post_matches_jax(blocked_mode, first_bounce):
    r, table, pid, payload, t, active, live_sg, lights = frame_state(0.0)
    a = active.numpy()
    k = lights.shape[0]
    sh, caps, masks, _ = shade_tile.shade_pre(
        table, pid, payload, t, live_sg, lights, emit_next=False
    )
    sh_valid = (active[None] & (masks > 0)).reshape(k * t.shape[0], -1)
    kw = dict(t_cap=caps.reshape(k * t.shape[0], -1), refine=True)
    intersect_fn, _, anyhit_fn = r._bound(r.handler)
    if blocked_mode:
        blocked = anyhit_fn(sh, sh_valid, **kw)
        sh_t = sh_id = blocked.reshape(caps.shape).float()
    else:
        st, sid = intersect_fn(sh, sh_valid, **kw)
        sh_t, sh_id = st.reshape(caps.shape), sid.reshape(caps.shape).float()
    assert 0.0 < (sh_id.numpy()[:, a] != 0).mean() < 1.0  # lit and shadowed rays
    args = (payload, t, active.float(), sh_t, sh_id, caps, live_sg, lights)
    flags = dict(first_bounce=first_bounce, t_min=0.01, t_max=1000.0, blocked_mode=blocked_mode)
    ours = shade_tile.shade_post(table, pid, *args, **flags)
    rows = shade_tile.table_rows(table, pid)
    ref = jst.shade_post(*(_j(x) for x in (rows, *args)), interpret=True, **flags)
    close_on(ours, ref, a, "colour")
    assert not ours.numpy()[:, ~a].any()  # inactive rays contribute nothing
    assert ours.numpy()[:, a].mean() > 0.01


@pytest.mark.parametrize("case", post_cases.cases(), ids=lambda c: c.name)
def test_shade_post_synthetic_matches_jax(case):
    """The twin against the JAX kernel on chip_smoke.py's synthetic cases
    (post_cases: r, k, liveness, blocked_mode; NaN directions, shadow
    distances at exactly t_min, t_max and the cap) at T = 32, the JAX
    kernel's TILE_GROUP."""
    arrays, kw = post_cases.post_arrays(case)
    ours = shade_tile.shade_post(*(torch.from_numpy(x) for x in arrays), **kw).numpy()
    table, pid, *rest = arrays
    rows = np.ascontiguousarray(table[pid].transpose(2, 0, 1))
    ref = np.asarray(jst.shade_post(*(jnp.asarray(x) for x in (rows, *rest)), interpret=True, **kw))
    np.testing.assert_allclose(ours, ref, rtol=0.0, atol=ATOL, err_msg=case.name)
    live = np.repeat(arrays[8] != 0, shade_tile.SUBGROUP)
    assert not ours[:, ~live].any()  # dead subgroups write zeros
    if live.any():
        lit = ours[:, live]
        assert np.isnan(lit).any() and (np.nan_to_num(lit) > 0.0).mean() > 0.1


def test_post_rays_mirror():
    """shade_tile.POST_RAYS (the floor kernel's grid in chip_smoke.py) is
    kernel D's block size."""
    src = (cuda.CSRC / "shade_post.cu").read_text()
    assert re.findall(r"constexpr int POST_RAYS = (\d+);", src) == [str(shade_tile.POST_RAYS)]


# ---- the row source: table[pid] against the plane the TPU kernels take ----


@pytest.fixture(scope="module")
def bounces():
    r = bb.renderer()
    return r, bb.bounce_batches(r)


@pytest.fixture(scope="module")
def shadow_cache():
    return {}


def shadows(bounces, shadow_cache, bounce: int, k: int, blocked_mode: bool):
    key = (bounce, k, blocked_mode)
    if key not in shadow_cache:
        r, batches = bounces
        shadow_cache[key] = bb.shadows(r, batches[bounce], bb.lights(r, k), blocked_mode)
    return shadow_cache[key]


def plane(table, pid) -> torch.Tensor:
    """table[pid] as the [32, T, r] plane, gathered in NumPy."""
    return torch.from_numpy(np.ascontiguousarray(table.numpy()[pid.numpy()].transpose(2, 0, 1)))


def assert_bits(ours, ref, live=None):
    """Equal outputs (NaN == NaN), on the rays of ``live`` [T, r] if given."""
    for a, b in zip(ours, ref, strict=True):
        if a is None or b is None:
            assert a is None and b is None
            continue
        a, b = a.numpy(), b.numpy()
        if live is not None:
            n = live.numel()
            a, b = a.reshape(-1, n)[:, live.reshape(-1)], b.reshape(-1, n)[:, live.reshape(-1)]
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bounce", [0, 1])
def test_emitted_rows_are_table_rows(bounces, bounce):
    """The rows mode's plane is table[pid] on every live ray; a dead
    ray's pid is 0, and each batch has dead rays in live subgroups and
    a dead subgroup with live rays."""
    r, batches = bounces
    b = batches[bounce]
    live = shade_tile._live_mask(b.live_sg, b.t.shape[0]).expand_as(b.active)
    assert torch.equal(b.emitted[:, b.active], plane(r.arrays.shade_table, b.pid)[:, b.active])
    assert not b.pid[~b.active].any()
    assert (live & ~b.active).any() and (~live & b.active).any()


@pytest.mark.parametrize("emit_next", [True, False])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("bounce", [0, 1])
def test_shade_pre_reads_the_table(bounces, bounce, k, emit_next):
    """Kernel C's wrapper on (table, pid) = the twin on table[pid]'s
    plane on every ray, and the twin on the emitted plane on live rays."""
    r, batches = bounces
    b, table, lights = batches[bounce], r.arrays.shade_table, bb.lights(r, k)
    ours = shade_tile.shade_pre(table, b.pid, b.payload, b.t, b.live_sg, lights, emit_next)
    args = (b.payload, b.t, b.pid.float(), b.live_sg, lights, emit_next)
    assert_bits(ours, shade_tile.shade_pre_reference(plane(table, b.pid), *args))
    assert_bits(ours, shade_tile.shade_pre_reference(b.emitted, *args), b.active)


@pytest.mark.parametrize("first_bounce", [True, False])
@pytest.mark.parametrize("blocked_mode", [True, False])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("bounce", [0, 1])
def test_shade_post_reads_the_table(bounces, shadow_cache, bounce, k, blocked_mode, first_bounce):
    """Kernel D's wrapper on (table, pid), as kernel C's."""
    r, batches = bounces
    b, table, lights = batches[bounce], r.arrays.shade_table, bb.lights(r, k)
    sh = shadows(bounces, shadow_cache, bounce, k, blocked_mode)
    args = (b.payload, b.t, b.active.float(), *sh, b.live_sg, lights)
    kw = dict(first_bounce=first_bounce, t_min=bb.CFG.t_min, t_max=bb.CFG.t_max, blocked_mode=blocked_mode)
    ours = shade_tile.shade_post(table, b.pid, *args, **kw)
    assert ours[:, b.active].mean() > 0.01
    assert_bits((ours,), (shade_tile.shade_post_reference(plane(table, b.pid), *args, **kw),))
    assert_bits((ours,), (shade_tile.shade_post_reference(b.emitted, *args, **kw),), b.active)


@pytest.mark.parametrize("first_bounce", [True, False])
@pytest.mark.parametrize("blocked_mode", [True, False])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_shade_bounce_reads_the_table(bounces, shadow_cache, k, blocked_mode, first_bounce):
    """Kernel F's wrapper on (table, pid, pid2): bounce 0's post half and
    bounce 1's pre half, as kernels D and C."""
    r, (b0, b1) = bounces
    table, lights = r.arrays.shade_table, bb.lights(r, k)
    sh = shadows(bounces, shadow_cache, 0, k, blocked_mode)
    post = (b0.payload, b0.t, b0.active.float(), *sh)
    live2 = torch.stack([b0.live_sg, b1.live_sg])
    kw = dict(
        first_bounce=first_bounce, t_min=bb.CFG.t_min, t_max=bb.CFG.t_max,
        blocked_mode=blocked_mode, emit_next=True,
    )
    ours = shade_tile.shade_bounce(table, b0.pid, *post, b1.pid, b1.payload, b1.t, live2, lights, **kw)
    for rows, rows2 in ((plane(table, b0.pid), plane(table, b1.pid)), (b0.emitted, b1.emitted)):
        ref = shade_tile.shade_bounce_reference(
            rows, *post, rows2, b1.payload, b1.t, b1.pid.float(), live2, lights, **kw
        )
        if rows is b0.emitted:  # live rays only: bounce 0's colour, bounce 1's rays
            assert_bits(ours[:1], ref[:1], b0.active)
            assert_bits(ours[1:], ref[1:], b1.active)
        else:
            assert_bits(ours, ref)
