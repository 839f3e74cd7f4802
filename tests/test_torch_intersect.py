"""rt_rs_tpu_torch's XLA intersection code (``ops/intersect.py``) and the
``naive`` and ``blank`` handlers against the JAX package's.

Inputs: ``random_soup`` (100 triangles) and 400 rays from a seed, some
with an exclusion.  The hit distance is held at rtol 1e-5: XLA:CPU
contracts the JAX lattice's arithmetic into FMAs, where the port rounds
every op (as tests/test_torch_packet_trace.py).  A lattice entry or a
pid may differ only where the two roundings put a ray on either side of
a triangle edge (at most 0.1% of them).  ``slab_test`` is compares,
subtractions and products only: bit-equal.  Frames at atol 2e-5.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_rs_tpu.ops import intersect as jix
from rt_rs_tpu_torch import ComputeConfig
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.ops import intersect as ix
from rt_rs_tpu_torch.scene.presets import ghost_scene, random_soup, torus_scene

from .test_torch_flat import jax_frame, port_frame

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

KW = dict(t_min=0.01, t_max=1000.0, eps=1e-7)
MISS = np.float32(1001.0)


@pytest.fixture(scope="module")
def soup():
    """(corners pa, pb, pc [P, 3] with the null row, o, d, excl)."""
    a = random_soup(21, 100).pack(device="cpu")
    rng = np.random.default_rng(21)
    n = 400
    o = rng.normal(size=(n, 3))
    o = (25.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-5.0, 5.0, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:8, 1] = 0.0  # a few directions with a zero component
    excl = np.where(rng.random(n) < 0.3, rng.integers(1, 101, n), 0).astype(np.int32)
    return a.pa.numpy(), a.pb.numpy(), a.pc.numpy(), o, d, excl


def _t(x):
    return torch.from_numpy(np.asarray(x))


def close_t(t, jt):
    """Equal misses and hits at rtol 1e-5, except at most 0.1% edge
    flips."""
    t, jt = np.asarray(t), np.asarray(jt)
    flip = (t == MISS) != (jt == MISS)
    assert flip.mean() <= 1e-3, f"{flip.sum()} hit/miss flips"
    np.testing.assert_allclose(t[~flip], jt[~flip], rtol=1e-5)
    return ~flip


def test_tri_intersect_matches_jax(soup):
    pa, pb, pc, o, d, _ = soup
    ours = ix.tri_intersect(_t(o), _t(d), _t(pa[1:]), _t(pb[1:]), _t(pc[1:]), **KW)
    ref = jix.tri_intersect(*(jnp.asarray(x) for x in (o, d, pa[1:], pb[1:], pc[1:])), **KW)
    assert ours.shape == (400, 100)
    same = close_t(ours.numpy(), ref)
    assert 0.01 < (ours.numpy()[same] < MISS).mean() < 0.9  # both outcomes


def test_tri_intersect_pairs_matches_jax_and_the_lattice(soup):
    pa, pb, pc, o, d, _ = soup
    k = np.arange(400) % 100 + 1  # ray i against prim k[i]
    args = (o, d, pa[k], pb[k], pc[k])
    ours = ix.tri_intersect_pairs(*(_t(x) for x in args), **KW)
    ref = jix.tri_intersect_pairs(*(jnp.asarray(x) for x in args), **KW)
    close_t(ours.numpy(), ref)
    lattice = ix.tri_intersect(_t(o), _t(d), _t(pa[1:]), _t(pb[1:]), _t(pc[1:]), **KW)
    assert torch.equal(ours, lattice[torch.arange(400), _t(k - 1)])


@pytest.mark.parametrize("chunk", [128, 32])
def test_closest_hit_bruteforce_matches_jax(soup, chunk):
    pa, pb, pc, o, d, excl = soup
    t, pid = ix.closest_hit_bruteforce(*(_t(x) for x in (o, d, pa, pb, pc, excl)), chunk=chunk, **KW)
    jt, jpid = jix.closest_hit_bruteforce(
        *(jnp.asarray(x) for x in (o, d, pa, pb, pc, excl)), chunk=chunk, **KW
    )
    t, pid, jt, jpid = t.numpy(), pid.numpy(), np.asarray(jt), np.asarray(jpid)
    np.testing.assert_allclose(t, jt, rtol=1e-5)
    diff = pid != jpid
    assert diff.mean() <= 1e-3 and (np.abs(t[diff] - jt[diff]) <= 1e-5 * jt[diff]).all()
    hit = pid != 0
    assert 0.1 < hit.mean() < 1.0  # some rays miss
    assert (t[~hit] == MISS).all() and (pid[excl != 0] != excl[excl != 0]).all()


def test_closest_hit_bruteforce_is_the_lattice_min(soup):
    """The chunked scan == the first minimum of the full lattice over
    the live prims, whatever the chunk and the ray slicing."""
    pa, pb, pc, o, d, excl = soup
    lattice = ix.tri_intersect(_t(o), _t(d), _t(pa[1:]), _t(pb[1:]), _t(pc[1:]), **KW)
    lattice[_t(excl) > 0, _t(excl)[_t(excl) > 0].long() - 1] = float(MISS)
    bt, barg = lattice.min(dim=1)
    old = ix.BUDGET["cpu"]
    ix.BUDGET["cpu"] = 7 * 16  # rays in slices of 7
    try:
        t, pid = ix.closest_hit_bruteforce(*(_t(x) for x in (o, d, pa, pb, pc, excl)), chunk=16, **KW)
    finally:
        ix.BUDGET["cpu"] = old
    hit = bt < 1000.0
    assert torch.equal(t[hit], bt[hit]) and torch.equal(pid[hit], barg[hit].int() + 1)
    assert (pid[~hit] == 0).all()


def test_slab_test_matches_jax(soup):
    _, _, _, o, d, _ = soup
    with np.errstate(divide="ignore"):
        inv_d = (1.0 / d).astype(np.float32)
    boxes = [((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0)), ((3.0, 0.0, -1.0), (3.0, 4.0, 1.0))]
    o2 = o.copy()
    o2[:8, 1] = 0.0  # origins on a flat box's slab with d = 0: NaN -> hit
    for bmin, bmax in boxes:
        bmin, bmax = np.float32(bmin), np.float32(bmax)
        ours = ix.slab_test(_t(o2), _t(inv_d), _t(bmin), _t(bmax))
        ref = jix.slab_test(*(jnp.asarray(x) for x in (o2, inv_d, bmin, bmax)))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert 0 < int(ours.sum()) < 400


@pytest.mark.parametrize("handler", ["naive", "blank"])
def test_handler_frames_match_jax(handler):
    ours, ref = port_frame(torus_scene(), 32, 24, handler), jax_frame(torus_scene(), 32, 24, handler)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)
    if handler == "blank":
        assert not ours.any()  # every ray misses: a black frame
    else:
        # brute force == the packet BVH: the cross-handler check
        np.testing.assert_allclose(ours, port_frame(torus_scene(), 32, 24), rtol=0, atol=2e-5)


def test_naive_negative_material_frame_matches_pbvh():
    scene = ghost_scene(-1)
    np.testing.assert_allclose(
        port_frame(scene, 32, 24, "naive"), port_frame(scene, 32, 24), rtol=0, atol=2e-6
    )


def test_registry_and_blank_entries():
    from rt_rs_tpu.handlers import available as jax_available
    from rt_rs_tpu_torch.handlers import _REGISTRY
    from rt_rs_tpu_torch.handlers.lbvh import LbvhIntrs

    # every handler of the JAX package, lbvh included
    assert sorted(_REGISTRY) == ["blank", "bvh", "lbvh", "naive", "pbvh", "rf_bvh"] == jax_available()
    assert isinstance(get_handler("lbvh"), LbvhIntrs)
    with pytest.raises(ValueError, match="unknown handler 'nope'.*naive"):
        get_handler("nope")
    cfg = ComputeConfig()
    h = get_handler("blank")
    assert h.stats(None).name == "Blank" and get_handler("naive").stats(None).size == 0
    t, pid = h.intersect_tiled_fn(None, None, cfg)(torch.zeros(8, 32, 128), torch.ones(32, 128, dtype=torch.bool))
    assert t.shape == (32, 128) and (t == MISS).all() and (pid == 0).all()
    t, pid = h.intersect_fn(None, None, cfg)(torch.zeros(5, 3), torch.zeros(5, 3), torch.zeros(5, dtype=torch.int32))
    assert t.shape == (5,) and (t == MISS).all() and pid.dtype == torch.int32


def test_register_adds_and_replaces_handlers(monkeypatch):
    """``register(name, factory)``, the JAX package's extension point: a
    registered factory is what ``get_handler`` and ``Renderer(handler=)``
    build, and a later call replaces an earlier one, in both packages."""
    import rt_rs_tpu.handlers as jh

    from rt_rs_tpu_torch import Config, Renderer, Resolution
    from rt_rs_tpu_torch import handlers
    from rt_rs_tpu_torch.handlers import register
    from rt_rs_tpu_torch.handlers.blank import BlankIntrs
    from rt_rs_tpu_torch.handlers.naive import BasicIntrs

    monkeypatch.setattr(handlers, "_REGISTRY", dict(handlers._REGISTRY))
    monkeypatch.setattr(jh, "_REGISTRY", dict(jh._REGISTRY))
    made = []

    class Custom(BlankIntrs):
        def __init__(self, tag="x"):
            made.append(tag)

    register("custom", Custom)
    assert isinstance(get_handler("custom", tag="a"), Custom) and made == ["a"]
    r = Renderer(torus_scene(), config=Config(resolution=Resolution.sized(16, 16)), handler="custom", device="cpu")
    assert isinstance(r.handler, Custom) and made == ["a", "x"]
    assert not r.render_frame().any()  # Custom is blank: every ray misses
    register("custom", BasicIntrs)
    assert isinstance(get_handler("custom"), BasicIntrs) and "custom" in handlers.available()
    jh.register("custom", jh.get_handler("blank").__class__)
    jh.register("custom", jh.get_handler("naive").__class__)
    assert type(jh.get_handler("custom")).__name__ == type(get_handler("custom")).__name__ == "BasicIntrs"
