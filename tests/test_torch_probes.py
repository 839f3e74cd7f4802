"""rt_rs_tpu_torch's kernel probes against the JAX package's
(``experiments/roofline.py``, ``mxu_mt.py``, ``tpose_table.py``).

The JAX probes are loaded by path (``experiments/`` is not a package)
and run in interpret mode on the CPU.  Inputs are numpy, from a seed:
a 300-triangle soup (``random_soup``) in 64-triangle chunks, and 512
rays into it from outside, with random exclusions, validity and caps.

Tolerances:

* ``fma_chains``: both twins within rtol 2e-6 of the JAX kernel at 16
  iterations on a grid of 2.  XLA:CPU contracts the JAX kernel's
  ``a * 0.999999 + 1e-7`` into FMAs, so its sums (near 130) land up to
  ~8e-5 (6e-7 relative) from the separate twin's.
* the tables (``build_mxu_table``, ``build_tri_chunks_t``): bit-equal.
* ``packet_closest_hit_t`` and ``packet_closest_hit_mxu`` (highest): t
  at rtol 1e-5 and pids equal except near-ties (the bound of
  tests/test_torch_packet_trace.py; XLA:CPU contracts the JAX kernels'
  arithmetic).  The transposed twin equals the port's
  ``packet_closest_hit`` bit for bit: the same arithmetic over the same
  prims, whatever the chunking.
* ``high`` and ``default`` against ``highest`` (both twins): pid
  agreement and the largest relative t error on rays where both hit the
  same prim, within ``mxu_mt.TF32_BOUNDS``, the bounds ``chip_smoke.py``
  holds the card's tensor-core results to (set from the card's
  torus_scene 1080p primaries, where high agrees on every pid with t
  within 4.1e-5 and default on 99.6% with t within 4.4e-2).  Measured
  here on the twins' TF32 emulation over three seeds of 2048 rays: high
  agrees on every pid with t within 3.7e-6 relative; default on 99.4%
  with t within 1.5e-2 (torus_scene's 192x108 primaries: 99.6% and
  6.8e-3).
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu_torch import Config, ComputeConfig, Renderer, Resolution, convert
from rt_rs_tpu_torch.experiments import mxu_mt, roofline, tpose_table
from rt_rs_tpu_torch.experiments.probe_rays import probe_rays
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.ops import shade
from rt_rs_tpu_torch.scene.presets import random_soup, torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
T_MIN, T_MAX, EPS = 0.01, 1000.0, 1e-7
KW = dict(t_min=T_MIN, t_max=T_MAX, eps=EPS)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_probe_{name}", ROOT / "experiments" / f"{name}.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jprobes():
    return {name: _load(name) for name in ("roofline", "mxu_mt", "tpose_table")}


@pytest.fixture(scope="module")
def soup():
    """(port TriChunks, JAX TriChunks, corners [pa, pb, pc] numpy, n)."""
    arrays = random_soup(11, 300).pack(device="cpu")
    corners = [arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy()]
    chunks = pt.build_tri_chunks(*corners, max_chunks=None, tri_chunk=64, device="cpu")
    jc = jpt.build_tri_chunks(*corners, max_chunks=None, tri_chunk=64)
    return chunks, jc, corners, 300


def soup_rays(seed: int, n_prims: int, n: int = 512):
    """Rays into the soup from a sphere of radius 30 around it (towards
    random points of its box, like camera rays), random exclusions, 70%
    valid, caps."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 30.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-6.0, 6.0, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    excl = rng.integers(0, n_prims + 1, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    cap = rng.uniform(20.0, 60.0, n).astype(np.float32)
    return o.astype(np.float32), d, excl, valid, cap


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def assert_hits_match(t, pid, jt, jpid, valid):
    t, pid, jt, jpid = t[valid], pid[valid], jt[valid], jpid[valid]
    np.testing.assert_allclose(t, jt, rtol=1e-5)
    diff = pid != jpid
    assert diff.mean() <= 1e-3, f"{diff.sum()} pids differ"
    assert (np.abs(t[diff] - jt[diff]) <= 1e-5 * np.abs(jt[diff])).all()


# ----------------------------------------------------------------------
# TPU kernel 7: the FMA chains


@pytest.mark.parametrize("fused", [True, False])
def test_fma_chains_twin_matches_jax_kernel(jprobes, fused):
    iters, grid = 16, 2
    rows = roofline.CHAINS * roofline.ROWS
    x = np.random.default_rng(3).uniform(0.5, 2.0, (grid * rows, roofline.COLS))
    x = x.astype(np.float32)
    ref = pl.pallas_call(
        partial(jprobes["roofline"]._fma_kernel, iters=iters),
        grid=(grid,),
        in_specs=[pl.BlockSpec((rows, roofline.COLS), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((roofline.ROWS, roofline.COLS), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((grid * roofline.ROWS, roofline.COLS), jnp.float32),
        interpret=True,
    )(jnp.asarray(x))
    ours = roofline.fma_chains(_t(x), iters, fused)
    assert ours.shape == (grid * roofline.ROWS, roofline.COLS)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-6)


def test_fma_chains_variants_and_peak(monkeypatch):
    x = torch.from_numpy(np.random.default_rng(4).uniform(0.5, 2.0, (256, 128)).astype(np.float32))
    fused, separate = roofline.fma_chains(x, 64, True), roofline.fma_chains(x, 64, False)
    # The two roundings drift apart by a few ULP over 64 steps.
    np.testing.assert_allclose(fused.numpy(), separate.numpy(), rtol=1e-5)
    # The separate twin rounds the multiply and the add: numpy's f32.
    acc = x.numpy().reshape(2, 16, 8, 128).transpose(1, 0, 2, 3) + np.arange(16, dtype=np.float32)[:, None, None, None]
    for _ in range(64):
        acc = acc * np.float32(0.999999) + np.float32(1e-7)
    out = acc[0]
    for c in range(1, 16):
        out = out + acc[c]
    np.testing.assert_array_equal(separate.numpy(), out.reshape(16, 128))
    for name, value in (("ITERS", 2), ("GRID", 1), ("REPS", 1)):
        monkeypatch.setattr(roofline, name, value)
    rate = roofline.practical_peak(device="cpu")
    assert rate > 0 and roofline.peak_flops(2, 1) == 2 * 2 * 16 * 8 * 128
    with pytest.raises(ValueError, match="grid"):
        roofline.fma_chains(torch.zeros(100, 128))


# ----------------------------------------------------------------------
# TPU kernel 9: the transposed table


@pytest.mark.parametrize("tc", [64, 128])
def test_tpose_table_bit_equal_to_jax(jprobes, soup, tc):
    _, _, corners, _ = soup
    ours = tpose_table.build_tri_chunks_t(*corners, tri_chunk=tc, device="cpu")
    ref = jprobes["tpose_table"].build_tri_chunks_t(*corners, tri_chunk=tc)
    assert ours.num_chunks == ref[3] and ours.num_chunks % pt.CHUNK_ALIGN == 0
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    conv = convert.tpose_tables(*(np.asarray(x) for x in ref[:3]), ref[3], device="cpu")
    for a, b in zip(conv, ours):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("tc", [64, 128])
def test_tpose_twin_matches_jax_and_packet_closest_hit(jprobes, soup, tc):
    chunks, _, corners, n = soup
    o, d, excl, valid, cap = soup_rays(5, n)
    ref_tables = jprobes["tpose_table"].build_tri_chunks_t(*corners, tri_chunk=tc)
    jt, jpid = jprobes["tpose_table"].packet_closest_hit_t(
        ref_tables, _j(o), _j(d), _j(excl), _j(valid), _j(cap), interpret=True, **KW
    )
    tables = tpose_table.build_tri_chunks_t(*corners, tri_chunk=tc, device="cpu")
    t, pid = tpose_table.packet_closest_hit_t(
        tables, _t(o), _t(d), _t(excl), _t(valid), _t(cap), **KW
    )
    assert_hits_match(t.numpy(), pid.numpy(), np.asarray(jt), np.asarray(jpid), valid)
    assert 0.05 < (pid.numpy()[valid] != 0).mean()
    # The port's packet_closest_hit over the same prims, bit for bit.
    t0, pid0 = pt.packet_closest_hit(
        chunks, _t(o), _t(d), _t(excl), _t(valid), _t(cap), ray_tile=256, **KW
    )
    assert torch.equal(t[_t(valid)], t0[_t(valid)]) and torch.equal(pid[_t(valid)], pid0[_t(valid)])


def test_tpose_twin_is_mt_trace_on_the_same_lists(soup):
    """Kernel H's twin == kernel B's closest-hit twin over the same lists
    (the relation chip_smoke.py holds the kernels to)."""
    chunks, _, corners, n = soup
    o, d, excl, valid, cap = soup_rays(6, n)
    tables = tpose_table.build_tri_chunks_t(*corners, tri_chunk=64, device="cpu")
    s = probe_rays(
        _t(o), _t(d), _t(excl), _t(valid), _t(cap), tables.bmin, tables.bmax,
        t_min=T_MIN, t_max=T_MAX, ray_tile=256,
    )
    ours = tpose_table.mt_tpose(tables.comp, s.rays, s.ids, s.counts, **KW)
    ref = pt.mt_trace(chunks.comp, s.rays.permute(1, 0, 2).contiguous(), s.ids, s.counts, mode="closest", **KW)
    assert torch.equal(ours[0], ref[0]) and torch.equal(ours[1], ref[1])


def test_tpose_frame_matches_renderer():
    """A shade.render frame through the transposed table == the pbvh
    Renderer's frame of the same camera (torus_scene, 32x24)."""
    scene = torus_scene()
    cfg = Config(resolution=Resolution.sized(32, 24))
    r = Renderer(scene, config=cfg, handler="pbvh", device="cpu")
    frame = r.render_frame().numpy()
    tables = tpose_table.build_tri_chunks_t(r.arrays.pa, r.arrays.pb, r.arrays.pc, tri_chunk=64, device="cpu")
    c = cfg.compute
    fn = partial(tpose_table.packet_closest_hit_t, tables, t_min=c.t_min, t_max=c.t_max, eps=c.eps)
    pos = torch.tensor(scene.camera.pos, dtype=torch.float32)
    at = torch.tensor(scene.camera.at, dtype=torch.float32)
    ours = shade.render(r.arrays, fn, c, pos, at, 32, 24, block=(16, 16)).numpy()
    assert ours.mean() > 0.05
    np.testing.assert_allclose(ours, frame, rtol=0, atol=2e-5)


# ----------------------------------------------------------------------
# TPU kernel 8: the matrix-unit MT


def test_mxu_table_bit_equal_to_jax(jprobes, soup):
    chunks, jc, _, _ = soup
    ours = mxu_mt.build_mxu_table(chunks)
    ref = np.asarray(jprobes["mxu_mt"].build_mxu_table(jc))
    assert ours.shape == (chunks.num_chunks, 16, 4 * chunks.tri_chunk)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert torch.equal(convert.mxu_table(ref, device="cpu"), ours)


def test_mxu_highest_twin_matches_jax(jprobes, soup):
    chunks, jc, _, n = soup
    o, d, excl, valid, cap = soup_rays(7, n)
    jt, jpid = jprobes["mxu_mt"].packet_closest_hit_mxu(
        jc, jprobes["mxu_mt"].build_mxu_table(jc), _j(o), _j(d), _j(excl), _j(valid), _j(cap),
        interpret=True, **KW,
    )
    t, pid = mxu_mt.packet_closest_hit_mxu(
        chunks, mxu_mt.build_mxu_table(chunks), _t(o), _t(d), _t(excl), _t(valid), _t(cap), **KW
    )
    assert_hits_match(t.numpy(), pid.numpy(), np.asarray(jt), np.asarray(jpid), valid)
    assert 0.05 < (pid.numpy()[valid] != 0).mean()
    # ... and the port's Möller–Trumbore closest hit (other arithmetic).
    t0, pid0 = pt.packet_closest_hit(chunks, _t(o), _t(d), _t(excl), _t(valid), _t(cap), **KW)
    assert_hits_match(t.numpy(), pid.numpy(), t0.numpy(), pid0.numpy(), valid)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_mxu_tf32_twins_within_bounds(soup, precision):
    chunks, _, _, n = soup
    o, d, excl, valid, cap = soup_rays(8, n, n=2048)
    table = mxu_mt.build_mxu_table(chunks)
    args = (chunks, table, _t(o), _t(d), _t(excl), _t(valid), _t(cap))
    t_ref, pid_ref = mxu_mt.packet_closest_hit_mxu(*args, **KW)
    t, pid = mxu_mt.packet_closest_hit_mxu(*args, precision=precision, **KW)
    v = _t(valid)
    match, rel = mxu_mt.tf32_agreement(t[v], pid[v], t_ref[v], pid_ref[v])
    least, most = mxu_mt.TF32_BOUNDS[precision]
    assert match >= least and rel <= most, (match, rel)
    assert rel > 0.0  # the TF32 rounding is really there


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11), 2**-12, float("inf"), float("nan")])
    y = mxu_mt.tf32(x)
    # ties round away from zero; 10 mantissa bits remain
    assert y[:5].tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2 * 2**-10, -(1.0 + 2**-10), 2**-12]
    assert y[5] == float("inf") and torch.isnan(y[6])
    assert (mxu_mt.tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF == 0).all()


def test_probe_entry_checks(soup):
    chunks, _, _, _ = soup
    table = mxu_mt.build_mxu_table(chunks)
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="precision"):
        mxu_mt.packet_closest_hit_mxu(chunks, table, o, o, torch.zeros(4, dtype=torch.int32), precision="bf16", **KW)
