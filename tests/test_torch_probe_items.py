"""The probes' balanced designs (csrc/mt_tpose.cu, csrc/mt_mxu.cu) in
their plain-PyTorch mirrors.

On the card ``mt_tpose`` (the transposed table) and ``mt_mxu`` (the
coefficient table, at three precisions) run the balanced items of
csrc/mt_items.cuh: each tile's chunk list cut into work items of a few
consecutive entries, run on a persistent grid in whatever order the
blocks take them, each ray's item bests merged with an atomic minimum
of a 64-bit (t, pid) key.  ``mt_tpose_split_reference`` and
``mt_mxu_split_reference`` mirror that; here they are held to the
twins of the per-tile walk, bit for bit, in several item sizes (1 to 8)
and merge orders, on the interval cull's lists, on skewed lists (one
tile listing every chunk, the others empty or listing one), on lists
that are all empty, and on a soup whose every triangle is there twice
(equal t, two pids: the smaller must win).  The twins themselves are
held to the JAX package's probes in tests/test_torch_probes.py.  Also:
each mirror's item size is its kernel's, and the tensor-core variants'
TF32 table is ``mxu_mt.tf32`` / ``_split`` of the table.  Inputs
are ``random_soup`` triangles and seeded numpy rays.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from rt_rs_tpu_torch.experiments import mxu_mt, tpose_table
from rt_rs_tpu_torch.experiments.probe_rays import probe_rays
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.presets import random_soup

# One OpenMP thread pool per pytest-xdist worker (see
# tests/test_torch_packet_trace.py).
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

T_MIN, T_MAX, EPS = 0.01, 1000.0, 1e-7
KW = dict(t_min=T_MIN, t_max=T_MAX, eps=EPS)
MISS = np.float32(T_MAX + 1.0)
N_PRIMS = 256  # soup triangles (the "ties" soup holds each twice)


def soup_corners(ties: bool) -> list[np.ndarray]:
    """Leaf-ordered corners [pa, pb, pc] (row 0 the null sentinel) of a
    random soup; ``ties``: every triangle again after the originals
    (prims N_PRIMS + 1 .. 2 N_PRIMS), in other chunks."""
    arrays = random_soup(11, N_PRIMS).pack(device="cpu")
    corners = [arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy()]
    if ties:
        corners = [np.concatenate([x, x[1:]]) for x in corners]
    return corners


def rays(n_prims: int, n: int = 1024):
    """Rays into the soup from a sphere of radius 30 (towards random
    points of its box), random exclusions, 70% valid."""
    rng = np.random.default_rng(5)
    o = rng.normal(size=(n, 3))
    o = 30.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-6.0, 6.0, (n, 3)) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    excl = rng.integers(0, n_prims + 1, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    return tuple(torch.from_numpy(x) for x in (o.astype(np.float32), d.astype(np.float32), excl, valid))


def skew(ids: torch.Tensor, counts: torch.Tensor, nc: int):
    """Lists at an extreme of balance: the busiest tile lists every chunk,
    every third tile nothing and the others one chunk each."""
    n_tiles = counts.shape[0]
    busiest = int(counts.argmax())
    ids = torch.arange(nc, dtype=torch.int32).expand(n_tiles, nc).clone()
    t = torch.arange(n_tiles)
    ids[:, 0] = (t % nc).to(torch.int32)
    counts = torch.where(t % 3 == 0, 0, 1).to(torch.int32)
    ids[busiest] = torch.arange(nc, dtype=torch.int32)
    counts[busiest] = nc
    return ids, counts


LISTS = ("culled", "skewed", "ties")


@pytest.fixture(scope="module")
def tpose_calls():
    """lists -> the args (table, rays, ids, counts) of an mt_tpose call."""
    out = {}
    for name in LISTS:
        corners = soup_corners(ties=name == "ties")
        tables = tpose_table.build_tri_chunks_t(*corners, tri_chunk=64, device="cpu")
        s = probe_rays(
            *rays(corners[0].shape[0] - 1), None, tables.bmin, tables.bmax,
            ray_tile=256, t_min=T_MIN, t_max=T_MAX,
        )
        ids, counts = skew(s.ids, s.counts, tables.num_chunks) if name == "skewed" else (s.ids, s.counts)
        out[name] = (tables.comp, s.rays, ids, counts)
    return out


@pytest.fixture(scope="module")
def mxu_calls():
    """lists -> the args (table, rays, ids, counts) of an mt_mxu call."""
    out = {}
    for name in LISTS:
        corners = soup_corners(ties=name == "ties")
        chunks = pt.build_tri_chunks(*corners, max_chunks=None, tri_chunk=64, device="cpu")
        s = probe_rays(
            *rays(corners[0].shape[0] - 1), None, chunks.bmin, chunks.bmax,
            ray_tile=mxu_mt.TC_RAYS, t_min=T_MIN, t_max=T_MAX,
        )
        ids, counts = skew(s.ids, s.counts, chunks.num_chunks) if name == "skewed" else (s.ids, s.counts)
        out[name] = (mxu_mt.build_mxu_table(chunks), s.rays, ids, counts)
    return out


def assert_bit_equal(got, want, what: str) -> None:
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        a, b = (x.view(torch.int32) if x.dtype == torch.float32 else x for x in (a, b))
        assert torch.equal(a, b), f"{what}: not bit-equal"


def orders(counts: torch.Tensor, per_item: int):
    """Item orders: as numbered, a random permutation and reversed."""
    n_items = pt.mt_items(counts, per_item)[0].numel()
    g = torch.Generator().manual_seed(per_item)
    return (None, torch.randperm(n_items, generator=g), torch.arange(n_items).flip(0))


def check_hits(want, args, lists: str) -> None:
    """The call hits geometry; on the duplicated soup the original (the
    smaller pid) wins every tie unless the ray excludes it; skewed, only
    listed tiles hit."""
    t, pid = want
    counts, excl = args[3], args[1][:, 6]
    hit = pid != 0
    assert bool(hit.any())
    assert bool((t[~hit] == MISS).all())
    if lists == "ties":
        copy = pid > N_PRIMS
        assert bool((excl[copy] == (pid[copy] - N_PRIMS).float()).all())
        assert int(copy.sum()) < int((hit & ~copy).sum())
    if lists == "skewed":
        assert not bool(hit[counts == 0].any())


@pytest.mark.parametrize("per_item", range(1, 9))
@pytest.mark.parametrize("lists", LISTS)
def test_tpose_split_bit_equal_to_the_twin(tpose_calls, lists, per_item):
    """Kernel H's mirror gives its twin's result bit for bit in every item
    size and order."""
    args = tpose_calls[lists]
    want = tpose_table.mt_tpose_reference(*args, **KW)
    check_hits(want, args, lists)
    for order in orders(args[3], per_item):
        got = tpose_table.mt_tpose_split_reference(*args, per_item=per_item, order=order, **KW)
        assert_bit_equal(got, want, f"mt_tpose {lists} per_item={per_item}")


@pytest.mark.parametrize("per_item", range(1, 9))
@pytest.mark.parametrize("lists", LISTS)
@pytest.mark.parametrize("precision", mxu_mt.PRECISIONS)
def test_mxu_split_bit_equal_to_the_twin(mxu_calls, precision, lists, per_item):
    """Kernel I's mirror gives its twin's result bit for bit at every
    precision, item size and order."""
    args = mxu_calls[lists]
    want = mxu_mt.mt_mxu_reference(*args, precision=precision, **KW)
    check_hits(want, args, lists)
    for order in orders(args[3], per_item):
        got = mxu_mt.mt_mxu_split_reference(*args, precision=precision, per_item=per_item, order=order, **KW)
        assert_bit_equal(got, want, f"mt_mxu[{precision}] {lists} per_item={per_item}")


def test_split_on_empty_lists(tpose_calls, mxu_calls):
    """No list entry anywhere: no items, every ray misses."""
    for kernel, calls, extra in (
        ("tpose", tpose_calls, [{}]),
        ("mxu", mxu_calls, [{"precision": p} for p in mxu_mt.PRECISIONS]),
    ):
        table, r, ids, counts = calls["culled"]
        zero = torch.zeros_like(counts)
        for kw in extra:
            mirror = tpose_table.mt_tpose_split_reference if kernel == "tpose" else mxu_mt.mt_mxu_split_reference
            t, pid = mirror(table, r, ids, zero, **kw, **KW)
            assert bool((t == MISS).all() and (pid == 0).all()), kernel
            assert t.shape == pid.shape == (r.shape[0], r.shape[2])


@pytest.mark.parametrize(
    "kernel,constant,size",
    [
        ("mt_tpose", "ITEM_TPOSE", tpose_table.TPOSE_ITEM_SIZE),
        ("mt_mxu[highest]", "ITEM_MXU", mxu_mt.MXU_ITEM_SIZES["highest"]),
        ("mt_mxu[high]", "ITEM_MXU_TC", mxu_mt.MXU_ITEM_SIZES["high"]),
        ("mt_mxu[default]", "ITEM_MXU_TC", mxu_mt.MXU_ITEM_SIZES["default"]),
    ],
)
def test_item_sizes_mirror_the_kernels(tpose_calls, mxu_calls, monkeypatch, kernel, constant, size):
    """Each mirror's default item size is its kernel's compile-time one,
    and it is the size the mirror cuts the lists into."""
    source = "mt_tpose.cu" if kernel == "mt_tpose" else "mt_mxu.cu"
    (found,) = re.findall(rf"\b{constant} = (\d+)", (cuda.CSRC / source).read_text())
    assert int(found) == size >= 1
    seen = []
    items = pt.mt_items
    monkeypatch.setattr(pt, "mt_items", lambda counts, per_item: seen.append(per_item) or items(counts, per_item))
    if kernel == "mt_tpose":
        tpose_table.mt_tpose_split_reference(*tpose_calls["culled"], **KW)
    else:
        mxu_mt.mt_mxu_split_reference(*mxu_calls["culled"], precision=kernel[7:-1], **KW)
    assert seen == [size]


@pytest.mark.parametrize("precision", ["high", "default"])
def test_tf32_table_is_the_cached_rounding(mxu_calls, precision):
    """The tensor-core variants' table, the words the kernel stages:
    mxu_mt.tf32 (default) or the hi / lo of mxu_mt._split (high) of the
    coefficient table, bit for bit; made from the table as it is at the
    call, after it changes in place too."""
    table = mxu_calls["culled"][0].clone()
    words = mxu_mt.tf32_table(table, precision)
    if precision == "default":
        want = mxu_mt.tf32(table)
    else:
        want = torch.stack(mxu_mt._split(table), dim=1)
        hi, lo = words.unbind(1)
        np.testing.assert_allclose((hi + lo).numpy(), table.numpy(), rtol=2**-21)
    assert words.shape == want.shape and torch.equal(words.view(torch.int32), want.view(torch.int32))
    assert bool((words.view(torch.int32) & 0x1FFF == 0).all())  # 10 mantissa bits
    assert bool((table != mxu_mt.tf32(table)).any())  # the rounding is really there
    table[0, 0, 0] += 1.0
    assert mxu_mt.tf32_table(table, precision).view(-1)[0] != words.view(-1)[0]
    with pytest.raises(ValueError, match="precision"):
        mxu_mt.tf32_table(table, "highest")
