"""Kernel E's balanced design (csrc/mt_stream.cu) in its plain-PyTorch
mirror.

On the card ``mt_stream`` expands each tile's block words into its
ascending list of set chunks and runs kernel B's balanced items over
them, merging each ray's hits with an atomic minimum of a 64-bit
(t, pid) key.  ``packet_stream`` mirrors it (``stream_lists``,
``mt_stream_split_reference``); here the mirror is held to the twin of
the per-group walk, ``mt_stream_reference``, bit for bit in several
item sizes and merge orders and on skewed lists, and to the JAX
package's interpret-mode kernel at the tolerances of
tests/test_torch_stream.py (t rtol 1e-5, pids equal except near-ties).
The inputs are tests/test_torch_stream.py's two cases: the 300-triangle
soup (32 chunks a block, bit 31 in use) and ``torus_scene`` on the
streamed table (8 chunks a block), with seeded numpy rays.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_rs_tpu.ops.pallas import packet_stream as jps
from rt_rs_tpu_torch import convert
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops import packet_stream as ps
from rt_rs_tpu_torch.ops import packet_trace as pt

from .test_torch_stream import CASES

# One OpenMP thread pool per pytest-xdist worker (see
# tests/test_torch_packet_trace.py).
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

T_MIN, T_MAX, EPS = 0.01, 1000.0, 1e-7
KW = dict(t_min=T_MIN, t_max=T_MAX, eps=EPS)
MISS = np.float32(T_MAX + 1.0)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module", params=sorted(CASES))
def inputs(request):
    """(case name, port TriChunks, JAX TriChunks, rays, StreamInputs)."""
    jc, o, d, excl, valid, cap = CASES[request.param]()
    ours = convert.tri_chunks(jc.comp, jc.bmin, jc.bmax, jc.num_chunks, device="cpu")
    rays = (o, d, excl, valid, cap)
    s = ps.stream_inputs(ours, *(_t(x) for x in rays), t_min=T_MIN, t_max=T_MAX)
    return request.param, ours, jc, rays, s


def args(s, words=None, blockids=None, counts=None):
    return (
        s.payload, s.table, s.words if words is None else words,
        s.blockids if blockids is None else blockids, s.counts if counts is None else counts,
    )


def skewed(s, shape: str):
    """Block lists at an extreme of balance: one tile (the one with the
    most set chunks) listing every chunk of every block and every other
    tile nothing, or every tile listing every chunk."""
    n_tiles, nb = s.words.shape
    cpb = s.table.shape[0] // nb
    full = np.int64((1 << cpb) - 1).astype(np.uint32).view(np.int32)  # cpb ones, as int32
    ids, counts = ps.stream_lists(s.words, s.blockids, s.counts, cpb)
    groups = n_tiles // pt.TILE_GROUP
    blockids = torch.arange(nb, dtype=torch.int32).expand(groups, nb).contiguous()
    words = torch.full((n_tiles, nb), int(full), dtype=torch.int32)
    g_counts = torch.full((groups,), nb, dtype=torch.int32)
    if shape == "one tile":
        busiest = int(counts.argmax())
        words.zero_()
        words[busiest] = int(full)
        g_counts.zero_()
        g_counts[busiest // pt.TILE_GROUP] = nb
    return words, blockids, g_counts


def test_stream_lists_expand_the_words(inputs):
    """Each tile's list holds exactly the set bits of its words at the
    blocks its group lists, ascending, as chunk ids."""
    name, _, _, _, s = inputs
    n_tiles, nb = s.words.shape
    cpb = s.table.shape[0] // nb
    ids, counts = ps.stream_lists(s.words, s.blockids, s.counts, cpb)
    words, blockids, g_counts = (x.numpy() for x in (s.words, s.blockids, s.counts))
    for t in range(n_tiles):
        g = t // pt.TILE_GROUP
        want = [
            int(b) * cpb + j
            for b in sorted(blockids[g, : g_counts[g]])
            for j in range(cpb)
            if (int(words[t, b]) >> j) & 1
        ]
        assert counts[t] == len(want)
        assert ids[t, : counts[t]].tolist() == want, f"{name} tile {t}"
    assert int(counts.max()) > 0
    # A tile's nonzero words all lie in its group's list: the count is
    # the popcount of its whole row of words.
    pop = sum(((s.words >> j) & 1) for j in range(32)).sum(dim=1)
    assert torch.equal(counts.to(torch.int64), pop)


@pytest.mark.parametrize("per_item", [1, 3, 8])
def test_stream_split_bit_equal_to_the_twin(inputs, per_item):
    """Every item size and merge order gives the twin's result bit for
    bit, on every ray."""
    name, _, _, _, s = inputs
    want = ps.mt_stream_reference(*args(s), **KW)
    _, counts = ps.stream_lists(s.words, s.blockids, s.counts, s.table.shape[0] // s.words.shape[1])
    n_items = pt.mt_items(counts, per_item)[0].numel()
    g = torch.Generator().manual_seed(per_item)
    for order in (None, torch.randperm(n_items, generator=g), torch.arange(n_items).flip(0)):
        got = ps.mt_stream_split_reference(*args(s), per_item=per_item, order=order, **KW)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), name
        assert torch.equal(got[1], want[1]), name
    assert bool((want[1] != 0).any())  # the call hits geometry


@pytest.mark.parametrize("shape", ["one tile", "every tile"])
def test_stream_split_skewed(inputs, shape):
    """Skewed lists: the mirror (at the kernel's item size and at 1) and
    the twin agree bit for bit."""
    name, _, _, _, s = inputs
    words, blockids, g_counts = skewed(s, shape)
    a = args(s, words, blockids, g_counts)
    want = ps.mt_stream_reference(*a, **KW)
    for per_item in (None, 1):
        got = ps.mt_stream_split_reference(*a, per_item=per_item, **KW)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), name
        assert torch.equal(got[1], want[1]), name
    live = (want[1] != 0).any(dim=1)
    if shape == "one tile":
        assert int(live.sum()) <= 1
    else:
        assert bool((want[1] != 0).any())


def test_stream_split_matches_jax_kernel(inputs):
    """The mirror against the JAX package's kernel (interpret mode) on
    the same rays, on valid rays."""
    name, _, jc, (o, d, excl, valid, cap), s = inputs
    t, pid = ps.mt_stream_split_reference(*args(s), **KW)
    t, pid = t.reshape(-1)[: s.n].numpy()[valid], pid.reshape(-1)[: s.n].numpy()[valid]
    jt, jpid = jps.stream_closest_hit(
        jc, *(None if x is None else jnp.asarray(x) for x in (o, d, excl, valid, cap)),
        interpret=True, **KW,
    )
    jt, jpid = np.asarray(jt)[valid], np.asarray(jpid)[valid]
    np.testing.assert_allclose(t, jt, rtol=1e-5)
    diff = pid != jpid
    assert diff.mean() <= 1e-3, f"{diff.sum()} pids differ"
    assert (np.abs(t[diff] - jt[diff]) <= 1e-5 * np.abs(jt[diff])).all()
    assert 0.05 < (pid != 0).mean()
    assert (t[pid == 0] == MISS).all()


def test_stream_item_size_mirrors_the_kernel():
    """The mirror's default item size is the kernel's compile-time one
    (``ITEM_STREAM`` in csrc/mt_stream.cu)."""
    src = (cuda.CSRC / "mt_stream.cu").read_text()
    (size,) = re.findall(r"ITEM_STREAM = (\d+)", src)
    assert int(size) == ps.STREAM_ITEM_SIZE >= 1


def test_stream_split_edges(inputs):
    """No set chunk anywhere: every ray misses."""
    _, _, _, _, s = inputs
    zero = torch.zeros_like(s.counts)
    want = ps.mt_stream_reference(*args(s, counts=zero), **KW)
    got = ps.mt_stream_split_reference(*args(s, counts=zero), **KW)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert bool((got[0] == MISS).all() and (got[1] == 0).all())
