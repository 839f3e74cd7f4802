"""Closest hit over a table traced in streamed blocks (``streaming_mode="dma"``).

Counterpart of ``rt_rs_tpu/ops/pallas/packet_stream.py``.  The host half
is the JAX package's: rays padded to 128-ray tiles in groups of
TILE_GROUP, the ray-major tile-interval cull, and per tile one int32
word per block of ``cpb`` chunks (bit j = the tile may hit chunk j of
the block); per group, the compacted ascending list of blocks any of its
tiles may hit.  Kernel E (:func:`mt_stream`, csrc/mt_stream.cu)
replaces ``_mt_stream_kernel``: it expands each tile's words into its
ascending list of set chunks and runs kernel B's balanced items over
them (:func:`mt_stream_split_reference` mirrors that design); its
plain-PyTorch twin :func:`mt_stream_reference` runs only for CPU
tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops.packet_trace import (
    TILE_GROUP,
    TriChunks,
    _f32,
    chunk_overlap_mask,
    compact,
    mt_chunk_test,
    mt_trace_split_reference,
    twin_slices,
)

BLOCK_SUBLANES = 512  # triangles per block (the JAX package's DMA block)
STREAM_LANES = 128  # rays per tile: the kernel's fixed tile width
# Kernel E's work item: a tile and at most this many consecutive chunks
# of its expanded list.  The kernel's compile-time ITEM_STREAM
# (csrc/mt_stream.cu, tuned on the card, PERF.md); here only the plain
# mirror's default.
STREAM_ITEM_SIZE = 4


def chunks_per_block(tc: int) -> int:
    """Chunks per block: 512 triangles' worth, at most 32 (one bit each
    in the int32 word); 8 at tc = 64."""
    return min(32, max(1, BLOCK_SUBLANES // tc))


@dataclasses.dataclass(frozen=True)
class StreamInputs:
    """What kernel E reads: ``payload [8, T, 128]`` (ox, oy, oz, dx,
    dy, dz, excl, valid), ``table [NB * cpb, tc, 9]`` (the chunk table
    padded to whole blocks), ``words [T, NB]``, ``blockids [T / 32,
    NB]`` and ``counts [T / 32]`` int32; ``n`` real rays."""

    payload: torch.Tensor
    table: torch.Tensor
    words: torch.Tensor
    blockids: torch.Tensor
    counts: torch.Tensor
    n: int


def block_lists(
    overlap: torch.Tensor, cpb: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[T, Nc] chunk mask -> (words [T, NB], blockids [T / 32, NB],
    counts [T / 32]), int32, as the JAX package computes them: bits
    summed with int32 weights (bit 31 is -2^31; the bits are disjoint,
    so the sum never overflows), and each group's blocks ordered by a
    stable argsort of an int32 key (any tile's word nonzero first)."""
    t_tiles, nc = overlap.shape
    nb = -(-nc // cpb)
    bits = torch.nn.functional.pad(overlap, (0, nb * cpb - nc)).to(torch.int32)
    # 1 << j made on the device (no host copy); bit 31 wraps to -2^31 as
    # in NumPy's int32 shift.
    one = torch.ones((), dtype=torch.int64, device=overlap.device)
    weights = (one << torch.arange(cpb, device=overlap.device)).to(torch.int32)
    words = (bits.reshape(t_tiles, nb, cpb) * weights).sum(dim=-1, dtype=torch.int32)
    block_any = (words.reshape(t_tiles // TILE_GROUP, TILE_GROUP, nb) != 0).any(dim=1)
    key = (~block_any).to(torch.int32)
    blockids = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    counts = block_any.sum(dim=1, dtype=torch.int32)
    return words.contiguous(), blockids.contiguous(), counts


def stream_inputs(
    chunks: TriChunks,
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    excl: torch.Tensor,  # [N] int32 global prim ids
    valid: torch.Tensor | None = None,  # [N] bool
    t_cap: torch.Tensor | None = None,  # [N]
    *,
    t_min: float,
    t_max: float,
) -> StreamInputs:
    """The host half of ``stream_closest_hit``: padding, cull and
    block lists."""
    n = o.shape[0]
    nc, tc = chunks.num_chunks, chunks.tri_chunk
    cpb = chunks_per_block(tc)
    # Prim ids travel as f32 (exclusion ids in the payload): exact
    # below 2^24 only.
    if nc * tc + 1 >= 1 << 24:
        raise ValueError(
            f"{nc * tc} triangles exceeds the kernel's exact-f32 prim-id "
            "range (2^24)"
        )
    nb = -(-nc // cpb)
    t_tiles = max(1, -(-n // STREAM_LANES))
    t_tiles = -(-t_tiles // TILE_GROUP) * TILE_GROUP
    n_pad = t_tiles * STREAM_LANES
    shape = (t_tiles, STREAM_LANES)

    def pad(x):  # zero rows up to n_pad, then into tiles
        fill = x.new_zeros((n_pad - n, *x.shape[1:]))
        return torch.cat([x, fill]).reshape(*shape, *x.shape[1:])

    o_p, d_p, excl_p = pad(o), pad(d), pad(excl)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=o.device)
    valid_p = pad(valid)
    cap_p = None if t_cap is None else pad(t_cap)
    overlap = chunk_overlap_mask(
        o_p, 1.0 / d_p, valid_p, chunks.bmin, chunks.bmax,
        t_min=t_min, t_max=t_max, t_cap=cap_p,
    )
    words, blockids, counts = block_lists(overlap, cpb)
    payload = torch.cat(
        [
            o_p.permute(2, 0, 1),
            d_p.permute(2, 0, 1),
            excl_p[None].to(torch.float32),
            valid_p[None].to(torch.float32),
        ]
    ).contiguous()
    table = chunks.comp
    if nb * cpb != nc:
        table = torch.cat([table, table.new_zeros((nb * cpb - nc, tc, 9))])
    return StreamInputs(payload, table.contiguous(), words, blockids, counts, n)


def mt_stream_reference(
    payload: torch.Tensor,  # [8, T, 128]
    table: torch.Tensor,  # [NB * cpb, tc, 9]
    words: torch.Tensor,  # [T, NB] int32
    blockids: torch.Tensor,  # [T / 32, NB] int32
    counts: torch.Tensor,  # [T / 32] int32
    *,
    t_min: float,
    t_max: float,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of kernel E, vectorised over the tiles whose
    group list reaches position ``k`` and whose word for that block is
    nonzero, looping over ``k``.  Per block, the best hit of each ray
    among the chunks whose bit is set (min w, ties to the smallest slot)
    replaces the running best only when strictly nearer: the kernel's
    ascending strict scan."""
    dev = payload.device
    n_tiles, r = payload.shape[1], payload.shape[2]
    nb = words.shape[1]
    cpb, tc = table.shape[0] // nb, table.shape[1]
    blk_tris = cpb * tc
    f = lambda x: _f32(x, dev)  # noqa: E731
    t_min_t, t_max_t, eps_t = f(t_min), f(t_max), f(eps)
    miss = f(float(np.float32(t_max + 1.0)))
    blocks = table.reshape(nb, blk_tris, 9)
    sub = torch.arange(blk_tris, dtype=torch.int32, device=dev)
    chunk_of = (sub // tc)[None, :]  # [1, cpb * tc]
    group = torch.arange(n_tiles, device=dev) // TILE_GROUP
    cnt, lists = counts[group], blockids[group]  # [T], [T, NB]
    best_t = miss.expand(n_tiles, r).clone()
    best_id = torch.zeros((n_tiles, r), dtype=torch.int32, device=dev)
    kmax = int(cnt.max()) if n_tiles else 0
    for k in range(kmax):
        blk_k = lists[:, k].to(torch.int64)  # [T]
        word_k = words.gather(1, blk_k[:, None])[:, 0]  # [T]
        live_tiles = ((cnt > k) & (word_k != 0)).nonzero()[:, 0]
        for sel in twin_slices(live_tiles, blk_tris * r):
            ox, oy, oz, dx, dy, dz, excl = (payload[i, sel][:, None, :] for i in range(7))
            blk = blk_k[sel]  # [S]
            bit = ((word_k[sel][:, None] >> chunk_of) & 1) != 0  # [S, cpb * tc]
            tri = blocks[blk]  # [S, cpb * tc, 9]
            ok, w = mt_chunk_test(
                [tri[:, :, i : i + 1] for i in range(9)], ox, oy, oz, dx, dy, dz,
                t_min=t_min_t, t_max=t_max_t, eps=eps_t,
            )  # [S, cpb * tc, r]
            pid = 1 + blk.to(torch.int32)[:, None] * blk_tris + sub  # [S, cpb * tc]
            ok = ok & (pid.to(torch.float32)[:, :, None] != excl) & bit[:, :, None]
            wm = torch.where(ok, w, miss)
            cmin = wm.amin(dim=1)  # [S, r]
            s_first = torch.where(wm == cmin[:, None, :], sub[:, None], blk_tris).amin(dim=1)
            better = cmin < best_t[sel]
            best_t[sel] = torch.where(better, cmin, best_t[sel])
            first_pid = pid.gather(1, s_first.clamp(max=blk_tris - 1).to(torch.int64))
            best_id[sel] = torch.where(better, first_pid, best_id[sel])
    return best_t, best_id


def stream_lists(
    words: torch.Tensor,  # [T, NB] int32
    blockids: torch.Tensor,  # [T / 32, NB] int32
    counts: torch.Tensor,  # [T / 32] int32
    cpb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel E's expansion -> (ids [T, NB * cpb] int32, counts [T]
    int32): each tile's chunks (block * cpb + bit) whose bit is set in
    its word of a block its group lists, ascending (:func:`compact` of
    that mask)."""
    n_tiles, nb = words.shape
    dev = words.device
    group = torch.arange(n_tiles, device=dev) // TILE_GROUP
    listed = torch.arange(nb, device=dev)[None, :] < counts[group][:, None]  # [T, NB]
    order = blockids[group].to(torch.int64)  # a permutation of the blocks per tile
    w = torch.where(listed, words.gather(1, order), 0)
    w = torch.zeros_like(words).scatter(1, order, w)  # listed words, block order
    bit = (w[:, :, None] >> torch.arange(cpb, device=dev, dtype=torch.int32)) & 1
    return compact(bit.reshape(n_tiles, nb * cpb) != 0)


def mt_stream_split_reference(
    payload: torch.Tensor,
    table: torch.Tensor,
    words: torch.Tensor,
    blockids: torch.Tensor,
    counts: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    per_item: int | None = None,
    order: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel E's design (:func:`mt_stream`'s arguments): the expanded
    lists (:func:`stream_lists`) through kernel B's balanced closest-hit
    mirror, ``per_item`` chunks an item (None: STREAM_ITEM_SIZE), merged
    in the item order ``order`` (:func:`mt_trace_split_reference`).
    Equal to :func:`mt_stream_reference` bit for bit in every order."""
    nb = words.shape[1]
    ids, tile_counts = stream_lists(words, blockids, counts, table.shape[0] // max(nb, 1))
    return mt_trace_split_reference(
        table, payload, ids, tile_counts, t_min=t_min, t_max=t_max, eps=eps, mode="closest",
        per_item=STREAM_ITEM_SIZE if per_item is None else per_item, order=order,
    )


def mt_stream(
    payload: torch.Tensor,
    table: torch.Tensor,
    words: torch.Tensor,
    blockids: torch.Tensor,
    counts: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel E (csrc/mt_stream.cu) -> (t [T, 128] f32, pid [T, 128]
    int32; misses (t_max + 1, 0)).  Outputs for rays whose tile lists
    nothing they could hit are misses; ``valid`` (payload row 7) is not
    read.  CPU tensors run :func:`mt_stream_reference`; CUDA tensors
    launch the kernel: the expansion, the items prologue and the items
    (three launches; see :func:`mt_stream_split_reference`)."""
    kw = dict(t_min=t_min, t_max=t_max, eps=eps)
    if not payload.is_cuda:
        return mt_stream_reference(payload, table, words, blockids, counts, **kw)
    n_tiles, nb = words.shape
    tc = table.shape[1]
    cpb = table.shape[0] // max(nb, 1)
    dev = payload.device
    cuda.check("payload", payload, torch.float32, (8, n_tiles, STREAM_LANES), dev)
    cuda.check("table", table, torch.float32, (nb * cpb, tc, 9), dev)
    cuda.check("words", words, torch.int32, (n_tiles, nb), dev)
    cuda.check("blockids", blockids, torch.int32, (n_tiles // TILE_GROUP, nb), dev)
    cuda.check("counts", counts, torch.int32, (n_tiles // TILE_GROUP,), dev)
    if n_tiles % TILE_GROUP:
        raise ValueError(f"tile count {n_tiles} not a multiple of {TILE_GROUP}")
    if not 1 <= cpb <= 32 or cpb * tc > BLOCK_SUBLANES:
        raise ValueError(f"{cpb} chunks of {tc} per block: expected <= 32 and <= 512 tris")
    out_t = torch.empty((n_tiles, STREAM_LANES), dtype=torch.float32, device=dev)
    out_pid = torch.empty((n_tiles, STREAM_LANES), dtype=torch.int32, device=dev)
    # Scratch (csrc/mt_stream.cu): the expanded lists, the per-ray merge
    # keys and the items' counters and offsets; the kernel fills them.
    ids = torch.empty((n_tiles, nb * cpb), dtype=torch.int32, device=dev)
    tile_counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    keys = torch.empty((n_tiles, STREAM_LANES), dtype=torch.int64, device=dev)
    work = torch.empty((4 * n_tiles + 4,), dtype=torch.int32, device=dev)
    cuda.call(
        "mt_stream", "rt_mt_stream",
        payload.data_ptr(), table.data_ptr(), words.data_ptr(),
        blockids.data_ptr(), counts.data_ptr(), ids.data_ptr(),
        tile_counts.data_ptr(), keys.data_ptr(), work.data_ptr(),
        out_t.data_ptr(), out_pid.data_ptr(), n_tiles, nb, cpb, tc,
        float(t_min), float(t_max), float(eps), float(np.float32(t_max + 1.0)),
    )
    return out_t, out_pid


def stream_closest_hit(
    chunks: TriChunks,
    o: torch.Tensor,
    d: torch.Tensor,
    excl: torch.Tensor,
    valid: torch.Tensor | None = None,
    t_cap: torch.Tensor | None = None,
    *,
    t_min: float,
    t_max: float,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest hit over a chunk table traced in blocks -> (t [N], pid
    [N]); ``valid`` and ``t_cap`` only narrow the cull, so outputs are
    specified for valid rays only."""
    s = stream_inputs(chunks, o, d, excl, valid, t_cap, t_min=t_min, t_max=t_max)
    t, pid = mt_stream(
        s.payload, s.table, s.words, s.blockids, s.counts,
        t_min=t_min, t_max=t_max, eps=eps,
    )
    return t.reshape(-1)[: s.n], pid.reshape(-1)[: s.n]
