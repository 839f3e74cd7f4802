"""Carry state from the JAX package into the port.

The port never imports ``jax`` or ``rt_rs_tpu``, so these take the JAX
package's objects by duck typing: anything whose fields ``numpy.asarray``
reads (a ``rt_rs_tpu`` ``SceneArrays`` or ``TriChunks``, or a namespace
of numpy arrays).  Parity tests use them to run both packages on the
same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rt_rs_tpu_torch.bvh import BvhData
from rt_rs_tpu_torch.bvh.rf import RfData
from rt_rs_tpu_torch.experiments.tpose_table import TposeTables
from rt_rs_tpu_torch.ops.packet_trace import DualTriChunks, SegmentedTriChunks, TriChunks
from rt_rs_tpu_torch.scene.arrays import SceneArrays


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX arrays are read-only


def scene_arrays(src, *, device: str | torch.device) -> SceneArrays:
    """The JAX package's ``SceneArrays`` (same field names) -> the
    port's, value for value."""
    fields = {}
    for f in dataclasses.fields(SceneArrays):
        v = getattr(src, f.name)
        fields[f.name] = (
            bool(v) if f.name == "no_negative_materials" else _tensor(v, device)
        )
    return SceneArrays(**fields)


def bvh_data(src) -> BvhData:
    """The JAX package's ``BvhData`` (same field names) -> the port's,
    value for value (host NumPy arrays, as in both packages)."""
    return BvhData(
        **{f.name: np.array(getattr(src, f.name)) for f in dataclasses.fields(BvhData)}
    )


def rf_data(src) -> RfData:
    """The JAX package's ``RfData`` -> the port's (its ``[R, 4]``
    uint32 records)."""
    return RfData(records=np.array(src.records, dtype=np.uint32))


def tri_chunks(
    comp,  # [Nc, tc, 128] f32: a, e1, e2 in lanes 0..8
    bmin,  # [Nc, 3]
    bmax,  # [Nc, 3]
    num_chunks: int,
    attr_t=None,  # [Nc, 32, 128] f32: attr_t[c, j, s] = row 1 + c*tc + s
    *,
    device: str | torch.device,
) -> TriChunks:
    """The JAX package's lane-padded ``TriChunks`` arrays -> the port's
    compact table: ``comp [Nc, tc, 9]`` and the rows table
    ``attr [Nc * tc + 1, 32]`` (a zero miss row, then prim rows 1..)."""
    comp = np.asarray(comp, dtype=np.float32)
    nc, tc = comp.shape[0], comp.shape[1]
    if nc != num_chunks:
        raise ValueError(f"comp has {nc} chunks, num_chunks says {num_chunks}")
    attr = None
    if attr_t is not None:
        rows = np.asarray(attr_t, dtype=np.float32)[:, :, :tc].transpose(0, 2, 1)
        attr = np.zeros((nc * tc + 1, 32), dtype=np.float32)
        attr[1:] = rows.reshape(nc * tc, 32)
    return TriChunks(
        comp=_tensor(comp[:, :, :9], device),
        bmin=_tensor(np.asarray(bmin, dtype=np.float32), device),
        bmax=_tensor(np.asarray(bmax, dtype=np.float32), device),
        num_chunks=int(num_chunks),
        attr=None if attr is None else _tensor(attr, device),
    )


def segmented_chunks(src, *, device: str | torch.device) -> SegmentedTriChunks:
    """The JAX package's ``SegmentedTriChunks`` (segments of lane-padded
    tables, each with its slice of ``attr_t``) -> the port's: the same
    segments as views on one compact table, sharing one global rows
    table.  Raises if the JAX package's ``prim_base`` is not the
    segments' chunk offsets times ``tc``."""
    segs = list(src.segments)

    def cat(field):
        parts = [getattr(s, field) for s in segs]
        if any(p is None for p in parts):
            return None
        return np.concatenate([np.asarray(p, dtype=np.float32) for p in parts])

    flat = tri_chunks(
        cat("comp"), cat("bmin"), cat("bmax"), sum(s.num_chunks for s in segs),
        attr_t=cat("attr_t"), device=device,
    )
    tc = flat.tri_chunk
    parts, bases, c0 = [], [], 0
    for s in segs:
        c1 = c0 + int(s.num_chunks)
        parts.append(
            TriChunks(
                comp=flat.comp[c0:c1], bmin=flat.bmin[c0:c1], bmax=flat.bmax[c0:c1],
                num_chunks=c1 - c0, attr=flat.attr,
            )
        )
        bases.append(c0 * tc)
        c0 = c1
    if tuple(bases) != tuple(int(b) for b in src.prim_base):
        raise ValueError(f"prim_base {tuple(src.prim_base)} != chunk offsets {tuple(bases)}")
    return SegmentedTriChunks(segments=tuple(parts), prim_base=tuple(bases))


def dual_chunks(src, *, device: str | torch.device) -> DualTriChunks:
    """The JAX package's ``DualTriChunks`` -> the port's: each of its
    ``coarse`` and ``fine`` tables carried across as a resident table
    (:func:`tri_chunks`) or a segmented one (:func:`segmented_chunks`)."""

    def table(t):
        if hasattr(t, "segments"):
            return segmented_chunks(t, device=device)
        return tri_chunks(t.comp, t.bmin, t.bmax, t.num_chunks, attr_t=t.attr_t, device=device)

    return DualTriChunks(coarse=table(src.coarse), fine=table(src.fine))


def mxu_table(table, *, device: str | torch.device) -> torch.Tensor:
    """The JAX probe's ``build_mxu_table`` result ``[Nc, 16, 4 tc]`` ->
    the port's tensor (the same layout)."""
    return _tensor(np.asarray(table, dtype=np.float32), device)


def tpose_tables(comp, bmin, bmax, num_chunks: int, *, device: str | torch.device) -> TposeTables:
    """The JAX probe's ``build_tri_chunks_t`` tuple (comp ``[Nc, 16,
    tc]``, bmin, bmax, nc) -> the port's
    :class:`~rt_rs_tpu_torch.experiments.tpose_table.TposeTables`."""
    f32 = lambda a: _tensor(np.asarray(a, dtype=np.float32), device)  # noqa: E731
    return TposeTables(f32(comp), f32(bmin), f32(bmax), int(num_chunks))
