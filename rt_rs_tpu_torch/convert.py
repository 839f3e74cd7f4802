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

from rt_rs_tpu_torch.ops.packet_trace import TriChunks
from rt_rs_tpu_torch.scene.arrays import SceneArrays


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX arrays are read-only


def scene_arrays(src, device: str | torch.device = "cpu") -> SceneArrays:
    """The JAX package's ``SceneArrays`` (same field names) -> the
    port's, value for value."""
    fields = {}
    for f in dataclasses.fields(SceneArrays):
        v = getattr(src, f.name)
        fields[f.name] = (
            bool(v) if f.name == "no_negative_materials" else _tensor(v, device)
        )
    return SceneArrays(**fields)


def tri_chunks(
    comp,  # [Nc, tc, 128] f32: a, e1, e2 in lanes 0..8
    bmin,  # [Nc, 3]
    bmax,  # [Nc, 3]
    num_chunks: int,
    attr_t=None,  # [Nc, 32, 128] f32: attr_t[c, j, s] = row 1 + c*tc + s
    device: str | torch.device = "cpu",
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
