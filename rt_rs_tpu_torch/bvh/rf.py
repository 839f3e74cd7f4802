"""Reduced-footprint BVH packing (16-byte records).

Counterpart of ``rt_rs_tpu/bvh/rf.py``, with its format (parity with
``RfBvhIntrs``, ``src/lib/handlers/rf.rs``):

* every record is 16 bytes: ``bounds: [u32; 3]`` + ``tag: u32``
  (rf.rs:8-14);
* bounds pack each axis as two f16s, ``(min, max)`` in the low/high
  halves of a u32 (rf.rs:87-92, WGSL ``unpack2x16float`` rf.rs:400-406);
* an interior node's tag is ``fst << 16 | snd`` (15-bit child record
  indices); a leaf sets the tag MSB and is followed by a *second* 16-byte
  record whose 8 u16 slots hold the leaf's prim ids, 0-padded
  (rf.rs:94-127);
* child indices account for the interleaved leaf-payload records
  (rf.rs:130-158), computed from a prefix count of leaves;
* structural limits: <= 8 prims per leaf, < 2^15 records, prim ids
  < 2^16 (pdf p.13-14 §3.2.2).  The reference panics past them; both
  packages raise ``RfFormatError``.

The JAX package's two deliberate divergences from the reference
(PARITY.md) are kept: a slot holds ``prim_id + 1`` (the null-prefixed id
space; 0 = empty), and f16 bounds round *outward* (min down, max up), so
a culling walk never loses a hit to rounding.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rt_rs_tpu_torch.bvh import BvhData


class RfFormatError(ValueError):
    """A structural limit of the RF format was exceeded."""


MAX_LEAF_ITEMS = 8
MAX_RECORDS = 1 << 15
MAX_PRIM_ID = 1 << 16


def _f16_down(x: np.ndarray) -> np.ndarray:
    """Largest f16 <= x (conservative min bound)."""
    h = x.astype(np.float16)
    too_big = h.astype(np.float32) > x
    return np.where(too_big, np.nextafter(h, np.float16(-np.inf)), h)


def _f16_up(x: np.ndarray) -> np.ndarray:
    """Smallest f16 >= x (conservative max bound)."""
    h = x.astype(np.float16)
    too_small = h.astype(np.float32) < x
    return np.where(too_small, np.nextafter(h, np.float16(np.inf)), h)


def pack2x16(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Two f16 -> u32 (lo in low bits; rf.rs:87-92 cast layout)."""
    lo_bits = lo.astype(np.float16).view(np.uint16).astype(np.uint32)
    hi_bits = hi.astype(np.float16).view(np.uint16).astype(np.uint32)
    return lo_bits | (hi_bits << 16)


def unpack2x16(u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    lo = (u & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    hi = (u >> 16).astype(np.uint16).view(np.float16).astype(np.float32)
    return lo, hi


@dataclasses.dataclass
class RfData:
    """Packed record array: [R, 4] uint32 (bounds x3 + tag)."""

    records: np.ndarray  # [R, 4] uint32

    @property
    def num_records(self) -> int:
        return int(self.records.shape[0])

    def byte_size(self) -> int:
        """16 B per record (rf.rs:216-219)."""
        return 16 * self.num_records


def pack_rf(
    data: BvhData,
    cover_min: np.ndarray | None = None,
    cover_max: np.ndarray | None = None,
) -> RfData:
    """BvhData -> RF records (rf.rs:76-158).

    ``cover_min/max`` override the stored bounds (used to pack truly
    covering bounds; see ``BvhData.cover_bounds``)."""
    n = data.num_nodes
    leaf = data.is_leaf()
    bmin = data.bounds_min if cover_min is None else cover_min
    bmax = data.bounds_max if cover_max is None else cover_max

    # Record index of each node after payload interleaving: node i's
    # record index = i + (#leaves among nodes 0..i-1)  (rf.rs:130-158).
    leaves_before = np.concatenate([[0], np.cumsum(leaf[:-1])])
    rec_index = np.arange(n) + leaves_before
    total = n + int(leaf.sum())
    if total >= MAX_RECORDS:
        raise RfFormatError(
            f"{total} records exceeds the 15-bit index limit ({MAX_RECORDS})"
        )

    records = np.zeros((total, 4), dtype=np.uint32)
    for i in range(n):
        r = int(rec_index[i])
        records[r, 0] = pack2x16(_f16_down(bmin[i, 0]), _f16_up(bmax[i, 0]))
        records[r, 1] = pack2x16(_f16_down(bmin[i, 1]), _f16_up(bmax[i, 1]))
        records[r, 2] = pack2x16(_f16_down(bmin[i, 2]), _f16_up(bmax[i, 2]))
        if leaf[i]:
            records[r, 3] = np.uint32(1 << 31)
            lo = int(data.item_idx[i])
            count = int(data.item_count[i])
            if count > MAX_LEAF_ITEMS:
                raise RfFormatError(
                    f"leaf with {count} prims exceeds the 8-slot payload"
                )
            slots = np.zeros(8, dtype=np.uint32)
            for k in range(count):
                pid = int(data.indices[lo + k]) + 1  # null-prefixed id space
                if pid >= MAX_PRIM_ID:
                    raise RfFormatError(f"prim id {pid} exceeds u16")
                slots[k] = pid
            # Payload record: 8 u16 packed into 4 u32 (rf.rs:105-117).
            payload = slots[0::2] | (slots[1::2] << 16)
            records[r + 1] = payload
        else:
            f = int(rec_index[int(data.fst[i])])
            s = int(rec_index[int(data.snd[i])])
            records[r, 3] = np.uint32((f << 16) | (s & 0xFFFF))
    return RfData(records=records)


def unpack_rf(rf: RfData) -> dict:
    """RF records -> traversal-friendly SoA (used by the rf handler and
    the round-trip tests).

    Returns bounds [R,3]x2 float32, is_leaf [R] bool, fst/snd [R] int32,
    leaf_prims [R, 8] int32 (0 = empty slot; only valid where is_leaf).
    Payload records are marked with valid=False.
    """
    rec = rf.records
    r = rec.shape[0]
    bmin = np.zeros((r, 3), dtype=np.float32)
    bmax = np.zeros((r, 3), dtype=np.float32)
    for ax in range(3):
        lo, hi = unpack2x16(rec[:, ax])
        bmin[:, ax] = lo
        bmax[:, ax] = hi
    tag = rec[:, 3]
    fst = ((tag >> 16) & 0x7FFF).astype(np.int32)
    snd = (tag & 0xFFFF).astype(np.int32)

    # Identify leaf/payload records STRUCTURALLY (a sequential walk:
    # every leaf record is followed by exactly one payload record).
    # Testing the raw MSB alone misclassifies payload words whose
    # slot-7 prim id >= 2^15 (bit 31 set) as leaves.
    msb = (tag >> 31) & 1 == 1
    is_leaf = np.zeros(r, dtype=bool)
    is_payload = np.zeros(r, dtype=bool)
    i = 0
    while i < r:
        if msb[i]:
            is_leaf[i] = True
            if i + 1 < r:
                is_payload[i + 1] = True
            i += 2
        else:
            i += 1

    leaf_prims = np.zeros((r, 8), dtype=np.int32)
    payload_rows = np.where(is_leaf)[0] + 1
    for row in payload_rows:
        words = rec[row]
        slots = np.zeros(8, dtype=np.int32)
        slots[0::2] = words & 0xFFFF
        slots[1::2] = (words >> 16) & 0xFFFF
        leaf_prims[row - 1] = slots
    return dict(
        bmin=bmin,
        bmax=bmax,
        is_leaf=is_leaf,
        is_payload=is_payload,
        fst=fst,
        snd=snd,
        leaf_prims=leaf_prims,
    )
