"""On-device LBVH construction: Morton codes, a stable sort, Karras'
radix-tree emit and a bottom-up bounds refit.

Counterpart of ``rt_rs_tpu/ops/lbvh.py``, which is XLA code (no Pallas
kernel): here torch ops on the tensors' own device, every step in the
JAX package's operation order so that codes, order, hierarchy and
bounds are bit-equal to it.

1. Triangle centroids are quantized to 10 bits per axis and
   interleaved into 30-bit Morton codes (x major).
2. A stable sort of the codes is the leaf order.
3. Karras (2012) emits each internal node's range and split in parallel;
   equal codes continue into the index bits (the ``code << 32 | i``
   key).
4. Node bounds are refit by a fixed number of union sweeps.

For the packet kernels the sorted order is the whole product: runs of
Morton-consecutive prims are spatially local, so a chunk table over
that order is the "build" (``handlers/lbvh.py``).  The hierarchy feeds
:func:`rt_rs_tpu_torch.bvh.device.build_bvh_device`.

Integer widths: the JAX package works in uint32 and lets products wrap.
Codes are below 2^30 and indices below 2^31, so the port keeps them in
int64 and masks each product to 32 bits where the JAX package wraps
(:func:`_clz32`).  A NaN centroid (a non-finite vertex) quantizes to 0
on every device, which is what XLA:CPU's float-to-uint32 conversion
gives (``tests/test_torch_lbvh.py`` pins it).
"""

from __future__ import annotations

import torch

from rt_rs_tpu_torch.ops.packet_trace import _f32

_U32 = 0xFFFFFFFF
# The bounds of an empty union (and of a pad triangle in the device
# chunk builder), as in the JAX package.
BIG = 3.0e38
# The fixed loop counts of the JAX package (fori_loop bounds).
SEARCH_STEPS = 32
REFIT_SWEEPS = 64


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value to every 3rd bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(
    centroids: torch.Tensor,  # [P, 3] float32
    lo: torch.Tensor,  # [3]
    hi: torch.Tensor,  # [3]
) -> torch.Tensor:
    """30-bit Morton codes (x major, then y, z) -> int32 [P].

    ``((c - lo) / max(hi - lo, 1e-30)) * 1024`` clipped to [0, 1023] and
    truncated, as in the JAX package; NaN quantizes to 0."""
    dev = centroids.device
    extent = torch.maximum(hi - lo, _f32(1e-30, dev))
    q = torch.clamp(((centroids - lo[None, :]) / extent[None, :]) * _f32(1024.0, dev), 0.0, 1023.0)
    q = torch.where(torch.isnan(q), _f32(0.0, dev), q).to(torch.int64)
    sx = _expand_bits_10(q[:, 0])
    sy = _expand_bits_10(q[:, 1])
    sz = _expand_bits_10(q[:, 2])
    return ((sx << 2) | (sy << 1) | sz).to(torch.int32)


def morton_order(codes: torch.Tensor) -> torch.Tensor:
    """Stable sort permutation of the codes -> int32 [P] (equal codes
    keep their index order, as ``jnp.argsort(stable=True)``)."""
    return torch.sort(codes, stable=True).indices.to(torch.int32)


def centroid_codes(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Triangle corners [P, 3] -> their Morton codes over the corners'
    bounding box: centroid ``(a + b + c) * f32(1/3)``, box from the
    corners' minima and maxima (the JAX package's build prologue)."""
    cent = (a + b + c) * _f32(1.0 / 3.0, a.device)
    lo = torch.minimum(torch.minimum(a, b), c).amin(dim=0)
    hi = torch.maximum(torch.maximum(a, b), c).amax(dim=0)
    return morton_codes(cent, lo, hi)


def _clz32(v: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64 (bit smear, then a
    popcount whose multiply wraps at 32 bits as uint32 does)."""
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    v = v | (v >> 16)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = ((((v + (v >> 4)) & 0x0F0F0F0F) * 0x01010101) & _U32) >> 24
    return 32 - v


def karras_splits(codes_sorted: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Karras' (2012) parallel radix-tree emit over sorted codes, every
    internal node at once -> ``(i, j, gamma)`` int64 [P-1]: internal
    node ``i`` covers the sorted keys from ``min(i, j)`` to ``max(i,
    j)`` and splits after key ``gamma`` (its children are ``gamma`` and
    ``gamma + 1``, each a leaf where its range is that one key).  Equal
    codes continue into the index bits (the ``code << 32 | i`` key), so
    the keys are distinct and the tree is unique.  P >= 2."""
    n = codes_sorted.shape[0]
    dev = codes_sorted.device
    codes = codes_sorted.to(torch.int64)
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    ci = codes[: n - 1]

    def delta(j):
        """Common-prefix length of keys i and j (code in the high half,
        index in the low half); -1 outside [0, n)."""
        valid = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        x = ci ^ codes[jc]
        d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
        return torch.where(valid, d, -1)

    d = torch.sign(delta(i + 1) - delta(i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i - d)

    # Exponential search for an upper bound of the range's length.
    lmax = torch.full((n - 1,), 2, dtype=torch.int64, device=dev)
    for _ in range(SEARCH_STEPS):
        lmax = torch.where(delta(i + lmax * d) > delta_min, lmax * 2, lmax)

    # Binary search for the range's other end j.
    l = torch.zeros((n - 1,), dtype=torch.int64, device=dev)  # noqa: E741
    t = lmax
    for _ in range(SEARCH_STEPS):
        t = torch.clamp_min(torch.div(t, 2, rounding_mode="floor"), 1)
        l = torch.where(delta(i + (l + t) * d) > delta_min, l + t, l)  # noqa: E741
    j = i + l * d
    delta_node = delta(j)

    # Split search: s += t for t = ceil(l/2), ceil(l/4), ... while the
    # prefix stays longer than delta_node.  The JAX package clamps the
    # doubling at 2^30 (32 unguarded doublings overflow int32); once
    # div > l, t is 1 for good, so the clamp changes no step.
    s = torch.zeros((n - 1,), dtype=torch.int64, device=dev)
    div = torch.full((n - 1,), 2, dtype=torch.int64, device=dev)
    for _ in range(SEARCH_STEPS):
        t = torch.div(l + div - 1, div, rounding_mode="floor")
        probe = delta(i + (s + t) * d) > delta_node
        s = torch.where(probe & (t >= 1), s + t, s)
        div = torch.clamp_max(div * 2, 1 << 30)
    return i, j, i + s * d + torch.clamp_max(d, 0)


def karras_hierarchy(codes_sorted: torch.Tensor):
    """Parallel radix-tree emit (Karras 2012) over sorted codes
    (:func:`karras_splits`).

    Returns ``(left, right, left_leaf, right_leaf, parent_leaf,
    parent_internal)``: ``left`` / ``right`` [P-1] int32 child indices,
    ``left_leaf`` / ``right_leaf`` [P-1] bool (the child is a leaf),
    and parent pointers ([P] and [P-1] int32).  Duplicate codes are
    told apart by index."""
    n = codes_sorted.shape[0]
    dev = codes_sorted.device
    i32 = dict(dtype=torch.int32, device=dev)
    if n < 2:
        z = torch.zeros((0,), **i32)
        f = torch.zeros((0,), dtype=torch.bool, device=dev)
        return z, z, f, f, torch.zeros((n,), **i32), torch.zeros((0,), **i32)

    i, j, gamma = karras_splits(codes_sorted)
    left = gamma
    right = gamma + 1
    left_leaf = torch.minimum(i, j) == gamma
    right_leaf = torch.maximum(i, j) == gamma + 1

    # Parent pointers: masked scatters, the misses into a dropped slot.
    parent_leaf = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    parent_leaf.scatter_(0, torch.where(left_leaf, left, n), i)
    parent_leaf.scatter_(0, torch.where(right_leaf, right, n), i)
    parent_internal = torch.zeros((n,), dtype=torch.int64, device=dev)
    parent_internal.scatter_(0, torch.where(~left_leaf, left, n - 1), i)
    parent_internal.scatter_(0, torch.where(~right_leaf, right, n - 1), i)
    return (
        left.to(torch.int32),
        right.to(torch.int32),
        left_leaf,
        right_leaf,
        parent_leaf[:n].to(torch.int32),
        parent_internal[: n - 1].to(torch.int32),
    )


def refit_bounds(
    left: torch.Tensor,
    right: torch.Tensor,
    left_leaf: torch.Tensor,
    right_leaf: torch.Tensor,
    leaf_min: torch.Tensor,  # [P, 3] bounds of the sorted leaves
    leaf_max: torch.Tensor,
    sweeps: int = REFIT_SWEEPS,
):
    """Bottom-up node bounds by ``sweeps`` union sweeps over every
    internal node (``sweeps`` bounds the tree depth it converges for)
    -> (node_min, node_max) [P-1, 3]."""
    n1 = left.shape[0]
    dev = leaf_min.device
    big = _f32(BIG, dev)
    nmin = big.expand(n1, 3).clone()
    nmax = (-big).expand(n1, 3).clone()
    li, ri = left.long(), right.long()
    # A leaf child's index may pass the last internal node; the JAX
    # gather clamps it, and the select drops that value.
    lin, rin = torch.clamp_max(li, max(n1 - 1, 0)), torch.clamp_max(ri, max(n1 - 1, 0))
    ll, rl = left_leaf[:, None], right_leaf[:, None]
    for _ in range(sweeps):
        lmin = torch.where(ll, leaf_min[li], nmin[lin])
        lmax = torch.where(ll, leaf_max[li], nmax[lin])
        rmin = torch.where(rl, leaf_min[ri], nmin[rin])
        rmax = torch.where(rl, leaf_max[ri], nmax[rin])
        nmin, nmax = torch.minimum(lmin, rmin), torch.maximum(lmax, rmax)
    return nmin, nmax
