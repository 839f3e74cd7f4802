"""The port's tracing: work counted inside its kernels, and the
renderer's own steps as host spans, both on while a ``torch.profiler``
session records.

Tracing is on exactly while a profiler session records
(``torch.autograd.profiler._is_profiler_enabled``); there is no other
switch.  A dispatch of ``animate(chain=K)`` and an eager frame each
check it once (:func:`begin`).

**Device counters.**  One int64 buffer per device (:func:`buffer`),
kept here so that it outlives every ``Renderer`` (and is not reachable
from its accel).  Word 0 is the enable flag; then :data:`SUB` words for
each counter of :data:`COUNTERS`.  Kernels B (its prologue), D, F, G, the records walk,
the wide refit and the wide build take the buffer's address and a counter's index as launch arguments,
which a CUDA graph captures as they are, so one graph serves tracing on
and off.  Each block reads the flag once; when it is 0 the block does
nothing more, and when it is 1 the block adds its counts with one
``atomicAdd`` a counter into word ``blockIdx.x % SUB`` of that counter
(csrc/common.cuh).  On the CPU the wrappers add the twins' same counts
to the CPU's buffer while its flag is set.  The first check that sees a
session zeroes the device's counters and sets its flag; the first that
sees none clears it.  A session that follows another with no check in
between continues its counts.

* ``live_rays.b`` / ``slots.b`` (b = 0 .. 7; bounces from 7 on count
  as 7): the rays a bounce shades (``active_f`` set) and the ray slots
  launched (T x r), by kernel D, or kernel F for ``fuse_bounce``;
* ``cull_entries.<mode>.<cull>``: the chunk-list entries a cull kept
  (the sum of ``counts`` that kernel B's prologue reads), by mode
  (closest, rows, anyhit) and cull (``interval``: the tile-interval
  cull of primaries; ``refine``: the per-ray cull of refined batches);
* ``walk_rays``, ``walk_nodes``, ``walk_prims``: kernel G's valid rays,
  wide-node visits and prim tests (the wide walk's counts,
  ``bvh_walk_wide_reference``'s ``WideWork``), in every mode;
* ``walk_anyhit``, ``walk_blocked``: the valid rays kernel G walks in
  its any-hit mode, and those of them that stopped at a blocker;
* ``rf_rays``, ``rf_records``, ``rf_prims``: the RF records walk's
  (``csrc/bvh_walk_rf.cu``) valid rays, the node records whose box it
  tests and the slots it tests (empty and excluded slots skipped), in
  every mode (``ops/bvh_walk_rf.py``'s ``RfWork``);
* ``refit_prims``, ``refit_nodes``: the packed prim records and the
  wide nodes' child slots that ``DynamicRenderer``'s per-frame refit of
  kernel G's tree rewrites (``csrc/wide_refit.cu``);
* ``rebuild_prims``, ``rebuild_nodes``: the packed prim records and the
  wide nodes that ``DynamicRenderer``'s per-frame build of kernel G's
  tree writes (``csrc/wide_build.cu``).

Other kernels (``mt_stream``, ``refine_cull``, ``shade_pre``, the
probes) count nothing.

**Spans.**  :func:`span` is a host span on the profiler's own clock and
timeline, a no-op while tracing is off.  It is a ``RecordFunction`` of
the function scope (``torch._C._profiler._RecordFunctionFast``), not
``torch.profiler.record_function``: a user-scope range also puts an
annotation of its name on the device's timeline, over the kernels
launched inside it, which a reader of device operations would count as
device time.  The set-up steps also add their seconds to always-on
totals (:func:`setup`).

:func:`snapshot` is the one read path: it syncs and returns the
counters, the frames counted, the set-up totals and the kernel launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.autograd.profiler as _profiler

SUB = 32  # words a counter (kTraceSub in csrc/common.cuh)
BOUNCES = 8  # bounces counted apart
MODES = ("closest", "rows", "anyhit")  # kernel B's modes (packet_trace.MT_MODES)
CULLS = ("interval", "refine")
COUNTERS = (
    *(f"{name}.{b}" for b in range(BOUNCES) for name in ("live_rays", "slots")),
    *(f"cull_entries.{mode}.{cull}" for mode in MODES for cull in CULLS),
    "walk_rays", "walk_nodes", "walk_prims", "walk_anyhit", "walk_blocked",
    "rf_rays", "rf_records", "rf_prims",
    "refit_prims", "refit_nodes",
    "rebuild_prims", "rebuild_nodes",
)
INDEX = {name: i for i, name in enumerate(COUNTERS)}
WORDS = 1 + SUB * len(COUNTERS)
# The always-on set-up totals: seconds, and how many times.
TOTALS = ("capture_s", "captures", "build_s", "library_s", "library_built")


@dataclasses.dataclass
class _State:
    """The host's side of the counters: the sessions seen, the frames
    counted in the newest, each device's armed session (its flag set;
    None: clear) and the session its counters were zeroed for."""

    on: bool = False
    session: int = 0
    frames: int = 0
    armed: dict = dataclasses.field(default_factory=dict)
    zeroed: dict = dataclasses.field(default_factory=dict)
    totals: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(TOTALS, 0))


_STATE = _State()
_BUFFERS: dict[torch.device, torch.Tensor] = {}
_NO_SPAN = contextlib.nullcontext()


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def buffer(device) -> torch.Tensor:
    """The device's counter buffer [WORDS] int64, made at first use,
    never during a CUDA graph capture (its address is captured)."""
    device = _key(device)
    buf = _BUFFERS.get(device)
    if buf is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the trace buffer must exist before a CUDA graph capture")
        buf = _BUFFERS[device] = torch.zeros(WORDS, dtype=torch.int64, device=device)
    return buf


def bounce_counter(bounce: int) -> str:
    """Kernel D's and F's first counter for bounce ``bounce``
    (``live_rays.b``; ``slots.b`` follows it)."""
    return f"live_rays.{min(bounce, BOUNCES - 1)}"


def cull_counter(mode: str, refine) -> str:
    """The ``cull_entries`` counter of a kernel B call in ``mode``."""
    return f"cull_entries.{mode}.{'refine' if refine else 'interval'}"


def kernel_args(device, counter: str | None) -> tuple[int | None, int]:
    """A counting kernel's launch arguments: the buffer's address and
    ``counter``'s index (its next counters follow it); (None, 0) counts
    nothing."""
    if counter is None:
        return None, 0
    return buffer(device).data_ptr(), INDEX[counter]


def begin(device, frames: int) -> None:
    """Check tracing, once per dispatch or eager frame of ``frames``
    frames on ``device``.  Arms the device's counters at the first check
    in a session (zeroed, flag set) and counts the frames; disarms them
    at the first check outside one."""
    on, st = _profiler._is_profiler_enabled, _STATE
    device = _key(device)
    if on and not st.on:
        st.session += 1
        st.frames = 0
    st.on = on
    if on:
        if st.armed.get(device) != st.session:
            buf = buffer(device)
            buf.zero_()
            buf[0] = 1
            st.armed[device] = st.zeroed[device] = st.session
        st.frames += frames
    elif st.armed.get(device) is not None:
        buffer(device)[0] = 0
        st.armed[device] = None


def add_frames(frames: int) -> None:
    """Count ``frames`` more frames rendered while tracing is on (a
    capture's warm-up frame)."""
    if _STATE.on:
        _STATE.frames += frames


def counting(device) -> bool:
    """Whether ``device``'s counters are armed (the CPU twins count)."""
    return _STATE.armed.get(_key(device)) is not None


def add(device, counter: str, value: int) -> None:
    """Add ``value`` to ``counter`` on ``device`` (the CPU's twins)."""
    buffer(device)[1 + INDEX[counter] * SUB] += int(value)


def span(name: str):
    """A host span ``name`` on the profiler's timeline while tracing is
    on, else a shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def setup(name: str, seconds: str, count: str | None = None):
    """A set-up step: span ``name``, its ``time.perf_counter`` seconds
    added to the total ``seconds`` and, if given, 1 to ``count``."""
    t0 = time.perf_counter()
    with span(name):
        yield
    _STATE.totals[seconds] += time.perf_counter() - t0
    if count is not None:
        _STATE.totals[count] += 1


def count_setup(count: str) -> None:
    """Add 1 to the set-up total ``count``."""
    _STATE.totals[count] += 1


def snapshot() -> dict:
    """Sync and read: the counters of the newest session (by name;
    ``live_rays`` and ``slots`` as lists by bounce, ``cull_entries`` by
    ``<mode>.<cull>``), ``frames`` counted in it, the set-up totals and
    a copy of ``ops.cuda.LAUNCHES`` as ``launches``."""
    from rt_rs_tpu_torch.ops import cuda

    st = _STATE
    sums = torch.zeros(len(COUNTERS), dtype=torch.int64)
    for device, buf in _BUFFERS.items():
        if st.session and st.zeroed.get(device) == st.session:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            sums += buf[1:].cpu().reshape(len(COUNTERS), SUB).sum(dim=1)
    c = dict(zip(COUNTERS, sums.tolist()))
    return {
        "live_rays": [c[f"live_rays.{b}"] for b in range(BOUNCES)],
        "slots": [c[f"slots.{b}"] for b in range(BOUNCES)],
        "cull_entries": {f"{m}.{k}": c[f"cull_entries.{m}.{k}"] for m in MODES for k in CULLS},
        "walk_rays": c["walk_rays"],
        "walk_nodes": c["walk_nodes"],
        "walk_prims": c["walk_prims"],
        "walk_anyhit": c["walk_anyhit"],
        "walk_blocked": c["walk_blocked"],
        **{
            k: c[k]
            for k in ("rf_rays", "rf_records", "rf_prims", "refit_prims", "refit_nodes", "rebuild_prims", "rebuild_nodes")
        },
        "frames": st.frames,
        **st.totals,
        "launches": dict(cuda.LAUNCHES),
    }
