#!/usr/bin/env python3
"""On-card smoke run of rt_rs_tpu_torch's frame paths (one NVIDIA GPU).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Twelve paths are driven, the frame paths through ``Renderer(...,
device="cuda")`` and ``DynamicRenderer(..., device="cuda")``:

* ``torus``: ``torus_scene()`` (6,322 triangles), one resident table,
  the emit branch (closest hits, any-hit shadows; the shading kernels
  read each hit's row from the shade table);
* ``segmented``: scenes beyond the resident table split into segments
  (``streaming_mode="segmented"``, ``seg_order="auto"``), the gather
  branch with closest-hit shadows: ``torus_row(2)`` (2 segments) and
  ``torus_canyon()`` (50,562 triangles, 7 segments);
* ``dma``: the same scenes on one table traced in streamed blocks
  (``streaming_mode="dma"``, 128-ray tiles);
* ``knobs``: the frame knobs that default off: the fused bounce kernel
  (``fuse_bounce=True``) and early exit (``handler_kwargs={"early_exit":
  True}``) on ``torus_scene`` and ``torus_row(2)``, early exit on the
  segmented canyon, and the glue-only knobs (``retile``, ``narrow``,
  ``shadow_cull=False``, ``cull_block``, ``refine="all"``);
* ``flat``: the XLA reference path (``shade.render`` through pbvh's flat
  entry, shading in torch) that scenes with a real ``material = -1``
  prim take: ``torus_ghost()`` (6,326 triangles) and ``ghost_scene``;
  the ``blank`` handler (every ray misses) and the ``naive`` one (brute
  force) on ``torus_scene``;
* ``probes``: the JAX package's kernel probes (experiments/roofline.py,
  mxu_mt.py, tpose_table.py) as ``rt_rs_tpu_torch.experiments``: the
  practical f32 rate, the matrix-product and transposed-table closest
  hits on ``torus_scene``'s 1080p primaries, and the canyon rendered
  through the transposed table;
* ``bvh``: the default handler ``bvh`` with the threaded walk
  (``handler_kwargs={"backend": "threaded"}``; kernel G,
  ``csrc/bvh_walk.cu``, over the tree packed 4 wide) and ``rf_bvh``
  with the records walk (``csrc/bvh_walk_rf.cu`` over its 16-byte
  records), the emit branch: ``torus_scene`` (both handlers) and
  ``torus_canyon()`` (``bvh``); and ``bvh`` with ``backend="auto"`` on
  the torus, which takes kernel G's walk on the card too; at 96x72, in
  both handlers, ``deep_chain`` (a tree deeper than the walks' local
  stacks: the scratch kernels) and ``no_prims``, each equal to the
  packet backend's frame;
* ``lbvh``: ``Renderer(torus_scene(), handler="lbvh")``, the chunk
  table built on the card in Morton order;
* ``dynamic``: ``DynamicRenderer`` on ``torus_scene`` moved by
  :func:`wave` (a periodic rise of the vertices along y, in f64 and then
  f32, which changes the Morton order from frame to frame), rebuild and
  ``refit=True`` with ``backend="packet"``: per frame the corner
  gathers, the shade table and the chunk table on the card, then the
  packet kernels; with the on-device builds (ops/lbvh,
  ``build_bvh_device``, ``build_accel_device``, ``device_chunks``) held
  to the same code on the CPU; and the walked
  refit (``backend="threaded"``) on ``torus_row(3)`` (18,962 triangles,
  past the chunk table's cap): per frame ``wide_refit``
  (``csrc/wide_refit.cu``) rewrites kernel G's packed tree, then kernel
  G walks it, each frame held to the CPU's walked frame; and the walked
  rebuild (``backend="threaded"``, refit off) on ``torus_row(3)``: per
  frame ``wide_build`` (``csrc/wide_build.cu``) builds kernel G's tree
  from the frame's corners, its records held bit for bit to the twin's
  (:func:`check_wide_builds`: ``torus_row(3)`` at the rest pose and two
  waved poses, the canyon, the deep chain, one prim), every build call
  of a frame replayed, and timed in phase 6;
* ``dual``: pbvh with ``tri_chunk_fine=16`` (the refined batches sweep
  a second, tc = 16 table), resident torus and segmented canyon;
* ``tools``: the user-facing layer, in a temporary directory
  (:func:`phase_tools`): ``tools.construct`` from an OBJ of
  ``torus_scene`` and ``tools.load --handler-pbvh`` on its scene JSON;
  ``tools.precompute --device`` (the LBVH of ``torus_row(2)`` built on
  the card) and ``tools.load --handler-bvh PATH`` on it (12,642
  triangles: the threaded walk); the study's protocol (``load
  --benchmark``, ``run_benchmark_protocol``: 200 frames over 5 orbits)
  for pbvh, ``bvh`` (``"auto"`` through ``load``, which walks the
  torus on the card; the threaded walk's Renderer timed directly beside
  it) and DynamicRenderer; ``load
  --profile`` in a child process; the web viewer (``web.make_server``)
  and ``utils.animation.render_orbit_gif``; then the card-built
  checkpoint's frame and two viewer frames replayed call by call;
* ``parallel``: multi-device rendering (``rt_rs_tpu_torch.parallel``,
  :func:`phase_parallel`): ``make_sharded_render`` on ranks started by
  ``run_ranks``, four ranks sharing the card over gloo with every case
  of PARALLEL (image bands of pbvh, of the threaded ``bvh`` walk and of
  the flat path; scene shards of the torus, of the canyon (each shard
  past the resident cap, so segmented) and of a padded table), and one
  rank over NCCL; with the native builder's and parser's checks;
* ``chain``: ``Renderer.animate(chain=K)``, one replay of a captured
  CUDA graph of K orbit frames per dispatch, on every frame path above
  (torus, segmented and dma canyon, knobs, flat, blank, naive, the
  threaded ``bvh`` torus, ``lbvh``), and ``DynamicRenderer.animate(chain=K)``
  (rebuild and refit, the per-frame build inside the graph; the walked
  refit on ``torus_row(3)``).

Phases (each prints its own lines; any failure raises and the script
exits nonzero without printing a result):

1. Device: asserts CUDA; prints torch / CUDA / nvcc versions and the
   card's name and power limit.
2. Build: compiles the hand-written kernels (rt_rs_tpu_torch/csrc) with
   nvcc and prints the build time and each kernel's register use.
3. Kernels vs twins on the card.  Every kernel call of one frame is
   recorded and replayed through the kernel and through its
   plain-PyTorch twin: the ``torus_scene`` frame at 384x288, default
   and with the knobs path's knobs, and the ``torus_canyon()`` frame at
   640x480 with segmented tables, with ``"dma"`` and segmented with
   early exit, the flat path's ``torus_ghost()`` frames at 384x288 and
   1920x1080, the canyon through the transposed table at 640x480
   (every mt_tpose call), the threaded ``bvh`` torus frame at 384x288
   and canyon frame at 640x480 (every bvh_walk_tiled call, also against
   the wide design's mirror ``bvh_walk_tiled_wide_reference`` and run
   twice alike), the ``rf_bvh`` torus and ``teapots3`` frames at
   384x288 (every bvh_walk_rf call, run twice alike); then synthetic
   batches through both walks, kernel G in its closest mode and the
   records walk in its three modes:
   axis-parallel, NaN, invalid and excluded rays at the torus, tie rays
   at two coincident copies of it, and the same rays at ``deep_chain``
   and ``no_prims``, which every ray misses),
   a DynamicRenderer rebuild frame at 384x288 (frame DYNAMIC_FRAME of the
   wave), the dual pbvh torus frame at 384x288 and the dual segmented
   canyon frame at 640x480 (``mt_trace`` and ``refine_cull`` at tc = 16).
   Intersection and refine outputs (t, pid, rows, blocked,
   overlap masks, compacted ids and counts) must be bit-equal, and each
   mt_trace, mt_stream, mt_tpose, mt_mxu and refine_cull call, run twice,
   gives the same bits (the balanced designs merge their items with
   atomics in no fixed order); mt_stream and mt_tpose also equal their
   designs' mirrors (``mt_stream_split_reference``,
   ``mt_tpose_split_reference``).  Early-exit mt_trace calls equal the
   balanced design's mirror (``mt_trace_exit_split_reference``) on every
   ray, and the twin and the default mode on the same lists on valid
   rays (outputs are specified there only; the call's ``valid`` is its
   interval cull's) and on every ray of the tiles whose list fits one
   item;
   shading outputs within SHADE_MAX_ULP (the twins use torch's pow,
   whose CUDA build may round differently from the kernels' powf).  Each
   segmented call's (t, pid) must equal one flat call on
   ``flatten_segments`` of its table, and each streamed call's the flat
   closest hit under the same cull, on valid rays.  mt_trace at the
   extremes of balance, in each default mode: one tile listing every
   chunk of a 128-chunk table and the others empty, and every tile
   listing every chunk, bit-equal to its twin and to the balanced
   design's mirror (``mt_trace_split_reference``); early exit likewise
   on the canyon's busiest closest call and the knobs torus primary rows
   call, the lists sorted by the call's own entry bounds; mt_stream on
   256 tiles of the canyon dma frame's busiest call, one tile and then
   every tile listing every chunk of every block, against its twin and
   mirror.  The probes' kernels
   at the JAX mains' sizes: fma_peak (separate bit-equal, fused within
   rtol 1e-6), mt_tpose (tc 64 and 128) bit-equal to its twin, its mirror
   and mt_trace[closest] on the same lists, mt_mxu[highest] bit-equal to
   its twin and mirror, [high] and [default] within
   ``mxu_mt.TF32_BOUNDS`` of highest and of their twins' emulation
   (each precision's mirror bit-equal to its twin); both again on the
   256 busiest tiles of those calls (the TF32 variants against their
   twins' emulation) and on the busiest and 255 spread over the image,
   with one tile, then every tile, listing every chunk.  Kernel D
   (shade_post) also on post_cases' synthetic inputs (r 256 and 128, 1-3
   lights, liveness all, none, alternating and a single subgroup, both
   blocked modes, T = 8 and 8 x 45, NaN directions, shadow distances at
   exactly t_min, t_max and the cap; and 5 lights, past its light-count
   instantiations, and 37-ray tiles) and on inputs 4 bytes into their
   storage, bit-equal
   to its twin; every kernel F call also bit-equal to kernels D + C on
   its halves.
4. Paths.  Launch counters are reset right before each path and read
   right after it; every kernel of the path must have launched, and no
   rows mode (ROWS_MODES; the ``chain`` path runs last, as phase 8).
   torus: the 96x72 frame against the JAX package's stored frame
   (tests/data/torch_port_torus_96x72.npz, atol 2e-5), 384x288 and
   1920x1080 frames and orbits (30 and 12 frames).  segmented and dma:
   ``torus_row(2)`` at 96x72 against the JAX package's stored frame
   (tests/data/torch_port_torus_row2_96x72.npz, atol 2e-5); segmented
   also ``gather_band_torus()`` (one table past the rows table's cap:
   the gather branch) at 32x16 against its stored frame
   (tests/data/torch_port_gather_band_32x16.npz, atol 2e-5), its
   distance from the port's CPU frame printed; the canyon
   at 640x480 (both) and 1920x1080 (segmented): finite, not black,
   orbits of 16 and 12 frames; the canyon's segmented and DMA frames at
   640x480 must be bit-equal.  knobs: the 96x72 frames of
   ``torus_scene`` and of segmented ``torus_row(2)`` against the stored
   frames; every other knob frame bit-equal to the default path's frame
   of the same scene and size (torus 384x288 and 1080p, then orbits of
   30 and 12 frames; the canyon at 640x480; a camera with pos == at);
   early exit's sort of NaN keys equal on the card and the CPU.  flat:
   the glue's rsqrt bit-equal to IEEE ``1 / sqrt``; ``torus_ghost()`` at 96x72 and ``ghost_scene(-1)`` / ``(1)`` at
   64x48 against the JAX package's stored frames
   (tests/data/torch_port_torus_ghost_96x72.npz,
   torch_port_ghost_64x48.npz; atol 2e-5), ``torus_ghost()`` orbits
   (384x288, 1080p), a black ``blank`` orbit at 384x288, one timed
   ``naive`` frame at 384x288 with its distance from the pbvh frame.
   probes: ``practical_peak`` fused and separate; the mxu (three
   precisions) and tpose (tc 64, 128; bit-equal to it) closest hits
   against ``packet_closest_hit`` on the same rays, 20 calls each; the
   canyon at 640x480 through ``shade.render`` with the tc = 64
   transposed table, an orbit, and its first frame within atol 2e-5 of
   the segmented Renderer's on all but TPOSE_FAR_SHARE of the values.
   bvh: the threaded ``bvh`` and ``rf_bvh`` torus frames at 96x72
   against the JAX package's stored frames
   (tests/data/torch_port_bvh_torus_96x72.npz, atol 2e-5); the
   ``backend="auto"`` torus frame at 384x288 (kernel G's walk, the
   accel holding a walk tree and no packet table) bit-equal to the pbvh
   frame; orbits of the threaded ``bvh`` torus (384x288, 1080p), the
   ``"auto"`` torus (384x288), the threaded ``bvh`` canyon (640x480,
   1080p: finite, not black) and the ``rf_bvh`` torus through the
   records walk (384x288, 1080p), each with its structure's bytes.
   lbvh: the 96x72 torus frame against the JAX package's stored frame
   (tests/data/torch_port_lbvh_torus_96x72.npz, atol 2e-5), 384x288 (its
   distance from pbvh's frame printed) and an orbit of 30.  dynamic:
   ops/lbvh's codes, order, Karras arrays and refit bounds and
   ``build_bvh_device`` on ``torus_scene`` and ``torus_canyon()``, and
   ``build_accel_device`` / ``device_chunks`` on the moved torus, card =
   CPU bit for bit, ``build_bvh_device``'s seconds on the card; the
   card-built torus tree's 96x72 frame through the threaded ``bvh`` walk
   bit-equal to pbvh's on it; DynamicRenderer 96x72 rebuild and refit at
   the rest pose and frame DYNAMIC_FRAME against the stored frames
   (tests/data/torch_port_dynamic_torus_96x72.npz, atol 2e-5); first
   frames at 384x288 and 1080p.  dual: the torus at 384x288 and 1080p and
   the segmented canyon at 640x480 bit-equal to their single-table
   frames, an orbit of the torus at 384x288.
   parallel (:func:`phase_parallel`, after the paths): the native
   library built in this process first, ``build_bvh`` on the canyon
   native against the NumPy builder (equal arrays, both timed); then one
   ``run_ranks`` call of four ranks on ``cuda:0`` over gloo with every
   case of PARALLEL, and one of a single rank over NCCL
   (PARALLEL_NCCL): every rank's frame bit-equal to
   ``Renderer(...).render_frame()`` at the same size on the card, the
   luminance equal on every rank and within rel 1e-4 of the single
   frame's mean, rank 0's launches of each case's first frame counted
   from 0, ms/frame on rank 0 over PARALLEL_FRAMES frames after it
   (ranks sharing one card over gloo: a correctness run, not a scaling
   number), and rank 0's kernel calls of PARALLEL_REPLAY's first frame
   replayed through kernel and twin (into ``max_abs_err``).
   tools (:func:`phase_tools`, after the paths and before the first
   torch.profiler phase; launches counted over its in-process steps):
   ``load_obj`` native against the Python parser on the OBJ it writes;
   construct -> load's PNG (decoded by :func:`decode_png`, the standard
   library) equal to ``render_image`` after the same orbit steps; the
   card's ``precompute --device`` checkpoint equal to the CPU's, 0
   violations in ``debug_tree.check_tree``, its threaded frame within
   REF_ATOL of the host build's (bit-equality printed); the protocol's
   average ms per frame for each case of PROTOCOL beside phase 4's eager
   orbit of the same frames, every per-frame time finite and positive,
   one per frame (without matplotlib, BenchScheduler.render_chart is
   replaced by a no-op for the phase, and the script says so);
   ``load --profile``'s trace naming mt_trace's and shade_post's
   kernels; the viewer's ``/frame.png`` equal to ``render_image`` after
   start, a config update, a viewport change and a scene switch, a bad
   scene name keeping the scene and writing the note; the orbit GIF
   equal to ``write_gif`` of the ``render_image`` sequence (where PIL is
   installed).
5. The knob A/Bs (experiments/early_exit_ab.py's protocol: the knob
   off and on in interleaved turns): early exit on torus 1080p and
   canyon segmented 640x480 orbits, with the closest-hit list entries of
   one frame against the entries early exit tested; the fused bounce
   kernel on torus 384x288 orbits; the ``bvh`` handler's packet backend
   against its threaded walk on torus 384x288 and 1080p orbits.
6. Kernel times (device time from torch.profiler with the L2 cache
   overwritten before each call, so inputs come from HBM as the bounds
   assume; beside CUDA events around back-to-back calls), each against
   its twin and its bound (the
   least time the card could take for the call's work), at the
   384x288 torus frame's shapes, the 640x480 canyon frame's and the
   torus 1080p early-exit frame's primary call; early-exit calls also
   as the default call over the same lists, the fused shading call also
   as shade_post + shade_pre; the probes' kernels at the compare
   phase's calls, and mt_trace[closest] on mt_tpose's tc = 64 lists;
   kernel G's three modes at the threaded torus frame's primary rows
   call (also in closest mode) and first shadow call (its bound from
   the node steps and prim tests its twin, the binary walk, counts on
   the same rays; the wide walk's node visits and the packed records'
   bytes from the mirror; the threaded canyon frame's primary rays in
   closest mode are also printed).
   Each f32 kernel's bound also at the measured separate-FMA rate, its
   launches per wrapper call (torch.profiler; mt_tpose and mt_mxu must
   make PROBE_CALL_LAUNCHES), and each mt_trace call's list lengths.  The default-mode mt_trace
   calls in one table: the three above, the torus 1080p primary rows
   call and the flat ``torus_ghost()`` 1080p frame's busiest closest
   call.  shade_post also at the torus 1080p frame's shapes, with its
   share of its bytes bound and its launch floor at both shapes: an
   empty kernel on its grid (``FLOOR_SRC``, built here: T / 8 *
   ceil(8 r / POST_RAYS) blocks of POST_RAYS), timed the same way.  mt_stream,
   the early-exit calls and the probes' MT kernels also print the
   per-tile walks' times they replaced (WALK_MS, constants) and, for
   early exit, the entries the per-tile rule and the items test.
7. The dynamic build's parts at 1080p profiled alone (gathers and shade
   table, Morton codes and sort, permute, chunk table: device ms and
   launches) against a DynamicRenderer rebuild frame's busy time.  Where
   a frame's device time goes, by kernel kind, is the benchmark's
   breakdown (``rtbench/``).
8. The ``chain`` path (:func:`phase_chain`; last, because single-call
   profiles taken after graph captures lost kernels): each case of
   CHAIN captures its graphs (a host read or a host-to-device copy
   inside a frame makes the capture raise); frame 0 of a replay equals
   eager ``render_frame``, frames 1..K-1 eager frames at the f32 cameras
   the graph wrote out, a second replay the first, bit for bit; N
   chained frames launch what N eager frames launch, kernel by kernel,
   with the counts set to 0 just before and read just after, and leave
   the host camera where the eager loop does; the device bytes of the
   1080p graphs, captured at chain=16 and chain=4 (CHAIN4).  The
   dynamic cases stack the wave's frames into the graph's vertex
   buffers: their eager and chained orbits move the geometry.  The
   benchmark (``rtbench/``) times chained orbits.

The second-to-last lines are JSON objects of frame times (with the
chain phase's checks, the A/B, the mt_trace calls, shade_post at 1080p and its
launch floor, the parallel phase's ms/frame and native build times, the
tools phase's protocol,
mt_trace[closest] on mt_tpose's lists and the dynamic build) and
of per-kernel results, then the ``nvidia-smi`` name / power-limit line;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import inspect
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

DEVICE = "cuda"
TORUS_FRAME = ROOT / "tests" / "data" / "torch_port_torus_96x72.npz"
ROW2_FRAME = ROOT / "tests" / "data" / "torch_port_torus_row2_96x72.npz"
BAND_FRAME = ROOT / "tests" / "data" / "torch_port_gather_band_32x16.npz"
GHOST_FRAMES = ROOT / "tests" / "data" / "torch_port_ghost_64x48.npz"
TORUS_GHOST_FRAME = ROOT / "tests" / "data" / "torch_port_torus_ghost_96x72.npz"
BVH_FRAMES = ROOT / "tests" / "data" / "torch_port_bvh_torus_96x72.npz"
LBVH_FRAME = ROOT / "tests" / "data" / "torch_port_lbvh_torus_96x72.npz"
DYNAMIC_FRAMES = ROOT / "tests" / "data" / "torch_port_dynamic_torus_96x72.npz"
# The dynamic path's deformation (tests/test_torch_dynamic.py defines the
# same): each vertex rises by WAVE_AMP * 4u(1 - u), u the fractional part
# of WAVE_FREQ * x + WAVE_STEP * frame, in f64 and then rounded to f32
# (floor, products and sums only: the same bits on every machine).  The
# torus' Morton order changes from frame to frame.
WAVE_AMP, WAVE_FREQ, WAVE_STEP = 0.3, 0.5, 0.125
# the stored dynamic frames' moved pose
DYNAMIC_FRAME = 3
# the dual tables' fine chunk height (the coarse one is 64)
FINE_TC = 16
# The bound the JAX package holds between its own two frame paths
# (tests/test_shade_tiled.py).  The stored frames were rendered with
# XLA:CPU held to SSE4.2, so no FMA contraction (see
# tests/test_torch_render.py); they round op by op like the port.
REF_ATOL = 2e-5
# Shading kernels vs twins: both compute rsqrt as IEEE 1 / sqrt, and
# torch's CUDA pow is the kernels' powf; every replay was 0 ULP apart.
SHADE_MAX_ULP = 0
TORUS_REPLAY = (384, 288)
CANYON_REPLAY = (640, 480)
# path -> frame sizes driven (name -> width, height, orbit frames)
SIZES = {
    "torus": {"384x288": (384, 288, 30), "1920x1080": (1920, 1080, 12)},
    "segmented": {"640x480": (640, 480, 16), "1920x1080": (1920, 1080, 12)},
    "dma": {"640x480": (640, 480, 16)},
    "flat": {"384x288": (384, 288, 30), "1920x1080": (1920, 1080, 12)},
}
# The bvh path's orbits: name -> (scene, handler, backend, width, height,
# orbit frames).  "auto" walks like "threaded" (handlers/bvh.py::use_packet).
THREADED = {"backend": "threaded"}
BVH_ORBITS = {
    "bvh threaded torus 384x288": ("torus", "bvh", "threaded", 384, 288, 16),
    "bvh threaded torus 1920x1080": ("torus", "bvh", "threaded", 1920, 1080, 8),
    "bvh auto torus 384x288": ("torus", "bvh", "auto", 384, 288, 16),
    "bvh threaded canyon 640x480": ("canyon", "bvh", "threaded", 640, 480, 8),
    "bvh threaded canyon 1920x1080": ("canyon", "bvh", "threaded", 1920, 1080, 4),
    "rf_bvh threaded torus 384x288": ("torus", "rf_bvh", "threaded", 384, 288, 16),
    "rf_bvh threaded torus 1920x1080": ("torus", "rf_bvh", "threaded", 1920, 1080, 8),
}
# the probes' rays: torus_scene's primaries at this size (the JAX mains')
PROBE_SIZE = (1920, 1080)
# the transposed-table frame: torus_canyon() through shade.render
TPOSE_FRAME = (640, 480, 20)
# share of its values allowed beyond REF_ATOL from the segmented
# Renderer's frame (one flipped hit in 640x480 is 3 of 921,600 values)
TPOSE_FAR_SHARE = 1e-4
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "refine_cull": (
        "rt_rs_tpu_torch/csrc/refine_cull.cu",
        "rt_rs_tpu/ops/pallas/packet_trace.py:497",
    ),
    "mt_trace[closest]": (
        "rt_rs_tpu_torch/csrc/mt_trace.cu",
        "rt_rs_tpu/ops/pallas/packet_trace.py:746",
    ),
    "mt_trace[rows]": (
        "rt_rs_tpu_torch/csrc/mt_trace.cu",
        "rt_rs_tpu/ops/pallas/packet_trace.py:746",
    ),
    "mt_trace[anyhit]": (
        "rt_rs_tpu_torch/csrc/mt_trace.cu",
        "rt_rs_tpu/ops/pallas/packet_trace.py:746",
    ),
    "mt_stream": (
        "rt_rs_tpu_torch/csrc/mt_stream.cu",
        "rt_rs_tpu/ops/pallas/packet_stream.py:57",
    ),
    "shade_pre": (
        "rt_rs_tpu_torch/csrc/shade_pre.cu",
        "rt_rs_tpu/ops/pallas/shade_tile.py:195",
    ),
    "shade_post": (
        "rt_rs_tpu_torch/csrc/shade_post.cu",
        "rt_rs_tpu/ops/pallas/shade_tile.py:226",
    ),
    "mt_trace[closest,early_exit]": (
        "rt_rs_tpu_torch/csrc/mt_trace.cu",
        "rt_rs_tpu/ops/pallas/packet_trace.py:746",
    ),
    "mt_trace[rows,early_exit]": (
        "rt_rs_tpu_torch/csrc/mt_trace.cu",
        "rt_rs_tpu/ops/pallas/packet_trace.py:746",
    ),
    "shade_bounce": (
        "rt_rs_tpu_torch/csrc/shade_bounce.cu",
        "rt_rs_tpu/ops/pallas/shade_tile.py:352",
    ),
    "fma_peak[fused]": ("rt_rs_tpu_torch/csrc/fma_peak.cu", "experiments/roofline.py:66"),
    "fma_peak[separate]": ("rt_rs_tpu_torch/csrc/fma_peak.cu", "experiments/roofline.py:66"),
    "mt_tpose": ("rt_rs_tpu_torch/csrc/mt_tpose.cu", "experiments/tpose_table.py:54"),
    "mt_mxu[highest]": ("rt_rs_tpu_torch/csrc/mt_mxu.cu", "experiments/mxu_mt.py:50"),
    "mt_mxu[high]": ("rt_rs_tpu_torch/csrc/mt_mxu.cu", "experiments/mxu_mt.py:50"),
    "mt_mxu[default]": ("rt_rs_tpu_torch/csrc/mt_mxu.cu", "experiments/mxu_mt.py:50"),
    # DynamicRenderer's per-frame refit of kernel G's tree: no TPU kernel
    # (the JAX package refits a chunk table in XLA ops)
    "wide_refit": ("rt_rs_tpu_torch/csrc/wide_refit.cu", "none: the walked dynamic path is the port's"),
    # DynamicRenderer's per-frame build of kernel G's tree (a rebuild past
    # the chunk table's cap): no TPU kernel (the JAX package rebuilds a
    # chunk table in XLA ops)
    "wide_build": ("rt_rs_tpu_torch/csrc/wide_build.cu", "none: the walked dynamic rebuild is the port's"),
    # hand-written for XLA code (a lax.while_loop), no pallas_call: kernel
    # G's modes (the frame path's closest, rows and any-hit; the flat path
    # takes closest)
    **{
        f"bvh_walk[bvh,{mode}]": ("rt_rs_tpu_torch/csrc/bvh_walk.cu", "rt_rs_tpu/handlers/bvh.py:314")
        for mode in ("closest", "rows", "anyhit")
    },
    # the RF records walk of rf_bvh, tiled only
    **{
        f"bvh_walk_rf[{mode}]": ("rt_rs_tpu_torch/csrc/bvh_walk_rf.cu", "rt_rs_tpu/handlers/rf.py:271")
        for mode in ("closest", "rows", "anyhit")
    },
}
PROBE_KERNELS = tuple(k for k in KERNELS if k.startswith(("fma_peak", "mt_tpose", "mt_mxu")))
# path -> the kernels it must launch
PATHS = {
    "torus": ("refine_cull", "mt_trace[closest]", "mt_trace[anyhit]", "shade_pre", "shade_post"),
    "segmented": ("refine_cull", "mt_trace[closest]", "shade_pre", "shade_post"),
    "dma": ("mt_stream", "shade_pre", "shade_post"),
    "knobs": ("refine_cull", "mt_trace[anyhit]", "mt_trace[closest,early_exit]", "shade_bounce"),
    # shade.render through pbvh's flat entry: shading is torch glue
    "flat": ("mt_trace[closest]",),
    "probes": PROBE_KERNELS,
    # threaded and "auto" bvh frames (the emit branch: kernel G's closest
    # and any-hit modes), rf_bvh frames (the records walk's), and the packet
    # backend's edge-scene frames
    "bvh": (
        "bvh_walk[bvh,closest]", "bvh_walk[bvh,anyhit]", "bvh_walk_rf[closest]",
        "bvh_walk_rf[anyhit]", "shade_pre", "shade_post", "refine_cull", "mt_trace[closest]",
        "mt_trace[anyhit]",
    ),
    # Renderer(handler="lbvh"): the chunk table built on the card
    "lbvh": ("refine_cull", "mt_trace[closest]", "mt_trace[anyhit]", "shade_pre", "shade_post"),
    # DynamicRenderer: the table rebuilt (or refit) on the card each frame,
    # and the walk's tree refit, or built, each frame
    "dynamic": (
        "refine_cull", "mt_trace[closest]", "mt_trace[anyhit]", "shade_pre", "shade_post", "wide_refit",
        "bvh_walk[bvh,closest]", "bvh_walk[bvh,anyhit]", "wide_build",
    ),
    # pbvh with tri_chunk_fine: refined batches on the tc = 16 table
    "dual": ("refine_cull", "mt_trace[closest]", "mt_trace[anyhit]", "shade_pre", "shade_post"),
    # the tools, the study's protocol, the viewer and the GIF (phase_tools):
    # pbvh frames, and the threaded walk on the checkpoints precompute writes
    "tools": (
        "refine_cull", "mt_trace[closest]", "mt_trace[anyhit]", "shade_pre", "shade_post",
        "bvh_walk[bvh,closest]",
    ),
    # multi-device rendering (phase_parallel): rank 0's launches of one
    # frame per case, image bands and scene shards on ranks sharing the card
    "parallel": (
        "refine_cull", "mt_trace[closest]", "mt_trace[anyhit]", "shade_pre", "shade_post",
        "bvh_walk[bvh,closest]",
    ),
    # animate(chain=K): the frame paths above inside captured CUDA graphs
    "chain": (
        "refine_cull", "mt_trace[closest]", "mt_trace[anyhit]", "mt_trace[closest,early_exit]",
        "mt_stream", "shade_pre", "shade_post", "shade_bounce", "bvh_walk[bvh,closest]", "wide_refit",
        "wide_build",
    ),
}
# The rows modes, which no path launches: the shading kernels read each
# hit's row from the shade table.  The compare and kernel-time phases
# still check and time them, on their frames' closest-hit calls
# (:func:`with_rows_calls`).
ROWS_MODES = ("mt_trace[rows]", "mt_trace[rows,early_exit]", "bvh_walk[bvh,rows]", "bvh_walk_rf[rows]")


def check_launches(path: str, counts) -> None:
    """Every kernel of ``path`` launched, and no rows mode."""
    missing = [k for k in PATHS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched on the path: {missing}")
    rows = {k: counts[k] for k in ROWS_MODES if counts[k]}
    if rows:
        raise AssertionError(f"{path}: a rows mode launched on the path: {rows}")


# The knobs path's torus and segmented frames: the fused bounce kernel
# and early exit (Renderer kwargs, handler kwargs).
KNOBS = ({"fuse_bounce": True}, {"early_exit": True})
# Knobs that change only the glue: one 384x288 torus frame each, bit-equal
# to the default frame.
GLUE_KNOBS = {
    "retile": ({"retile": True}, {}),
    "narrow=128": ({"narrow": 128}, {}),
    "shadow_cull=False": ({"shadow_cull": False}, {}),
    "cull_block=4": ({}, {"cull_block": 4}),
    "refine=all": ({}, {"refine": "all"}),
}
# The A/Bs (experiments/early_exit_ab.py's protocol): orbits in
# interleaved turns, the knob off (False) and on (True).
AB_ORDER = (False, True, True, False, False, True)
# The chain phase (Renderer.animate(chain=K): a replay of a captured CUDA
# graph of K orbit frames per dispatch): case -> (Renderer factory, K,
# orbit frames N).  K = 16 is bench.py's; N is a multiple of K, so that
# N chained frames launch what N eager frames launch.
CHAIN = {
    "torus 384x288": (lambda: renderer(384, 288), 16, 32),
    "torus 1920x1080": (lambda: renderer(1920, 1080), 16, 16),
    "canyon segmented 640x480": (lambda: canyon(640, 480, "segmented"), 16, 16),
    "canyon segmented 1920x1080": (lambda: canyon(1920, 1080, "segmented"), 16, 16),
    "canyon dma 640x480": (lambda: canyon(640, 480, "dma"), 16, 16),
    "knobs torus 384x288": (lambda: renderer(384, 288, knobs=KNOBS[0], **KNOBS[1]), 16, 16),
    "flat torus_ghost 384x288": (lambda: ghost(384, 288), 16, 16),
    "blank 384x288": (lambda: renderer(384, 288, handler="blank"), 16, 32),
    "naive 96x72": (lambda: renderer(96, 72, handler="naive"), 2, 2),
    "bvh threaded torus 384x288": (lambda: renderer(384, 288, handler="bvh", **THREADED), 16, 16),
    "lbvh torus 384x288": (lambda: renderer(384, 288, handler="lbvh"), 16, 32),
    "dynamic rebuild torus 384x288": (lambda: Wavy(dynamic(384, 288), 0), 16, 32),
    "dynamic refit torus 384x288": (lambda: Wavy(dynamic(384, 288, refit=True), 0), 16, 32),
    "dynamic rebuild torus 1920x1080": (lambda: Wavy(dynamic(1920, 1080), 0), 16, 16),
    "dynamic refit torus 1920x1080": (lambda: Wavy(dynamic(1920, 1080, refit=True), 0), 16, 16),
    "dynamic walk teapots3 384x288": (lambda: Wavy(walked(384, 288), 0), 16, 32),
    "dynamic walk teapots3 1920x1080": (lambda: Wavy(walked(1920, 1080), 0), 16, 16),
    "dynamic rebuilt walk teapots3 384x288": (lambda: Wavy(rebuilt(384, 288), 0), 16, 32),
    "dynamic rebuilt walk teapots3 1920x1080": (lambda: Wavy(rebuilt(1920, 1080), 0), 16, 16),
}
# cases also captured and checked at chain=4, whose graphs' device bytes are read
CHAIN4 = ("torus 1920x1080", "canyon segmented 1920x1080")
# The parallel path (phase_parallel): case -> (mesh shape, scene,
# handler, handler kwargs, width, height), each rendered by
# rt_rs_tpu_torch.parallel on PARALLEL_RANKS ranks that share the card
# over gloo, every rank's frame bit-equal to Renderer's at the same size.
PARALLEL_RANKS = 4
PARALLEL = {
    "(a) image_mesh(4) torus pbvh 384x288": ((4,), "torus", "pbvh", {}, 384, 288),
    "(b) image_mesh(4) torus bvh threaded 384x288": ((4,), "torus", "bvh", THREADED, 384, 288),
    "(c) hybrid_mesh(2,2) torus pbvh 384x288": ((2, 2), "torus", "pbvh", {}, 384, 288),
    "(d) hybrid_mesh(2,2) canyon pbvh 640x480": ((2, 2), "canyon", "pbvh", {}, 640, 480),
    "(e) hybrid_mesh(1,3) torus pbvh tc8 384x288": (
        (1, 3), "torus", "pbvh", {"tri_chunk": 8}, 384, 288,
    ),
    "(f) image_mesh(4) torus_ghost flat 384x288": ((4,), "ghost", "pbvh", {}, 384, 288),
}
# one rank on the card over NCCL, against case (a)'s reference frame
PARALLEL_NCCL = {"image_mesh(1) torus pbvh 384x288 nccl": ((1,), "torus", "pbvh", {}, 384, 288)}
# rank 0 of this case records its first frame's kernel calls, replayed
PARALLEL_REPLAY = "(d) hybrid_mesh(2,2) canyon pbvh 640x480"
# frames timed per case, after the first (the warm frame)
PARALLEL_FRAMES = 4

# The card's peaks (NVIDIA H100 SXM data sheet, at its 700 W limit):
# f32 outside the tensor cores, dense TF32 on the tensor cores, and HBM3
# bandwidth.
PEAK_F32_OPS = 67e12
PEAK_TF32_OPS = 495e12
PEAK_BYTES = 3.35e12


def say(*parts) -> None:
    print(*parts, flush=True)


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


def card_line() -> str:
    return sh(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    ).strip().splitlines()[0]


# ----------------------------------------------------------------------
# comparisons


def _ordered(x):
    """f32 bits mapped to integers that are ordered like the floats."""
    import torch

    i = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def max_ulp(a, b) -> int:
    """Largest distance in units of the last place (NaN == NaN)."""
    import torch

    d = (_ordered(a) - _ordered(b)).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0, d)
    return int(d.max()) if d.numel() else 0


def max_abs(a, b) -> float:
    import torch

    if a.dtype == torch.bool:
        return float((a != b).any())
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0, d)
    return float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0


def outputs(x) -> list:
    return [o for o in (x if isinstance(x, tuple) else (x,)) if o is not None]


def check_equal(what: str, kern, twin) -> float:
    """Bit-equal (NaN == NaN) -> max abs error (0.0)."""
    err = 0.0
    for i, (a, b) in enumerate(zip(outputs(kern), outputs(twin), strict=True)):
        if a.dtype.is_floating_point and max_ulp(a, b) != 0:
            raise AssertionError(
                f"{what} output {i}: kernel != twin (max {max_ulp(a, b)} ULP)"
            )
        if not a.dtype.is_floating_point and not bool((a == b).all()):
            raise AssertionError(
                f"{what} output {i}: kernel != twin "
                f"({int((a != b).sum())} mismatches)"
            )
        err = max(err, max_abs(a, b))
    return err


def check_ulp(what: str, kern, twin) -> tuple[float, int]:
    """Within SHADE_MAX_ULP -> (max abs error, max ULP)."""
    err, ulp = 0.0, 0
    for i, (a, b) in enumerate(zip(outputs(kern), outputs(twin), strict=True)):
        u = max_ulp(a, b)
        if u > SHADE_MAX_ULP:
            raise AssertionError(
                f"{what} output {i}: {u} ULP apart (limit {SHADE_MAX_ULP})"
            )
        err, ulp = max(err, max_abs(a, b)), max(ulp, u)
    return err, ulp


def check_valid_equal(what: str, ours, flat, valid) -> None:
    """Bit-equal on valid rays (outputs are specified there only)."""
    for i, (a, b) in enumerate(zip(outputs(ours), outputs(flat), strict=True)):
        x, y = a[..., valid], b[..., valid]
        if x.dtype.is_floating_point and max_ulp(x, y) != 0:
            raise AssertionError(f"{what} output {i}: != the flat call ({max_ulp(x, y)} ULP)")
        if not x.dtype.is_floating_point and not bool((x == y).all()):
            raise AssertionError(f"{what} output {i}: {int((x != y).sum())} rays != the flat call")


# ----------------------------------------------------------------------
# phases


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from rt_rs_tpu_torch.ops import cuda

    nvcc = [
        ln for ln in sh([cuda.nvcc_path(), "--version"]).splitlines()
        if "release" in ln
    ]
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"[device] nvcc: {nvcc[0].strip() if nvcc else '?'}")
    say(f"[device] card: {card_line()}")
    say(f"[device] count: {torch.cuda.device_count()}")


def phase_build():
    from rt_rs_tpu_torch.ops import cuda

    t0 = time.perf_counter()
    lib_path = cuda.build()
    cuda.library()
    say(f"[build] {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for ln in (lib_path.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in ln or "registers" in ln or "spill" in ln:
            say(f"[build] {ln.strip()}")


# The wrappers' tracing arguments (rt_rs_tpu_torch/tracing.py): which
# counter a call adds to; the twins take none of them.
TRACE_KWARGS = ("counter", "bounce")


class Recorder:
    """Wraps the kernel wrappers (and the segmented and streamed
    entries) for one frame and keeps each call's arguments and result
    (the frame path calls them through these module attributes)."""

    def __init__(self):
        from rt_rs_tpu_torch.experiments import mxu_mt, tpose_table
        from rt_rs_tpu_torch.ops import (
            bvh_walk, bvh_walk_rf, packet_stream, packet_trace, shade_tile, wide_build, wide_refit,
        )

        self.targets = [
            (packet_trace, "refine_cull"),
            (packet_trace, "mt_trace"),
            (packet_trace, "chunk_overlap_mask_cm"),
            (packet_trace, "packet_closest_hit_segmented_tiled"),
            (packet_stream, "mt_stream"),
            (packet_stream, "stream_closest_hit"),
            (shade_tile, "shade_pre"),
            (shade_tile, "shade_post"),
            (shade_tile, "shade_bounce"),
            (tpose_table, "mt_tpose"),
            (mxu_mt, "mt_mxu"),
            (bvh_walk, "bvh_walk_tiled"),
            (bvh_walk_rf, "bvh_walk_rf_tiled"),
            (wide_refit, "wide_refit"),
            (wide_build, "wide_build"),
        ]
        self.calls: dict[str, list] = {name: [] for _, name in self.targets}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def rec(*args, _fn=fn, _name=name, **kw):
                out = _fn(*args, **kw)
                # kept without the trace counters' arguments, which the
                # twins do not take and a replay need not count under
                kept = {k: v for k, v in kw.items() if k not in TRACE_KWARGS}
                self.calls[_name].append((args, kept, out))
                return out

            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class with_rows_calls:
    """Within it, each closest-hit call of ``r``'s emit-branch frame (the
    primaries and the continuations; the shadows take the any-hit entry)
    is also made through the rows entry on the same rays, beside it, and
    that result dropped: no frame makes a rows call (the shading kernels
    read each hit's row from the shade table), so the compare and
    kernel-time phases record the rows modes' calls this way.  The frame
    is unchanged; ``r``'s entries are restored on exit."""

    def __init__(self, r):
        self.r, self.key = r, None

    def __enter__(self):
        r = self.r
        if not hasattr(r, "_bound") or not r.arrays.no_negative_materials:
            return r
        h = r._frame_handler()
        closest, rows, anyhit = r._bound(h)
        if rows is None:
            return r

        def both(payload, valid, t_cap=None, **kw):
            out = closest(payload, valid, t_cap=t_cap, **kw)
            if t_cap is None:
                rows(payload, valid, **kw)
            return out

        both.supports_refine = getattr(closest, "supports_refine", False)
        self.key, self.saved = id(h), r._entries[id(h)]
        r._entries[id(h)] = (both, rows, anyhit)
        return r

    def __exit__(self, *exc):
        if self.key is not None:
            self.r._entries[self.key] = self.saved


def renderer(
    width: int, height: int, scene=None, knobs=None, handler="pbvh", **handler_kwargs
):
    """A Renderer of ``scene`` (default ``torus_scene()``) through
    ``handler`` with the Renderer kwargs ``knobs`` and the handler kwargs
    given."""
    from rt_rs_tpu_torch import Config, Renderer, Resolution
    from rt_rs_tpu_torch.scene.presets import torus_scene

    return Renderer(
        torus_scene() if scene is None else scene,
        config=Config(resolution=Resolution.sized(width, height)),
        handler=handler,
        handler_kwargs=handler_kwargs or None,
        device=DEVICE,
        **(knobs or {}),
    )


def canyon(width: int, height: int, mode: str, **handler_kwargs):
    from rt_rs_tpu_torch.scene.presets import torus_canyon

    return renderer(width, height, torus_canyon(), streaming_mode=mode, **handler_kwargs)


def ghost(width: int, height: int):
    """``torus_ghost()`` (a negative-material scene: the flat path)."""
    from rt_rs_tpu_torch.scene.presets import torus_ghost

    return renderer(width, height, torus_ghost())


class TposeCanyon:
    """tpose_table.py's 50K-triangle frame: ``torus_canyon()``'s
    leaf-ordered arrays in one transposed tc = 64 table, rendered through
    ``shade.render`` with ``packet_closest_hit_t``; ``render_frame`` and
    ``orbit`` as a Renderer's.  ``seg`` is the segmented Renderer of the
    same scene and camera."""

    def __init__(self, width: int, height: int):
        from functools import partial

        from rt_rs_tpu_torch.experiments import tpose_table

        self.seg = r = canyon(width, height, "segmented")
        self.width, self.height, self.camera = width, height, r.camera
        self.tables = tpose_table.build_tri_chunks_t(
            r.arrays.pa, r.arrays.pb, r.arrays.pc, tri_chunk=64, device=DEVICE
        )
        cfg = r.config.compute
        self.fn = partial(
            tpose_table.packet_closest_hit_t, self.tables, t_min=cfg.t_min, t_max=cfg.t_max,
            eps=cfg.eps,
        )

    def render_frame(self, block: bool = True):
        from rt_rs_tpu_torch.ops import shade

        r, c = self.seg, self.camera
        return shade.render(
            r.arrays, self.fn, r.config.compute, r._camera_tensor(c.pos), r._camera_tensor(c.at),
            self.width, self.height, block=(16, 16),
        )

    def orbit(self, mult: float) -> None:
        self.camera = self.camera.orbited(mult)


def wave(scene, i: int):
    """Frame ``i`` of the dynamic path's deformation of ``scene`` ->
    (vert_pos, vert_norm) f32 arrays; the normals stay the rest pose's."""
    import numpy as np

    vp = np.asarray(scene.vert_pos, dtype=np.float64)
    u = WAVE_FREQ * vp[:, 0] + WAVE_STEP * i
    u = u - np.floor(u)
    out = vp.copy()
    out[:, 1] += WAVE_AMP * 4.0 * u * (1.0 - u)
    return out.astype(np.float32), np.asarray(scene.vert_norm, dtype=np.float32)


def dynamic(width: int, height: int, scene=None, device: str | None = None, **kw):
    """A DynamicRenderer of ``scene`` (default ``torus_scene()``) on
    ``device`` (default DEVICE), on the chunk table unless ``kw`` names
    another backend (``"auto"`` walks with ``refit=True``)."""
    from rt_rs_tpu_torch import Config, DynamicRenderer, Resolution
    from rt_rs_tpu_torch.scene.presets import torus_scene

    kw.setdefault("backend", "packet")
    return DynamicRenderer(
        torus_scene() if scene is None else scene,
        config=Config(resolution=Resolution.sized(width, height)),
        device=DEVICE if device is None else device,
        **kw,
    )


def walked(width: int, height: int, device: str | None = None):
    """A DynamicRenderer of ``torus_row(3)`` (18,962 triangles, past the
    chunk table's cap) on the walked refit."""
    from rt_rs_tpu_torch.scene.presets import torus_row

    return dynamic(width, height, torus_row(3), device=device, refit=True, backend="threaded")


def rebuilt(width: int, height: int, device: str | None = None):
    """A DynamicRenderer of ``torus_row(3)`` on the walked rebuild: kernel
    G's tree built on the card every frame (``csrc/wide_build.cu``)."""
    from rt_rs_tpu_torch.scene.presets import torus_row

    return dynamic(width, height, torus_row(3), device=device, backend="threaded")


def check_build(what: str, a, errs: dict) -> None:
    """A recorded wide_build call: the kernels into a fresh workspace
    equal the twin's records and wide node count, bit for bit, and a
    second build leaves the same bits."""
    from rt_rs_tpu_torch.ops import wide_build as wb

    pa, pb, pc, build = a
    twin = wb.wide_build_reference(pa.cpu(), pb.cpu(), pc.cpu())
    fresh = wb.workspace(build.p, pa.device)
    tree = wb.wide_build(pa, pb, pc, fresh)
    kern = (tree.nodes.clone(), tree.prims.clone())
    errs["wide_build"] = max(errs["wide_build"], check_equal(what, [x.cpu() for x in kern], [twin.nodes, twin.prims]))
    count = int(fresh.work["count"][0])
    if count != twin.count:
        raise AssertionError(f"{what}: {count} wide nodes, the twin's {twin.count}")
    wb.wide_build(pa, pb, pc, fresh)
    check_equal(f"{what} run twice", (tree.nodes, tree.prims), kern)


def attach_twin_tree(calls) -> None:
    """A walked-rebuild frame's recorded kernel G calls given the binary
    tree their twin steps through (the card's records have none): the
    twin build's of the recorded build's corners, payload leaves."""
    import dataclasses

    from rt_rs_tpu_torch.ops import wide_build as wb

    if not calls["wide_build"]:
        return
    (pa, pb, pc, _), _, _ = calls["wide_build"][-1]
    twin = wb.wide_build_reference(pa.cpu(), pb.cpu(), pc.cpu())
    binary = tuple(x.to(pa.device) for x in twin.binary)
    calls["bvh_walk_tiled"] = [
        ((p, v, dataclasses.replace(tree, binary=binary, payload=True)), kw, out)
        for (p, v, tree), kw, out in calls["bvh_walk_tiled"]
    ]


def check_refit(what: str, a, errs: dict) -> None:
    """A recorded wide_refit call: the kernel on a copy of the tree's
    records equals the twin on another, bit for bit, and a second run
    leaves the same bits (the tree itself holds a later frame's
    records by now)."""
    from rt_rs_tpu_torch.bvh import wide
    from rt_rs_tpu_torch.ops import wide_refit as wr

    pa, pb, pc, tree, refit = a

    def copy():
        return wide.WalkTree(binary=(), payload=False, nodes=tree.nodes.clone(), prims=tree.prims.clone())

    kern, twin = copy(), copy()
    wr.wide_refit(pa, pb, pc, kern, refit)
    wr.wide_refit_reference(pa, pb, pc, twin, refit)
    errs["wide_refit"] = max(errs["wide_refit"], check_equal(what, (kern.nodes, kern.prims), (twin.nodes, twin.prims)))
    again = (kern.nodes.clone(), kern.prims.clone())
    wr.wide_refit(pa, pb, pc, kern, refit)
    check_equal(f"{what} run twice", (kern.nodes, kern.prims), again)


def attach_binary(r, calls) -> None:
    """A walked dynamic frame's recorded kernel G calls given the binary
    tree their twin steps through (the card's structure keeps none): the
    rest pose's links of ``r``'s scene and the covering bounds refit at
    the frame's pose from the recorded refit's corners."""
    import dataclasses

    from rt_rs_tpu_torch.bvh import build_bvh, wide
    from rt_rs_tpu_torch.handlers.bvh import accel_from_bvh_data
    from rt_rs_tpu_torch.ops import wide_refit as wr

    if not calls["wide_refit"]:
        return
    (pa, pb, pc, tree, _), _, _ = calls["wide_refit"][-1]
    data = build_bvh(r.scene, eps=0.02, target_item_count=2)
    n = accel_from_bvh_data(data, r.scene, pa.device)
    links = (n.hit_link, n.miss_link, n.leaf_count, n.leaf_start)
    lo, hi = wr.binary_refit(pa, pb, pc, wide.binary_refit_topology(*links, r.scene.num_prims))
    full = dataclasses.replace(tree, binary=(lo, hi, *links, pa, pb, pc))
    calls["bvh_walk_tiled"] = [((p, v, full), kw, out) for (p, v, _), kw, out in calls["bvh_walk_tiled"]]


class Wavy:
    """A DynamicRenderer driven by :func:`wave` with a Renderer's
    interface for the phases: ``render_frame`` renders frame ``frame``
    of the deformation (None: the rest pose), ``animate`` passes
    ``vertex_fn``, and the chain phase's hooks stack frames 0..K-1."""

    def __init__(self, r, frame: int | None = None):
        self.r, self.frame = r, frame
        self.width, self.height = r.width, r.height

    @property
    def camera(self):
        return self.r.camera

    @camera.setter
    def camera(self, c):
        self.r.camera = c

    @property
    def stats(self):
        return self.r.stats

    def verts(self, i: int):
        return wave(self.r.scene, i)

    def render_frame(self, block: bool = True):
        if self.frame is None:
            return self.r.render_frame(block=block)
        return self.r.render_frame(*self.verts(self.frame), block=block)

    def orbit(self, mult: float) -> None:
        self.r.orbit(mult)

    def animate(self, frames: int, **kw):
        return self.r.animate(frames, vertex_fn=self.verts, **kw)

    def _camera_tensor(self, v):
        return self.r._device_f32(v)

    def _run_chain(self, k: int, mult: float):
        import numpy as np

        vs = [self.verts(i) for i in range(k)]
        frames, poses = self.r._run_chain(
            k, mult, np.stack([v[0] for v in vs]), np.stack([v[1] for v in vs])
        )
        return frames, poses, None

    def eager_at(self, j: int, h, pos, at):
        """Frame ``j`` of a dispatch rendered eagerly at camera ``pos``."""
        vp, vn = (self.r._device_f32(x) for x in self.verts(j))
        return self.r._step(vp, vn, pos, at)


def replay(label: str, calls, errs: dict, ulps: dict) -> None:
    """Every recorded kernel call through kernel and twin."""
    from rt_rs_tpu_torch.ops import bvh_walk as bw
    from rt_rs_tpu_torch.ops import bvh_walk_rf as rw
    from rt_rs_tpu_torch.ops import packet_stream as ps
    from rt_rs_tpu_torch.ops import packet_trace as pt
    from rt_rs_tpu_torch.ops import shade_tile as st

    for i, (a, kw, _) in enumerate(calls["refine_cull"]):
        kern, twin = pt.refine_cull(*a, **kw), pt.refine_cull_reference(*a, **kw)
        errs["refine_cull"] = max(
            errs["refine_cull"], check_equal(f"{label} refine_cull#{i}", kern, twin)
        )
        check_equal(f"{label} refine_cull#{i} run twice", pt.refine_cull(*a, **kw), kern)
        check_equal(f"{label} compact#{i}", pt.compact(kern), pt.compact(twin))
    exits = iter(exit_calls(calls))
    for i, (a, kw, _) in enumerate(calls["mt_trace"]):
        name = pt.mt_name(kw["mode"], bind(pt.mt_trace_reference, a, kw)["ed"] is not None)
        kern, twin = pt.mt_trace(*a, **kw), pt.mt_trace_reference(*a, **kw)
        if name.endswith("early_exit]"):
            valid = next(exits)[0]
            errs[name] = max(errs[name], check_exit(f"{label} {name}#{i}", a, kw, kern, twin, valid))
        else:
            errs[name] = max(errs[name], check_equal(f"{label} {name}#{i}", kern, twin))
        check_equal(f"{label} {name}#{i} run twice", pt.mt_trace(*a, **kw), kern)
    for i, (a, kw, _) in enumerate(calls["bvh_walk_tiled"]):
        check_walk_tiled(f"{label} {bw.walk_name(a[2].payload, kw['mode'])}#{i}", a, kw, errs)
    for i, (a, kw, _) in enumerate(calls["bvh_walk_rf_tiled"]):
        check_rf_walk(f"{label} {rw.walk_name(kw['mode'])}#{i}", a, kw, errs)
    for i, (a, _, _) in enumerate(calls["wide_refit"]):
        check_refit(f"{label} wide_refit#{i}", a, errs)
    for i, (a, _, _) in enumerate(calls["wide_build"]):
        check_build(f"{label} wide_build#{i}", a, errs)
    for i, (a, kw, _) in enumerate(calls["mt_tpose"]):
        check_tpose(f"{label} mt_tpose#{i}", a, kw, errs)
    for i, (a, kw, _) in enumerate(calls["mt_mxu"]):
        check_mxu(f"{label} mt_mxu#{i}", a, kw, errs)
    for i, (a, kw, _) in enumerate(calls["mt_stream"]):
        kern, twin = ps.mt_stream(*a, **kw), ps.mt_stream_reference(*a, **kw)
        errs["mt_stream"] = max(
            errs["mt_stream"], check_equal(f"{label} mt_stream#{i}", kern, twin)
        )
        check_equal(f"{label} mt_stream#{i} vs the split mirror", kern, ps.mt_stream_split_reference(*a, **kw))
        check_equal(f"{label} mt_stream#{i} run twice", ps.mt_stream(*a, **kw), kern)
    for name in ("shade_pre", "shade_post", "shade_bounce"):
        for i, (a, kw, _) in enumerate(calls[name]):
            kern = getattr(st, name)(*a, **kw)
            err, ulp = check_ulp(f"{label} {name}#{i}", kern, st.twin(name, *a, **kw))
            errs[name] = max(errs[name], err)
            ulps[name] = max(ulps.get(name, 0), ulp)
            if name == "shade_bounce":  # kernel F = kernel D + kernel C
                (post, post_kw), (pre, pre_kw) = bounce_halves(a, kw)
                halves = (st.shade_post(*post, **post_kw), *st.shade_pre(*pre, **pre_kw))
                check_equal(f"{label} shade_bounce#{i} vs shade_post + shade_pre", kern, halves)


def check_post_synthetic(errs: dict) -> None:
    """Kernel D on post_cases' synthetic inputs (r 256 / 128, k 1-3,
    liveness all / none / alternating / single, both blocked modes, T = 8
    and 8 x 45; NaN directions, shadow distances at exactly t_min, t_max
    and the cap; rows at permuted pids of the table) bit-equal to its
    twin, and on k = 5 (past the kernel's light-count instantiations)
    and r = 37 (a subgroup's last block partly filled); then with each
    plane a view 4 bytes into its storage (the kernel reads every plane
    with 4-byte loads, so any alignment is taken, as before the
    redesign), and a table 4 bytes in refused (its rows are read as
    16-byte vectors)."""
    import dataclasses

    import torch

    from rt_rs_tpu_torch.experiments import post_cases as pc
    from rt_rs_tpu_torch.ops import shade_tile as st

    cases = pc.cases(tiles=(8, 8 * 45))
    cases += [dataclasses.replace(c, k=5) for c in cases if c.tiles == 8 and c.r == 256]
    cases += [dataclasses.replace(c, r=37) for c in cases if c.tiles == 8 and c.r == 128]
    for case in cases:
        a, kw = pc.post_args(case, DEVICE)
        err = check_equal(f"synthetic shade_post {case.name}", st.shade_post(*a, **kw), st.twin("shade_post", *a, **kw))
        errs["shade_post"] = max(errs["shade_post"], err)
    a, kw = pc.post_args(next(c for c in cases if c.liveness == "alternating" and not c.blocked_mode), DEVICE)
    views = []
    for x in a:
        v = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        v.copy_(x)
        views.append(v)
    check_equal(
        "synthetic shade_post, planes at a 4-byte offset", st.shade_post(a[0], *views[1:], **kw),
        st.shade_post(*a, **kw),
    )
    try:
        st.shade_post(*views, **kw)
    except ValueError as e:
        if "16-byte aligned" not in str(e):
            raise
    else:
        raise AssertionError("shade_post took a table 4 bytes into its storage")
    say(
        f"[compare] synthetic shade_post: {len(cases)} cases bit-equal to the twin; planes "
        f"at a 4-byte storage offset equal the aligned call; a table there is refused"
    )


def check_walk_tiled(what: str, a, kw, errs: dict) -> None:
    """One bvh_walk_tiled call: the kernel bit-equal to its twin (the
    binary walk; table[pid]; the closest verdict against the cap) and to
    the wide design's mirror in its mode, and run twice alike."""
    from rt_rs_tpu_torch.ops import bvh_walk as bw

    name = bw.walk_name(a[2].payload, kw["mode"])
    kern = bw.bvh_walk_tiled(*a, **kw)
    # a walked rebuild's records with the twin's payload tree attached
    # (attach_twin_tree) launch as kernel G's [rf] leaves
    errs[name] = max(errs.get(name, 0.0), check_equal(what, kern, bw.bvh_walk_tiled_reference(*a, **kw)))
    check_equal(f"{what} vs the wide mirror", kern, bw.bvh_walk_tiled_wide_reference(*a, **kw))
    check_equal(f"{what} run twice", bw.bvh_walk_tiled(*a, **kw), kern)


def check_rf_walk(what: str, a, kw, errs: dict) -> None:
    """One bvh_walk_rf_tiled call: the records walk bit-equal to its
    twin (the same walk, rays in lockstep, in torch) and run twice
    alike."""
    from rt_rs_tpu_torch.ops import bvh_walk_rf as rw

    name = rw.walk_name(kw["mode"])
    kern = rw.bvh_walk_rf_tiled(*a, **kw)
    errs[name] = max(errs[name], check_equal(what, kern, rw.bvh_walk_rf_tiled_reference(*a, **kw)))
    check_equal(f"{what} run twice", rw.bvh_walk_rf_tiled(*a, **kw), kern)


def ray_tiles(o, d, excl, valid, cap, r: int = 128):
    """Flat rays (N a multiple of r) as the walks' tiles -> (payload
    [8, N / r, r], valid [N / r, r]), row 7 ``cap``."""
    import torch

    payload = torch.cat([o.T, d.T, excl[None].float(), cap[None]]).contiguous()
    return payload.reshape(8, -1, r), valid.reshape(-1, r)


def closest_call(call):
    """A recorded walk call as its closest mode's call on the same rays."""
    a, kw, _ = call
    return a, dict(kw, mode="closest", table=None), None


def twin_walk_args(a, kw):
    """A bvh_walk_tiled call's arguments as the binary twin's and the
    wide mirror's (``walk_reference``, ``bvh_walk_wide_reference``) ->
    ((o, d, excl, valid, tree), kwargs)."""
    from rt_rs_tpu_torch.ops import bvh_walk as bw

    payload, valid, tree = a
    o, d, excl, flat_valid, _ = bw.tile_rays(payload, valid)
    return (o, d, excl, flat_valid, tree), {k: kw[k] for k in ("t_min", "t_max", "eps")}


def walk_rays(n: int, seed: int, num_prims: int, nan: int):
    """Seeded rays for the walk's synthetic batches -> (o, d, excl,
    valid) on the card: from a sphere of radius 6 toward the middle,
    with axis-parallel directions (+-0.0 components, rays along +-y),
    ``nan`` NaN directions, 5% invalid and 20% excluding a prim."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (6.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    q = n // 16
    d[:q, 1] = 0.0
    d[q : 2 * q, 1] = -0.0
    d[2 * q : 3 * q, 0] = d[2 * q : 3 * q, 2] = np.float32(-0.0)
    d[2 * q : 3 * q, 1] = np.where(o[2 * q : 3 * q, 1] > 0, -1.0, 1.0)
    d[3 * q : 3 * q + nan] = np.nan
    valid = rng.random(n) > 0.05
    excl = np.where(rng.random(n) < 0.2, rng.integers(1, num_prims + 1, n), 0).astype(np.int32)
    return tuple(torch.from_numpy(x).to(DEVICE) for x in (o, d, excl, valid))


def edge_scenes() -> dict:
    """The trees at the walk's edges: name -> (scene, handler kwargs).
    deep_chain with eps=0 is about 100 levels deep, so its walk needs
    more stack than kernel G keeps in local memory (the scratch kernel);
    no_prims packs as one inverted leaf over a copy of the null row."""
    from rt_rs_tpu_torch.scene.presets import deep_chain, no_prims

    return {"deep chain": (deep_chain(), {"eps": 0.0}), "no prims": (no_prims(), {})}


def check_walk_synthetic(errs: dict) -> None:
    """Kernel G's closest mode (check_walk_tiled) and the records walk's
    three modes on synthetic batches: walk_rays at torus_scene (NaN
    directions included: those rays enter every node), at two coincident
    copies of the torus, whose duplicated triangles tie at equal t on
    every hit, and at the edge_scenes (the deep chain's through the
    scratch kernels; every ray misses the scene with no prims)."""
    import torch

    from rt_rs_tpu_torch.bvh import wide
    from rt_rs_tpu_torch.config import ComputeConfig
    from rt_rs_tpu_torch.handlers import get_handler
    from rt_rs_tpu_torch.ops import bvh_walk as bw
    from rt_rs_tpu_torch.scene.presets import tiled_copies, torus_scene

    cfg = ComputeConfig()
    kw = dict(t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps)
    scenes = {
        "torus": (torus_scene(), {}, 4), "ties": (tiled_copies(torus_scene(), [(0.0, 0.0, 0.0)] * 2), {}, 0),
        **{label: (scene, hkw, 4) for label, (scene, hkw) in edge_scenes().items()},
    }
    for label, (scene, hkw, nan) in scenes.items():
        accel, _ = get_handler("bvh", backend="threaded", **hkw).build(scene, scene.pack(device=DEVICE))
        tree = accel.walk
        rays = walk_rays(4096, 7, max(scene.num_prims, 1), nan)
        payload, tv = ray_tiles(*rays, torch.zeros_like(rays[0][:, 0]))
        a, akw = (payload, tv, tree), dict(kw, mode="closest")
        check_walk_tiled(f"synthetic {label} {bw.walk_name(False, 'closest')}", a, akw, errs)
        if label == "deep chain" and not tree.stack > wide.LOCAL_STACK:
            raise AssertionError(f"{label} bvh: a stack of {tree.stack}, not past the local stack")
        if label == "no prims" and bool(bw.bvh_walk_tiled(*a, **akw)[1].any()):
            raise AssertionError(f"{label} bvh: a ray hit a scene with no prims")
        say(
            f"[compare] synthetic {label} bvh ({scene.num_prims} tris, {nan} NaN rays of "
            f"4096, walk stack {tree.stack} of {wide.LOCAL_STACK} local): bvh_walk_tiled "
            f"closest bit-equal to its twin and the wide mirror, run twice alike"
        )
        check_rf_synthetic(label, scene, hkw, rays, nan, errs)



def check_rf_synthetic(label: str, scene, hkw: dict, rays, nan: int, errs: dict) -> None:
    """The records walk on one synthetic batch in its three modes
    (check_rf_walk), any-hit at caps around each ray's closest hit: the
    deep chain's through the scratch kernel."""
    import torch

    from rt_rs_tpu_torch.config import ComputeConfig
    from rt_rs_tpu_torch.handlers import get_handler
    from rt_rs_tpu_torch.ops import bvh_walk_rf as rw

    cfg = ComputeConfig()
    kw = dict(t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps)
    accel, arrays = get_handler("rf_bvh", **hkw).build(scene, scene.pack(device=DEVICE))
    o, d, excl, valid = rays
    corners = (arrays.pa, arrays.pb, arrays.pc)
    t, pid = rw.bvh_walk_rf_reference(o, d, excl, valid, accel.records, *corners, **kw)
    cap = torch.where(torch.arange(t.shape[0], device=t.device) % 2 == 0, torch.nextafter(t, t + 1), t * 0.5)
    payload, tv = ray_tiles(o, d, excl, valid, cap)
    for mode in ("closest", "rows", "anyhit"):
        table = arrays.shade_table.contiguous() if mode == "rows" else None
        check_rf_walk(f"synthetic {label} {rw.walk_name(mode)}", (payload, tv, accel.records, *corners), dict(kw, mode=mode, table=table), errs)
    depth = accel.records.depth
    if label == "deep chain" and not depth > rw.LOCAL_STACK:
        raise AssertionError(f"{label} rf_bvh: {depth} levels, not past the local stack")
    if label == "no prims" and bool(pid.any()):
        raise AssertionError(f"{label} rf_bvh: a ray hit a scene with no prims")
    say(
        f"[compare] synthetic {label} rf_bvh ({scene.num_prims} tris, {accel.records.words.shape[0]} "
        f"records, {depth} levels of {rw.LOCAL_STACK} local, {nan} NaN rays of 4096): "
        f"bvh_walk_rf bit-equal to its twin in each mode, run twice alike"
    )


def bind(fn, a, kw) -> dict:
    """A recorded call's arguments by parameter name."""
    b = inspect.signature(fn).bind(*a, **kw)
    b.apply_defaults()
    return dict(b.arguments)


def exit_calls(calls) -> list:
    """(valid, overlap, near) of each early-exit mt_trace call of a
    recorded frame, in order: the interval cull with entry bounds that
    its packet_closest_hit_tiled call ran just before it (the same
    payload)."""
    from rt_rs_tpu_torch.ops import packet_trace as pt

    culls = [
        (bind(pt.chunk_overlap_mask_cm, a, kw), out)
        for a, kw, out in calls["chunk_overlap_mask_cm"]
    ]
    culls = [(b, out) for b, out in culls if b["want_near"]]
    exits = [bind(pt.mt_trace_reference, a, kw) for a, kw, _ in calls["mt_trace"]]
    exits = [b for b in exits if b["ed"] is not None]
    if len(culls) != len(exits):
        raise AssertionError(f"{len(exits)} early-exit calls, {len(culls)} interval culls with bounds")
    out = []
    for (c, (overlap, near)), b in zip(culls, exits, strict=True):
        if c["o3"].data_ptr() != b["payload"].data_ptr():
            raise AssertionError("an early-exit call and its interval cull differ in rays")
        out.append((c["ray_valid"], overlap, near))
    return out


def check_exit(what: str, a, kw, kern, twin, valid) -> float:
    """An early-exit mt_trace call: the kernel equals the balanced
    design's mirror (``mt_trace_exit_split_reference``) on every ray,
    the twin on valid rays and on every ray of the tiles whose list fits
    the lead item, and the default mode on the same lists on valid rays
    (outputs are specified on valid rays only) -> max abs error against
    the twin on those rays (0.0).  Prints how many rays outside them
    differ from the twin."""
    from rt_rs_tpu_torch.ops import packet_trace as pt

    b = bind(pt.mt_trace_reference, a, kw)
    check_equal(f"{what} vs the exit mirror", kern, pt.mt_trace_exit_split_reference(**b))
    single = (b["counts"] <= pt.MT_EXIT_ITEM_SIZE)[:, None] | valid
    check_valid_equal(f"{what} vs the twin", kern, twin, single)
    check_valid_equal(f"{what} vs the default mode", kern, pt.mt_trace(**without_early_exit(a, kw)), valid)
    other = sum(int(((x != y) & ~single).sum()) for x, y in zip(outputs(kern)[:2], outputs(twin)[:2]))
    if other:
        say(f"[compare] {what}: {other} outputs of invalid rays differ from the twin (unspecified there)")
    return max(max_abs(x[..., single], y[..., single]) for x, y in zip(outputs(kern), outputs(twin)))


def check_skewed(errs: dict, recorded: dict) -> None:
    """mt_trace at the two extremes of balance, in each default mode:
    one tile (the recorded call's busiest) lists every chunk of the table
    and every other tile nothing, and every tile lists every chunk.  The
    calls: the canyon segmented frame's closest-hit call on its largest
    segment, the torus frame's primary rows call and first any-hit call
    (640x480, 384x288).  Kernel = twin = the balanced design's mirror
    (``mt_trace_split_reference``) bit for bit, and run twice alike."""
    import torch

    from rt_rs_tpu_torch.ops import packet_trace as pt

    seg, torus = recorded["canyon segmented"]["mt_trace"], recorded["torus"]["mt_trace"]
    picks = {
        "canyon closest": max(
            (c for c in seg if c[1]["mode"] == "closest"), key=lambda c: c[0][0].shape[0]
        ),
        "torus rows": next(c for c in torus if c[1]["mode"] == "rows"),
        "torus anyhit": next(c for c in torus if c[1]["mode"] == "anyhit"),
    }
    for label, (a, kw, _) in picks.items():
        b = bind(pt.mt_trace_reference, a, kw)
        if b.pop("ed") is not None:
            raise AssertionError(f"{label}: an early-exit call")
        nc, n_tiles = b["comp"].shape[0], b["payload"].shape[1]
        busiest = int(b["counts"].argmax())
        b["ids"] = torch.arange(nc, dtype=torch.int32, device=DEVICE).expand(n_tiles, nc).contiguous()
        name = pt.mt_name(b["mode"], False)
        for shape in ("one tile", "every tile"):
            if shape == "one tile":
                b["counts"] = torch.zeros(n_tiles, dtype=torch.int32, device=DEVICE)
                b["counts"][busiest] = nc
            else:
                b["counts"] = torch.full((n_tiles,), nc, dtype=torch.int32, device=DEVICE)
            kern = pt.mt_trace(**b)
            what = f"skewed {label}, {shape} listing all {nc} chunks"
            errs[name] = max(errs[name], check_equal(what, kern, pt.mt_trace_reference(**b)))
            check_equal(f"{what} vs the split mirror", kern, pt.mt_trace_split_reference(**b))
            check_equal(f"{what} run twice", pt.mt_trace(**b), kern)
            say(
                f"[compare] {what} ({n_tiles} tiles of {b['payload'].shape[2]} rays): "
                f"{name} = twin = split mirror, run twice alike"
            )


def check_skewed_exit(errs: dict, recorded: dict) -> None:
    """Early exit at the two extremes of balance: the canyon early-exit
    frame's busiest closest-hit call and the knobs torus frame's primary
    rows call (640x480, 384x288) with one tile (the call's busiest)
    listing every chunk of the table and every other tile nothing, and
    with every tile listing every chunk, front to back by the call's own
    interval-cull entry bounds.  Checked as every early-exit call is
    (:func:`check_exit`), and run twice alike."""
    import torch

    from rt_rs_tpu_torch.ops import packet_trace as pt

    entries = lambda c: int(c[0][3].sum())  # noqa: E731
    for label, calls, mode in (
        ("canyon closest", recorded["canyon early_exit"], "closest"),
        ("torus knobs rows", recorded["torus knobs"], "rows"),
    ):
        exits = [c for c in calls["mt_trace"] if bind(pt.mt_trace_reference, c[0], c[1])["ed"] is not None]
        i = max((i for i, c in enumerate(exits) if c[1]["mode"] == mode), key=lambda i: entries(exits[i]))
        valid, overlap, near = exit_calls(calls)[i]
        b = bind(pt.mt_trace_reference, exits[i][0], exits[i][1])
        name = pt.mt_name(mode, True)
        for shape in ("one tile", "every tile"):
            if shape == "one tile":
                listed = torch.zeros_like(overlap)
                listed[int(overlap.sum(dim=1).argmax())] = True
            else:
                listed = torch.ones_like(overlap)
            b["ids"], b["counts"], b["ed"] = pt.early_exit_lists(listed, near)
            kern = pt.mt_trace(**b)
            what = f"skewed {label}, {shape} listing all {overlap.shape[1]} chunks"
            errs[name] = max(errs[name], check_exit(what, (), b, kern, pt.mt_trace_reference(**b), valid))
            check_equal(f"{what} run twice", pt.mt_trace(**b), kern)
            say(
                f"[compare] {what} ({overlap.shape[0]} tiles): {name} = exit mirror, = twin "
                "and = the default mode on valid rays, run twice alike"
            )


def check_skewed_stream(errs: dict, recorded: dict) -> None:
    """mt_stream at the two extremes of balance, on the first 256 tiles
    (8 groups) of the canyon dma frame's busiest call: one tile (the
    busiest) listing every chunk of every block and every other tile
    nothing, and every tile listing every chunk.  Kernel = twin = the
    design's mirror (``mt_stream_split_reference``) bit for bit, and run
    twice alike."""
    import torch

    from rt_rs_tpu_torch.ops import packet_stream as ps
    from rt_rs_tpu_torch.ops import packet_trace as pt

    a, kw, _ = max(recorded["canyon dma"]["mt_stream"], key=lambda c: c[0][0].shape[1])
    b = bind(ps.mt_stream_reference, a, kw)
    n = min(8 * pt.TILE_GROUP, b["payload"].shape[1])
    groups, nb = n // pt.TILE_GROUP, b["words"].shape[1]
    cpb = b["table"].shape[0] // nb
    _, counts = ps.stream_lists(b["words"][:n], b["blockids"][:groups], b["counts"][:groups], cpb)
    full = (1 << cpb) - 1
    full -= (1 << 32) if full >= 1 << 31 else 0  # cpb ones as an int32
    b["payload"] = b["payload"][:, :n].contiguous()
    b["blockids"] = torch.arange(nb, dtype=torch.int32, device=DEVICE).expand(groups, nb).contiguous()
    for shape in ("one tile", "every tile"):
        b["words"] = torch.full((n, nb), full, dtype=torch.int32, device=DEVICE)
        b["counts"] = torch.full((groups,), nb, dtype=torch.int32, device=DEVICE)
        if shape == "one tile":
            busiest = int(counts.argmax())
            b["words"][torch.arange(n, device=DEVICE) != busiest] = 0
            b["counts"][torch.arange(groups, device=DEVICE) != busiest // pt.TILE_GROUP] = 0
        kern = ps.mt_stream(**b)
        what = f"skewed canyon dma, {shape} listing all {nb * cpb} chunks"
        errs["mt_stream"] = max(errs["mt_stream"], check_equal(what, kern, ps.mt_stream_reference(**b)))
        check_equal(f"{what} vs the split mirror", kern, ps.mt_stream_split_reference(**b))
        check_equal(f"{what} run twice", ps.mt_stream(**b), kern)
        say(f"[compare] {what} ({n} tiles of 128 rays): mt_stream = twin = split mirror, run twice alike")


def check_tpose(what: str, a, kw, errs: dict):
    """One mt_tpose call: the kernel bit-equal to its twin and to the
    balanced design's mirror (``mt_tpose_split_reference``), and run twice
    alike -> the kernel's result."""
    from rt_rs_tpu_torch.experiments import tpose_table as tp

    kern = tp.mt_tpose(*a, **kw)
    errs["mt_tpose"] = max(errs["mt_tpose"], check_equal(what, kern, tp.mt_tpose_reference(*a, **kw)))
    check_equal(f"{what} vs the split mirror", kern, tp.mt_tpose_split_reference(*a, **kw))
    check_equal(f"{what} run twice", tp.mt_tpose(*a, **kw), kern)
    return kern


def check_mxu(what: str, a, kw, errs: dict, image: bool = True):
    """One mt_mxu call, run twice alike, its mirror
    (``mt_mxu_split_reference``) bit-equal to its twin.  highest: the
    kernel bit-equal to both.  high and default, on the rays of listed
    tiles, against highest's kernel on the same lists: the kernel's pid
    agreement at least its twin's (the TF32 emulation against the highest
    twin) less ``mxu_mt.TF32_TWIN_MARGIN``, its t rel err within
    ``mxu_mt.TF32_BOUNDS``, and, where the rays are an ``image``'s (what
    TF32_BOUNDS is set over), its agreement within TF32_BOUNDS too (errs:
    the largest t difference where the pids agree) -> (pid agreement, t
    rel err) against highest, and the twin's, or None for highest."""
    from rt_rs_tpu_torch.experiments import mxu_mt

    b = bind(mxu_mt.mt_mxu_reference, a, kw)
    precision = b["precision"]
    name = f"mt_mxu[{precision}]"
    kern = mxu_mt.mt_mxu(**b)
    twin = mxu_mt.mt_mxu_reference(**b)
    check_equal(f"{what} {name} split mirror vs twin", mxu_mt.mt_mxu_split_reference(**b), twin)
    check_equal(f"{what} {name} run twice", mxu_mt.mt_mxu(**b), kern)
    if precision == "highest":
        errs[name] = max(errs[name], check_equal(f"{what} {name}", kern, twin))
        return None
    listed = (b["counts"] > 0)[:, None].expand_as(twin[0])
    ref = mxu_mt.mt_mxu(**dict(b, precision="highest"))
    twin_ref = mxu_mt.mt_mxu_reference(**dict(b, precision="highest"))
    t, pid, t_ref, pid_ref = (x[listed] for x in (*kern, *ref))
    match, rel = mxu_mt.tf32_agreement(t, pid, t_ref, pid_ref)
    twin_match, twin_rel = mxu_mt.tf32_agreement(*(x[listed] for x in (*twin, *twin_ref)))
    least, most = mxu_mt.TF32_BOUNDS[precision]
    floor = twin_match - mxu_mt.TF32_TWIN_MARGIN
    if image:
        floor = max(floor, least)
    if not (match >= floor and rel <= most):
        raise AssertionError(
            f"{what} {name} vs highest: pid agreement {match} (its twin's {twin_match}), "
            f"t rel err {rel} (its twin's {twin_rel})"
        )
    same = pid == pid_ref
    errs[name] = max(errs[name], max_abs(t[same], t_ref[same]))
    return (match, rel), (twin_match, twin_rel)


def check_skewed_probes(errs: dict, probe_calls: dict) -> None:
    """mt_tpose (tc 64) and mt_mxu (each precision) at the two extremes
    of balance, on two sets of 256 tiles of the compare phase's calls
    (torus_scene's 1080p primaries): the 256 busiest, and the busiest and
    255 spread evenly over the image (the rays TF32_BOUNDS is set over;
    on the busiest tiles TF32 loses more pids, and the TF32 variants are
    held to their twins' emulation there).  One tile (the busiest) lists
    every chunk of the table and every other tile nothing, then every
    tile lists every chunk.  Checked as every recorded call is
    (:func:`check_tpose`, :func:`check_mxu`)."""
    import torch

    for name in ("mt_tpose", "mt_mxu[highest]", "mt_mxu[high]", "mt_mxu[default]"):
        _, _, (table, rays_all, ids, counts_all), kw = probe_calls[name]
        nc = table.shape[0]
        spread = torch.linspace(0, counts_all.numel() - 1, 255, device=DEVICE).long()
        busiest = counts_all.topk(256).indices  # the busiest first
        for tiles, pick, image in (
            ("the 256 busiest tiles", busiest, False),
            ("the busiest tile and 255 spread over the image", torch.cat([busiest[:1], spread]), True),
        ):
            rays = rays_all[pick].contiguous()
            n_tiles = rays.shape[0]
            ids = torch.arange(nc, dtype=torch.int32, device=DEVICE).expand(n_tiles, nc).contiguous()
            for shape in ("one tile", "every tile"):
                if shape == "one tile":
                    counts = torch.zeros(n_tiles, dtype=torch.int32, device=DEVICE)
                    counts[0] = nc
                else:
                    counts = torch.full((n_tiles,), nc, dtype=torch.int32, device=DEVICE)
                what = (
                    f"skewed {name} on {tiles}, {shape} listing all {nc} chunks "
                    f"({n_tiles} tiles of {rays.shape[2]} rays)"
                )
                extra = "= twin = split mirror"
                if name == "mt_tpose":
                    check_tpose(what, (table, rays, ids, counts), kw, errs)
                else:
                    agree = check_mxu(what, (table, rays, ids, counts), kw, errs, image=image)
                    if agree is not None:
                        (match, rel), (t_match, t_rel) = agree
                        held = "TF32_BOUNDS and its twin's emulation" if image else "its twin's emulation"
                        extra = (
                            f"within {held} against highest (pid agreement {match:.6f}, t rel err "
                            f"{rel:.3e}; the twin's {t_match:.6f}, {t_rel:.3e}), split mirror = twin"
                        )
                say(f"[compare] {what}: {extra}, run twice alike")


def check_against_flat(label: str, calls) -> tuple[int, int]:
    """Each segmented call against one flat call on its flattened table,
    each streamed call against the flat closest hit under the same
    interval cull on the same 128-ray tiles; bit-equal on valid rays."""
    import torch

    from rt_rs_tpu_torch.ops import packet_stream as ps
    from rt_rs_tpu_torch.ops import packet_trace as pt

    flat_of: dict[int, object] = {}
    segs = calls["packet_closest_hit_segmented_tiled"]
    for i, (a, kw, out) in enumerate(segs):
        b = bind(pt.packet_closest_hit_segmented_tiled, a, kw)
        seg = b.pop("seg")
        table = flat_of.setdefault(id(seg), pt.flatten_segments(seg))
        b.pop("chain")
        b.pop("seg_order")
        flat = pt.packet_closest_hit_tiled(table, **b)
        check_valid_equal(f"{label} segmented call #{i}", out, flat, b["valid"])
    streams = calls["stream_closest_hit"]
    for i, (a, kw, out) in enumerate(streams):
        b = bind(ps.stream_closest_hit, a, kw)
        win = dict(t_min=b["t_min"], t_max=b["t_max"])
        s = ps.stream_inputs(b["chunks"], b["o"], b["d"], b["excl"], b["valid"], b["t_cap"], **win)
        v = s.payload[7] > 0
        cap = b["t_cap"]
        if cap is not None:
            cap = torch.cat([cap, cap.new_zeros(v.numel() - s.n)]).reshape(v.shape)
        ft, fpid = pt.packet_closest_hit_tiled(
            b["chunks"], s.payload, v, cap, eps=b["eps"], refine=False, **win
        )
        flat = (ft.reshape(-1)[: s.n], fpid.reshape(-1)[: s.n])
        check_valid_equal(f"{label} streamed call #{i}", out, flat, v.reshape(-1)[: s.n])
    return len(segs), len(streams)


def phase_compare():
    """Every kernel call of one torus frame (384x288), default and with
    the knobs path's fused bounce kernel and early exit, of one canyon
    frame (640x480) per canyon mode and with early exit, of the flat
    path's ``torus_ghost()`` frames (384x288, 1080p), of the
    transposed-table canyon frame (640x480), of the threaded ``bvh``
    torus frame (384x288) and canyon frame (640x480) and of the
    ``rf_bvh`` torus and ``teapots3`` (``torus_row(3)``) frames
    (384x288: the records walk), kernel vs twin; emit-branch frames with
    the rows mode's calls beside their closest-hit calls
    (:func:`with_rows_calls`)."""
    import torch

    from rt_rs_tpu_torch.ops import packet_trace as pt
    from rt_rs_tpu_torch.scene.presets import torus_canyon, torus_ghost, torus_row

    errs = {name: 0.0 for name in KERNELS}
    ulps: dict[str, int] = {}
    recorded = {}
    cases = {
        "torus": lambda: renderer(*TORUS_REPLAY),
        "canyon segmented": lambda: canyon(*CANYON_REPLAY, "segmented"),
        "canyon dma": lambda: canyon(*CANYON_REPLAY, "dma"),
        "torus knobs": lambda: renderer(*TORUS_REPLAY, knobs=KNOBS[0], **KNOBS[1]),
        "canyon early_exit": lambda: canyon(*CANYON_REPLAY, "segmented", early_exit=True),
        "flat torus_ghost": lambda: renderer(*TORUS_REPLAY, torus_ghost()),
        "flat torus_ghost 1080p": lambda: renderer(*PROBE_SIZE, torus_ghost()),
        "tpose canyon": lambda: TposeCanyon(*TPOSE_FRAME[:2]),
        "bvh torus": lambda: renderer(*TORUS_REPLAY, handler="bvh", **THREADED),
        "rf_bvh torus": lambda: renderer(*TORUS_REPLAY, handler="rf_bvh", **THREADED),
        "rf_bvh teapots3": lambda: renderer(*TORUS_REPLAY, torus_row(3), handler="rf_bvh"),
        "bvh canyon": lambda: renderer(*CANYON_REPLAY, torus_canyon(), handler="bvh", **THREADED),
        "dynamic rebuild torus": lambda: Wavy(dynamic(*TORUS_REPLAY), DYNAMIC_FRAME),
        "dynamic walk teapots3": lambda: Wavy(walked(*TORUS_REPLAY), DYNAMIC_FRAME),
        "dynamic rebuilt walk teapots3": lambda: Wavy(rebuilt(*TORUS_REPLAY), DYNAMIC_FRAME),
        "dual torus": lambda: renderer(*TORUS_REPLAY, tri_chunk_fine=FINE_TC),
        "dual canyon segmented": lambda: canyon(*CANYON_REPLAY, "segmented", tri_chunk_fine=FINE_TC),
    }
    for label, make in cases.items():
        r = make()
        with Recorder() as rec, with_rows_calls(r):
            r.render_frame()
        calls = rec.calls
        if isinstance(r, Wavy):
            attach_binary(r.r, calls)
            attach_twin_tree(calls)
        t0 = time.perf_counter()
        replay(label, calls, errs, ulps)
        if calls["mt_tpose"]:
            say(f"[compare] {label} mt_tpose calls: " + "; ".join(list_stats(a[3]) for a, _, _ in calls["mt_tpose"]))
        n_seg, n_stream = check_against_flat(label, calls)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        n = {k: len(v) for k, v in calls.items() if v}
        modes = sorted(
            {
                pt.mt_name(kw["mode"], bind(pt.mt_trace_reference, a, kw)["ed"] is not None)
                for a, kw, _ in calls["mt_trace"]
            }
        )
        say(
            f"[compare] {label} {r.width}x{r.height} frame calls {n}, mt modes "
            f"{modes}: intersection, refine, mt_tpose and bvh_walk bit-equal (mt_trace, "
            f"refine_cull and bvh_walk also run twice alike), shading max ULP {ulps}; "
            f"{n_seg} segmented and {n_stream} streamed calls equal the flat "
            f"call; replay {time.perf_counter() - t0:.1f} s"
        )
        recorded[label] = calls
    check_post_synthetic(errs)
    check_walk_synthetic(errs)
    check_skewed(errs, recorded)
    check_skewed_exit(errs, recorded)
    check_skewed_stream(errs, recorded)
    recorded["probes"], recorded["tpose lists"] = compare_probes(errs)
    check_skewed_probes(errs, recorded["probes"])
    return errs, recorded


def compare_probes(errs: dict) -> tuple[dict, tuple]:
    """The probes' kernels against their twins on the card, at the JAX
    mains' sizes: fma_peak (iters 4096, grid 256; separate bit-equal,
    fused within rtol 1e-6), mt_tpose on the chunk lists of torus_scene's
    1080p primaries at tc 64 and 128 (:func:`check_tpose`, and bit-equal
    to mt_trace[closest] on the same lists and tc), mt_mxu at each
    precision (:func:`check_mxu`; high and default also against highest
    on the image's rays).  -> (name -> (kernel, twin, args, kwargs) of
    one call each, for the kernel times; mt_trace[closest]'s (args,
    kwargs) on mt_tpose's tc = 64 lists)."""
    import torch

    from rt_rs_tpu_torch.experiments import mxu_mt, roofline, tpose_table
    from rt_rs_tpu_torch.experiments.probe_rays import probe_rays
    from rt_rs_tpu_torch.ops import packet_trace as pt

    calls = {}
    g = torch.Generator().manual_seed(0)
    x = torch.rand(
        (roofline.GRID * roofline.CHAINS * roofline.ROWS, roofline.COLS), generator=g
    ).add_(0.5).to(DEVICE)
    for fused in (True, False):
        name = "fma_peak[fused]" if fused else "fma_peak[separate]"
        kern = roofline.fma_chains(x, roofline.ITERS, fused)
        twin = roofline.fma_chains_reference(x, roofline.ITERS, fused)
        if fused:
            rel = float(((kern - twin).abs() / twin.abs()).max())
            if not rel <= 1e-6:
                raise AssertionError(f"{name}: kernel vs twin rtol {rel}")
            errs[name] = max_abs(kern, twin)
            extra = f"within rtol {rel:.3g}"
        else:
            errs[name] = check_equal(name, kern, twin)
            extra = "bit-equal"
        calls[name] = (roofline.fma_chains, roofline.fma_chains_reference, (x, roofline.ITERS, fused), {})
        say(f"[compare] {name} at iters {roofline.ITERS}, grid {roofline.GRID}: {extra}")

    p = probe_inputs()
    win, eps = p["win"], p["eps"]
    kw = dict(eps=eps, **win)
    o, d, excl = p["rays"][(16, 16)]
    for tc in (64, 128):
        tables = tpose_table.build_tri_chunks_t(*p["corners"], tri_chunk=tc, device=DEVICE)
        s = probe_rays(o, d, excl, None, None, tables.bmin, tables.bmax, ray_tile=256, **win)
        args = (tables.comp, s.rays, s.ids, s.counts)
        kern = check_tpose(f"mt_tpose tc={tc}", args, kw, errs)
        payload = s.rays.permute(1, 0, 2).contiguous()
        same = ((p["chunks"][tc].comp, payload, s.ids, s.counts), dict(mode="closest", **kw))
        check_equal(f"mt_tpose tc={tc} vs mt_trace[closest]", kern, pt.mt_trace(*same[0], **same[1]))
        if tc == 64:
            calls["mt_tpose"] = (tpose_table.mt_tpose, tpose_table.mt_tpose_reference, args, kw)
            same_lists = same
        say(
            f"[compare] mt_tpose tc={tc} on the 1080p primaries' lists "
            f"({int(s.counts.sum())} entries): bit-equal to its twin, its split mirror and "
            "mt_trace[closest], run twice alike"
        )
    o, d, excl = p["rays"][(8, 16)]
    chunks = p["chunks"][64]
    table = mxu_mt.build_mxu_table(chunks)
    s = probe_rays(o, d, excl, None, None, chunks.bmin, chunks.bmax, ray_tile=mxu_mt.TC_RAYS, **win)
    args = (table, s.rays, s.ids, s.counts)
    n = s.n
    best = mxu_mt.mt_mxu(*args, precision="highest", **kw)
    t_ref, pid_ref = (x.reshape(-1)[:n] for x in best)
    line = (
        f"[compare] mt_mxu on the 1080p primaries' lists ({int(s.counts.sum())} entries): each "
        "precision's split mirror bit-equal to its twin and run twice alike; highest bit-equal to its twin"
    )
    for precision in mxu_mt.PRECISIONS:
        name = f"mt_mxu[{precision}]"
        calls[name] = (mxu_mt.mt_mxu, mxu_mt.mt_mxu_reference, args, dict(precision=precision, **kw))
        agree = check_mxu("mt_mxu", args, dict(precision=precision, **kw), errs)
        if precision == "highest":
            continue
        t, pid = (x.reshape(-1)[:n] for x in mxu_mt.mt_mxu(*args, precision=precision, **kw))
        match, rel = mxu_mt.tf32_agreement(t, pid, t_ref, pid_ref)
        least, most = mxu_mt.TF32_BOUNDS[precision]
        if not (match >= least and rel <= most):
            raise AssertionError(f"{name} vs highest: pid agreement {match}, t rel err {rel}")
        line += (
            f"; {precision}: pid agreement {match:.6f} (least {least}), t rel err max "
            f"{rel:.3e} (most {most}) on the image's rays ({agree[0][0]:.6f}, {agree[0][1]:.3e} on "
            f"listed tiles; the twin's {agree[1][0]:.6f}, {agree[1][1]:.3e})"
        )
    say(line)
    return calls, same_lists


def reset_counts() -> None:
    from rt_rs_tpu_torch.ops import cuda

    cuda.LAUNCHES.clear()


def read_counts() -> dict[str, int]:
    from rt_rs_tpu_torch.ops import cuda

    return {name: cuda.LAUNCHES[name] for name in KERNELS}


def check_frame(name: str, frame, width: int, height: int, black: bool = False) -> None:
    """Finite, of the frame's shape, and lit (``black``: every value 0,
    the blank handler's frame)."""
    import torch

    if tuple(frame.shape) != (height, width, 3):
        raise AssertionError(f"{name}: shape {tuple(frame.shape)}")
    if not bool(torch.isfinite(frame).all()):
        raise AssertionError(f"{name}: non-finite values")
    mean = float(frame.mean())
    if black and bool(frame.any()):
        raise AssertionError(f"{name}: not black (mean {mean})")
    if not black and not mean > 0.01:
        raise AssertionError(f"{name}: black frame (mean {mean})")
    say(f"[frame] {name}: finite, mean {mean:.6f}, max {float(frame.max()):.6f}")


def check_stored(name: str, r, path: pathlib.Path, key: str = "frame") -> None:
    import numpy as np

    ref = np.load(path)[key]
    frame = r.render_frame().cpu().numpy()
    err = float(np.abs(frame - ref).max())
    if not err <= REF_ATOL:
        raise AssertionError(f"{name} vs the JAX package's stored frame: max {err}")
    say(f"[frame] {name} vs the JAX package's stored frame: max abs {err:.3g} (atol {REF_ATOL})")


def gather_band() -> None:
    """The gather branch on one table: ``gather_band_torus()`` at 32x16,
    finite, not black, and within REF_ATOL of the JAX package's stored
    frame (one pixel flipped there while the shading kernels used
    ``rsqrtf``: ROADMAP §3); its distance from the port's own CPU frame
    is printed."""
    import numpy as np

    global DEVICE
    from rt_rs_tpu_torch.scene.presets import gather_band_torus

    frame = renderer(32, 16, gather_band_torus()).render_frame()
    check_frame("gather band 32x16", frame, 32, 16)
    frame = frame.cpu().numpy()
    device, DEVICE = DEVICE, "cpu"
    try:
        on_cpu = renderer(32, 16, gather_band_torus()).render_frame().numpy()
    finally:
        DEVICE = device
    for what, ref in (
        ("the JAX package's stored frame", np.load(BAND_FRAME)["frame"]),
        ("the port's CPU frame", on_cpu),
    ):
        d = np.abs(frame - ref)
        far = np.argwhere(d > REF_ATOL)
        line = (
            f"gather band 32x16 vs {what}: max abs {d.max():.3g}, "
            f"{len(far)} of {d.size} values beyond {REF_ATOL} at (row, col) "
            f"{sorted({(int(i), int(j)) for i, j, _ in far})}"
        )
        if what.endswith("stored frame") and len(far):
            raise AssertionError(line)
        say(f"[frame] {line}")


def orbit_ms(name: str, r, frames: int, card: str, black: bool = False) -> float:
    """A full orbit in ``frames`` steps -> ms/frame (CUDA events)."""
    import torch

    mult = 2.0 * math.pi / frames / 0.0314
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(frames):
        out = r.render_frame(block=False)
        r.orbit(mult)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / frames * 1e3
    ms = start.elapsed_time(end) / frames
    check_frame(f"{name} orbit end", out, r.width, r.height, black)
    say(
        f"[orbit] {name}: {ms:.3f} ms/frame (CUDA events), {host_ms:.3f} ms "
        f"host, {frames} frames; {card}"
    )
    return ms


def drive_path(path: str, card: str) -> tuple[dict, dict, dict]:
    """One path's frames and orbits -> (frame ms, first frames, renderers)."""
    from rt_rs_tpu_torch.scene.presets import gather_band_torus, torus_row

    if path == "torus":
        check_stored("torus 96x72", renderer(96, 72), TORUS_FRAME)
    else:
        r = renderer(96, 72, torus_row(2), streaming_mode=path)
        check_stored(f"torus_row(2) {path} 96x72", r, ROW2_FRAME)
    if path == "segmented":
        gather_band()
    frame_ms, first, kept = {}, {}, {}
    for size, (w, h, frames) in SIZES[path].items():
        r = renderer(w, h) if path == "torus" else canyon(w, h, path)
        name = f"torus {size}" if path == "torus" else f"canyon {path} {size}"
        first[size] = r.render_frame()  # also the warm-up
        check_frame(name, first[size], w, h)
        frame_ms[name] = orbit_ms(name, r, frames, card)
        kept[size] = r
    return frame_ms, first, kept


def same_frame(what: str, a, b) -> None:
    """Bit-equal frames (NaN where the other is NaN)."""
    import torch

    nan = torch.isnan(a)
    if not (torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])):
        raise AssertionError(f"{what}: differs from the default frame (max {max_abs(a, b)})")
    say(f"[frame] {what}: bit-equal to the default frame")


def drive_knobs(card: str, first: dict) -> tuple[dict, dict]:
    """The knobs path: the fused bounce kernel and early exit on
    ``torus_scene`` (96x72 against the stored frame; 384x288 and 1080p
    bit-equal to the torus path's first frames, then orbits) and on the
    segmented ``torus_row(2)`` (96x72 against its stored frame: the
    gather branch); the segmented canyon with early exit at 640x480,
    bit-equal to the segmented path's frame; each glue-only knob once at
    384x288; early exit under a camera with pos == at (NaN rays)."""
    import warnings

    from rt_rs_tpu_torch.scene.camera import CameraUniform
    from rt_rs_tpu_torch.scene.presets import torus_row, torus_scene

    knobs, hkw = KNOBS
    check_stored("knobs torus 96x72", renderer(96, 72, knobs=knobs, **hkw), TORUS_FRAME)
    row2 = renderer(96, 72, torus_row(2), knobs=knobs, **hkw)
    check_stored("knobs torus_row(2) segmented 96x72", row2, ROW2_FRAME)
    frame_ms, kept = {}, {}
    for size, (w, h, frames) in SIZES["torus"].items():
        r = renderer(w, h, knobs=knobs, **hkw)
        name = f"knobs torus {size}"
        f = r.render_frame()
        check_frame(name, f, w, h)
        same_frame(name, f, first["torus"][size])
        frame_ms[name] = orbit_ms(name, r, frames, card)
        kept[size] = r
    w, h = CANYON_REPLAY
    r = canyon(w, h, "segmented", early_exit=True)
    same_frame(f"canyon segmented early_exit {w}x{h}", r.render_frame(), first["segmented"][f"{w}x{h}"])
    kept[f"canyon {w}x{h}"] = r
    for name, (knobs_g, hkw_g) in GLUE_KNOBS.items():
        w, h = TORUS_REPLAY
        f = renderer(w, h, knobs=knobs_g, **hkw_g).render_frame()
        same_frame(f"torus {w}x{h} {name}", f, first["torus"][f"{w}x{h}"])
    scene = torus_scene()
    scene.camera = CameraUniform((1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a = renderer(64, 48, scene, early_exit=True).render_frame()
        b = renderer(64, 48, scene).render_frame()
    same_frame("camera pos == at, early_exit 64x48", a, b)
    check_nan_sort()
    return frame_ms, kept


def check_nan_sort() -> None:
    """Early exit's stable sort puts NaN keys where NumPy's (and so
    jnp.argsort) does, on the card as on the CPU."""
    import numpy as np
    import torch

    from rt_rs_tpu_torch.ops import packet_trace as pt

    key = torch.tensor([[1.0, math.nan, 3e38, -1.0, math.nan, 2.0, 3e38, 0.5]])
    listed = torch.ones_like(key, dtype=torch.bool)
    on_card = pt.early_exit_lists(listed.to(DEVICE), key.to(DEVICE))[0].cpu()
    on_cpu = pt.early_exit_lists(listed, key)[0]
    ref = np.argsort(key.numpy(), axis=1, kind="stable")
    if not (np.array_equal(on_card.numpy(), ref) and np.array_equal(on_cpu.numpy(), ref)):
        raise AssertionError(f"NaN keys sort differently: card {on_card}, cpu {on_cpu}, numpy {ref}")
    say(f"[compare] early-exit sort with NaN keys: card = CPU = NumPy {ref[0].tolist()}")


def drive_flat(card: str, first: dict) -> tuple[dict, dict]:
    """The flat path: the glue's rsqrt bit-equal to IEEE ``1 / sqrt``;
    ``shade.render`` through pbvh's flat entry on the negative-material
    scenes (``torus_ghost()`` at 96x72 and both
    ``ghost_scene`` frames at 64x48 against the JAX package's stored
    frames; ``torus_ghost()`` orbits at 384x288 and 1080p), a ``blank``
    orbit of ``torus_scene`` at 384x288 (every ray misses: the frame
    pipeline alone), and one timed ``naive`` (brute force) frame of
    ``torus_scene`` at 384x288, with its distance from the torus path's
    pbvh frame of the same camera."""
    import numpy as np
    import torch

    from rt_rs_tpu_torch.ops import shade
    from rt_rs_tpu_torch.scene.presets import ghost_scene, torus_ghost

    # The glue's rsqrt: 1 / sqrt with each op correctly rounded, as on
    # the CPU (tests/test_torch_flat.py), so its rays are the CPU's bits.
    x = (np.random.default_rng(0).random(1 << 22) * 100.0 + 1e-3).astype(np.float32)
    got = shade._rsqrt(torch.from_numpy(x).to(DEVICE)).cpu().numpy()
    n = int((got != np.float32(1.0) / np.sqrt(x)).sum())
    if n:
        raise AssertionError(f"shade._rsqrt on the card: {n} values != IEEE 1 / sqrt")
    say(f"[compare] the flat glue's rsqrt on the card: IEEE 1 / sqrt bit for bit on {x.size} values")
    check_stored("torus_ghost 96x72", renderer(96, 72, torus_ghost()), TORUS_GHOST_FRAME)
    for m in (-1, 1):
        check_stored(
            f"ghost_scene({m}) 64x48", renderer(64, 48, ghost_scene(m)), GHOST_FRAMES,
            key=f"material_{m}",
        )
    frame_ms, kept = {}, {}
    for size, (w, h, frames) in SIZES["flat"].items():
        r = renderer(w, h, torus_ghost())
        name = f"torus_ghost {size}"
        check_frame(name, r.render_frame(), w, h)
        frame_ms[name] = orbit_ms(name, r, frames, card)
        kept[size] = r
    size = "384x288"
    w, h, frames = SIZES["torus"][size]
    r = renderer(w, h, handler="blank")
    check_frame(f"blank torus {w}x{h}", r.render_frame(), w, h, black=True)
    frame_ms[f"blank torus {w}x{h}"] = orbit_ms(f"blank torus {w}x{h}", r, frames, card, black=True)
    r = renderer(w, h, handler="naive")
    r.render_frame()  # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    f = r.render_frame(block=False)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    frame_ms[f"naive torus {w}x{h}"] = ms
    check_frame(f"naive torus {w}x{h}", f, w, h)
    d = (f - first["torus"][size]).abs().cpu().numpy()
    say(
        f"[frame] naive torus {w}x{h}: {ms:.3f} ms (one frame, CUDA events); vs the "
        f"pbvh frame: max abs {d.max():.3g}, {int((d > REF_ATOL).sum())} of {d.size} "
        f"values beyond {REF_ATOL}; {card}"
    )
    return frame_ms, kept


def probe_inputs():
    """torus_scene's 1080p primaries (the probes' JAX mains' rays, in
    8x16 and 16x16 pixel blocks: (o, d, excl) each) and its pbvh tables:
    the leaf-ordered arrays, the 64-triangle chunk table and a
    128-triangle one."""
    import torch

    from rt_rs_tpu_torch.ops import packet_trace as pt
    from rt_rs_tpu_torch.ops import shade

    r = renderer(*PROBE_SIZE)
    pos, at = r._camera_tensor(r.camera.pos), r._camera_tensor(r.camera.at)
    arrays = r.arrays
    corners = [x.cpu().numpy() for x in (arrays.pa, arrays.pb, arrays.pc)]
    rays = {}
    for blk in ((8, 16), (16, 16)):
        o, d = shade.camera_rays(pos, at, *PROBE_SIZE, block=blk)
        rays[blk] = (o, d, torch.zeros((o.shape[0],), dtype=torch.int32, device=DEVICE))
    return dict(
        r=r, arrays=arrays, corners=corners, rays=rays,
        chunks={
            64: r.accel,
            128: pt.build_tri_chunks(*corners, max_chunks=None, tri_chunk=128, device=DEVICE),
        },
        win=dict(t_min=r.config.compute.t_min, t_max=r.config.compute.t_max),
        eps=r.config.compute.eps,
    )


def drive_probes(card: str, first: dict) -> tuple[dict, dict]:
    """The probes' path (the JAX mains of experiments/roofline.py,
    mxu_mt.py and tpose_table.py): the practical f32 rate, fused and
    separate; ``packet_closest_hit_mxu`` at the three precisions and
    ``packet_closest_hit_t`` (tc 64 and 128) on torus_scene's 1080p
    primaries, each timed against ``packet_closest_hit`` on the same
    rays (20 calls, CUDA events); the canyon (``torus_canyon()``, one
    transposed tc = 64 table) rendered at 640x480 through
    ``shade.render`` with ``packet_closest_hit_t`` over an orbit, and
    held against the segmented Renderer's frame of the same camera."""
    from functools import partial

    import torch

    from rt_rs_tpu_torch.experiments import mxu_mt, roofline, tpose_table
    from rt_rs_tpu_torch.ops import packet_trace as pt
    from rt_rs_tpu_torch.ops import shade

    rates = {}
    for fused in (True, False):
        kind = "fused" if fused else "separate"
        rates[kind] = roofline.practical_peak(DEVICE, fused=fused)
        say(
            f"[peak] practical f32 rate, {kind} ({roofline.CHAINS} FMA chains per element, "
            f"iters {roofline.ITERS}, grid {roofline.GRID}): {rates[kind] / 1e12:.3f} TFLOP/s; {card}"
        )
    p = probe_inputs()
    win, eps = p["win"], p["eps"]
    call_ms = {}
    o, d, excl = p["rays"][(8, 16)]
    vpu = partial(pt.packet_closest_hit, p["chunks"][64], eps=eps, **win)
    t0, id0 = vpu(o, d, excl)
    call_ms["packet_closest_hit r128"] = time_ms(lambda: vpu(o, d, excl), 20)
    table = mxu_mt.build_mxu_table(p["chunks"][64])
    for precision in mxu_mt.PRECISIONS:
        mxu = partial(
            mxu_mt.packet_closest_hit_mxu, p["chunks"][64], table, eps=eps, precision=precision, **win
        )
        t1, id1 = mxu(o, d, excl)
        match, rel = mxu_mt.tf32_agreement(t1, id1, t0, id0)
        call_ms[f"mxu[{precision}]"] = time_ms(lambda: mxu(o, d, excl), 20)
        say(
            f"[probe] mxu[{precision}] 1080p primaries: {call_ms[f'mxu[{precision}]']:.3f} ms "
            f"against packet_closest_hit {call_ms['packet_closest_hit r128']:.3f} ms (20 calls); "
            f"pid match {match:.6f}, t rel err max {rel:.3e}; {card}"
        )
    o, d, excl = p["rays"][(16, 16)]
    cur = partial(pt.packet_closest_hit, p["chunks"][64], eps=eps, ray_tile=256, **win)
    t0, id0 = cur(o, d, excl)
    call_ms["packet_closest_hit r256"] = time_ms(lambda: cur(o, d, excl), 20)
    for tc in (64, 128):
        tables = tpose_table.build_tri_chunks_t(*p["corners"], tri_chunk=tc, device=DEVICE)
        new = partial(tpose_table.packet_closest_hit_t, tables, eps=eps, ray_tile=256, **win)
        t1, id1 = new(o, d, excl)
        if not (torch.equal(t0, t1) and torch.equal(id0, id1)):
            raise AssertionError(f"tpose tc={tc}: != packet_closest_hit on the 1080p primaries")
        call_ms[f"tpose[tc{tc}]"] = time_ms(lambda: new(o, d, excl), 20)
        say(
            f"[probe] tpose tc={tc} 1080p primaries: {call_ms[f'tpose[tc{tc}]']:.3f} ms against "
            f"packet_closest_hit {call_ms['packet_closest_hit r256']:.3f} ms (20 calls); t and "
            f"pid bit-equal; {card}"
        )
    frame_ms = {"probe calls": call_ms, "practical_peak_tflops": {k: v / 1e12 for k, v in rates.items()}}
    frame_ms["tpose canyon 640x480"], tpose = tpose_frame(card)
    return frame_ms, {"rates": rates, "inputs": p, "tpose canyon": tpose}


def tpose_frame(card: str):
    """The transposed-table canyon (:class:`TposeCanyon`) at TPOSE_FRAME
    -> (ms/frame over its orbit, the frame's TposeCanyon); its first
    frame against the segmented Renderer's frame of the same camera."""
    w, h, frames = TPOSE_FRAME
    r = TposeCanyon(w, h)
    seg, mine = r.seg.render_frame(), r.render_frame()
    check_frame(f"tpose canyon {w}x{h}", mine, w, h)
    d = (mine - seg).abs()
    far = int((d > REF_ATOL).sum())
    say(
        f"[frame] tpose canyon {w}x{h} ({r.tables.comp.numel() * 4 / 1e6:.2f} MB table) vs the "
        f"segmented Renderer's frame: max abs {float(d.max()):.3g}, {far} of {d.numel()} values "
        f"beyond {REF_ATOL}"
    )
    if far > TPOSE_FAR_SHARE * d.numel():
        raise AssertionError(f"tpose canyon frame: {far} values beyond {REF_ATOL}")
    return orbit_ms(f"tpose canyon {w}x{h}", r, frames, card), r


def drive_bvh(card: str, first: dict) -> tuple[dict, dict]:
    """The bvh path: the threaded ``bvh`` and ``rf_bvh`` torus frames at
    96x72 against the JAX package's stored frames, then BVH_ORBITS: each
    first frame finite and lit (the ``"auto"`` torus frame bit-equal to
    the torus path's pbvh frame: on the card it takes kernel G's walk,
    so its accel holds a walk tree and no packet table; the threaded
    torus frames' distance from it printed), then its orbit, with the
    structure's bytes (``Renderer.stats``)."""
    from rt_rs_tpu_torch.scene.presets import torus_canyon

    for handler in ("bvh", "rf_bvh"):
        r = renderer(96, 72, handler=handler, **THREADED)
        check_stored(f"{handler} threaded torus 96x72", r, BVH_FRAMES, key=handler)
    frame_ms, kept = {}, {}
    for name, (scene, handler, backend, w, h, frames) in BVH_ORBITS.items():
        r = renderer(w, h, torus_canyon() if scene == "canyon" else None, handler=handler, backend=backend)
        f = r.render_frame()
        check_frame(name, f, w, h)
        pbvh = first["torus"].get(f"{w}x{h}") if scene == "torus" else None
        if backend == "auto":
            if r.accel.walk is None or r.accel.chunks is not None:
                raise AssertionError(f"{name}: backend='auto' took the packet kernels on the card")
            same_bits(f"{name} vs the pbvh frame", f, pbvh)
            say(f"[frame] {name}: kernel G's walk, bit-equal to the pbvh frame (the packet kernels)")
        elif pbvh is not None:
            d = (f - pbvh).abs()
            say(
                f"[frame] {name} vs the pbvh frame: max abs {float(d.max()):.3g}, "
                f"{int((d > REF_ATOL).sum())} of {d.numel()} values beyond {REF_ATOL}"
            )
        label = f"{name} ({r.stats.name}, {r.stats.size} B)"
        frame_ms[name] = orbit_ms(label, r, frames, card)
        kept[name] = r
    for name, (scene, hkw) in edge_scenes().items():
        for handler in ("bvh", "rf_bvh"):
            f = {b: renderer(96, 72, scene, handler=handler, backend=b, **hkw).render_frame() for b in ("threaded", "packet")}
            check_frame(f"{handler} threaded {name} 96x72", f["threaded"], 96, 72, black=name == "no prims")
            same_bits(f"{handler} threaded {name} 96x72 vs the packet backend's frame", f["threaded"], f["packet"])
            say(f"[frame] {handler} threaded {name} 96x72: bit-equal to the packet backend's frame")
    return frame_ms, kept


def drive_lbvh(card: str, first: dict) -> tuple[dict, dict]:
    """The lbvh path: ``Renderer(torus_scene(), handler="lbvh")`` at 96x72
    against the JAX package's stored frame, at 384x288 and 1080p (their
    distance from the pbvh frames printed: the two leaf orders may break
    exact ties apart) with orbits of 30 and 12 frames and the table's
    bytes."""
    check_stored("lbvh torus 96x72", renderer(96, 72, handler="lbvh"), LBVH_FRAME)
    frame_ms, kept = {}, {}
    for size, (w, h, frames) in SIZES["torus"].items():
        r = renderer(w, h, handler="lbvh")
        f = r.render_frame()
        check_frame(f"lbvh torus {size}", f, w, h)
        d = (f - first["torus"][size]).abs()
        say(
            f"[frame] lbvh torus {size} vs the pbvh frame: max abs {float(d.max()):.3g}, "
            f"{int((d > REF_ATOL).sum())} of {d.numel()} values beyond {REF_ATOL}"
        )
        name = f"lbvh torus {size}"
        frame_ms[name] = orbit_ms(f"{name} ({r.stats.name}, {r.stats.size} B)", r, frames, card)
        kept[size] = r
    return frame_ms, kept


def lbvh_arrays(a, b, c) -> dict:
    """ops/lbvh's outputs for triangle corners a, b, c [P, 3]: Morton
    codes, order, Karras arrays and refit bounds."""
    import torch

    from rt_rs_tpu_torch.ops import lbvh

    codes = lbvh.centroid_codes(a, b, c)
    order = lbvh.morton_order(codes)
    o = order.long()
    kh = lbvh.karras_hierarchy(codes[o])
    lo = torch.minimum(torch.minimum(a, b), c)[o]
    hi = torch.maximum(torch.maximum(a, b), c)[o]
    nmin, nmax = lbvh.refit_bounds(*kh[:4], lo, hi)
    names = ("left", "right", "left_leaf", "right_leaf", "parent_leaf", "parent_internal")
    return dict(codes=codes, order=order, **dict(zip(names, kh)), node_min=nmin, node_max=nmax)


def check_builds() -> dict:
    """The on-device builds against the same torch code on the CPU:
    ops/lbvh (codes, order, Karras arrays, refit bounds) and
    ``build_bvh_device`` on ``torus_scene`` and ``torus_canyon()``,
    ``build_accel_device`` and ``device_chunks`` on the torus at frame
    DYNAMIC_FRAME of the wave, bit-equal; the card-built torus tree's
    96x72 frame through the threaded ``bvh`` walk bit-equal to pbvh's
    over the same tree.  -> build_bvh_device's seconds on the card."""
    import dataclasses

    import numpy as np
    import torch

    from rt_rs_tpu_torch.bvh.device import build_bvh_device
    from rt_rs_tpu_torch.handlers.lbvh import build_accel_device, device_chunks
    from rt_rs_tpu_torch.scene.presets import torus_canyon, torus_scene

    secs = {}
    for name, scene in (("torus", torus_scene()), ("canyon", torus_canyon())):
        arrays = {dev: scene.pack(device=dev) for dev in ("cpu", DEVICE)}
        out = {
            dev: lbvh_arrays(a.pa[1:], a.pb[1:], a.pc[1:]) for dev, a in arrays.items()
        }
        for key, x in out["cpu"].items():
            if not torch.equal(out[DEVICE][key].cpu(), x):
                raise AssertionError(f"ops/lbvh {name} {key}: card != CPU")
        build_bvh_device(scene, device=DEVICE)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = build_bvh_device(scene, device=DEVICE)
        secs[name] = time.perf_counter() - t0
        ref = build_bvh_device(scene, device="cpu")
        for f in dataclasses.fields(ref):
            if not np.array_equal(getattr(data, f.name), getattr(ref, f.name)):
                raise AssertionError(f"build_bvh_device {name} {f.name}: card != CPU")
        say(
            f"[build] {name} ({scene.num_prims} triangles): ops/lbvh (codes, order, Karras "
            f"arrays, refit bounds) and build_bvh_device ({data.num_nodes} nodes) card = CPU, "
            f"bit for bit; build_bvh_device {secs[name] * 1e3:.3f} ms on the card (host "
            "flatten included)"
        )
        if name == "torus":
            walk = renderer(96, 72, handler="bvh", data=data, **THREADED).render_frame()
            check_frame("bvh threaded torus 96x72 on the card-built LBVH", walk, 96, 72)
            same_bits(
                "bvh threaded 96x72 on the card-built LBVH vs pbvh on it",
                walk, renderer(96, 72, handler="pbvh", data=data).render_frame(),
            )
            say("[frame] bvh threaded torus 96x72 on the card-built LBVH: bit-equal to pbvh's")
    scene = torus_scene()
    vp, vn = wave(scene, DYNAMIC_FRAME)
    tables = {}
    for dev in ("cpu", DEVICE):
        r = dynamic(96, 72, scene, device=dev)
        arrays = r._frame_arrays(r._device_f32(vp), r._device_f32(vn))
        accel, permuted = build_accel_device(arrays, with_attrs=True)
        chunks = device_chunks(arrays.pa, arrays.pb, arrays.pc, shade_rows=arrays.shade_table)
        tensors = [getattr(permuted, f.name) for f in dataclasses.fields(permuted)]
        tables[dev] = [
            accel.comp, accel.bmin, accel.bmax, accel.attr,
            chunks.comp, chunks.bmin, chunks.bmax, chunks.attr,
            *(t for t in tensors if isinstance(t, torch.Tensor)),
        ]
    for i, (x, y) in enumerate(zip(tables["cpu"], tables[DEVICE], strict=True)):
        if not torch.equal(x, y.cpu()):
            raise AssertionError(f"build_accel_device / device_chunks tensor #{i}: card != CPU")
    say(
        f"[build] build_accel_device (with the rows table) and device_chunks on torus frame "
        f"{DYNAMIC_FRAME}: card = CPU, bit for bit ({len(tables['cpu'])} tensors)"
    )
    return secs


def walk_referee_frames() -> None:
    """The walked refit of ``torus_row(3)`` at 96x72, at the rest pose
    and at frame DYNAMIC_FRAME of the wave, bit-equal to the static
    ``bvh`` Renderer of a scene holding that pose's vertices over the
    rest pose's tree (whose covering bounds are recomputed on them)."""
    import copy

    from rt_rs_tpu_torch.bvh import build_bvh

    w = Wavy(walked(96, 72), None)
    data = build_bvh(w.r.scene, eps=0.02, target_item_count=2)
    for frame in (None, DYNAMIC_FRAME):
        w.frame = frame
        posed = copy.deepcopy(w.r.scene)
        if frame is not None:
            posed.vert_pos = w.verts(frame)[0]
        ref = renderer(96, 72, posed, handler="bvh", data=data)
        same_frame(f"dynamic walk teapots3 96x72 frame {frame} vs the static bvh referee", w.render_frame(), ref.render_frame())


def check_wide_builds() -> None:
    """The walked rebuild's kernels against their twin, bit for bit and
    twice alike, with the twin's wide node count: ``torus_row(3)`` at
    the rest pose and frames 3 and DYNAMIC_FRAME of the wave, the canyon
    (50,562 triangles), the deep chain and a one-prim soup."""
    from rt_rs_tpu_torch.ops import wide_build as wb
    from rt_rs_tpu_torch.scene.presets import deep_chain, random_soup, torus_canyon, torus_row

    errs = {"wide_build": 0.0}
    row3 = torus_row(3)
    cases = {f"teapots3 wave {i}": (row3, i) for i in (None, 3, DYNAMIC_FRAME)}
    cases.update({"canyon": (torus_canyon(), None), "deep chain": (deep_chain(), None), "one prim": (random_soup(3, 1), None)})
    for label, (scene, frame) in cases.items():
        posed = scene
        if frame is not None:
            import copy

            posed = copy.deepcopy(scene)
            posed.vert_pos = wave(scene, frame)[0]
        a = posed.pack(device=DEVICE)
        build = wb.workspace(posed.num_prims, DEVICE)
        check_build(f"wide_build {label}", (a.pa, a.pb, a.pc, build), errs)
    say(f"[build] wide_build on {list(cases)}: records bit-equal to the twin, twice alike")


def drive_dynamic(card: str) -> tuple[dict, dict]:
    """The dynamic path: the on-device builds against the CPU
    (:func:`check_builds`); DynamicRenderer at 96x72, rebuild and refit,
    at the rest pose and at frame DYNAMIC_FRAME of the wave, against the
    JAX package's stored frames; the walked refit of ``torus_row(3)`` at
    96x72 (:func:`walk_referee_frames`); first frames at 384x288 and 1080p, the walk's
    too (their orbits run in the chain phase's turns, eager against
    ``animate(chain=16)``)."""
    import numpy as np

    secs = check_builds()
    stored = np.load(DYNAMIC_FRAMES)
    for mode in ("rebuild", "refit"):
        for pose, frame in (("rest", None), (f"frame{DYNAMIC_FRAME}", DYNAMIC_FRAME)):
            w = Wavy(dynamic(96, 72, refit=mode == "refit"), frame)
            f = w.render_frame().cpu().numpy()
            err = float(np.abs(f - stored[f"{mode}_{pose}"]).max())
            if not err <= REF_ATOL:
                raise AssertionError(f"dynamic {mode} {pose} 96x72 vs the stored frame: max {err}")
            say(
                f"[frame] dynamic {mode} torus 96x72 {pose} vs the JAX package's stored frame: "
                f"max abs {err:.3g} (atol {REF_ATOL})"
            )
    walk_referee_frames()
    check_wide_builds()
    kept = {}
    for mode in ("rebuild", "refit", "walk", "rebuilt walk"):
        for w, h in (TORUS_REPLAY, PROBE_SIZE):
            if mode.endswith("walk"):
                r = Wavy(walked(w, h) if mode == "walk" else rebuilt(w, h), 0)
            else:
                r = Wavy(dynamic(w, h, refit=mode == "refit"), 0)
            scene = "teapots3" if mode.endswith("walk") else "torus"
            check_frame(f"dynamic {mode} {scene} {w}x{h} frame 0", r.render_frame(), w, h)
            kept[f"{mode} {w}x{h}"] = r
    kept["build_bvh_device_s"] = secs
    return {}, kept


def drive_dual(card: str, first: dict) -> tuple[dict, dict]:
    """The dual path: pbvh with ``tri_chunk_fine=FINE_TC``, the torus at
    384x288 and 1080p (resident, the rows branch) and the canyon at
    640x480 (segmented, the gather branch), each bit-equal to the
    single-table frame of its path; an orbit of the torus at 384x288."""
    frame_ms, kept = {}, {}
    for size, (w, h, _) in SIZES["torus"].items():
        r = renderer(w, h, tri_chunk_fine=FINE_TC)
        same_frame(f"dual torus {size}", r.render_frame(), first["torus"][size])
        kept[size] = r
    w, h = CANYON_REPLAY
    r = canyon(w, h, "segmented", tri_chunk_fine=FINE_TC)
    same_frame(f"dual canyon segmented {w}x{h}", r.render_frame(), first["segmented"][f"{w}x{h}"])
    kept[f"canyon {w}x{h}"] = r
    say(
        f"[frame] dual tables (fine tc {FINE_TC}): torus {list(SIZES['torus'])} and segmented "
        f"canyon {w}x{h} bit-equal to their single-table frames"
    )
    r = kept["384x288"]
    name = "dual torus 384x288"
    frame_ms[name] = orbit_ms(f"{name} ({r.stats.name}, {r.stats.size} B)", r, 30, card)
    return frame_ms, kept


def phase_paths(card: str):
    """Each path with the launch counters reset before and read after."""
    import torch

    counts, frame_ms, first, kept = {}, {}, {}, {}
    for path in PATHS:
        if path in ("chain", "tools", "parallel"):  # phase_chain, phase_tools, phase_parallel
            continue
        t0 = time.perf_counter()
        reset_counts()
        if path == "knobs":
            ms, kept[path] = drive_knobs(card, first)
        elif path == "flat":
            ms, kept[path] = drive_flat(card, first)
        elif path == "probes":
            ms, kept[path] = drive_probes(card, first)
        elif path == "bvh":
            ms, kept[path] = drive_bvh(card, first)
        elif path == "lbvh":
            ms, kept[path] = drive_lbvh(card, first)
        elif path == "dynamic":
            ms, kept[path] = drive_dynamic(card)
        elif path == "dual":
            ms, kept[path] = drive_dual(card, first)
        else:
            ms, first[path], kept[path] = drive_path(path, card)
        counts[path] = read_counts()
        frame_ms.update(ms)
        check_launches(path, counts[path])
        say(f"[launches] {path}: {counts[path]} ({time.perf_counter() - t0:.1f} s)")
    a, b = first["segmented"]["640x480"], first["dma"]["640x480"]
    if not torch.equal(a, b):
        raise AssertionError(
            f"canyon 640x480: segmented and dma frames differ (max {max_abs(a, b)})"
        )
    say("[frame] canyon 640x480: segmented and dma frames bit-equal")
    return counts, frame_ms, kept


# ----------------------------------------------------------------------
# the parallel path: rt_rs_tpu_torch.parallel on ranks sharing the card


def parallel_scene(name: str):
    from rt_rs_tpu_torch.scene.presets import torus_canyon, torus_ghost, torus_scene

    return {"torus": torus_scene, "canyon": torus_canyon, "ghost": torus_ghost}[name]()


def parallel_rank(rank: int, cases: dict, replay_case: str | None) -> dict:
    """One rank of the parallel path: per case (on the ranks of its
    mesh) the first frame, with rank 0's launches counted from 0 just
    before it and read just after it (and, for ``replay_case``, its
    kernel calls recorded), then PARALLEL_FRAMES frames timed on the
    host clock between synchronizations.  Rank 0 then replays the
    recorded calls through kernel and twin.  -> {case: frame (NumPy),
    luminance, launches, ms}, plus the replay's errors."""
    import contextlib

    import torch

    from rt_rs_tpu_torch import Config, Resolution
    from rt_rs_tpu_torch.handlers import get_handler
    from rt_rs_tpu_torch.parallel import hybrid_mesh, image_mesh, make_sharded_render

    meshes, out, recorded = {}, {}, None
    for label, (shape, scene_name, hname, hkw, w, h) in cases.items():
        if shape not in meshes:
            meshes[shape] = image_mesh(shape[0]) if len(shape) == 1 else hybrid_mesh(*shape)
        mesh = meshes[shape]
        if mesh is None:
            continue
        scene = parallel_scene(scene_name)
        handler = get_handler(hname, **hkw)
        accel, arrays = handler.build(scene, scene.pack(device=mesh.device))
        config = Config(resolution=Resolution.sized(w, h))
        fn = make_sharded_render(
            handler, accel, arrays, config.compute, w, h, mesh, resolution=config.resolution
        )
        pos, at = scene.camera.pos, scene.camera.at
        rec = Recorder() if rank == 0 and label == replay_case else contextlib.nullcontext()
        torch.cuda.synchronize()
        reset_counts()
        with rec:
            frame, lum = fn(pos, at)
            torch.cuda.synchronize()
        launches = read_counts()
        if isinstance(rec, Recorder):
            recorded = (label, rec.calls)
        t0 = time.perf_counter()
        for _ in range(PARALLEL_FRAMES):
            again, _ = fn(pos, at)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / PARALLEL_FRAMES * 1e3
        out[label] = dict(
            frame=frame.cpu().numpy(), lum=float(lum), launches=launches, ms=ms,
            again_equal=bool(torch.equal(again, frame)),
        )
    errs, ulps, n_calls = {k: 0.0 for k in KERNELS}, {}, {}
    if recorded is not None:
        label, calls = recorded
        replay(f"parallel {label} rank 0", calls, errs, ulps)
        n_calls = {k: len(v) for k, v in calls.items() if v}
    return dict(cases=out, errs=errs, ulps=ulps, n_calls=n_calls)


def check_native() -> dict:
    """The native builder on the card's host: build_bvh on the canyon,
    native against the NumPy builder (equal arrays), both timed."""
    import numpy as np

    from rt_rs_tpu_torch.bvh import BvhData, build_aabb_tree
    from rt_rs_tpu_torch.native import bindings
    from rt_rs_tpu_torch.native import build as native_build
    from rt_rs_tpu_torch.scene.presets import torus_canyon

    t0 = time.perf_counter()
    lib = native_build.build()
    build_s = time.perf_counter() - t0
    scene = torus_canyon()
    t0 = time.perf_counter()
    native = bindings.bvh_build_native(scene.vert_pos, scene.prim_indices, 0.02, 2)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = BvhData.from_tree(build_aabb_tree(scene, eps=0.02, target_item_count=2))
    numpy_s = time.perf_counter() - t0
    for f, a in native.items():
        if not np.array_equal(a, getattr(ref, f)):
            raise AssertionError(f"native build_bvh {f} differs from the NumPy builder's")
    say(
        f"[native] {lib.relative_to(ROOT)} built in {build_s:.2f} s; build_bvh canyon "
        f"({scene.num_prims} triangles): native {native_s:.4f} s, NumPy {numpy_s:.4f} s, "
        "every array equal"
    )
    return dict(build_s=build_s, native_s=native_s, numpy_s=numpy_s)


def check_native_obj(path: str) -> None:
    """``load_obj`` (native) equal to the Python parser on ``path``."""
    import numpy as np

    from rt_rs_tpu_torch.scene import obj

    def triangles(mesh):
        return [(i, [None if x is None else tuple(x) for x in n]) for i, n in mesh.triangles()]

    native, py = obj.load_obj(path), obj._load_obj_py(path)
    same = (
        np.array_equal(native.positions, py.positions)
        and np.array_equal(native.normals, py.normals)
        and triangles(native) == triangles(py)
    )
    if not same:
        raise AssertionError(f"native load_obj({path}) differs from the Python parser")
    say(f"[native] load_obj({path}): native = Python ({len(native.faces)} triangles)")


def phase_parallel(card: str, errs: dict) -> tuple[dict[str, int], dict]:
    """The parallel path: the native build and its checks, then one
    run_ranks call of PARALLEL_RANKS ranks on the card over gloo with
    every case of PARALLEL, and one of a single rank over NCCL; every
    rank's frame bit-equal to Renderer's at the same size on the card,
    its luminance equal on every rank and within rel 1e-4 of the single
    frame's mean; rank 0's replayed calls fold into ``errs``.  ->
    (rank 0's launches, summed over the cases, results)."""
    import numpy as np

    from rt_rs_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    native = check_native()  # built here, before the ranks load it
    runs = [
        (
            PARALLEL,
            run_ranks(parallel_rank, ["cuda:0"] * PARALLEL_RANKS, PARALLEL, PARALLEL_REPLAY),
            f"{PARALLEL_RANKS} ranks sharing one card over gloo: a correctness run, not a "
            "scaling number",
        ),
        (PARALLEL_NCCL, run_ranks(parallel_rank, ["cuda:0"], PARALLEL_NCCL, None), "1 rank, NCCL"),
    ]
    luma = np.array([0.2126, 0.7152, 0.0722], np.float32)
    counts = {k: 0 for k in KERNELS}
    ms = {}
    for cases, results, note in runs:
        for label, (shape, scene_name, hname, hkw, w, h) in cases.items():
            r = (
                ghost(w, h) if scene_name == "ghost"
                else renderer(w, h, parallel_scene(scene_name), handler=hname, **hkw)
            )
            ref = r.render_frame().cpu().numpy()
            got = [res["cases"][label] for res in results if label in res["cases"]]
            if len(got) != math.prod(shape):
                raise AssertionError(f"parallel {label}: {len(got)} ranks rendered")
            for rank, g in enumerate(got):
                if not np.array_equal(g["frame"], ref):
                    d = np.abs(g["frame"] - ref)
                    raise AssertionError(
                        f"parallel {label} rank {rank}: frame differs from Renderer's "
                        f"({int((d > 0).sum())} values, max {float(d.max())})"
                    )
                if not g["again_equal"]:
                    raise AssertionError(f"parallel {label} rank {rank}: timed frames differ")
            lums = {g["lum"] for g in got}
            single = float((ref @ luma).mean())
            lum = lums.pop()
            if lums or not abs(lum - single) <= 1e-4 * abs(single):
                raise AssertionError(
                    f"parallel {label}: luminance {sorted(lums | {lum})} vs the single "
                    f"frame's {single}"
                )
            for k in KERNELS:
                counts[k] += got[0]["launches"][k]
            ms[label] = got[0]["ms"]
            say(
                f"[parallel] {label}: {len(got)} ranks' frames bit-equal to Renderer's "
                f"({w}x{h}); luminance {lum:.6f} on every rank (single {single:.6f}); "
                f"{got[0]['ms']:.3f} ms/frame on rank 0 ({note}); launches {dict((k, v) for k, v in got[0]['launches'].items() if v)}; {card}"
            )
    check_launches("parallel", counts)
    rank0 = runs[0][1][0]
    for k, v in rank0["errs"].items():
        errs[k] = max(errs[k], v)
    say(
        f"[compare] parallel {PARALLEL_REPLAY} rank 0: every kernel call bit-equal to its "
        f"twin {rank0['n_calls']}; shading ulps {rank0['ulps']}"
    )
    seconds = time.perf_counter() - t0
    say(f"[parallel] phase done in {seconds:.1f} s")
    return counts, dict(ms=ms, native=native, seconds=seconds)


# ----------------------------------------------------------------------
# the tools phase: the user-facing layer (tools, timing, web, GIF)

# the study's protocol (the JAX package's timing.run_benchmark_protocol):
# case -> (load flags, width, height, frames over 5 orbits).  None: a
# Renderer of the threaded walk, timed directly beside load's
# --handler-bvh, which takes the same walk ("auto") on the card.
PROTOCOL = {
    "pbvh torus 384x288": (["--handler-pbvh"], 384, 288, 200),
    "bvh auto torus 384x288": (["--handler-bvh"], 384, 288, 200),
    "bvh threaded torus 384x288": (None, 384, 288, 200),
    "bvh auto torus 1920x1080": (["--handler-bvh"], 1920, 1080, 48),
    "bvh threaded torus 1920x1080": (None, 1920, 1080, 48),
    "dynamic rebuild torus 384x288": (["--dynamic"], 384, 288, 50),
    "dynamic refit torus 384x288": (["--refit"], 384, 288, 50),
}
# each protocol case beside phase 4's eager orbit of the same frames
PROTOCOL_ORBITS = {
    "pbvh torus 384x288": "torus 384x288",
    "bvh auto torus 384x288": "bvh auto torus 384x288",
    "bvh threaded torus 384x288": "bvh threaded torus 384x288",
    "bvh threaded torus 1920x1080": "bvh threaded torus 1920x1080",
}
TOOLS_SIZE = (384, 288)
VIEWER_SIZE = (320, 240)
GIF_FRAMES = 24


def decode_png(data: bytes):
    """A PNG of the port's writer (8-bit RGB, filter 0 on every row) as
    an [H, W, 3] uint8 array, with the standard library only."""
    import struct
    import zlib

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    w, h, depth, color = head[:4]
    if (depth, color) != (8, 2):
        raise AssertionError(f"PNG bit depth {depth}, colour type {color}: expected 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError("PNG rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def write_obj(scene, path: str) -> None:
    """A scene's mesh as OBJ text: positions, normals, faces v//vn."""
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in scene.vert_pos.astype(float).tolist()]
    lines += [f"vn {x!r} {y!r} {z!r}" for x, y, z in scene.vert_norm.astype(float).tolist()]
    lines += ["f " + " ".join(f"{i + 1}//{i + 1}" for i in tri) for tri in scene.prim_indices.tolist()]
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def check_png_equal(what: str, path: str, image) -> None:
    import numpy as np

    got = decode_png(pathlib.Path(path).read_bytes())
    if got.shape != image.shape or not np.array_equal(got, image):
        d = np.abs(got.astype(int) - image.astype(int)) if got.shape == image.shape else None
        raise AssertionError(
            f"{what}: PNG {got.shape} != render_image {image.shape}"
            + ("" if d is None else f", {int((d > 0).sum())} values differ, max {int(d.max())}")
        )
    say(f"[tools] {what}: the PNG equals render_image byte for byte ({image.shape})")


def tools_construct_load() -> None:
    """construct -> load --handler-pbvh: the PNG equals render_image of
    the same scene after the same orbit steps."""
    from rt_rs_tpu_torch import Renderer, Scene
    from rt_rs_tpu_torch.tools import construct, load

    w, h = TOOLS_SIZE
    rc = construct.main([
        "--out", "built.json", "--model", "torus.obj", "default",
        "--light", "30", "40", "-20", "1.6", "--light", "-25", "30", "25", "1.2",
        "--camera-pos", "0", "3", "-9", "0", "0", "0", "--camera-orbit",
    ])
    if rc != 0:
        raise AssertionError(f"construct exited {rc}")
    rc = load.main([
        "--path", "built.json", "--handler-pbvh", "--width", str(w), "--height", str(h),
        "--frames", "3", "--out", "load.png", "--device", DEVICE,
    ])
    if rc != 0:
        raise AssertionError(f"load exited {rc}")
    r = Renderer(Scene.load("built.json"), handler="pbvh", size=(w, h), device=DEVICE)
    r.orbit(1.0)
    r.orbit(1.0)
    check_png_equal(f"construct -> load --handler-pbvh {w}x{h}, frame 3", "load.png", r.render_image())


def tools_precompute() -> list:
    """precompute --device on the card = on the CPU; check_tree; the
    card-built tree rendered by load --handler-bvh PATH against the host
    build's frame.  The scene is two tori in a row (12,642 triangles);
    load's --handler-bvh takes the threaded walk (kernel G) on the card,
    as at every size.  -> the card-built frame's
    kernel calls, for the replay."""
    import io

    import numpy as np

    from rt_rs_tpu_torch import Renderer, Scene
    from rt_rs_tpu_torch.bvh import BvhData
    from rt_rs_tpu_torch.ops import cuda
    from rt_rs_tpu_torch.tools import load, precompute
    from rt_rs_tpu_torch.tools.debug_tree import check_tree

    t0 = time.perf_counter()
    precompute.main(["--scene", "row.json", "--out", "card.bvh.json", "--device", "--torch-device", DEVICE])
    card_s = time.perf_counter() - t0
    precompute.main(["--scene", "row.json", "--out", "cpu.bvh.json", "--device", "--torch-device", "cpu"])
    precompute.main(["--scene", "row.json", "--out", "host.bvh.json", "--item-count", "2"])
    card, cpu = (pathlib.Path(p).read_text() for p in ("card.bvh.json", "cpu.bvh.json"))
    if card != cpu:
        raise AssertionError("precompute --device: the card's checkpoint != the CPU's")
    say(f"[tools] precompute --device (two tori, 12,642 triangles): the card's checkpoint = the CPU's "
        f"({len(card)} bytes of JSON; {card_s:.3f} s)")
    scene = Scene.load("row.json")
    report = io.StringIO()
    bad = check_tree(BvhData.load("card.bvh.json"), scene, out=report)
    if bad:
        raise AssertionError(f"check_tree on the card-built checkpoint: {bad} violations\n{report.getvalue()}")
    say(f"[tools] debug_tree check_tree on the card-built checkpoint: {report.getvalue().strip().replace(chr(10), '; ')}")

    w, h = TOOLS_SIZE
    size = ["--width", str(w), "--height", str(h), "--device", DEVICE]
    for ckpt in ("card.bvh.json", "host.bvh.json"):
        before = cuda.LAUNCHES["bvh_walk[bvh,closest]"]
        rc = load.main(["--path", "row.json", "--handler-bvh", ckpt, *size, "--out", f"{ckpt}.png"])
        if rc != 0:
            raise AssertionError(f"load --handler-bvh {ckpt} exited {rc}")
        if cuda.LAUNCHES["bvh_walk[bvh,closest]"] == before:
            raise AssertionError(f"load --handler-bvh {ckpt}: the threaded walk never launched")
    frames, calls = {}, None
    for name in ("card", "host"):
        r = Renderer(scene, handler="bvh", handler_kwargs={"path": f"{name}.bvh.json"}, size=(w, h), device=DEVICE)
        if r.accel.walk is None:
            raise AssertionError(f"{name} checkpoint: the renderer took the packet kernels, not the walk")
        with Recorder() as rec:
            frames[name] = r.render_frame().cpu().numpy()
        calls = calls or rec.calls
        check_png_equal(f"load --handler-bvh {name} checkpoint (threaded walk) {w}x{h}", f"{name}.bvh.json.png", r.render_image())
    d = np.abs(frames["card"] - frames["host"])
    if not d.max() <= REF_ATOL:
        raise AssertionError(f"the card-built tree's frame vs the host build's: max {d.max()}")
    say(
        f"[tools] the card-built tree's frame vs the host build's (threaded, {w}x{h}): max abs "
        f"{d.max():.3g} (atol {REF_ATOL}), {'bit-equal' if not d.any() else f'{int((d > 0).sum())} values differ'}"
    )
    return [(f"tools card-built checkpoint bvh {w}x{h}", calls)]


def tools_protocol(frame_ms: dict, card: str) -> tuple[dict[str, float], bool]:
    """The study's protocol through load --benchmark, and directly
    through run_benchmark_protocol for its per-frame times (the threaded
    walk's cases directly only) -> (case -> mean ms per frame, whether
    the chart ran)."""
    import importlib.util

    from rt_rs_tpu_torch import Renderer, Scene, timing
    from rt_rs_tpu_torch.tools import load

    saved = timing.BenchScheduler.render_chart
    if importlib.util.find_spec("matplotlib") is None:
        say("[tools] matplotlib is not installed here: the chart does not run; chip_smoke.py "
            "replaces BenchScheduler.render_chart with a no-op for this phase (the times do not "
            "depend on it)")
        timing.BenchScheduler.render_chart = lambda self: None
        chart = False
    else:
        chart = True
    out = {}
    try:
        for name, (flags, w, h, frames) in PROTOCOL.items():
            if flags is None:
                r = Renderer(
                    Scene.load("torus.json"), handler="bvh", handler_kwargs={"backend": "threaded"},
                    size=(w, h), device=DEVICE,
                )
            else:
                argv = ["--path", "torus.json", *flags, "--width", str(w), "--height", str(h), "--device", DEVICE]
                rc = load.main([*argv, "--benchmark", "--bench-frames", str(frames)])
                if rc != 0:
                    raise AssertionError(f"load --benchmark {name} exited {rc}")
                r = load.make_renderer(load.build_parser().parse_args(argv))
            sched, mean_ms = timing.run_benchmark_protocol(r, frames=frames)
            t = sched.times_ms
            if len(t) != frames or not all(math.isfinite(x) and x > 0 for x in t):
                raise AssertionError(f"protocol {name}: {len(t)} times of {frames}, or not finite and positive")
            beside = PROTOCOL_ORBITS.get(name)
            orbit = f"; phase 4's eager orbit of the same frames {frame_ms[beside]:.3f} ms/frame" if beside in frame_ms else ""
            say(
                f"[protocol] {name}: {mean_ms:.3f} ms/frame averaged over {frames} frames, 5 orbits "
                f"({len(t)} frame times, all finite and > 0; {r.stats.name} {r.stats.size} B){orbit}; {card}"
            )
            out[name] = mean_ms
    finally:
        timing.BenchScheduler.render_chart = saved
    say(f"[tools] the chart {'ran' if chart else 'did not run (no matplotlib)'}")
    return out, chart


def tools_profile() -> None:
    """load --profile in a child process (its profiler would slow the
    later eager launches of this one): the trace names mt_trace's and
    shade_post's kernels."""
    w, h = TOOLS_SIZE
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rt_rs_tpu_torch.tools.load", "--path", "torus.json", "--handler-pbvh",
         "--width", str(w), "--height", str(h), "--frames", "2", "--profile", "prof", "--device", DEVICE],
        capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    if proc.returncode != 0:
        raise AssertionError(f"load --profile exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    trace = json.loads(pathlib.Path("prof/trace.json").read_text())
    kernels = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"}
    for want in ("mt_trace", "shade_post"):
        if not any(want in k for k in kernels):
            raise AssertionError(f"load --profile: no {want} kernel in the trace's {len(kernels)} kernel names")
    named = sorted(
        {
            re.sub(r"^void |\(anonymous namespace\)::", "", k).split("(")[0].split("<")[0]
            for k in kernels
            if "mt_trace" in k or "shade_post" in k
        }
    )
    say(
        f"[tools] load --profile (a child process, {time.perf_counter() - t0:.1f} s): the trace names "
        f"{len(kernels)} kernels, among them {named}"
    )


def tools_viewer() -> list:
    """The viewer on the card: frames equal render_image; a config, a
    viewport and a scene switch each show in the next frame; a bad scene
    keeps the old one and writes the note.  -> the kernel calls of the
    first frame (320x240) and of the scene switch's (256x192, the second
    torus), for the replay."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from rt_rs_tpu_torch.web import WebState, make_server

    state = WebState("torus.json", handler="pbvh", size=VIEWER_SIZE, device=DEVICE)
    server = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path: str) -> bytes:
        with urllib.request.urlopen(base + path, timeout=120) as resp:
            return resp.read()

    def post(path: str, body: bytes = b"{}") -> None:
        req = urllib.request.Request(base + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            resp.read()

    recorded = []

    def frame(what: str, record: str | None = None):
        if record is None:
            got = decode_png(get("/frame.png"))
        else:
            with Recorder() as rec:  # the server thread calls the patched wrappers
                got = decode_png(get("/frame.png"))
            recorded.append((record, rec.calls))
        with state.lock:
            ref = state.renderer.render_image()
        if got.shape != ref.shape or not np.array_equal(got, ref):
            raise AssertionError(f"viewer {what}: /frame.png != render_image")
        return got

    try:
        first = frame("first frame", f"tools viewer pbvh {VIEWER_SIZE[0]}x{VIEWER_SIZE[1]}")
        post("/config", json.dumps({"bounces": 1}).encode())
        f = frame("after a config update")
        if state.renderer.config.compute.bounces != 1 or np.array_equal(f, first):
            raise AssertionError("viewer: the config update did not show in the next frame")
        post("/viewport", json.dumps({"width": 256, "height": 192}).encode())
        f = frame("after a viewport change")
        if f.shape != (192, 256, 3):
            raise AssertionError(f"viewer: viewport change gave a frame of {f.shape}")
        prims = state.renderer.scene.num_prims
        post("/scene?name=second")
        f = frame("after a scene switch", "tools viewer pbvh 256x192 second torus")
        if state.renderer.scene.num_prims == prims or state.renderer.device != torch.device(DEVICE):
            raise AssertionError("viewer: the scene switch did not take, or left the card")
        prims = state.renderer.scene.num_prims
        post("/scene?name=missing")
        frame("after a bad scene name")
        note = json.loads(get("/status"))["note"]
        if state.renderer.scene.num_prims != prims or "failed to load scene" not in note:
            raise AssertionError(f"viewer: a bad scene name replaced the scene or wrote no note ({note!r})")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("viewer: the server thread did not stop")
    say(
        f"[tools] viewer ({VIEWER_SIZE[0]}x{VIEWER_SIZE[1]}, pbvh, {DEVICE}): /frame.png = render_image "
        f"after start, a config update (bounces 1), a viewport change (256x192), a scene switch "
        f"({prims} prims); a bad scene name kept the scene, note {note!r}"
    )
    return recorded


def tools_gif() -> bool:
    """render_orbit_gif: its file equals write_gif of the render_image
    sequence at the same cameras -> whether it ran (it needs PIL)."""
    import importlib.util

    from rt_rs_tpu_torch import Renderer, Scene
    from rt_rs_tpu_torch.scene.camera import ORBIT_RATE
    from rt_rs_tpu_torch.utils.animation import render_orbit_gif, write_gif

    if importlib.util.find_spec("PIL") is None:
        say("[tools] PIL is not installed here: the GIF does not run")
        return False
    make = lambda: Renderer(Scene.load("torus.json"), handler="pbvh", size=VIEWER_SIZE, device=DEVICE)  # noqa: E731
    times = render_orbit_gif(make(), "orbit.gif", frames=GIF_FRAMES)
    ref, seq = make(), []
    for _ in range(GIF_FRAMES):
        seq.append(ref.render_image())
        ref.orbit(2.0 * math.pi / GIF_FRAMES / ORBIT_RATE)
    write_gif("ref.gif", seq)
    if pathlib.Path("orbit.gif").read_bytes() != pathlib.Path("ref.gif").read_bytes():
        raise AssertionError("render_orbit_gif != write_gif of the render_image sequence")
    say(
        f"[tools] the GIF ran: render_orbit_gif {GIF_FRAMES} frames at {VIEWER_SIZE[0]}x{VIEWER_SIZE[1]} "
        f"= write_gif of the render_image sequence byte for byte (avg {sum(times) / len(times) * 1e3:.3f} ms "
        "a frame, the copy to the host included)"
    )
    return True


def phase_tools(card: str, frame_ms: dict, errs: dict) -> tuple[dict[str, int], dict]:
    """The user-facing layer on the card, in a temporary directory:
    construct -> load, precompute --device -> load --handler-bvh PATH,
    the study's protocol, load --profile (a child process), the viewer
    and the orbit GIF; then every kernel call of the card-built
    checkpoint's frame and of two viewer frames replayed through kernel
    and twin (into ``errs``).  -> (launches of the in-process steps,
    results)."""
    import contextlib
    import tempfile

    from rt_rs_tpu_torch.scene.presets import torus_row, torus_scene

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        scene = torus_scene()
        scene.save("torus.json")
        torus_scene(segments=(40, 20)).save("second.json")
        torus_row(2).save("row.json")
        write_obj(scene, "torus.obj")
        check_native_obj("torus.obj")
        reset_counts()
        tools_construct_load()
        recorded = tools_precompute()
        protocol_ms, chart_ran = tools_protocol(frame_ms, card)
        in_process = read_counts()
        tools_profile()
        reset_counts()
        recorded += tools_viewer()
        gif_ran = tools_gif()
        counts = {k: in_process[k] + v for k, v in read_counts().items()}
    check_launches("tools", counts)
    ulps: dict[str, int] = {}
    for label, calls in recorded:  # after the counts: these launches compare
        replay(label, calls, errs, ulps)
        n = {k: len(v) for k, v in calls.items() if v}
        say(f"[compare] {label}: every kernel call bit-equal to its twin {n}; shading ulps {ulps}")
    seconds = time.perf_counter() - t0
    say(f"[tools] phase done in {seconds:.1f} s")
    return counts, dict(protocol_ms=protocol_ms, chart_ran=chart_ran, gif_ran=gif_ran, seconds=seconds)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same_bits(what: str, a, b) -> None:
    """Bit-equal tensors (NaN where the other is NaN)."""
    import torch

    nan = torch.isnan(a)
    if not (a.shape == b.shape and torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])):
        raise AssertionError(f"{what}: not bit-equal (max abs {max_abs(a, b)})")


def device_bytes() -> tuple[int, int]:
    """(bytes the caching allocator holds, bytes in use on the card),
    with the allocator's unused cache released first."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return torch.cuda.memory_reserved(), total - free


def check_chain(label: str, r, k: int, mult: float) -> dict:
    """Checks (a)-(d) of one chain case: (a) the first dispatch captures
    its graph (a host read or a host-to-device copy in the frame makes the
    capture raise); (b) its frame 0 equals eager ``render_frame`` at the
    same camera and (c) frames 1..K-1 equal eager frames at the f32
    cameras the graph wrote out, bit for bit; (d) a second replay gives
    the same bits.  -> the capture's seconds and device bytes: the
    chains' buffers of this K, the graph memory pool's growth, and what
    the card gave outside the caching allocator (the graph itself)."""
    import torch

    held0, used0 = device_bytes()
    t0 = time.perf_counter()
    frames, poses, h = r._run_chain(k, mult)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    held1, used1 = device_bytes()
    io_bytes = (frames.numel() + poses.numel() + 7) * 4
    frames, poses = frames.clone(), poses.clone()
    same_bits(f"chain {label} frame 0 vs render_frame", frames[0], r.render_frame())
    at = r._camera_tensor(r.camera.at)
    host, drift = r.camera, 0.0
    eager_at = getattr(r, "eager_at", lambda j, h, pos, at: r._render(h, pos, at))
    for j in range(1, k):
        eager = eager_at(j, h, poses[j], at)
        same_bits(f"chain {label} frame {j} vs the eager frame at its camera", frames[j], eager)
        host = host.orbited(mult)
        drift = max(drift, max_abs(poses[j].double().cpu(), torch.tensor(host.pos, dtype=torch.float64)))
    again, poses2, _ = r._run_chain(k, mult)
    same_bits(f"chain {label} second replay", again, frames)
    same_bits(f"chain {label} second replay's cameras", poses2, poses)
    check_frame(f"chain {label} frame {k - 1}", frames[k - 1], r.width, r.height, black=label.startswith("blank"))
    return dict(
        capture_s=capture_s,
        io_mb=io_bytes / 1e6,
        pool_mb=(held1 - held0 - io_bytes) / 1e6,
        outside_mb=((used1 - used0) - (held1 - held0)) / 1e6,
        f32_camera_drift=drift,
    )


def busy_ms(r, frames: int = 2) -> float:
    """Device ms per eager frame (torch.profiler, the sum of its kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r.render_frame()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            r.render_frame(block=False)
            r.orbit(1.0)
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type != DeviceType.CPU)
    return us / 1e3 / frames


def phase_chain(card: str) -> tuple[dict[str, int], dict]:
    """``Renderer.animate(chain=K)`` on every frame path (CHAIN): the
    checks of :func:`check_chain` (at K, and at 4 for CHAIN4); then (e)
    the launch counts of N chained frames (all graphs captured, counts
    set to 0 just before and read just after) equal N eager frames',
    kernel by kernel, and (f) the host camera after them equals the
    eager loop's.  Timing chained against eager orbits is the
    benchmark's (``rtbench/``).  -> (the chained runs' launches, summed
    over the cases; the results by case)."""
    from rt_rs_tpu_torch.scene.camera import ORBIT_RATE

    total: collections.Counter[str] = collections.Counter()
    summary = {}
    for label, (make, k, n) in CHAIN.items():
        r = make()
        start = r.camera
        mult = 2.0 * math.pi / n / ORBIT_RATE
        r.render_frame()  # eager warm-up
        res = check_chain(label, r, k, mult)
        if label in CHAIN4:
            res["chain4"] = check_chain(label, r, 4, mult)
        r.animate(n, orbit_mult=mult, chain=k)  # captures every dispatch's graph
        r.camera = start
        reset_counts()
        r.animate(n, orbit_mult=mult, chain=k)
        chained, cam_chain = read_counts(), r.camera
        r.camera = start
        reset_counts()
        r.animate(n, orbit_mult=mult)
        eager, cam_loop = read_counts(), r.camera
        if chained != eager:
            diff = {x: (chained[x], eager[x]) for x in KERNELS if chained[x] != eager[x]}
            raise AssertionError(f"chain {label}: launches (chained, eager) differ: {diff}")
        if cam_chain != cam_loop:
            raise AssertionError(f"chain {label}: host camera {cam_chain} != the loop's {cam_loop}")
        total.update(chained)
        launched = {x: c for x, c in chained.items() if c}
        res["launches"] = launched
        summary[label] = res
        extra = ""
        if label in CHAIN4:
            c4 = res["chain4"]
            extra = (
                f"; bytes: K={k} buffers {res['io_mb']:.1f} MB, graph pool {res['pool_mb']:.1f} MB, "
                f"outside the allocator {res['outside_mb']:.1f} MB; K=4 buffers {c4['io_mb']:.1f} "
                f"MB, pool {c4['pool_mb']:.1f} MB, outside {c4['outside_mb']:.1f} MB"
            )
        say(
            f"[chain] {label}: K={k}, N={n}: captured in {res['capture_s']:.2f} s; frame 0 = "
            f"render_frame, frames 1..{k - 1} = eager frames at the graph's f32 cameras (max "
            f"{res['f32_camera_drift']:.3g} from the f64 orbit), a second replay alike: bit for "
            f"bit; launches of {n} chained frames = {n} eager frames' {launched}; host camera "
            f"= the loop's{extra}"
        )
        del r
    check_launches("chain", total)
    say(f"[launches] chain: {dict(+total)}")
    return {x: total[x] for x in KERNELS}, summary


# ----------------------------------------------------------------------
# bounds: the least time the card could take for a call's work, the
# larger of its f32 operations over PEAK_F32_OPS and its bytes (each
# input read once, each output written once, as far as this call's data
# needs them) over PEAK_BYTES.  Operations count f32 multiplies, adds,
# subtractions, divisions and square roots of the twins' arithmetic;
# comparisons and selects are not counted.

# mt_chunk_test per (ray, triangle): cross(d, e2) 9, o - a 3,
# cross(t, e1) 9, det / u / v 5 each, the sign fold 2, su + sv 1.
MT_OPS = 39
# refine_cull per (ray, chunk): two slab distances per axis (sub, mul).
SLAB_OPS = 12
# shade twins per live ray: the hit point and normal, each light's
# shadow ray and cull terms (pre) or diffuse and specular terms (post),
# the reflected ray (pre), the colour (post).
HIT_NORMAL_OPS = 77
PRE_LIGHT_OPS, PRE_NEXT_OPS = 43, 34
POST_LIGHT_OPS, POST_TAIL_OPS = 41, 9
# mt_mxu per (ray, triangle): the product, one multiply and one add per
# feature for each of det, u, v and wnum, over the features the table can
# make non-zero (d, o, o x d, one: 10 of 16; the tensor cores' k8 + k4
# steps pad them to 12, which the function does not need), and the
# epilogue's sign fold 2 and su + sv 1 (3xTF32: three products).
# bvh_walk: a node step's slab test, 3 axes of wobble (mul, add) and two
# slab distances (sub, sub, mul); a prim test's tri_intersect_pairs (edges
# 6, cross(d, e2) 9, o - a 3, cross(t, e1) 9, det / u / v 5 each, u + v
# 1, the numerator 5, the quotient 1); 3 reciprocals a ray.
WALK_NODE_OPS = 24
WALK_PRIM_OPS = 49
# bytes a walk reads per node stepped (bounds 24, links 8, count 4), per
# leaf entered (its start 4, or its 8 payload slots 32) and per prim
# tested (3 corners).
WALK_NODE_BYTES = 36
MXU_FEATURES = 10
MXU_PRODUCT_OPS = 2 * MXU_FEATURES * 4
MXU_EPILOGUE_OPS = 3


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def anyhit_pairs(b: dict) -> int:
    """Ray-triangle pairs an any-hit call needs: each ray's listed
    pairs, in list order, up to and including its first blocking hit
    (the kernel stops a ray there)."""
    import torch

    from rt_rs_tpu_torch.ops import packet_trace as pt

    comp, payload, ids, counts = (b[k] for k in ("comp", "payload", "ids", "counts"))
    tc = comp.shape[1]
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=payload.device)  # noqa: E731
    win = dict(t_min=f(b["t_min"]), t_max=f(b["t_max"]), eps=f(b["eps"]))
    sub = torch.arange(tc, device=payload.device)[None, :, None]
    done = torch.zeros(payload.shape[1:], dtype=torch.bool, device=payload.device)
    pairs = 0
    for k in range(int(counts.max()) if counts.numel() else 0):
        for sel in pt.twin_slices((counts > k).nonzero()[:, 0], tc * payload.shape[2]):
            ox, oy, oz, dx, dy, dz, excl, cap = (payload[i, sel][:, None, :] for i in range(8))
            c = ids[sel, k].long()
            tri = comp[c]
            ok, w = pt.mt_chunk_test(
                [tri[:, :, i : i + 1] for i in range(9)], ox, oy, oz, dx, dy, dz, **win
            )
            pid = (1 + b["pid_base"] + c[:, None, None] * tc + sub).float()
            hit = ok & (pid != excl) & (w < cap)  # [S, tc, r]
            any_hit = hit.any(dim=1)
            tested = torch.where(any_hit, hit.int().argmax(dim=1) + 1, tc)
            pairs += int(torch.where(done[sel], 0, tested).sum())
            done[sel] |= any_hit
    return pairs


def bound(name: str, a, kw) -> tuple[float, str]:
    """-> (bound ms, "bytes" or "operations") for one recorded call.
    fma_peak[separate] executes a multiply and an add for each
    multiply-add, so its f32 operations run at half the FFMA peak;
    mt_mxu[high] / [default] add their tensor-core products at the TF32
    peak."""
    ops, nbytes = work(name, a, kw)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    if name == "fma_peak[separate]":
        t_ops *= 2.0
    if name in ("mt_mxu[high]", "mt_mxu[default]"):
        t_ops += tf32_ops(name, a, kw) / PEAK_TF32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mxu_pairs(a) -> int:
    """(ray, triangle) pairs of an mt_mxu call: its list entries x tc x r."""
    table, rays, _, counts = a
    return int(counts.sum()) * (table.shape[2] // 4) * rays.shape[2]


def tf32_ops(name: str, a, kw) -> int:
    """The tensor-core product's operations of an mt_mxu[high] /
    [default] call (3xTF32: three products)."""
    precision = kw["precision"]
    return mxu_pairs(a) * MXU_PRODUCT_OPS * (3 if precision == "high" else 1)


def twin_of(name: str):
    """The twin of shading kernel ``name`` on the wrapper's arguments."""
    from rt_rs_tpu_torch.ops import shade_tile as st

    return lambda *a, **kw: st.twin(name, *a, **kw)


def bounce_halves(a, kw):
    """A recorded shade_bounce call's arguments as its two halves ->
    ((shade_post args, kwargs), (shade_pre args, kwargs))."""
    from rt_rs_tpu_torch.ops import shade_tile as st

    b = bind(st.shade_bounce, a, kw)
    live, lights = b["live_sg2"], b["lights"]
    post = [b[x] for x in ("table", "pid", "payload", "t", "active_f", "sh_t", "sh_id_f", "caps")]
    post_kw = {x: b[x] for x in ("first_bounce", "t_min", "t_max", "blocked_mode")}
    pre = [b[x] for x in ("table", "pid2", "payload2", "t2")]
    return (
        ((*post, live[0], lights), post_kw),
        ((*pre, live[1], lights), {"emit_next": b["emit_next"]}),
    )


def walk_work(a, kw):
    """The work of one recorded bvh_walk_tiled call, counted by its
    twin (the binary walk: the bound counts its node steps whatever walks
    them)."""
    from rt_rs_tpu_torch.ops import bvh_walk as bw

    w = bw.WalkWork()
    fa, fkw = twin_walk_args(a, kw)
    bw.walk_reference(*fa, **fkw, work=w)
    return w


def rf_walk_work(a, kw):
    """The work of one recorded bvh_walk_rf_tiled call, counted by its
    twin."""
    from rt_rs_tpu_torch.ops import bvh_walk_rf as rw

    w = rw.RfWork()
    rw.bvh_walk_rf_tiled_reference(*a, **kw, work=w)
    return w


def work(name: str, a, kw) -> tuple[int, int]:
    """-> (f32 operations, bytes) one recorded call needs."""
    import torch

    from rt_rs_tpu_torch.ops import packet_stream as ps
    from rt_rs_tpu_torch.ops import packet_trace as pt
    from rt_rs_tpu_torch.ops import shade_tile as st

    if name.startswith("bvh_walk_rf"):
        # the records walk: a record's slab test on its decoded bounds
        # (the wobble and the slab distances, kernel G's binary node
        # step), a slot's prim test; bytes: the floor every walk of
        # these rays moves, the payload's 32 bytes a ray read and its
        # outputs written (the records and prims stay in L2)
        w = rf_walk_work(a, kw)
        payload = a[0]
        n = payload.shape[1] * payload.shape[2]
        ops = w.records * WALK_NODE_OPS + w.prims * WALK_PRIM_OPS + 3 * w.rays
        out = {"closest": 8, "rows": 8 + 128, "anyhit": 1}[kw["mode"]]
        return ops, n * (32 + out)
    if name.startswith("bvh_walk"):
        # kernel G in a mode: the closest walk's work on its rays (any-hit's
        # stops sooner, so its bound lies below this), the payload's 32
        # bytes a ray read, t and pid written and, for rows, the 128-byte
        # row written
        w, n = walk_work(a, kw), a[1].numel()
        ops = w.node_steps * WALK_NODE_OPS + w.prim_tests * WALK_PRIM_OPS + 3 * n
        leaf_bytes = 32 if a[2].payload else 4
        nbytes = (
            n * (32 + 8) + w.nodes_read * WALK_NODE_BYTES + w.leaves_read * leaf_bytes
            + w.prims_read * 36 + (n * 128 if kw["mode"] == "rows" else 0)
        )
        return ops, nbytes
    if name == "wide_refit":
        # the refit: each prim's corners read once (36 B) with its row and
        # flag (8 B), its record written (48 B); each slot's word and range
        # read (12 B) and its six box words written (24 B), the unions
        # re-reading corners from L2; operations: a prim's 9 edge
        # subtractions, 12 min / max a prim box a slot under it, 5 for a
        # slot's wobble an axis
        pa, _, _, tree, refit = a
        q, u = refit.prim_meta.shape[0], refit.slot_word.shape[0]
        spans = int((refit.slot_range[:, 1] - refit.slot_range[:, 0]).sum())
        return 9 * q + 12 * spans + 15 * u, q * (36 + 8 + 48) + u * (12 + 24)
    if name == "wide_build":
        # the build: each prim's corners read once (36 B) and its record
        # written (48 B), each wide node's record written (128 B); the
        # keys, the tree, its boxes and the collapse stay in L2 (a few MB);
        # operations: a prim's box and code (about 60) and edges (9), an
        # internal node's union (6) and area (5), a slot's wobble (15)
        pa, _, _, build = a
        p, k = build.p, int(build.work["count"][0])
        return 69 * p + 11 * (p - 1) + 15 * 4 * k, p * (36 + 48) + k * 128
    if name.startswith("fma_peak"):
        from rt_rs_tpu_torch.experiments import roofline

        x, iters = a[0], a[1]
        grid = x.shape[0] // (roofline.CHAINS * roofline.ROWS)
        return int(roofline.peak_flops(iters, grid)), _bytes(x) + x.numel() // roofline.CHAINS * 4
    if name.startswith(("mt_tpose", "mt_mxu")):
        # f32 operations; the tables are read as far as their used rows
        table, rays, _, counts = a
        entries = int(counts.sum())
        n_tiles, r = rays.shape[0], rays.shape[2]
        if name == "mt_tpose":
            ops = entries * table.shape[2] * r * MT_OPS
            used = table.numel() * 9 // 16
        else:
            ops = mxu_pairs(a) * MXU_EPILOGUE_OPS
            if kw["precision"] == "highest":
                ops += mxu_pairs(a) * MXU_PRODUCT_OPS
            used = table.numel() * 10 // 16
        return ops, _bytes(rays, counts) + used * 4 + entries * 4 + n_tiles * r * 8
    if name == "shade_bounce":
        # The union of shade_post's and shade_pre's work: nothing shared.
        (post, post_kw), (pre, pre_kw) = bounce_halves(a, kw)
        ops_post, bytes_post = work("shade_post", post, post_kw)
        ops_pre, bytes_pre = work("shade_pre", pre, pre_kw)
        return ops_post + ops_pre, bytes_post + bytes_pre
    if name == "refine_cull":
        b = bind(pt.refine_cull_reference, a, kw)
        payload, valid, bounds = b["payload"], b["valid"], b["bounds"]
        n_tiles, r = valid.shape
        live = int(valid.any(dim=1).sum())
        nc = bounds.shape[0]
        ops = live * r * (nc * SLAB_OPS + 3)  # + the 3 reciprocals
        nbytes = live * r * (6 * 4 + 1 + 4) + _bytes(bounds) + n_tiles * nc
    elif name.startswith("mt_trace"):
        b = bind(pt.mt_trace_reference, a, kw)
        comp, payload, counts = b["comp"], b["payload"], b["counts"]
        n_tiles, r = payload.shape[1], payload.shape[2]
        # Early exit needs only the entries its tiles test (and their keys).
        ed = b["ed"]
        entries = int((counts if ed is None else pt.entries_tested(**b)).sum())
        if b["mode"] == "anyhit":
            ops = anyhit_pairs(b) * MT_OPS
        else:
            ops = entries * comp.shape[1] * r * MT_OPS
        out = {"closest": 8, "rows": 8 + 128, "anyhit": 1}[b["mode"]]
        nbytes = (
            _bytes(payload, comp, counts) + entries * 4 + n_tiles * r * out
            + (_bytes(b["attr"]) if b["mode"] == "rows" else 0)
            + (entries * 4 if ed is not None else 0)
        )
    elif name == "mt_stream":
        b = bind(ps.mt_stream_reference, a, kw)
        payload, table, words, blockids, counts = (
            b[k] for k in ("payload", "table", "words", "blockids", "counts")
        )
        n_tiles, r = payload.shape[1], payload.shape[2]
        tc = table.shape[1]
        group = counts.new_tensor(range(n_tiles)).long() // pt.TILE_GROUP
        listed = (
            words.new_tensor(range(words.shape[1]))[None, :] < counts[group][:, None]
        )
        w = words.gather(1, blockids[group].long())  # words in list order
        bits = sum(((w >> j) & 1) for j in range(32))  # popcount
        chunk_tests = int((bits * listed).sum())
        ops = chunk_tests * tc * r * MT_OPS
        nbytes = n_tiles * r * (7 * 4 + 8) + _bytes(table, words, blockids, counts)
    elif name in ("shade_pre", "shade_post"):
        b = bind(getattr(st, name), a, kw)
        t, pid, live_sg, lights = b["t"], b["pid"], b["live_sg"], b["lights"]
        n_tiles, r = t.shape
        k = lights.shape[0]
        lit = st._live_mask(live_sg, n_tiles).expand(n_tiles, r)
        live = int(lit.sum())
        # the table's rows read at least once each: 96 B (vectors 0-4 and
        # 6) for shade_pre, 112 B (0-6) for shade_post
        rows = int(torch.unique(pid[lit]).numel()) * (96 if name == "shade_pre" else 112)
        if name == "shade_pre":
            nxt = bool(b["emit_next"])
            ops = live * (HIT_NORMAL_OPS + k * PRE_LIGHT_OPS + (PRE_NEXT_OPS if nxt else 0))
            reads = live * (1 + 6 + 1) * 4  # pid, rays, t
            writes = n_tiles * r * (10 * k + (8 if nxt else 0)) * 4
        else:
            per_light = 1 if b["blocked_mode"] else 3
            ops = live * (HIT_NORMAL_OPS + k * POST_LIGHT_OPS + POST_TAIL_OPS)
            reads = live * (1 + 6 + 2 + k * per_light) * 4  # pid, rays, t, active
            writes = n_tiles * r * 3 * 4
        nbytes = rows + reads + writes + _bytes(live_sg, lights)
    else:
        raise KeyError(name)
    return ops, nbytes


def without_early_exit(a, kw) -> dict:
    """An early-exit mt_trace call's arguments as the default call over
    the same lists: ascending ids, no keys."""
    import torch

    from rt_rs_tpu_torch.ops import packet_trace as pt

    b = bind(pt.mt_trace_reference, a, kw)
    ids, counts = b["ids"], b["counts"]
    listed = torch.arange(ids.shape[1], device=ids.device)[None, :] < counts[:, None]
    overlap = torch.zeros_like(listed).scatter(1, ids.long(), listed)
    b["ids"], b["counts"] = pt.compact(overlap)
    b["ed"] = None
    return b


def phase_ab(card: str) -> tuple[dict, dict]:
    """The knob A/Bs: early exit on torus 1080p and on the segmented
    canyon at 640x480, the fused bounce kernel on torus 384x288 (the
    launch-bound frame), the bvh handler's packet backend (on) against
    its threaded walk (off) on torus 384x288 and 1080p; orbits with the
    knob off and on in interleaved turns (AB_ORDER).  For early exit, one recorded frame's closest-hit
    list entries against the entries its tiles tested.  -> (summary, the
    recorded calls of the torus 1080p early-exit frame)."""
    import torch

    from rt_rs_tpu_torch.ops import packet_trace as pt

    cases = {
        "early_exit torus 1920x1080": (lambda on: renderer(1920, 1080, early_exit=on), 12),
        "early_exit canyon segmented 640x480": (
            lambda on: canyon(640, 480, "segmented", early_exit=on), 16,
        ),
        "fuse_bounce torus 384x288": (
            lambda on: renderer(384, 288, knobs={"fuse_bounce": on}), 30,
        ),
        # off: bvh's threaded walk, on: its packet backend
        "bvh packet torus 384x288": (
            lambda on: renderer(384, 288, handler="bvh", backend="packet" if on else "threaded"), 16,
        ),
        "bvh packet torus 1920x1080": (
            lambda on: renderer(1920, 1080, handler="bvh", backend="packet" if on else "threaded"), 8,
        ),
    }
    summary, recorded = {}, {}
    for name, (make, frames) in cases.items():
        rs = {on: make(on) for on in (False, True)}
        for r in rs.values():
            r.render_frame()  # warm-up
        ms = {False: [], True: []}
        for on in AB_ORDER:
            ms[on].append(orbit_ms(f"A/B {name} {on}", rs[on], frames, card))
        summary[name] = {"off_ms": ms[False], "on_ms": ms[True]}
        line = (
            f"[A/B] {name}: off {[round(x, 3) for x in ms[False]]} ms, on "
            f"{[round(x, 3) for x in ms[True]]} ms per frame (orbits of {frames}, "
            f"order {AB_ORDER})"
        )
        if name.startswith("early_exit"):
            with Recorder() as rec, with_rows_calls(rs[True]):
                rs[True].render_frame()
            listed = tested = items = 0
            for a, kw, _ in rec.calls["mt_trace"]:
                b = bind(pt.mt_trace_reference, a, kw)
                if b["ed"] is not None and b["mode"] == "closest":  # the frame's own calls
                    listed += int(b["counts"].sum())
                    tested += int(pt.entries_tested(**b).sum())
                    items += int(pt.exit_entries_tested(**b).sum())
            torch.cuda.synchronize()
            summary[name].update(entries_listed=listed, entries_tested=tested, entries_items=items)
            line += (
                f"; closest-hit entries per frame: {listed} listed, {tested} tested by the "
                f"per-tile rule ({tested / max(listed, 1):.3f}), {items} by the items "
                f"({items / max(listed, 1):.3f})"
            )
            recorded[name] = rec.calls
        say(f"{line}; {card}")
    return summary, recorded["early_exit torus 1920x1080"]


def list_stats(counts) -> str:
    """An mt_trace call's lists: tiles, entries, the longest and mean
    list, empty tiles."""
    return (
        f"{counts.numel()} tiles, {int(counts.sum())} entries, max {int(counts.max())}, "
        f"mean {float(counts.float().mean()):.3f}, {int((counts == 0).sum())} empty"
    )


# Device ms of the per-tile walks that the balanced designs replaced, on
# the calls phase 6 times (this script's phase 6, NVIDIA H100 80GB HBM3,
# 700.00 W; mt_stream and early exit at commit 70c240c, the probes at
# db77f15): printed beside the new times for the record, not rerun.
WALK_MS = {
    "mt_stream": 10.1059,
    "mt_trace[closest,early_exit]": 1.3434,
    "mt_trace[rows,early_exit]": 2.1129,
    "mt_tpose": 2.7122,
    "mt_mxu[highest]": 8.9724,
    "mt_mxu[high]": 3.0711,
    "mt_mxu[default]": 2.1035,
}
# Launches per wrapper call of the probes' balanced designs: a prologue
# and the items, after the TF32 words' conversion on the tensor cores'
# variants (checked against torch.profiler in phase 6).
PROBE_CALL_LAUNCHES = {"mt_tpose": 2, "mt_mxu[highest]": 2, "mt_mxu[high]": 3, "mt_mxu[default]": 3}

# Bytes overwritten before each profiled call: five times the H100's
# 50 MB L2, so a call reads its inputs from HBM, as its bound assumes.
L2_FLUSH_BYTES = 256 << 20


# traces taken of one call before profiled() keeps the most complete
PROFILE_ATTEMPTS = 4


def profiled(fn, reps: int = 10, by_kernel: dict | None = None) -> tuple[dict[str, int], float]:
    """One wrapper call's kernel launches by kernel name and its device
    time in ms (the sum of its kernels' durations), from torch.profiler
    over ``reps`` calls, each after L2_FLUSH_BYTES are overwritten (the
    fill's own kernel is left out); ``by_kernel``, if given, gets each
    kernel's ms a call.  Unlike CUDA events around back-to-back calls,
    this does not read the host: a wrapper's Python side can outlast a
    kernel of tens of microseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 2, dtype=torch.int16, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        flush.fill_(1)
        flush.fill_(1)
        torch.cuda.synchronize()
    fill = {e.name for e in prof.events() if e.device_type != DeviceType.CPU}
    # A trace may come back without some of its device events (seen on the
    # card: 3 of 10 fills, kernels missing with them).  Such a trace is
    # taken again; the fills, one before each call, show whether it is
    # whole.
    best = None
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.fill_(1)
                fn()
            torch.cuda.synchronize()
        kernels, fills = [], 0
        for e in prof.events():
            if e.device_type == DeviceType.CPU:
                continue
            if e.name in fill or "FillFunctor<short>" in e.name:  # the fill of int16 `flush`
                fills += 1
            else:
                kernels.append(e)
        if best is None or fills > best[1]:
            best = (kernels, fills)
        if fills == reps:
            break
    kernels, fills = best
    if not kernels:
        raise AssertionError(f"profiled: no device event of the call in {PROFILE_ATTEMPTS} traces")
    if fills != reps:
        say(
            f"[warn] profiled: the L2 fill seen {fills} times in {reps} calls in the most "
            f"complete of {PROFILE_ATTEMPTS} traces; the times may miss kernels"
        )
    short = [
        re.sub(r"^void |\(anonymous namespace\)::", "", e.name).split("(")[0].split("<")[0]
        for e in kernels
    ]
    names = collections.Counter(short)
    if by_kernel is not None:
        for name, e in zip(short, kernels):
            by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    us = sum(e.time_range.elapsed_us() for e in kernels)
    return {k: round(v / reps) for k, v in names.items()}, us / reps / 1e3


def mt_call_ms(label: str, call, sep_rate: float, card: str) -> dict[str, float]:
    """One default-mode mt_trace call's device ms (:func:`profiled`),
    printed with the call's lists and bound."""
    from rt_rs_tpu_torch.ops import packet_trace as pt

    a, kw, _ = call
    b = bind(pt.mt_trace_reference, a, kw)
    name = pt.mt_name(b["mode"], False)
    ms = profiled(lambda: pt.mt_trace(*a, **kw))[1]
    b_ms, by = bound(name, a, kw)
    sep_ms = work(name, a, kw)[0] / sep_rate * 1e3
    say(
        f"[mt call] {label} ({list_stats(b['counts'])}): kernel {ms:.4f} ms; bound "
        f"{b_ms:.4f} ms ({by}), {sep_ms:.4f} at the separate rate; {card}"
    )
    return dict(ms=ms, bound_ms=b_ms, sep_ms=sep_ms)


# shade_post's launch floor: an empty kernel on the grid rt_shade_post
# launches (T / 8 * ceil(8 r / rays) blocks of ``rays`` threads, rays =
# shade_tile.POST_RAYS: a block never spans two 8-tile subgroups).  It
# computes nothing, so it has no plain version, and no frame path
# launches it: it lives here, not in the package.
FLOOR_SRC = r"""
#include <cuda_runtime.h>

__global__ void shade_post_floor_kernel() {}

extern "C" int rt_shade_post_floor(int n_tiles, int r, int rays, cudaStream_t stream) {
  const long per_sg = (8L * r + rays - 1) / rays;
  const long blocks = (long)(n_tiles / 8) * per_sg;
  if (blocks > 0) shade_post_floor_kernel<<<(unsigned)blocks, rays, 0, stream>>>();
  return (int)cudaGetLastError();
}
"""


def floor_launcher():
    """FLOOR_SRC built with the port's nvcc flags -> fn(t, rays) launching
    the empty kernel on shade_post's grid for rays shaped like ``t`` [T,
    r], blocks of ``rays`` (default shade_tile.POST_RAYS)."""
    import ctypes

    import torch

    from rt_rs_tpu_torch.ops import cuda
    from rt_rs_tpu_torch.ops import shade_tile as st

    out = cuda.BUILD / "shade_post_floor"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "shade_post_floor.cu", out / "libshade_post_floor.so"
    src.write_text(FLOOR_SRC)
    proc = subprocess.run(
        [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the floor kernel:\n" + proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(lib)).rt_shade_post_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(t, rays: int = st.POST_RAYS) -> None:
        err = fn(*t.shape, rays, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"rt_shade_post_floor: CUDA launch failed with error {err}")

    return launch


def phase_kernel_times(recorded, torus_1080_ee, kept, sep_rate: float, card: str):
    """Kernel vs twin vs bound: at the 384x288 torus frame's shapes (the
    primary rows call, bounce 0's shadow batch and its refine cull,
    bounce 0's shading, the knobs frame's first fused shading call),
    at the 640x480 canyon frame's (its busiest segment call in
    closest-hit mode and its busiest streamed call, and the busiest
    early-exit one), and at the torus 1080p early-exit frame's primary
    call.  Each early-exit call is also timed as the default call over
    the same lists, and the fused shading call as shade_post +
    shade_pre on the same inputs.  The probes' kernels at the compare
    phase's calls (fma_peak at the JAX sizes, mt_tpose and mt_mxu on
    torus_scene's 1080p primaries).  Each kernel on the CUDA cores' f32
    path also gets its bound at ``sep_rate``, the measured practical rate
    of separately rounded multiplies and adds, and its launches per
    wrapper call; each mt_trace call its lists.  Then the default-mode
    mt_trace calls (:func:`mt_call_ms`): the three above, the torus
    1080p frame's primary rows call and the flat ``torus_ghost()`` 1080p
    frame's busiest closest-hit call.  -> (kernel name -> times, call ->
    mt_trace time and bounds)."""
    from rt_rs_tpu_torch.bvh import wide
    from rt_rs_tpu_torch.ops import bvh_walk as bw
    from rt_rs_tpu_torch.ops import bvh_walk_rf as rw
    from rt_rs_tpu_torch.ops import packet_stream as ps
    from rt_rs_tpu_torch.ops import packet_trace as pt
    from rt_rs_tpu_torch.ops import shade_tile as st
    from rt_rs_tpu_torch.ops import wide_build as wb
    from rt_rs_tpu_torch.ops import wide_refit as wr

    torus, seg, dma, knobs, seg_ee = (
        recorded[k]
        for k in ("torus", "canyon segmented", "canyon dma", "torus knobs", "canyon early_exit")
    )
    mt = torus["mt_trace"]
    entries = lambda c: int(c[0][3].sum())  # noqa: E731  (counts of an mt_trace call)
    picks = {
        "refine_cull": (pt.refine_cull, pt.refine_cull_reference, torus["refine_cull"][0], 5),
        "mt_trace[closest]": (
            pt.mt_trace, pt.mt_trace_reference, max(seg["mt_trace"], key=entries), 2,
        ),
        "mt_trace[rows]": (
            pt.mt_trace, pt.mt_trace_reference,
            next(c for c in mt if c[1]["mode"] == "rows"), 5,
        ),
        "mt_trace[anyhit]": (
            pt.mt_trace, pt.mt_trace_reference,
            next(c for c in mt if c[1]["mode"] == "anyhit"), 5,
        ),
        "mt_stream": (
            ps.mt_stream, ps.mt_stream_reference,
            max(dma["mt_stream"], key=lambda c: c[0][0].shape[1]), 1,
        ),
        "shade_pre": (st.shade_pre, twin_of("shade_pre"), torus["shade_pre"][0], 5),
        "shade_post": (st.shade_post, twin_of("shade_post"), torus["shade_post"][0], 5),
        "mt_trace[closest,early_exit]": (
            pt.mt_trace, pt.mt_trace_reference,
            max((c for c in seg_ee["mt_trace"] if c[1]["mode"] == "closest"), key=entries), 2,
        ),
        "mt_trace[rows,early_exit]": (
            pt.mt_trace, pt.mt_trace_reference,
            next(c for c in torus_1080_ee["mt_trace"] if c[1]["mode"] == "rows"), 1,
        ),
        "shade_bounce": (
            st.shade_bounce, twin_of("shade_bounce"), knobs["shade_bounce"][0], 5,
        ),
        # the threaded canyon frame's primary rays in closest mode
        "bvh_walk[bvh,closest] canyon 640x480": (
            bw.bvh_walk_tiled, bw.bvh_walk_tiled_reference,
            closest_call(recorded["bvh canyon"]["bvh_walk_tiled"][0]), 1,
        ),
    }
    # the tiled modes on the same frames: the primary rows call (also in
    # closest mode), the first bounce's shadows (any-hit)
    for label, entry, name, kern, twin in (
        ("bvh torus", "bvh_walk_tiled", "bvh_walk[bvh,{}]", bw.bvh_walk_tiled, bw.bvh_walk_tiled_reference),
        ("rf_bvh torus", "bvh_walk_rf_tiled", "bvh_walk_rf[{}]", rw.bvh_walk_rf_tiled, rw.bvh_walk_rf_tiled_reference),
    ):
        tiled = recorded[label][entry]
        rows_call = next(c for c in tiled if c[1]["mode"] == "rows")
        for mode in ("closest", "rows", "anyhit"):
            call = next(c for c in tiled if c[1]["mode"] == mode) if mode != "closest" else closest_call(rows_call)
            picks[name.format(mode)] = (kern, twin, call, 1)
    for name, (kern, twin, a, kw) in recorded["probes"].items():
        picks[name] = (kern, twin, (a, kw, None), 1)
    # the walked refit of teapots3 (one call a frame)
    picks["wide_refit"] = (wr.wide_refit, wr.wide_refit_reference, recorded["dynamic walk teapots3"]["wide_refit"][0], 5)
    # the walked rebuild of teapots3 (one build a frame), the twin on the host's copy
    picks["wide_build"] = (
        wb.wide_build, lambda pa, pb, pc, _build: wb.wide_build_reference(pa.cpu(), pb.cpu(), pc.cpu()),
        recorded["dynamic rebuilt walk teapots3"]["wide_build"][0], 2,
    )
    times = {}
    for name, (kern, twin, (a, kw, _), twin_reps) in picks.items():
        ev_ms = time_ms(lambda: kern(*a, **kw), 50)
        by_kernel = {}
        launched, k_ms = profiled(lambda: kern(*a, **kw), by_kernel=by_kernel)
        t_ms = time_ms(lambda: twin(*a, **kw), twin_reps)
        b_ms, by = bound(name, a, kw)
        sep_ms = None
        if name.startswith(("mt_", "refine_cull", "bvh_walk")) and name not in ("mt_mxu[high]", "mt_mxu[default]"):
            sep_ms = work(name, a, kw)[0] / sep_rate * 1e3
        times[name] = (k_ms, t_ms, b_ms, by, sep_ms)
        extra = "" if sep_ms is None else f", bound at the separate rate {sep_ms:.4f} ms"
        extra += f", launches per call {sum(launched.values())} {launched}"
        if name in PROBE_CALL_LAUNCHES and sum(launched.values()) != PROBE_CALL_LAUNCHES[name]:
            raise AssertionError(f"{name}: {launched} launches per call, expected {PROBE_CALL_LAUNCHES[name]}")
        if "tf32_table_kernel" in by_kernel:
            extra += f", of which the TF32 words' conversion {by_kernel['tf32_table_kernel']:.4f} ms"
        if name.startswith(("mt_trace", "mt_tpose", "mt_mxu")):
            # list entries: (tile, chunk) pairs, each tc x r ray-triangle tests
            n = entries((a, kw))
            extra += f", {n} entries, {k_ms * 1e3 / n:.4f} us/entry"
        if name.startswith("mt_trace"):
            extra += f" ({list_stats(a[3])})"
        if name == "wide_build":
            extra += f", {a[3].p} prims, {int(a[3].work['count'][0])} wide nodes written"
        if name == "wide_refit":
            refit = a[4]
            spans = refit.slot_range[:, 1] - refit.slot_range[:, 0]
            extra += (
                f", {refit.prim_meta.shape[0]} prims, {spans.numel()} slots ({refit.block_slots} by a "
                f"block; the longest {int(spans.max())} prims, {int(spans.sum())} prim boxes unioned)"
            )
        if name.startswith("bvh_walk_rf"):
            w, records = rf_walk_work(a, kw), a[2]
            extra += (
                f", {w.rays} rays: {w.records} records tested ({w.records / w.rays:.2f} a ray), "
                f"{w.prims} prim tests ({w.prims / w.rays:.2f} a ray); records {records.words.numel() * 4} B, "
                f"{records.depth} levels"
            )
        elif name.startswith("bvh_walk"):
            fa, fkw = twin_walk_args(a, kw)
            w, ww, tree = walk_work(a, kw), bw.WideWork(), a[2]
            bw.bvh_walk_wide_reference(*fa, **fkw, work=ww)
            n = fa[0].shape[0]
            extra += (
                f", {n} rays: {w.node_steps} node steps, {w.prim_tests} prim tests "
                f"({w.nodes_read} nodes, {w.leaves_read} leaves, {w.prims_read} prims read); "
                f"wide walk: {ww.node_visits} node visits ({ww.node_visits / n:.2f} a ray), "
                f"{ww.prim_tests} prim tests, stack depth {ww.max_stack} of {tree.stack}; packed "
                f"records {tree.device_bytes} B ({tree.nodes.shape[0]} nodes of {wide.WIDTH}, "
                f"{tree.prims.shape[0]} prims)"
            )
        if name.endswith("early_exit]"):
            b0 = without_early_exit(a, kw)
            b = bind(pt.mt_trace_reference, a, kw)
            n_t = int(pt.entries_tested(**b).sum())
            n_i = int(pt.exit_entries_tested(**b).sum())
            d_ms = profiled(lambda: pt.mt_trace(**b0))[1]
            db_ms, _ = bound(name, (), b0)
            extra += (
                f", {n_t} tested by the per-tile rule, {n_i} by the items; the same call "
                f"without early exit: kernel {d_ms:.4f} ms, bound {db_ms:.4f} ms"
            )
        if name in WALK_MS:
            extra += f"; the per-tile walk it replaced: {WALK_MS[name]} ms (a constant: WALK_MS)"
        if name == "shade_bounce":
            (post, post_kw), (pre, pre_kw) = bounce_halves(a, kw)

            def post_pre():
                st.shade_post(*post, **post_kw)
                st.shade_pre(*pre, **pre_kw)

            extra += f"; shade_post + shade_pre on the same inputs {profiled(post_pre)[1]:.4f} ms"
        say(
            f"[time] {name}: kernel {k_ms:.4f} ms (device, profiler; CUDA events over 50 "
            f"back-to-back wrapper calls {ev_ms:.4f}), twin {t_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({by}){extra}; {card}"
        )
    # mt_trace[closest] on mt_tpose's lists: the time mt_tpose should match.
    a, kw = recorded["tpose lists"]
    b_ms = profiled(lambda: pt.mt_trace(*a, **kw))[1]
    times["mt_trace[closest] on mt_tpose's lists"] = (b_ms, None, *bound("mt_trace[closest]", a, kw), None)
    say(
        f"[time] mt_trace[closest] on mt_tpose's tc = 64 lists: kernel {b_ms:.4f} ms (device, "
        f"profiler); mt_tpose {times['mt_tpose'][0]:.4f} ms, {times['mt_tpose'][0] / b_ms:.3f} of it; {card}"
    )
    with Recorder() as rec, with_rows_calls(kept["torus"]["1920x1080"]) as torus_1080:
        torus_1080.render_frame()
    # shade_post at the torus 1080p frame's shapes (bounce 0's call), where
    # its body and not one launch's ramp sets its time.
    a, kw, _ = rec.calls["shade_post"][0]
    t_1080 = bind(st.shade_post, a, kw)["t"]
    k_ms = profiled(lambda: st.shade_post(*a, **kw))[1]
    b_ms, by = bound("shade_post", a, kw)
    t_ms = time_ms(lambda: st.twin("shade_post", *a, **kw), 2)
    times["shade_post 1920x1080"] = (k_ms, t_ms, b_ms, by, None)
    say(
        f"[time] shade_post torus 1920x1080 bounce 0 ({t_1080.shape[0]} tiles): kernel {k_ms:.4f} "
        f"ms (device, profiler), twin {t_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
        f"{b_ms / k_ms:.2f} of the bound; {card}"
    )
    # shade_post's launch floor: an empty kernel on its grid, timed as
    # shade_post is, at the 1080p call's shapes and the 384x288 call's.
    floors, floor = {}, floor_launcher()
    t_384 = bind(st.shade_post, *picks["shade_post"][2][:2])["t"]
    for label, t_in in (("1920x1080", t_1080), ("384x288", t_384)):
        floors[label] = profiled(lambda: floor(t_in))[1]
    times["shade_post floor"] = (floors["1920x1080"], floors["384x288"])
    for label, (ms_, bound_ms) in (
        ("384x288", (times["shade_post"][0], times["shade_post"][2])),
        ("1920x1080", (k_ms, b_ms)),
    ):
        floor = floors[label]
        n_tiles, r = (t_1080 if label == "1920x1080" else t_384).shape
        blocks = n_tiles // st.SUBGROUP * -(-st.SUBGROUP * r // st.POST_RAYS)
        say(
            f"[time] shade_post at {label}: kernel {ms_:.4f} ms, bytes bound {bound_ms:.4f} ms, "
            f"share of the bound {bound_ms / ms_:.2f}; launch floor (an empty kernel on its grid, "
            f"{blocks} blocks of {st.POST_RAYS}, device, profiler) {floor:.4f} ms, bound + floor "
            f"{bound_ms + floor:.4f} ms, {(bound_ms + floor) / ms_:.2f} of shade_post's time; {card}"
        )
    ghost = recorded["flat torus_ghost 1080p"]["mt_trace"]
    mt_calls = {
        "mt_trace[closest] canyon segmented 640x480, busiest call": picks["mt_trace[closest]"][2],
        "mt_trace[rows] torus 384x288 primary": picks["mt_trace[rows]"][2],
        "mt_trace[anyhit] torus 384x288 shadows": picks["mt_trace[anyhit]"][2],
        "mt_trace[rows] torus 1920x1080 primary": next(
            c for c in rec.calls["mt_trace"] if c[1]["mode"] == "rows"
        ),
        "mt_trace[closest] torus_ghost flat 1920x1080, busiest call": max(ghost, key=entries),
    }
    return times, {label: mt_call_ms(label, call, sep_rate, card) for label, call in mt_calls.items()}


def phase_dynamic_build(kept, card: str) -> dict:
    """Where a dynamic rebuild frame's build time goes, at 1080p: each
    part of the step before the trace (the corner gathers and the shade
    table, the Morton codes and the sort, the permute of the scene
    tensors, the chunk table with its rows table) profiled alone
    (:func:`profiled`: device ms and launches), against the frame's
    device busy time; build_bvh_device's seconds from the dynamic path.
    -> the numbers by part."""
    import dataclasses

    import torch

    from rt_rs_tpu_torch.handlers.lbvh import device_chunks
    from rt_rs_tpu_torch.ops.lbvh import centroid_codes, morton_order

    w = kept["dynamic"][f"rebuild {PROBE_SIZE[0]}x{PROBE_SIZE[1]}"]
    r = w.r
    vp, vn = (r._device_f32(x) for x in w.verts(DYNAMIC_FRAME))
    arrays = r._frame_arrays(vp, vn)
    order = morton_order(centroid_codes(arrays.pa[1:], arrays.pb[1:], arrays.pc[1:]))
    perm = torch.cat([order.new_zeros(1), order + 1]).long()

    def permute():
        return dataclasses.replace(
            arrays, **{k: getattr(arrays, k)[perm] for k in ("prim_mat", "pa", "pb", "pc", "na", "nb", "nc", "shade_table")}
        )

    permuted = permute()
    parts = {
        "gathers + shade table": lambda: r._frame_arrays(vp, vn),
        "Morton codes + sort": lambda: morton_order(centroid_codes(arrays.pa[1:], arrays.pb[1:], arrays.pc[1:])),
        "permute": permute,
        "chunk table + rows table": lambda: device_chunks(
            permuted.pa, permuted.pb, permuted.pc, shade_rows=permuted.shade_table
        ),
    }
    out = {}
    for name, fn in parts.items():
        launches, ms = profiled(fn)
        out[name] = {"ms": ms, "launches": sum(launches.values())}
    build_ms = sum(v["ms"] for v in out.values())
    build_n = sum(v["launches"] for v in out.values())
    frame_busy = busy_ms(w)
    out["build"] = {"ms": build_ms, "launches": build_n}
    out["frame_busy_ms"] = frame_busy
    out["build_bvh_device_s"] = kept["dynamic"]["build_bvh_device_s"]
    say(
        f"[dynamic build] rebuild torus {PROBE_SIZE[0]}x{PROBE_SIZE[1]}: "
        + ", ".join(f"{k} {v['ms']:.4f} ms ({v['launches']})" for k, v in out.items() if isinstance(v, dict) and "ms" in v and k != "build")
        + f"; build {build_ms:.4f} ms ({build_n} launches) of {frame_busy:.3f} busy ms a frame "
        f"({build_ms / frame_busy:.3f}); build_bvh_device s {out['build_bvh_device_s']}; {card}"
    )
    return out


def main(full: bool = True) -> None:
    import torch

    t0 = time.perf_counter()
    lap = [t0]

    def took(phase: str) -> None:
        now = time.perf_counter()
        say(f"[time] {phase}: {now - lap[0]:.1f} s")
        lap[0] = now

    phase_device()
    card = card_line()
    phase_build()
    took("device and build")
    errs, recorded = phase_compare()
    took("compare")
    if not full:
        return
    counts, frame_ms, kept = phase_paths(card)
    took("paths")
    counts["parallel"], parallel = phase_parallel(card, errs)
    took("parallel")
    counts["tools"], tools = phase_tools(card, frame_ms, errs)
    took("tools")
    ab, torus_1080_ee = phase_ab(card)
    took("ab")
    times, mt_calls = phase_kernel_times(
        recorded, torus_1080_ee, kept, kept["probes"]["rates"]["separate"], card
    )
    took("kernel times")
    builds = phase_dynamic_build(kept, card)
    took("dynamic build")
    # Last: the phases above time single calls with torch.profiler, whose
    # traces lost kernels when they ran after graphs were captured.
    counts["chain"], frame_ms["chain"] = phase_chain(card)
    took("chain")
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": rep,
            "launches": sum(c[name] for c in counts.values()),
            "launches_by_path": {p: c[name] for p, c in counts.items()},
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": times[name][2],
            "bound_by": times[name][3],
            "bound_ms_at_separate_rate": times[name][4],
            # No single PyTorch call computes these functions (a masked
            # Möller–Trumbore closest hit over per-tile chunk lists, a
            # per-ray slab cull OR-reduced per tile, the fused shading
            # passes, 16 chained multiply-adds summed, a BVH walk in the
            # escape links' order).
            "library_ms": None,
        }
        for name, (src, rep) in KERNELS.items()
    ]
    say(
        json.dumps(
            {
                "frame_ms": frame_ms, "ab": ab, "mt_calls": mt_calls,
                "shade_post_1080p": {
                    **dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), times["shade_post 1920x1080"])),
                    **dict(zip(("floor_ms", "floor_ms_384x288"), times["shade_post floor"])),
                },
                "mt_trace_on_tpose_lists": dict(
                    zip(("ms", "plain_ms", "bound_ms", "bound_by"), times["mt_trace[closest] on mt_tpose's lists"])
                ),
                "bvh_walk_canyon_640x480": dict(
                    zip(("ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_at_separate_rate"),
                        times["bvh_walk[bvh,closest] canyon 640x480"])
                ),
                "dynamic_build": builds,
                "parallel": parallel,
                "tools": tools,
                "card": card,
            }
        )
    )
    say(f"[total] chip_smoke.py ran for {time.perf_counter() - t0:.1f} s; {card}")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
