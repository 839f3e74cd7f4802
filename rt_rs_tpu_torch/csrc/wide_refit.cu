// wide_refit: the per-frame refit of kernel G's packed wide tree.
//
// Replaces no pallas_call: the JAX package has no walked dynamic path
// (its DynamicRenderer refits a chunk table).  DynamicRenderer's walked
// path packs the bvh handler's tree once, at the rest pose
// (rt_rs_tpu_torch/bvh/wide.py::pack_walk), and each frame rewrites its
// records from the frame's corners with the topology fixed:
//   * each packed prim's 48-byte record {a, pid}, {b - a, last},
//     {c - a, 0} from row pid of the corners pa, pb, pc [P + 1, 3];
//   * each used child slot's six box words (lo.x, hi.x, lo.y, hi.y,
//     lo.z, hi.z, kWidth words apart from the slot's lo.x) as the union
//     of the prims under it, one contiguous range of packed prims
//     (bvh/wide.py::refit_map checks that at the pack), with the walk's
//     wobble as pack_walk rounds it: lo - wob, hi + wob, wob = 2e-6 +
//     1e-5 * max(|lo|, |hi|).
// The child words, the empty slots and the prims' order stay as packed.
// Unions over subsets nest exactly in f32, so the walk's invariants hold
// by construction.  Min and max propagate NaN, as torch.minimum does;
// the order they are taken in changes no bit but a zero's sign, which
// the wobble drops.  The twin is ops/wide_refit.py::wide_refit_reference.
//
// One launch, the slots longest range first: the first `block_slots`
// blocks each reduce one slot of more than REFIT_BLOCK_RANGE prims
// (bvh/wide.py; the root's slots hold up to half of the scene), their
// threads striding over its prims, then a shuffle and a shared-memory
// reduction; the next blocks run one warp a slot, lanes striding, then a
// shuffle reduction; the last blocks run one thread a prim.  While the trace buffer's flag is set (tracing.py),
// each block adds the prim records and the node slots it wrote to
// refit_prims and refit_nodes (`counter`, `counter + 1`).
//
// What bounds it: the longest slot's chain of loads, a block's share of
// the largest slot; the records, the corners and the map (a few MB) stay
// in L2.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kWidth = 4;  // WIDTH in bvh/wide.py

// NaN-propagating min with the semantics of torch.minimum.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

struct Corners {
  const float* __restrict__ pa;
  const float* __restrict__ pb;
  const float* __restrict__ pc;
};

__device__ __forceinline__ void load_row(const float* __restrict__ p, int row,
                                         float (&v)[3]) {
  const float* r = p + 3 * (size_t)row;
  v[0] = r[0];
  v[1] = r[1];
  v[2] = r[2];
}

// One prim's record, rewritten.
__device__ __forceinline__ void refit_prim(const Corners& c, int2 meta,
                                           int4* __restrict__ rec) {
  float a[3], b[3], d[3];
  load_row(c.pa, meta.x, a);
  load_row(c.pb, meta.x, b);
  load_row(c.pc, meta.x, d);
  rec[0] = make_int4(__float_as_int(a[0]), __float_as_int(a[1]),
                     __float_as_int(a[2]), meta.x);
  rec[1] = make_int4(__float_as_int(b[0] - a[0]), __float_as_int(b[1] - a[1]),
                     __float_as_int(b[2] - a[2]), meta.y);
  rec[2] = make_int4(__float_as_int(d[0] - a[0]), __float_as_int(d[1] - a[1]),
                     __float_as_int(d[2] - a[2]), 0);
}

// The box of prims first + k * stride < end, by one thread, reduced
// over its warp: every lane holds the warp's union.
__device__ __forceinline__ void warp_box(const Corners& c,
                                         const int2* __restrict__ meta,
                                         int first, int end, int stride,
                                         float (&lo)[3], float (&hi)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = FLT_MAX;
    hi[k] = -FLT_MAX;
  }
#pragma unroll 4
  for (int j = first; j < end; j += stride) {
    const int row = meta[j].x;
    float a[3], b[3], d[3];
    load_row(c.pa, row, a);
    load_row(c.pb, row, b);
    load_row(c.pc, row, d);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = nan_min(lo[k], nan_min(nan_min(a[k], b[k]), d[k]));
      hi[k] = nan_max(hi[k], nan_max(nan_max(a[k], b[k]), d[k]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = nan_min(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
      hi[k] = nan_max(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
    }
  }
}

// A slot's six box words, wobbled, from its union.
__device__ __forceinline__ void write_box(int* __restrict__ nodes, int word,
                                          const float (&lo)[3],
                                          const float (&hi)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float wob = 2e-6f + 1e-5f * nan_max(fabsf(lo[k]), fabsf(hi[k]));
    nodes[word + 2 * k * kWidth] = __float_as_int(lo[k] - wob);
    nodes[word + (2 * k + 1) * kWidth] = __float_as_int(hi[k] + wob);
  }
}

// One slot's box by one warp; lane 0 writes it.
__device__ __forceinline__ void refit_slot_warp(const Corners& c,
                                                const int2* __restrict__ meta,
                                                int word, int2 range,
                                                int* __restrict__ nodes) {
  float lo[3], hi[3];
  warp_box(c, meta, range.x + (threadIdx.x & 31), range.y, 32, lo, hi);
  if ((threadIdx.x & 31) == 0) write_box(nodes, word, lo, hi);
}

// One slot's box by the whole block: each warp's union through shared
// memory to thread 0, which writes it.
__device__ __forceinline__ void refit_slot_block(const Corners& c,
                                                 const int2* __restrict__ meta,
                                                 int word, int2 range,
                                                 int* __restrict__ nodes) {
  __shared__ float part[kWarps][6];
  float lo[3], hi[3];
  warp_box(c, meta, range.x + threadIdx.x, range.y, kBlock, lo, hi);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      part[warp][k] = lo[k];
      part[warp][3 + k] = hi[k];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = nan_min(lo[k], part[w][k]);
        hi[k] = nan_max(hi[k], part[w][3 + k]);
      }
    }
    write_box(nodes, word, lo, hi);
  }
}

__global__ void __launch_bounds__(kBlock)
    wide_refit_kernel(Corners c, const int2* __restrict__ meta, int q,
                      const int* __restrict__ slot_word,
                      const int2* __restrict__ slot_range, int u,
                      int block_slots, int slot_blocks,
                      int* __restrict__ nodes, int4* __restrict__ prims,
                      long long* __restrict__ trace, int counter) {
  long long v[2] = {0, 0};
  const int b = blockIdx.x;
  if (b < block_slots) {
    refit_slot_block(c, meta, slot_word[b], slot_range[b], nodes);
    v[1] = threadIdx.x == 0;
  } else if (b < slot_blocks) {
    // warp-uniform
    const int s = block_slots + (b - block_slots) * kWarps + (threadIdx.x >> 5);
    if (s < u) {
      refit_slot_warp(c, meta, slot_word[s], slot_range[s], nodes);
      v[1] = (threadIdx.x & 31) == 0;
    }
  } else {
    const int i = (b - slot_blocks) * kBlock + threadIdx.x;
    if (i < q) {
      refit_prim(c, meta[i], prims + 3 * (size_t)i);
      v[0] = 1;
    }
  }
  if (!trace_on(trace)) return;  // the flag is the same for the whole block
  block_sum(v);
  if (threadIdx.x == 0) {
    trace_add(trace, counter, v[0]);
    trace_add(trace, counter + 1, v[1]);
  }
}

}  // namespace

// pa, pb, pc [P + 1, 3] f32; meta [q, 2] (row, last); slot_word [u]
// (node * 8 * kWidth + slot); slot_range [u, 2] ([first, end) of packed
// prims), the first block_slots of them reduced by a block each -> nodes
// [k, 8 * kWidth] (the used slots' boxes) and prims [q, 12], both int32,
// rewritten in place.
RT_EXPORT int rt_wide_refit(const float* pa, const float* pb, const float* pc,
                            const int* meta, int q, const int* slot_word,
                            const int* slot_range, int u, int block_slots,
                            int* nodes, int* prims, long long* trace,
                            int counter, cudaStream_t stream) {
  if (q < 0 || u < 0 || block_slots < 0 || block_slots > u)
    return (int)cudaErrorInvalidValue;
  const int slot_blocks =
      block_slots + (u - block_slots + kWarps - 1) / kWarps;
  const int prim_blocks = (q + kBlock - 1) / kBlock;
  if (slot_blocks + prim_blocks == 0) return (int)cudaGetLastError();
  wide_refit_kernel<<<slot_blocks + prim_blocks, kBlock, 0, stream>>>(
      Corners{pa, pb, pc}, reinterpret_cast<const int2*>(meta), q, slot_word,
      reinterpret_cast<const int2*>(slot_range), u, block_slots, slot_blocks,
      nodes, reinterpret_cast<int4*>(prims), trace, counter);
  return (int)cudaGetLastError();
}
