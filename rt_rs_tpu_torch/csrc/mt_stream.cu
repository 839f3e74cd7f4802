// Kernel E: the Möller–Trumbore trace over per-group block lists.
//
// Replaces rt_rs_tpu/ops/pallas/packet_stream.py::_mt_stream_kernel
// (streaming_mode="dma").  The chunk table is cut into blocks of cpb
// chunks (8 at tc = 64: 512 triangles, 18 KB as [cpb * tc, 9] f32).
// The host gives each 32-tile group a compacted, ascending list of the
// blocks any of its tiles may hit (blockids[g, 0:counts[g]]) and each
// tile one int32 word per block, bit j = "this tile may hit chunk j of
// the block".  Rays are the component-major payload [8, T, 128] (ox,
// oy, oz, dx, dy, dz, excl, -).  Outputs: t [T, 128] f32 (the miss is
// t_max + 1) and pid [T, 128] i32 (0 on a miss).  Chunk j of a block is
// tested only where its bit is set, with kernel B's test (mt_test in
// common.cuh) and exclusion (pid != excl); the winner is the minimum
// t, ties to the smallest pid.  valid and t_cap are not read: they act
// through the host's cull only, as on the TPU.
//
// Design.  The TPU kernel runs one grid step per group, DMAs each
// listed block into a double-buffered VMEM scratch and keeps per-slot
// accumulators reduced at the end.  Here one CTA owns one 128-ray tile
// (one thread per ray) and walks its group's list itself: a block whose
// word is 0 for this tile is skipped (the test is uniform across the
// CTA: no divergence), the others are staged into shared memory with
// cp.async, double-buffered so that the next live block's copy overlaps
// this block's tests.  Each thread scans the block's set chunks and
// their triangles in ascending (block, chunk, slot) order with a strict
// `<`, which keeps the minimum t and, on ties, the smallest pid: the
// same winner as the TPU's per-slot accumulators followed by its
// (min t, min pid) reduction.
//
// What bounds it on this card: f32 arithmetic, 39 operations per
// (ray, triangle) pair before the rare division, against 18 KB of
// block per 8K-65K pair tests; the block is read from shared memory as
// broadcasts.  The design keeps the arithmetic fed by overlapping the
// block copies with the tests and by skipping unset chunks wholesale.
#include "common.cuh"

namespace {

constexpr int kLanes = 128;     // rays per tile (one thread each)
constexpr int kTileGroup = 32;  // tiles per block list

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of n floats (one block) into shared memory as one
// cp.async group: 16-byte copies when n is a multiple of 4 (block
// offsets are then 16-byte aligned too), else 4-byte copies.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  if ((n & 3) == 0) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4)
      cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
  }
  cp_async_commit();
}

__global__ void mt_stream_kernel(const float* __restrict__ payload,
                                 const float* __restrict__ comp,
                                 const int* __restrict__ words,
                                 const int* __restrict__ blockids,
                                 const int* __restrict__ counts,
                                 float* __restrict__ out_t,
                                 int* __restrict__ out_pid, int n_tiles,
                                 int nb, int cpb, int tc, float t_min,
                                 float t_max, float eps, float miss) {
  extern __shared__ __align__(16) float smem[];  // 2 x [cpb * tc * 9]
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const long plane = (long)n_tiles * kLanes;
  const long idx = (long)tile * kLanes + lane;

  const float ox = payload[0 * plane + idx];
  const float oy = payload[1 * plane + idx];
  const float oz = payload[2 * plane + idx];
  const float dx = payload[3 * plane + idx];
  const float dy = payload[4 * plane + idx];
  const float dz = payload[5 * plane + idx];
  const float excl = payload[6 * plane + idx];

  const int group = tile / kTileGroup;
  const int count = counts[group];
  const int* list = blockids + (long)group * nb;
  const int* tile_words = words + (long)tile * nb;
  const int n = cpb * tc * 9;  // floats per block

  // The first list position >= k whose block this tile must test.
  auto next_live = [&](int k) {
    while (k < count && tile_words[list[k]] == 0) ++k;
    return k;
  };

  float best_t = miss;
  int best_id = 0;
  int k = next_live(0);
  if (k < count) stage(smem, comp + (long)list[k] * n, n);
  int slot = 0;
  while (k < count) {
    const int k_next = next_live(k + 1);
    if (k_next < count) {
      stage(smem + (1 - slot) * n, comp + (long)list[k_next] * n, n);
      cp_async_wait<1>();  // this block's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int blk = list[k];
    const unsigned word = (unsigned)tile_words[blk];
    const float* buf = smem + slot * n;
    for (int j = 0; j < cpb; ++j) {
      if (!((word >> j) & 1u)) continue;
      const int pid0 = 1 + (blk * cpb + j) * tc;
      const float* chunk = buf + j * tc * 9;
      for (int s = 0; s < tc; ++s) {
        float w;
        if (!mt_test(chunk + s * 9, ox, oy, oz, dx, dy, dz, t_min, t_max, eps,
                     w))
          continue;
        if ((float)(pid0 + s) == excl) continue;
        if (w < best_t) {
          best_t = w;
          best_id = pid0 + s;
        }
      }
    }
    __syncthreads();  // everyone is done with this buffer before its refill
    k = k_next;
    slot ^= 1;
  }
  out_t[idx] = best_t;
  out_pid[idx] = best_id;  // 0 unless some hit (all hits have w < t_max)
}

}  // namespace

RT_EXPORT int rt_mt_stream(const float* payload, const float* comp,
                           const int* words, const int* blockids,
                           const int* counts, float* out_t, int* out_pid,
                           int n_tiles, int nb, int cpb, int tc, float t_min,
                           float t_max, float eps, float miss,
                           cudaStream_t stream) {
  if (n_tiles > 0) {
    const size_t smem = 2 * (size_t)cpb * tc * 9 * sizeof(float);
    mt_stream_kernel<<<n_tiles, kLanes, smem, stream>>>(
        payload, comp, words, blockids, counts, out_t, out_pid, n_tiles, nb,
        cpb, tc, t_min, t_max, eps, miss);
  }
  return (int)cudaGetLastError();
}
