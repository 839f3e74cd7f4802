// Kernel H: the Möller–Trumbore closest hit on a transposed table.
//
// Replaces experiments/tpose_table.py::_mt_kernel_t (TPU kernel 9).  The
// table is [Nc, 16, tc] f32: component i (a, e1 = b - a, e2 = c - a, xyz)
// of triangle s of chunk c at [c, i, s], rows 9-15 zero.  Rays are
// tile-major [T, 8, r] (ox, oy, oz, dx, dy, dz, excl, unused).  Each
// tile tests every triangle of every chunk in ids[t, 0:counts[t]] (its
// compacted, ascending chunk list) with mt_chunk_test's arithmetic in
// its op order (common.cuh::mt_test); a hit also needs pid != excl,
// where triangle s of chunk c is prim 1 + c * tc + s.  Closest hit: the
// minimum w, ties to the smallest pid; misses (t_max + 1, 0).  On the
// same lists this is kernel B's closest-hit mode (mt_trace.cu) bit for
// bit: only the table's layout differs.
//
// Design: kernel B's closest-hit design on the balanced items of
// mt_items.cuh (a prologue launch and a persistent items launch, items
// of ITEM_TPOSE entries, the per-ray (t, pid) key merged with
// atomicMin), under the policy TposeChunks: kernel B's test, staged
// from the transposed layout.  A chunk's nine used component rows are
// 9 * tc contiguous floats, copied with cp.async in coalesced reads and
// scattered so that component i of triangle s lands at ring float
// 12 s + i, the padded layout mt_test_u_first reads with three 128-bit
// loads.  The rays are read in place from [T, 8, r].  The per-tile walk
// it replaces (one block per tile, the chunk copied between two
// barriers) lasted as long as the longest list.
//
// What bounds it: f32 arithmetic, 39 operations per (ray, triangle)
// pair, as kernel B; one thread owns one ray.
#include "mt_items.cuh"

namespace {

// Entries per work item (mirrored by experiments/tpose_table.py's
// TPOSE_ITEM_SIZE for the plain-PyTorch mirror): kernel B's closest mode.
enum { ITEM_TPOSE = 2 };

struct TposeChunks : ChunkRows {
  static __device__ __forceinline__ void stage(float* dst, const float* table,
                                               int c, int tc) {
    const float* src = table + (long)c * 16 * tc;
    for (int i = threadIdx.x; i < 9 * tc; i += blockDim.x) {
      const int k = i / tc;  // component k of triangle s -> 12 s + k
      cp_async4(dst + 12 * (i - k * tc) + k, src + i);
    }
    cp_async_commit();
  }

  template <int MODE>
  static __device__ __forceinline__ Ray load(const float* rays, int tile,
                                             int /*n_tiles*/, int r) {
    const float* ray = rays + (long)tile * 8 * r + threadIdx.x;
    Ray out;
    out.ox = ray[0 * r];
    out.oy = ray[1 * r];
    out.oz = ray[2 * r];
    out.dx = ray[3 * r];
    out.dy = ray[4 * r];
    out.dz = ray[5 * r];
    out.excl = ray[6 * r];
    out.cap = 0.0f;
    return out;
  }
};

__global__ void __launch_bounds__(kPrologueThreads) mt_tpose_prologue_kernel(
    const int* __restrict__ counts, float* __restrict__ out_t,
    int* __restrict__ out_pid, unsigned long long* __restrict__ keys,
    int* __restrict__ work, int n_tiles, int r, float miss) {
  items_prologue<MODE_CLOSEST, ITEM_TPOSE, false>(
      counts, nullptr, out_t, out_pid, nullptr, nullptr, keys, work, n_tiles,
      r, miss);
}

__global__ void __launch_bounds__(1024) mt_tpose_items_kernel(
    const float* __restrict__ rays, const float* __restrict__ table,
    const int* __restrict__ ids, const int* __restrict__ counts,
    float* __restrict__ out_t, int* __restrict__ out_pid,
    unsigned long long* __restrict__ keys, int* __restrict__ work,
    int n_tiles, int r, int nc, int tc, float t_min, float t_max, float eps,
    float miss) {
  items_body<TposeChunks, MODE_CLOSEST, ITEM_TPOSE, false>(
      rays, table, ids, counts, nullptr, nullptr, nullptr, out_t, out_pid,
      nullptr, nullptr, keys, work, n_tiles, r, nc, tc, 0, t_min, t_max, eps,
      miss, 1);
}

}  // namespace

// Scratch the wrapper allocates: `keys` [T * r] u64, `work` [4 T + 4]
// int32.
RT_EXPORT int rt_mt_tpose(const float* rays, const float* table,
                          const int* ids, const int* counts, float* out_t,
                          int* out_pid, unsigned long long* keys, int* work,
                          int n_tiles, int r, int nc, int tc, float t_min,
                          float t_max, float eps, float miss,
                          cudaStream_t stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  const size_t smem = 2 * (size_t)TposeChunks::slot_floats(tc) * sizeof(float);
  const Residency res = persistent_blocks(mt_tpose_items_kernel, r, smem);
  if (res.blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  mt_tpose_prologue_kernel<<<prologue_blocks((long)n_tiles * r, res.sms),
                             kPrologueThreads, 0, stream>>>(
      counts, out_t, out_pid, keys, work, n_tiles, r, miss);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long most = (long)n_tiles * ((nc + ITEM_TPOSE - 1) / ITEM_TPOSE);
  mt_tpose_items_kernel<<<items_grid(most, res.blocks), r, smem, stream>>>(
      rays, table, ids, counts, out_t, out_pid, keys, work, n_tiles, r, nc, tc,
      t_min, t_max, eps, miss);
  return (int)cudaGetLastError();
}
