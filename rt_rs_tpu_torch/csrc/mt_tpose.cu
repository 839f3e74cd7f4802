// Kernel H: the Möller–Trumbore closest hit on a transposed table.
//
// Replaces experiments/tpose_table.py::_mt_kernel_t (TPU kernel 9).  The
// table is [Nc, 16, tc] f32: component i (a, e1 = b - a, e2 = c - a, xyz)
// of triangle s of chunk c at [c, i, s], rows 9-15 zero.  Rays are
// tile-major [T, 8, r] (ox, oy, oz, dx, dy, dz, excl, unused).  Each
// tile walks ids[t, 0:counts[t]] (its compacted, ascending chunk list)
// and tests every triangle with mt_chunk_test's arithmetic in its op
// order (common.cuh::mt_test); a hit also needs pid != excl, where
// triangle s of chunk c is prim 1 + c * tc + s.  Closest hit: the
// minimum w, ties to the smallest pid; misses (t_max + 1, 0).  On the
// same lists this is kernel B's closest-hit mode (mt_trace.cu) bit for
// bit: only the table's layout differs.
//
// What bounds it: f32 arithmetic, 39 operations per (ray, triangle)
// pair, as kernel B.  One block per ray tile, one thread per ray.  The
// TPU kernel transposed each (16, tc) block in VMEM to put triangles
// on sublanes; here the layout is what makes the staging cheap: a
// chunk's 9 used component rows are 9 * tc contiguous floats, copied
// into shared memory with coalesced loads (kernel B's [tc, 9] chunk is
// contiguous too, so the two should time alike), and every thread
// then reads the same triangle at once: a shared-memory broadcast.
#include "common.cuh"

__global__ void mt_tpose_kernel(const float* __restrict__ rays,
                                const float* __restrict__ table,
                                const int* __restrict__ ids,
                                const int* __restrict__ counts,
                                float* __restrict__ out_t,
                                int* __restrict__ out_pid, int nc, int tc,
                                float t_min, float t_max, float eps,
                                float miss) {
  extern __shared__ float chunk[];  // [9, tc]
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int r = blockDim.x;
  const float* ray = rays + (long)tile * 8 * r + lane;
  const float ox = ray[0 * r], oy = ray[1 * r], oz = ray[2 * r];
  const float dx = ray[3 * r], dy = ray[4 * r], dz = ray[5 * r];
  const float excl = ray[6 * r];
  const int count = counts[tile];
  const int* list = ids + (long)tile * nc;
  float best_t = miss;
  int best_id = 0;
  for (int k = 0; k < count; ++k) {
    const int c = list[k];
    __syncthreads();  // everyone is done with the previous chunk
    const float* src = table + (long)c * 16 * tc;
    for (int i = lane; i < 9 * tc; i += r) chunk[i] = src[i];
    __syncthreads();
    const int pid0 = 1 + c * tc;
    for (int s = 0; s < tc; ++s) {
      float tri[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) tri[i] = chunk[i * tc + s];
      float w;
      if (!mt_test(tri, ox, oy, oz, dx, dy, dz, t_min, t_max, eps, w)) continue;
      if ((float)(pid0 + s) == excl) continue;
      if (w < best_t) {  // ascending pids: strict < keeps the smallest
        best_t = w;
        best_id = pid0 + s;
      }
    }
  }
  out_t[(long)tile * r + lane] = best_t;
  out_pid[(long)tile * r + lane] = best_id;
}

RT_EXPORT int rt_mt_tpose(const float* rays, const float* table,
                          const int* ids, const int* counts, float* out_t,
                          int* out_pid, int n_tiles, int r, int nc, int tc,
                          float t_min, float t_max, float eps, float miss,
                          cudaStream_t stream) {
  if (n_tiles > 0) {
    const size_t smem = (size_t)9 * tc * sizeof(float);
    mt_tpose_kernel<<<n_tiles, r, smem, stream>>>(
        rays, table, ids, counts, out_t, out_pid, nc, tc, t_min, t_max, eps,
        miss);
  }
  return (int)cudaGetLastError();
}
