// Kernel B: the Möller–Trumbore packet trace.
//
// Replaces rt_rs_tpu/ops/pallas/packet_trace.py::_mt_kernel with its
// per-(chunk, tile) test mt_chunk_test, in three modes:
//   closest (mode 0): t [T, r] f32, pid [T, r] i32;
//   rows    (mode 1): also the winner's 32-float shade row [32, T, r];
//   any-hit (mode 2): blocked [T, r] bool.
// Each tile walks ids[t, 0:counts[t]] (the compacted, ascending chunk
// list) and tests every triangle of each chunk.  A hit is ok iff the
// sign-folded two-sided test passes (adet > eps, 0 <= su <= adet,
// sv >= 0, su + sv <= adet), t_min < w < t_max, and pid != excl
// (payload row 6).  Closest hit: the minimum w, ties to the smallest
// pid, misses (t_max + 1, 0).  Any-hit: some ok hit has w < cap
// (payload row 7).  Tiles with an empty list write misses.  Prim ids
// are global: triangle s of chunk c is 1 + pid_base + c * tc + s (a
// segment of a larger table passes its base), and the rows table is
// indexed by that global id.
//
// What bounds it on this card: f32 arithmetic, ~40 ops per (ray,
// triangle) pair, with the chunk's 64 x 9 floats read from shared
// memory as broadcasts.  One block owns one 256-ray tile (one thread
// per ray); the chunk is staged cooperatively, then each thread scans
// the 64 triangles in ascending pid order with a strict `<`, which is
// exactly the TPU kernel's sublane-then-slot (min t, min pid)
// reduction.  The TPU builds rows with a 0/1-match matmul because it
// cannot gather; here the winner's row is one indexed 128-byte load
// (row 0 of the table is zeros, so misses need no branch).  Any-hit
// stops a tile once every ray is blocked (a block-wide vote per chunk).
//
// Early exit (the closest and rows modes with `ed` given; the TPU
// kernel's early_exit branches, packet_trace.py:837-846, :859-891 and
// :926-942).  The lists are front to back: ed[t, k] is a lower bound on
// the entry distance of entry k's chunk for every ray of the tile, and
// ascends along k.  The block keeps the tile's `worst` (the largest
// best t over all r lanes, invalid and padding lanes included) in
// shared memory, refreshed after every exit_check-th entry with a warp
// shuffle max and one pass over the warps' maxima.  Before staging
// entry k the block compares ed[t, k] with `worst`: both are per tile,
// so the decision is uniform and costs no divergence, and since ed
// ascends and `worst` never rises, the first entry beyond it ends the
// tile's walk outright (the TPU kernel could only skip entry by entry
// inside its fori_loop; the results are the same).  What bounds it is
// the same arithmetic, now over the entries actually tested.  The
// reordered walk no longer meets pids in ascending order, so the update
// is (t, pid)-lexicographic.  Rows stay one indexed load after the walk.
#include "common.cuh"

enum { MODE_CLOSEST = 0, MODE_ROWS = 1, MODE_ANYHIT = 2 };

template <int MODE, bool EARLY_EXIT>
__global__ void mt_trace_kernel(const float* __restrict__ payload,
                                const float* __restrict__ comp,
                                const int* __restrict__ ids,
                                const int* __restrict__ counts,
                                const float* __restrict__ attr,
                                const float* __restrict__ ed,
                                float* __restrict__ out_t,
                                int* __restrict__ out_pid,
                                float* __restrict__ out_rows,
                                bool* __restrict__ out_blocked, int n_tiles,
                                int r, int nc, int tc, int pid_base,
                                float t_min, float t_max, float eps,
                                float miss, int exit_check) {
  extern __shared__ float chunk[];  // [tc, 9]
  __shared__ float worst;           // early exit: the tile's worst best t
  __shared__ float warp_worst[32];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const long plane = (long)n_tiles * r;
  const long idx = (long)tile * r + lane;
  const int count = counts[tile];

  const float ox = payload[0 * plane + idx];
  const float oy = payload[1 * plane + idx];
  const float oz = payload[2 * plane + idx];
  const float dx = payload[3 * plane + idx];
  const float dy = payload[4 * plane + idx];
  const float dz = payload[5 * plane + idx];
  const float excl = payload[6 * plane + idx];
  const float cap = payload[7 * plane + idx];

  float best_t = miss;
  int best_id = 0;
  bool blocked = false;
  const int* list = ids + (long)tile * nc;
  const float* keys = EARLY_EXIT ? ed + (long)tile * nc : nullptr;
  if (EARLY_EXIT && lane == 0) worst = miss;
  for (int k = 0; k < count; ++k) {
    const int c = list[k];
    __syncthreads();  // everyone is done with the previous chunk
    // Uniform across the block (`worst` was published by the barrier);
    // `!(a <= b)` also stops at a NaN key, as the TPU kernel skips it.
    if (EARLY_EXIT && !(keys[k] <= worst)) break;
    for (int i = lane; i < tc * 9; i += blockDim.x)
      chunk[i] = comp[(long)c * tc * 9 + i];
    __syncthreads();
    if (!blocked) {
      const int pid0 = 1 + pid_base + c * tc;
      for (int s = 0; s < tc; ++s) {
        float w;
        if (!mt_test(chunk + s * 9, ox, oy, oz, dx, dy, dz, t_min, t_max,
                     eps, w))
          continue;
        if ((float)(pid0 + s) == excl) continue;
        if (MODE == MODE_ANYHIT) {
          if (w < cap) {
            blocked = true;
            break;
          }
        } else if (w < best_t ||
                   (EARLY_EXIT && w == best_t && pid0 + s < best_id)) {
          best_t = w;
          best_id = pid0 + s;
        }
      }
    }
    if (MODE == MODE_ANYHIT && __syncthreads_and(blocked)) break;
    if (EARLY_EXIT && k % exit_check == exit_check - 1) {
      float m = best_t;  // never NaN: a miss or an accepted w
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if ((lane & 31) == 0) warp_worst[lane >> 5] = m;
      __syncthreads();
      if (lane == 0) {
        float wmax = warp_worst[0];
        for (int i = 1; i < (int)(blockDim.x >> 5); ++i)
          wmax = fmaxf(wmax, warp_worst[i]);
        worst = wmax;  // published by the next iteration's barrier
      }
    }
  }

  if (MODE == MODE_ANYHIT) {
    out_blocked[idx] = blocked;
    return;
  }
  out_t[idx] = best_t;
  out_pid[idx] = best_id;
  if (MODE == MODE_ROWS) {
    const float* src = attr + (long)best_id * 32;
    for (int j = 0; j < 32; ++j) out_rows[j * plane + idx] = src[j];
  }
}

RT_EXPORT int rt_mt_trace(const float* payload, const float* comp,
                          const int* ids, const int* counts,
                          const float* attr, const float* ed, float* out_t,
                          int* out_pid, float* out_rows, bool* out_blocked,
                          int n_tiles, int r, int nc, int tc, int pid_base,
                          float t_min, float t_max, float eps, float miss,
                          int mode, int exit_check, cudaStream_t stream) {
  if (ed != nullptr && (mode == MODE_ANYHIT || exit_check < 1))
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const size_t smem = (size_t)tc * 9 * sizeof(float);
#define RT_LAUNCH(M, E)                                                   \
  mt_trace_kernel<M, E><<<n_tiles, r, smem, stream>>>(                    \
      payload, comp, ids, counts, attr, ed, out_t, out_pid, out_rows,     \
      out_blocked, n_tiles, r, nc, tc, pid_base, t_min, t_max, eps, miss, \
      exit_check)
    const bool ee = ed != nullptr;
    if (mode == MODE_CLOSEST && !ee)
      RT_LAUNCH(MODE_CLOSEST, false);
    else if (mode == MODE_CLOSEST)
      RT_LAUNCH(MODE_CLOSEST, true);
    else if (mode == MODE_ROWS && !ee)
      RT_LAUNCH(MODE_ROWS, false);
    else if (mode == MODE_ROWS)
      RT_LAUNCH(MODE_ROWS, true);
    else if (mode == MODE_ANYHIT)
      RT_LAUNCH(MODE_ANYHIT, false);
    else
      return (int)cudaErrorInvalidValue;
#undef RT_LAUNCH
  }
  return (int)cudaGetLastError();
}
