// Kernel I: Möller–Trumbore as one matrix product per (tile, chunk).
//
// Replaces experiments/mxu_mt.py::_mxu_kernel (TPU kernel 8).  det, u, v
// and wnum (w = wnum / det) are bilinear in a ray's features and a
// triangle's coefficients:
//   B [16, r]:     rows 0-2 d, 3-5 o, 6-8 o x d, 9 one, 10-15 zero;
//   A [16, 4 tc]:  the table's chunk (build_mxu_table), quantity-major
//                  columns [det | u | v | wnum];
//   C [4 tc, r] = A^T B.
// The product is computed here, in the kernel's own body; then the
// epilogue of mxu_mt.py:92-107: the sign fold, the barycentric bounds,
// w = wnum / det, the (t_min, t_max) window, pid != excl (triangle s of
// chunk c is prim 1 + c * tc + s), and the closest hit: min w, ties to
// the smallest pid; misses (t_max + 1, 0).  Rays are tile-major
// [T, 8, r]; each tile walks ids[t, 0:counts[t]].
//
// The JAX `precision` maps as XLA maps it on a GPU:
//   highest (0): f32 on the CUDA cores, C = sum over f = 0..15 in order,
//     each product and sum rounded (no contraction); equal to the torch
//     twin bit for bit.  One thread per ray, r threads.
//   high (1): three TF32 tensor-core products (3xTF32: a = hi + lo,
//     b = hi + lo, C = hi*lo + lo*hi + hi*hi);
//   default (2): one TF32 tensor-core product.
// The tensor-core variants use mma.sync.m16n8k8 (tf32 in, f32 out), 4
// warps per 128-ray tile, each warp 4 column groups of 8 rays.  The
// epilogue needs det, u, v and wnum of the same (triangle, ray) pair,
// which sit in four row blocks of C; a warp therefore multiplies the
// same 16 triangle rows of all four blocks against the same 8 rays, so
// the four accumulators of a thread hold the four quantities of the
// same pairs and the epilogue runs in registers.  Each thread keeps a
// running best per ray column it holds; a shuffle reduction over the 8
// threads that share a column ends the tile.  TF32 inputs are rounded
// with cvt.rna; the sums inside an mma are the hardware's, so these two
// are held to `highest` by pid agreement and t error, not bit for bit.
//
// What bounds it: on the tensor cores the product is 2 * 16 * 4 tc * r
// operations per entry at 495 TFLOP/s (TF32), but the epilogue's ~20
// f32 operations per pair run on the CUDA cores at 67 TFLOP/s; with
// K = 16 the product is too thin to pay, and the epilogue bounds it.
// `highest` does 64 multiply-adds per pair on the CUDA cores, against
// kernel B's 39 operations: it cannot win, and is the reference.
#include "common.cuh"

constexpr int kFeat = 16;

__device__ __forceinline__ float sign_of(float x) {
  return (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
}

// The ray's 16 features in mxu_mt.py:69-76's op order.
__device__ __forceinline__ void ray_features(const float* ray, int r,
                                             float* f) {
  const float ox = ray[0 * r], oy = ray[1 * r], oz = ray[2 * r];
  const float dx = ray[3 * r], dy = ray[4 * r], dz = ray[5 * r];
  f[0] = dx;
  f[1] = dy;
  f[2] = dz;
  f[3] = ox;
  f[4] = oy;
  f[5] = oz;
  f[6] = oy * dz - oz * dy;
  f[7] = oz * dx - ox * dz;
  f[8] = ox * dy - oy * dx;
  f[9] = 1.0f;
#pragma unroll
  for (int i = 10; i < kFeat; ++i) f[i] = 0.0f;
}

// The epilogue for one (triangle, ray) pair and the (t, pid) update.
__device__ __forceinline__ void epilogue(float det, float u, float v,
                                         float wnum, int pid, float excl,
                                         float t_min, float t_max, float eps,
                                         float& best_t, int& best_id) {
  const float sgn = sign_of(det);
  const float adet = fabsf(det);
  const float su = u * sgn;
  const float sv = v * sgn;
  if (!((adet > eps) && (su >= 0.0f) && (su <= adet) && (sv >= 0.0f) &&
        (su + sv <= adet)))
    return;
  const float w = wnum / det;
  if (!((w > t_min) && (w < t_max))) return;
  if ((float)pid == excl) return;
  if (w < best_t || (w == best_t && pid < best_id)) {
    best_t = w;
    best_id = pid;
  }
}

// Stage table[c] ([16, 4 tc]) into shared memory with row stride lda.
__device__ __forceinline__ void stage(float* a_s, const float* table, int c,
                                      int m, int lda) {
  const float* src = table + (long)c * kFeat * m;
  for (int i = threadIdx.x; i < kFeat * m; i += blockDim.x)
    a_s[(i / m) * lda + i % m] = src[i];
}

// highest: one thread per ray on the CUDA cores.
__global__ void mt_mxu_f32_kernel(const float* __restrict__ rays,
                                  const float* __restrict__ table,
                                  const int* __restrict__ ids,
                                  const int* __restrict__ counts,
                                  float* __restrict__ out_t,
                                  int* __restrict__ out_pid, int nc, int tc,
                                  float t_min, float t_max, float eps,
                                  float miss) {
  extern __shared__ float a_s[];  // [16, lda]
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int r = blockDim.x;
  const int m = 4 * tc, lda = m + 4;
  const float* ray = rays + (long)tile * 8 * r + lane;
  float f[kFeat];
  ray_features(ray, r, f);
  const float excl = ray[6 * r];
  const int count = counts[tile];
  const int* list = ids + (long)tile * nc;
  float best_t = miss;
  int best_id = 0;
  for (int k = 0; k < count; ++k) {
    const int c = list[k];
    __syncthreads();
    stage(a_s, table, c, m, lda);
    __syncthreads();
    for (int s = 0; s < tc; ++s) {
      float q[4];
#pragma unroll
      for (int qi = 0; qi < 4; ++qi) {
        const float* col = a_s + qi * tc + s;
        float acc = col[0] * f[0];
#pragma unroll
        for (int i = 1; i < kFeat; ++i) acc = acc + col[i * lda] * f[i];
        q[qi] = acc;
      }
      epilogue(q[0], q[1], q[2], q[3], 1 + c * tc + s, excl, t_min, t_max,
               eps, best_t, best_id);
    }
  }
  out_t[(long)tile * r + lane] = best_t;
  out_pid[(long)tile * r + lane] = best_id;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y & 0xFFFFE000u;  // a TF32 value as an f32 bit pattern
}

// x = hi + lo, both TF32 (3xTF32's split).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kWarps = 4;
constexpr int kTcRays = 128;                  // rays per tile
constexpr int kCgw = kTcRays / (8 * kWarps);  // column groups per warp

// high (THREE = true) and default: mma.sync on TF32, 128-ray tiles.
template <bool THREE>
__global__ void __launch_bounds__(kWarps * 32)
    mt_mxu_tc_kernel(const float* __restrict__ rays,
                     const float* __restrict__ table,
                     const int* __restrict__ ids,
                     const int* __restrict__ counts, float* __restrict__ out_t,
                     int* __restrict__ out_pid, int nc, int tc, float t_min,
                     float t_max, float eps, float miss) {
  extern __shared__ float a_s[];  // [16, lda]
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m = 4 * tc, lda = m + 4;  // the pad spreads tig over banks
  const float* tray = rays + (long)tile * 8 * kTcRays;

  // B fragments (k rows tig, tig + 4 of each 8-feature step) of the ray
  // this thread feeds, per column group; the exclusions of the two ray
  // columns it accumulates.
  uint32_t b_hi[kCgw][2][2], b_lo[kCgw][2][2];
  float excl[kCgw][2], best_t[kCgw][2];
  int best_id[kCgw][2];
#pragma unroll
  for (int g = 0; g < kCgw; ++g) {
    const int col0 = (warp * kCgw + g) * 8;
    float f[kFeat];
    ray_features(tray + col0 + gid, kTcRays, f);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i == tig) x = f[ks * 8 + h * 4 + i];
        if (THREE)
          split_tf32(x, b_hi[g][ks][h], b_lo[g][ks][h]);
        else
          b_hi[g][ks][h] = to_tf32(x);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      excl[g][e] = tray[6 * kTcRays + col0 + 2 * tig + e];
      best_t[g][e] = miss;
      best_id[g][e] = 0;
    }
  }

  const int count = counts[tile];
  const int* list = ids + (long)tile * nc;
  for (int k = 0; k < count; ++k) {
    const int c = list[k];
    __syncthreads();
    stage(a_s, table, c, m, lda);
    __syncthreads();
    for (int rg = 0; rg < tc / 16; ++rg) {
      // A fragments: rows (triangles) rg * 16 + gid (+ 8) of quantity
      // block q, columns (features) ks * 8 + tig (+ 4).
      uint32_t a_hi[4][2][4], a_lo[4][2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = q * tc + rg * 16 + gid + ((i & 1) ? 8 : 0);
            const int feat = ks * 8 + tig + ((i & 2) ? 4 : 0);
            const float x = a_s[feat * lda + row];
            if (THREE)
              split_tf32(x, a_hi[q][ks][i], a_lo[q][ks][i]);
            else
              a_hi[q][ks][i] = to_tf32(x);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kCgw; ++g) {
        float acc[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[q][i] = 0.0f;
          if (THREE) {
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) mma_tf32(acc[q], a_hi[q][ks], b_lo[g][ks]);
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) mma_tf32(acc[q], a_lo[q][ks], b_hi[g][ks]);
          }
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) mma_tf32(acc[q], a_hi[q][ks], b_hi[g][ks]);
        }
        // acc[q][i]: row gid (+ 8 for i >= 2), column 2 tig + (i & 1).
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = rg * 16 + gid + ((i & 2) ? 8 : 0);
          const int e = i & 1;
          epilogue(acc[0][i], acc[1][i], acc[2][i], acc[3][i], 1 + c * tc + s,
                   excl[g][e], t_min, t_max, eps, best_t[g][e], best_id[g][e]);
        }
      }
    }
  }

  // The 8 threads of a column (lanes tig, tig + 4, ..., tig + 28).
#pragma unroll
  for (int g = 0; g < kCgw; ++g) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float t = best_t[g][e];
      int id = best_id[g][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float t2 = __shfl_xor_sync(0xffffffffu, t, off);
        const int id2 = __shfl_xor_sync(0xffffffffu, id, off);
        if (t2 < t || (t2 == t && id2 < id)) {
          t = t2;
          id = id2;
        }
      }
      if (gid == 0) {
        const long o = (long)tile * kTcRays + (warp * kCgw + g) * 8 + 2 * tig + e;
        out_t[o] = t;
        out_pid[o] = id;
      }
    }
  }
}

RT_EXPORT int rt_mt_mxu(const float* rays, const float* table, const int* ids,
                        const int* counts, float* out_t, int* out_pid,
                        int n_tiles, int r, int nc, int tc, float t_min,
                        float t_max, float eps, float miss, int precision,
                        cudaStream_t stream) {
  if (precision < 0 || precision > 2) return (int)cudaErrorInvalidValue;
  if (precision > 0 && (r != kTcRays || tc % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const size_t smem = (size_t)kFeat * (4 * tc + 4) * sizeof(float);
    if (precision == 0)
      mt_mxu_f32_kernel<<<n_tiles, r, smem, stream>>>(
          rays, table, ids, counts, out_t, out_pid, nc, tc, t_min, t_max, eps,
          miss);
    else if (precision == 1)
      mt_mxu_tc_kernel<true><<<n_tiles, kWarps * 32, smem, stream>>>(
          rays, table, ids, counts, out_t, out_pid, nc, tc, t_min, t_max, eps,
          miss);
    else
      mt_mxu_tc_kernel<false><<<n_tiles, kWarps * 32, smem, stream>>>(
          rays, table, ids, counts, out_t, out_pid, nc, tc, t_min, t_max, eps,
          miss);
  }
  return (int)cudaGetLastError();
}
