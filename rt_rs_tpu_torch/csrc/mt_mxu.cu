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
// [T, 8, r]; each tile's chunks are ids[t, 0:counts[t]].  Features 10-15
// of every ray are zero, so the kernel reads only rows 0-9 of a chunk
// (the rows build_mxu_table can make non-zero).
//
// Design: the balanced items of mt_items.cuh (a prologue launch and a
// persistent items launch, items of ITEM_MXU entries on the CUDA cores
// and ITEM_MXU_TC on the tensor cores, the per-ray (t, pid) key merged
// with atomicMin), replacing a per-tile walk that
// copied each chunk between two barriers and lasted as long as the
// longest list.  The JAX `precision` maps as XLA maps it on a GPU, one
// policy each:
//   highest (0), MxuCudaCores: f32 on the CUDA cores, one thread per ray,
//     C = the sum over features 0..9 in order, each product and sum
//     rounded (no contraction); equal to the torch twin bit for bit.  A
//     chunk is staged per triangle as 40 floats, (det, u) of features
//     0..9 then (v, wnum), read with 128-bit broadcast loads; det and u
//     come first, and a warp whose rays all fail the u bounds skips v,
//     wnum and the division (the verdict is the same bits).
//   high (1), MxuTensorCores<true>: three TF32 tensor-core products
//     (3xTF32: a = hi + lo, b = hi + lo, C = hi*lo + lo*hi + hi*hi);
//   default (2), MxuTensorCores<false>: one TF32 tensor-core product.
// The tensor-core variants use mma.sync (tf32 in, f32 out), a k8 step
// for features 0-7 and a k4 step for 8-11 (10 and 11 zero: the product
// is 12 deep, not 16), 4 warps per 128-ray tile, each warp 4 column
// groups of 8 rays, at least 4 (high) or 5 (default) blocks an SM.  The
// epilogue needs det, u, v and wnum of the same (triangle, ray) pair,
// which sit in four row blocks of C; a warp therefore multiplies the
// same 16 triangle rows of all four blocks against the same 8 rays, so
// the four accumulators of a thread hold the four quantities of the
// same pairs and the epilogue runs in registers.  Each thread keeps a
// running best per ray column it holds; at the end of an item a shuffle
// reduction over the 8 threads that share a column leaves each ray's
// best in one of them (the thread whose row group is its column pair),
// which folds it.  Their table is A's TF32 words (cvt.rna words of A,
// and of its low part for 3xTF32), made by a conversion launch at the
// start of each call (tf32_table_kernel; mxu_mt.tf32_table is its plain
// version) and staged with 16-byte cp.async, so a fragment is loaded
// ready and nothing is converted per entry; only the rays' B fragments
// are converted, once per item.  The sums inside an mma are the hardware's,
// so these two are held to `highest` by pid agreement and t error, not
// bit for bit.
//
// What bounds it: on the tensor cores the product is 2 * 12 * 4 tc * r
// operations per entry at 495 TFLOP/s (TF32), but the epilogue's ~20
// f32 operations per pair run on the CUDA cores at 67 TFLOP/s; with
// K = 12 the product is too thin to pay, and the epilogue bounds it.
// wgmma is not used: its TF32 operands must be K-major, the table is
// feature-major, and the 16-deep product is not what bounds the kernel.
// `highest` does 40 multiply-adds per pair on the CUDA cores, against
// kernel B's 39 operations: it cannot win, and is the reference.
#include "mt_items.cuh"

namespace {

constexpr int kFeat = 16;  // the table's rows
constexpr int kUsed = 10;  // the rows a ray's features can weight

// Entries per work item, highest and the tensor-core variants (mirrored by
// experiments/mxu_mt.py's MXU_ITEM_SIZES for the plain-PyTorch mirror;
// the tensor cores' items amortise the rays' B fragments over more
// entries).
enum { ITEM_MXU = 2, ITEM_MXU_TC = 8 };

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
  for (int i = kUsed; i < kFeat; ++i) f[i] = 0.0f;
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

// highest: one thread per ray on the CUDA cores.
struct MxuCudaCores {
  static constexpr int kItem = ITEM_MXU;
  static constexpr int kMinBlocks = 1;  // __launch_bounds__'s
  struct Ray {
    float f[kUsed], excl;
  };
  using Best = MtBest;

  // [tc, 40]: triangle s's (det, u) of features 0..9, then its (v, wnum).
  static __host__ __device__ int slot_floats(int tc) { return tc * 4 * kUsed; }

  static __device__ __forceinline__ void stage(float* dst, const float* table,
                                               int c, int tc) {
    const int m = 4 * tc;
    const float* src = table + (long)c * kFeat * m;
    for (int i = threadIdx.x; i < kUsed * m; i += blockDim.x) {
      const int f = i / m, col = i - f * m;
      const int q = col / tc, s = col - q * tc;  // quantity q of triangle s
      cp_async4(dst + s * 4 * kUsed + (q >> 1) * 2 * kUsed + 2 * f + (q & 1),
                src + i);
    }
    cp_async_commit();
  }

  template <int MODE>
  static __device__ __forceinline__ Ray load(const float* rays, int tile,
                                             int /*n_tiles*/, int r) {
    const float* ray = rays + (long)tile * 8 * r + threadIdx.x;
    float f[kFeat];
    ray_features(ray, r, f);
    Ray out;
#pragma unroll
    for (int i = 0; i < kUsed; ++i) out.f[i] = f[i];
    out.excl = ray[6 * r];
    return out;
  }

  static __device__ __forceinline__ void reset(Best& best, float miss) {
    best.t = miss;
    best.id = 0;
  }

  // A pair of sums over the features in order, from 20 staged floats
  // (x_f, y_f interleaved).
  static __device__ __forceinline__ void sums(const float4* p, const float* f,
                                              float& x, float& y) {
    float4 a = p[0];
    x = a.x * f[0];
    y = a.y * f[0];
    x = x + a.z * f[1];
    y = y + a.w * f[1];
#pragma unroll
    for (int k = 1; k < kUsed / 2; ++k) {
      a = p[k];
      x = x + a.x * f[2 * k];
      y = y + a.y * f[2 * k];
      x = x + a.z * f[2 * k + 1];
      y = y + a.w * f[2 * k + 1];
    }
  }

  template <int MODE, bool EXIT>
  static __device__ __forceinline__ void test(const float* chunk,
                                              const Ray& ray, int c, int tc,
                                              int /*pid_base*/, float t_min,
                                              float t_max, float eps,
                                              Best& best, bool& /*blocked*/,
                                              bool* /*out_blocked*/,
                                              long /*idx*/) {
    static_assert(MODE == MODE_CLOSEST && !EXIT, "closest hits only");
    const float4* tri = reinterpret_cast<const float4*>(chunk);
    const int pid0 = 1 + c * tc;
    float best_t = best.t;  // on locals, as ChunkRows::test
    int best_id = best.id;
    for (int s = 0; s < tc; ++s, tri += kUsed) {
      float det, u;
      sums(tri, ray.f, det, u);
      const float sgn = sign_of(det);
      const float adet = fabsf(det);
      const float su = u * sgn;
      if (!((adet > eps) && (su >= 0.0f) && (su <= adet))) continue;
      float v, wnum;
      sums(tri + kUsed / 2, ray.f, v, wnum);
      const float sv = v * sgn;
      if (!((sv >= 0.0f) && (su + sv <= adet))) continue;
      const float w = wnum / det;
      if (!((w > t_min) && (w < t_max))) continue;
      if ((float)(pid0 + s) == ray.excl) continue;
      if (w < best_t) {  // ascending pids within an item
        best_t = w;
        best_id = pid0 + s;
      }
    }
    best.t = best_t;
    best.id = best_id;
  }

  static __device__ __forceinline__ int own_ray() { return threadIdx.x; }

  static __device__ __forceinline__ void result(const Best& best, float& t,
                                                int& id) {
    t = best.t;
    id = best.id;
  }
};

// a TF32 value as an f32 bit pattern
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y & 0xFFFFE000u;
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

// The k4 step: A [16, 4] (rows gid, gid + 8 of column tig), B [4, 8]
// (row tig of column gid).
__device__ __forceinline__ void mma_tf32_k4(float* c, const uint32_t* a,
                                            uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// The tensor cores' table from the f32 table [Nc, 16, 4 tc] (`chunk`
// floats a chunk): its TF32 words (PARTS 1, default), or each chunk's hi
// words then its lo words (PARTS 2, high: [Nc, 2, 16, 4 tc]).
template <int PARTS>
__global__ void tf32_table_kernel(const float* __restrict__ table,
                                  uint32_t* __restrict__ words, long n,
                                  int chunk) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const long c = i / chunk;
    uint32_t* dst = words + c * PARTS * chunk + (i - c * chunk);
    if (PARTS == 1) {
      dst[0] = to_tf32(table[i]);
    } else {
      split_tf32(table[i], dst[0], dst[chunk]);
    }
  }
}

constexpr int kWarps = 4;
constexpr int kTcRays = 128;                  // rays per tile
constexpr int kCgw = kTcRays / (8 * kWarps);  // column groups per warp

// high (THREE = true) and default: mma.sync on TF32, 128-ray tiles.  The
// table is the TF32 words [Nc, 16, 4 tc] (default) or [Nc, 2, 16, 4 tc]
// (hi, lo).
template <bool THREE>
struct MxuTensorCores {
  static constexpr int kItem = ITEM_MXU_TC;
  // Resident blocks an SM must hold: at most 128 (102) registers a
  // thread, against 148 (108) unbounded.  A few bytes spill; on an H100
  // each variant ran faster with this bound than with none or with 5
  // and 6 blocks.
  static constexpr int kMinBlocks = THREE ? 4 : 5;
  static constexpr int kParts = THREE ? 2 : 1;

  // The product runs over features 0-11 (10 and 11 zero) as one k8 and
  // one k4 step.  B fragments of the ray this thread feeds: features tig,
  // tig + 4 (k8) and 8 + tig (k4).
  struct Frag {
    uint32_t k8[2], k4;
  };
  struct Ray {
    // per column group; the exclusions of the two ray columns this
    // thread accumulates
    Frag b_hi[kCgw], b_lo[kCgw];
    float excl[kCgw][2];
  };
  struct Best {
    float t[kCgw][2];
    int id[kCgw][2];
  };

  // Rows 0-9 of each part, padded to lda = 4 tc + 4 (the pad spreads
  // tig over banks).
  static __host__ __device__ int lda(int tc) { return 4 * tc + 4; }
  static __host__ __device__ int slot_floats(int tc) {
    return kParts * kUsed * lda(tc);
  }

  static __device__ __forceinline__ void stage(float* dst, const float* table,
                                               int c, int tc) {
    const int m = 4 * tc, m4 = m / 4, ld = lda(tc);
    const float* src = table + (long)c * kParts * kFeat * m;
    for (int i = threadIdx.x; i < kParts * kUsed * m4; i += blockDim.x) {
      const int row = i / m4, col = 4 * (i - row * m4);
      const int part = row / kUsed;  // hi, then lo
      cp_async16(dst + row * ld + col,
                 src + (part * kFeat + row - part * kUsed) * m + col);
    }
    cp_async_commit();
  }

  template <int MODE>
  static __device__ __forceinline__ Ray load(const float* rays, int tile,
                                             int /*n_tiles*/, int /*r*/) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const float* tray = rays + (long)tile * 8 * kTcRays;
    Ray ray;
#pragma unroll
    for (int g = 0; g < kCgw; ++g) {
      const int col0 = (warp * kCgw + g) * 8;
      float f[kFeat];
      ray_features(tray + col0 + gid, kTcRays, f);
#pragma unroll
      for (int h = 0; h < 3; ++h) {  // features h * 4 + tig
        float x = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i == tig) x = f[h * 4 + i];
        uint32_t& hi = h < 2 ? ray.b_hi[g].k8[h] : ray.b_hi[g].k4;
        uint32_t& lo = h < 2 ? ray.b_lo[g].k8[h] : ray.b_lo[g].k4;
        if (THREE)
          split_tf32(x, hi, lo);
        else
          hi = to_tf32(x);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ray.excl[g][e] = tray[6 * kTcRays + col0 + 2 * tig + e];
    }
    return ray;
  }

  static __device__ __forceinline__ void reset(Best& best, float miss) {
#pragma unroll
    for (int g = 0; g < kCgw; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        best.t[g][e] = miss;
        best.id[g][e] = 0;
      }
    }
  }

  template <int MODE, bool EXIT>
  static __device__ __forceinline__ void test(const float* chunk,
                                              const Ray& ray, int c, int tc,
                                              int /*pid_base*/, float t_min,
                                              float t_max, float eps,
                                              Best& best, bool& /*blocked*/,
                                              bool* /*out_blocked*/,
                                              long /*idx*/) {
    static_assert(MODE == MODE_CLOSEST && !EXIT, "closest hits only");
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int ld = lda(tc);
    const uint32_t* a_hi_s = reinterpret_cast<const uint32_t*>(chunk);
    const uint32_t* a_lo_s = a_hi_s + kUsed * ld;
    for (int rg = 0; rg < tc / 16; ++rg) {
      // A fragments: rows (triangles) rg * 16 + gid (+ 8) of quantity
      // block q; k8: columns (features) tig (+ 4), i = 0-3; k4: column
      // 8 + tig, i = 4-5 (features 10 and 11 are zero).
      uint32_t a_hi[4][6], a_lo[4][6];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const int row = q * tc + rg * 16 + gid + ((i & 1) ? 8 : 0);
          const int feat = i < 4 ? tig + ((i & 2) ? 4 : 0) : 8 + tig;
          const bool used = feat < kUsed;
          a_hi[q][i] = used ? a_hi_s[feat * ld + row] : 0u;
          if (THREE) a_lo[q][i] = used ? a_lo_s[feat * ld + row] : 0u;
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
            mma_tf32(acc[q], a_hi[q], ray.b_lo[g].k8);
            mma_tf32_k4(acc[q], a_hi[q] + 4, ray.b_lo[g].k4);
            mma_tf32(acc[q], a_lo[q], ray.b_hi[g].k8);
            mma_tf32_k4(acc[q], a_lo[q] + 4, ray.b_hi[g].k4);
          }
          mma_tf32(acc[q], a_hi[q], ray.b_hi[g].k8);
          mma_tf32_k4(acc[q], a_hi[q] + 4, ray.b_hi[g].k4);
        }
        // acc[q][i]: row gid (+ 8 for i >= 2), column 2 tig + (i & 1).
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = rg * 16 + gid + ((i & 2) ? 8 : 0);
          const int e = i & 1;
          epilogue(acc[0][i], acc[1][i], acc[2][i], acc[3][i], 1 + c * tc + s,
                   ray.excl[g][e], t_min, t_max, eps, best.t[g][e],
                   best.id[g][e]);
        }
      }
    }
  }

  // The thread of row group gid = 2 g + e owns column 2 tig + e of
  // column group g.
  static __device__ __forceinline__ int own_ray() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
    return (warp * kCgw + (gid >> 1)) * 8 + 2 * tig + (gid & 1);
  }

  // The 8 threads of a column (lanes tig, tig + 4, ..., tig + 28) reduce
  // its best; each keeps the column it owns.
  static __device__ __forceinline__ void result(const Best& best, float& t,
                                                int& id) {
    const int gid = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int g = 0; g < kCgw; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float bt = best.t[g][e];
        int bid = best.id[g][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float t2 = __shfl_xor_sync(0xffffffffu, bt, off);
          const int id2 = __shfl_xor_sync(0xffffffffu, bid, off);
          if (t2 < bt || (t2 == bt && id2 < bid)) {
            bt = t2;
            bid = id2;
          }
        }
        if (2 * g + e == gid) {
          t = bt;
          id = bid;
        }
      }
    }
  }
};

template <class P>
__global__ void __launch_bounds__(kPrologueThreads) mt_mxu_prologue_kernel(
    const int* __restrict__ counts, float* __restrict__ out_t,
    int* __restrict__ out_pid, unsigned long long* __restrict__ keys,
    int* __restrict__ work, int n_tiles, int r, float miss) {
  items_prologue<MODE_CLOSEST, P::kItem, false>(
      counts, nullptr, out_t, out_pid, nullptr, nullptr, keys, work, n_tiles,
      r, miss);
}

template <class P, int THREADS>
__global__ void __launch_bounds__(THREADS, P::kMinBlocks) mt_mxu_items_kernel(
    const float* __restrict__ rays, const float* __restrict__ table,
    const int* __restrict__ ids, const int* __restrict__ counts,
    float* __restrict__ out_t, int* __restrict__ out_pid,
    unsigned long long* __restrict__ keys, int* __restrict__ work,
    int n_tiles, int r, int nc, int tc, float t_min, float t_max, float eps,
    float miss) {
  items_body<P, MODE_CLOSEST, P::kItem, false>(
      rays, table, ids, counts, nullptr, nullptr, nullptr, out_t, out_pid,
      nullptr, nullptr, keys, work, n_tiles, r, nc, tc, 0, t_min, t_max, eps,
      miss, 1);
}

template <class P, int THREADS>
int launch(const float* rays, const float* table, const int* ids,
           const int* counts, float* out_t, int* out_pid,
           unsigned long long* keys, int* work, int n_tiles, int r, int nc,
           int tc, float t_min, float t_max, float eps, float miss,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)P::slot_floats(tc) * sizeof(float);
  const Residency res =
      persistent_blocks(mt_mxu_items_kernel<P, THREADS>, r, smem);
  if (res.blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  mt_mxu_prologue_kernel<P><<<prologue_blocks((long)n_tiles * r, res.sms),
                              kPrologueThreads, 0, stream>>>(
      counts, out_t, out_pid, keys, work, n_tiles, r, miss);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long most = (long)n_tiles * ((nc + P::kItem - 1) / P::kItem);
  mt_mxu_items_kernel<P, THREADS>
      <<<items_grid(most, res.blocks), r, smem, stream>>>(
          rays, table, ids, counts, out_t, out_pid, keys, work, n_tiles, r, nc,
          tc, t_min, t_max, eps, miss);
  return (int)cudaGetLastError();
}

}  // namespace

// `table`: the f32 table [Nc, 16, 4 tc].  Scratch the wrapper allocates:
// `words` (high and default; 16-byte aligned) the tensor cores' table,
// [Nc, 2, 16, 4 tc] (high) or [Nc, 16, 4 tc] (default) f32 words; `keys`
// [T * r] u64, `work` [4 T + 4] int32.  high and default make `words`
// first (a third launch).
RT_EXPORT int rt_mt_mxu(const float* rays, const float* table, float* words,
                        const int* ids, const int* counts, float* out_t,
                        int* out_pid, unsigned long long* keys, int* work,
                        int n_tiles, int r, int nc, int tc, float t_min,
                        float t_max, float eps, float miss, int precision,
                        cudaStream_t stream) {
  if (precision < 0 || precision > 2) return (int)cudaErrorInvalidValue;
  if (precision > 0 &&
      (r != kTcRays || tc % 16 != 0 || (uintptr_t)words % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0) return (int)cudaGetLastError();
  if (precision > 0) {
    const int chunk = kFeat * 4 * tc;
    const long n = (long)nc * chunk;
    const long want = (n + 255) / 256;
    const int blocks = (int)(want < 65536 ? want : 65536);
    uint32_t* w = reinterpret_cast<uint32_t*>(words);
    if (precision == 1)
      tf32_table_kernel<2><<<blocks, 256, 0, stream>>>(table, w, n, chunk);
    else
      tf32_table_kernel<1><<<blocks, 256, 0, stream>>>(table, w, n, chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
#define RT_LAUNCH(P, THREADS, A)                                           \
  launch<P, THREADS>(rays, A, ids, counts, out_t, out_pid, keys, work,     \
                     n_tiles, r, nc, tc, t_min, t_max, eps, miss, stream)
  if (precision == 0) return RT_LAUNCH(MxuCudaCores, 1024, table);
  if (precision == 1)
    return RT_LAUNCH(MxuTensorCores<true>, kWarps * 32, words);
  return RT_LAUNCH(MxuTensorCores<false>, kWarps * 32, words);
#undef RT_LAUNCH
}
