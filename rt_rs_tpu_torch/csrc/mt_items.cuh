// The balanced-items Möller–Trumbore schedule shared by kernel B
// (mt_trace.cu: closest, rows, any-hit and early exit), kernel E
// (mt_stream.cu: the streamed block lists, expanded to chunk lists) and
// the probes' kernels H (mt_tpose.cu: the transposed table) and I
// (mt_mxu.cu: the coefficient table, on the CUDA or the tensor cores).
//
// The schedule (items_prologue, items_body) is what they share; what
// differs is a template policy P, which says how chunk c is staged into a
// ring slot (P::slot_floats, P::stage), where a tile's rays are read
// (P::load: [8, T, r] or [T, 8, r]), how a staged chunk is tested
// (P::test) and which ray a thread owns at the end of an item
// (P::result, P::own_ray: the test may leave a ray's best spread over
// several threads, and result() gathers it into its owner, which folds
// it).  ChunkRows below is kernels B and E's policy ([Nc, tc, 9] chunks,
// [8, T, r] rays, one thread per ray); early exit and any-hit are its
// modes only.
//
// The TPU kernels walk, per ray tile, a list of chunks of tc triangles.
// On this card a grid of one block per tile lasts as long as its longest
// list, and the lists are very uneven, so every list is cut into work
// items (a tile and at most E consecutive entries of its list) run on a
// persistent grid and merged per ray exactly:
//
// * A prologue launch scans the tiles' item counts into per-tile item
//   offsets (one block), resets the item counters and writes the misses
//   of empty tiles (any-hit: zeroes every flag).  The item count never
//   reaches the host.
// * The items launch is a persistent grid (SMs x resident blocks, from
//   the occupancy calculator, cached per key); each block takes items
//   from a global atomic counter and finds an item's tile with a 32-way
//   warp search over the offsets.
// * Closest and rows: an item's best is the (t, pid)-lexicographic
//   minimum over its entries.  A tile with one item writes that best
//   directly; otherwise the item folds it into a per-ray 64-bit key
//   (ordered_bits(t) << 32 | pid) with atomicMin, and the block that
//   finishes the tile's last item (a per-tile atomicAdd after a
//   __threadfence) decodes the keys and writes t, pid and, in rows mode,
//   the winner's 32-float row.  The lexicographic minimum is
//   order-independent, so the result does not depend on the order the
//   items run in.  Zero is canonical in the key (-0.0 comes back +0.0;
//   only t_min < 0, which no configuration uses, could give a -0.0 hit).
// * Any-hit: an item skips rays another item has blocked already; a
//   blocking hit stores `true` (idempotent), and a block-wide vote ends
//   the item once all its rays are blocked.
// * Early exit (EXIT): the lists are front to back, ed[t, k] a lower
//   bound on entry k's hit distances for every valid ray of the tile,
//   ascending along k.  Each listed tile's first item is its lead; the
//   counter hands out every lead before any later item.  A lead runs
//   the TPU kernel's per-tile rule: the tile's `worst` (the largest best
//   t over all r lanes, invalid and padding lanes included) is refreshed
//   after every exit_check-th entry (global k), and the item stops at
//   the first entry with !(ed[t, k] <= worst) (a NaN key stops too).  A
//   tile whose list fits its lead writes the result directly: the TPU
//   rule's result on every lane.  Otherwise the lead stores its per-lane
//   best t (`lead_t`), its key and the tile's worst over it
//   (`lead_worst`), then raises the tile's flag.  A later item waits for
//   that flag (one thread spins; leads never wait, and every lead was
//   handed out before any later item, to a running block, so the wait
//   ends), skips itself whole if its first key is beyond `lead_worst`,
//   and otherwise runs the same rule from `lead_worst`, refreshing to the
//   largest over lanes of min(own best, lead_t).  Each item reads only
//   its lead's snapshot, never another item's keys, so what it tests
//   does not depend on timing: the result is deterministic on every
//   lane.  On valid lanes it is exact: a skipped entry k has
//   ed[t, k] > worst >= the lane's final best, so none of its hits (all
//   at t >= ed[t, k]) can win.  Inside an item the entries are not in
//   pid order, so the update is lexicographic.
// * Staging: a double-buffered ring of chunks in shared memory, filled
//   with cp.async (each thread always copies the same positions of a
//   slot).  The next chunk, or the first chunk of the block's next item
//   (taken one item ahead), is in flight while the current one is
//   tested.  A ring over 32 KiB opts in to Hopper's larger shared memory.
// * ChunkRows stages each triangle padded to 12 floats (three 128-bit
//   loads) and checks u before it computes q and v (mt_test_u_first): a
//   warp whose 32 rays all miss a triangle's u slab skips the rest.
//
// What bounds ChunkRows on this card: f32 arithmetic, ~40 operations per
// (ray, triangle) pair with the triangle read from shared memory as a
// broadcast; one thread owns one ray.
#pragma once

#include "common.cuh"

namespace {

enum { MODE_CLOSEST = 0, MODE_ROWS = 1, MODE_ANYHIT = 2 };
constexpr int kPrologueThreads = 1024;

// The order-preserving map of a float to 32 bits (flip every bit of a
// negative, set the sign bit of a positive), with -0.0 taken as +0.0:
// unsigned order of the result is the float order of the input.
__device__ __forceinline__ unsigned ordered_bits(float t) {
  const unsigned u = (t == 0.0f) ? 0u : __float_as_uint(t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ordered_float(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The merge key of a hit: (t, pid)-lexicographic order as one unsigned
// 64-bit order (pids are non-negative and below 2^24).
__device__ __forceinline__ unsigned long long hit_key(float t, int pid) {
  return ((unsigned long long)ordered_bits(t) << 32) | (unsigned)pid;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// 16 bytes, both addresses 16-byte aligned (bypassing L1).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Start the copy of one chunk ([tc, 9] floats) into shared memory as
// [tc, 12]: each triangle padded to three 16-byte words, so the tests
// read it with three 128-bit loads instead of nine 32-bit ones.  Each
// thread always copies the same positions, so a thread that waits for
// its own copies may refill them without a barrier.
__device__ __forceinline__ void stage_padded(float* dst, const float* src,
                                             int tc) {
  for (int i = threadIdx.x; i < tc * 9; i += blockDim.x)
    cp_async4(dst + i + 3 * (i / 9), src + i);  // float k of triangle s -> 12 s + k
  cp_async_commit();
}

// mt_test (common.cuh) on a triangle staged as 12 floats (a, e1, e2 and
// 3 of padding), with the u test first: a warp whose rays all fail it
// skips q, v and the division.  Every value is mt_test's expression, so
// the verdict and w are the same bits.
__device__ __forceinline__ bool mt_test_u_first(const float4* tri, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz,
                                                float t_min, float t_max,
                                                float eps, float& w) {
  const float4 A = tri[0], B = tri[1], C = tri[2];
  const float ax = A.x, ay = A.y, az = A.z;
  const float e1x = A.w, e1y = B.x, e1z = B.y;
  const float e2x = B.z, e2y = B.w, e2z = C.x;
  // p = cross(d, e2)
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  // tvec = o - a
  const float tx = ox - ax;
  const float ty = oy - ay;
  const float tz = oz - az;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float u = tx * px + ty * py + tz * pz;
  const float sgn = (det > 0.0f) ? 1.0f : ((det < 0.0f) ? -1.0f : 0.0f);
  const float adet = fabsf(det);
  const float su = u * sgn;
  if (!((adet > eps) && (su >= 0.0f) && (su <= adet))) return false;
  // q = cross(tvec, e1)
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = dx * qx + dy * qy + dz * qz;
  const float sv = v * sgn;
  if (!((sv >= 0.0f) && (su + sv <= adet))) return false;
  w = (e2x * qx + e2y * qy + e2z * qz) / det;
  return (w > t_min) && (w < t_max);
}

// A ray's inputs to mt_test and its running best.
struct MtRay {
  float ox, oy, oz, dx, dy, dz, excl, cap;
};
struct MtBest {
  float t;
  int id;
};

// Kernels B and E's policy: chunks [Nc, tc, 9] staged as [tc, 12], rays
// the component-major payload [8, T, r] (ox, oy, oz, dx, dy, dz, excl,
// cap), one thread per ray (blockDim.x == r).
struct ChunkRows {
  using Ray = MtRay;
  using Best = MtBest;

  static __host__ __device__ int slot_floats(int tc) { return tc * 12; }

  static __device__ __forceinline__ void stage(float* dst, const float* table,
                                               int c, int tc) {
    stage_padded(dst, table + (long)c * tc * 9, tc);
  }

  template <int MODE>
  static __device__ __forceinline__ Ray load(const float* payload, int tile,
                                             int n_tiles, int r) {
    const long plane = (long)n_tiles * r;
    const long idx = (long)tile * r + threadIdx.x;
    Ray ray;
    ray.ox = payload[0 * plane + idx];
    ray.oy = payload[1 * plane + idx];
    ray.oz = payload[2 * plane + idx];
    ray.dx = payload[3 * plane + idx];
    ray.dy = payload[4 * plane + idx];
    ray.dz = payload[5 * plane + idx];
    ray.excl = payload[6 * plane + idx];
    ray.cap = MODE == MODE_ANYHIT ? payload[7 * plane + idx] : 0.0f;
    return ray;
  }

  static __device__ __forceinline__ void reset(Best& best, float miss) {
    best.t = miss;
    best.id = 0;
  }

  // Every triangle of the staged chunk c against the thread's ray.
  // Any-hit: a blocking hit stores `true` at out_blocked[idx] and stops.
  template <int MODE, bool EXIT>
  static __device__ __forceinline__ void test(const float* chunk,
                                              const Ray& ray, int c, int tc,
                                              int pid_base, float t_min,
                                              float t_max, float eps,
                                              Best& best, bool& blocked,
                                              bool* out_blocked, long idx) {
    // The loop runs on locals: with the running best kept in the struct,
    // nvcc predicated the rare update into every iteration (kernels B and
    // E measured 9-15% slower on an H100).
    const float4* tri = reinterpret_cast<const float4*>(chunk);
    const int pid0 = 1 + pid_base + c * tc;
    const float ox = ray.ox, oy = ray.oy, oz = ray.oz;
    const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
    const float excl = ray.excl;
    float best_t = best.t;
    int best_id = best.id;
    for (int s = 0; s < tc; ++s) {
      float w;
      if (!mt_test_u_first(tri + s * 3, ox, oy, oz, dx, dy, dz, t_min, t_max,
                           eps, w))
        continue;
      if ((float)(pid0 + s) == excl) continue;
      if (MODE == MODE_ANYHIT) {
        if (w < ray.cap) {
          blocked = true;
          out_blocked[idx] = true;
          break;
        }
      } else if (EXIT) {
        // Not in pid order: (t, pid)-lexicographic.
        if (w < best_t || (w == best_t && pid0 + s < best_id)) {
          best_t = w;
          best_id = pid0 + s;
        }
      } else if (w < best_t) {
        best_t = w;
        best_id = pid0 + s;
      }
    }
    best.t = best_t;
    best.id = best_id;
  }

  // The ray (lane of the tile) whose item best this thread folds.
  static __device__ __forceinline__ int own_ray() { return threadIdx.x; }

  static __device__ __forceinline__ void result(const Best& best, float& t,
                                                int& id) {
    t = best.t;
    id = best.id;
  }
};

// The workspace `work` (int32, 4 T + 4 of them): [0] the item counter,
// [1] unused, offsets[0 .. T] (offsets[t] = the first item of tile t,
// offsets[T] = the item count; early exit: the leads, one per listed
// tile), rest[0 .. T] (early exit: the same for the items after the
// leads, numbered from 0), done[T] (items of each tile finished so far;
// early exit: of the later items), then lead_done[T] (early exit: the
// tile's lead has stored its snapshot).
__device__ __forceinline__ int* item_offsets(int* work) { return work + 2; }
__device__ __forceinline__ int* rest_offsets(int* work, int n_tiles) {
  return work + 3 + n_tiles;
}
__device__ __forceinline__ int* tile_done(int* work, int n_tiles) {
  return work + 4 + 2 * n_tiles;
}
__device__ __forceinline__ int* lead_done(int* work, int n_tiles) {
  return work + 4 + 3 * n_tiles;
}

// The prologue's body.  Scans, per tile, the items of the launch(es)
// that follow: ceil(counts / E) for the default modes; for early exit a
// lead per listed tile and ceil(counts / E) - 1 further items, scanned
// together as one 64-bit value (leads in the low half).
template <int MODE, int E, bool EXIT>
__device__ __forceinline__ void items_prologue(
    const int* __restrict__ counts, const float* __restrict__ attr,
    float* __restrict__ out_t, int* __restrict__ out_pid,
    float* __restrict__ out_rows, bool* __restrict__ out_blocked,
    unsigned long long* __restrict__ keys, int* __restrict__ work,
    int n_tiles, int r, float miss) {
  if (blockIdx.x == 0) {
    // Exclusive scan, kPrologueThreads tiles a round: a warp scan, a
    // scan of the warp totals, a running carry.
    __shared__ unsigned long long warp_sum[32];
    __shared__ unsigned long long carry;
    int* offsets = item_offsets(work);
    int* rest = rest_offsets(work, n_tiles);
    int* done = tile_done(work, n_tiles);
    int* led = lead_done(work, n_tiles);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) carry = 0;
    for (int base = 0; base < n_tiles; base += blockDim.x) {
      const int t = base + threadIdx.x;
      const int c = (t < n_tiles) ? counts[t] : 0;
      const unsigned long long items = (unsigned long long)((c + E - 1) / E);
      const unsigned long long v =
          EXIT ? (c > 0 ? 1ull | ((items - 1) << 32) : 0ull) : items;
      unsigned long long x = v;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      __syncthreads();  // carry is published, warp_sum is free
      if (lane == 31) warp_sum[warp] = x;
      __syncthreads();
      if (warp == 0) {
        unsigned long long s =
            (lane < (int)(blockDim.x >> 5)) ? warp_sum[lane] : 0ull;
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned long long y = __shfl_up_sync(0xffffffffu, s, off);
          if (lane >= off) s += y;
        }
        warp_sum[lane] = s;
      }
      __syncthreads();
      const unsigned long long before =
          carry + (warp > 0 ? warp_sum[warp - 1] : 0ull) + x - v;
      if (t < n_tiles) {
        offsets[t] = (int)(before & 0xffffffffu);
        rest[t] = (int)(before >> 32);
        done[t] = 0;
        led[t] = 0;
      }
      __syncthreads();  // everyone has read carry
      if (threadIdx.x == blockDim.x - 1) carry = before + v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      offsets[n_tiles] = (int)(carry & 0xffffffffu);
      rest[n_tiles] = (int)(carry >> 32);
      work[0] = 0;
      work[1] = 0;
    }
  }
  // Every block: the per-ray state.  (Early exit: a lead writes the keys
  // of the tiles it does not finish.)
  const long plane = (long)n_tiles * r;
  const unsigned long long miss_key = hit_key(miss, 0);
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < plane;
       i += (long)gridDim.x * blockDim.x) {
    if (MODE == MODE_ANYHIT) {
      out_blocked[i] = false;
      continue;
    }
    const int count = counts[i / r];
    if (count == 0) {
      out_t[i] = miss;
      out_pid[i] = 0;
      if (MODE == MODE_ROWS)
        for (int j = 0; j < 32; ++j) out_rows[j * plane + i] = attr[j];
    } else if (!EXIT && count > E) {
      keys[i] = miss_key;
    }
  }
}

// The largest of v over the block (blockDim.x / 32 warps), in thread 0;
// every thread must call it.  `scratch` holds one float per warp.
__device__ __forceinline__ float block_max_to_thread0(float v,
                                                      float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) v = fmaxf(v, scratch[i]);
  return v;
}

// The items kernel's body under policy P (blockDim.x == r threads; P
// says which ray each thread owns).  Early exit only: `ed` [T, nc] the
// sorted entry bounds, `lead` [T * r + T] the leads' per-lane best t and,
// after them, their per-tile worst.  `payload` is the rays and `comp` the
// table, as P reads them.
template <class P, int MODE, int E, bool EXIT>
__device__ __forceinline__ void items_body(
    const float* __restrict__ payload, const float* __restrict__ comp,
    const int* __restrict__ ids, const int* __restrict__ counts,
    const float* __restrict__ attr, const float* __restrict__ ed,
    float* __restrict__ lead, float* __restrict__ out_t,
    int* __restrict__ out_pid, float* __restrict__ out_rows,
    bool* __restrict__ out_blocked, unsigned long long* __restrict__ keys,
    int* __restrict__ work, int n_tiles, int r, int nc, int tc, int pid_base,
    float t_min, float t_max, float eps, float miss, int exit_check) {
  extern __shared__ __align__(16) float ring[];  // 2 slots of P's chunks
  __shared__ int s_item[2][3];  // (tile or -1 when none is left, k0, entries)
  __shared__ int s_last;
  __shared__ float s_worst;  // early exit: the item's current bound
  __shared__ float warp_max[32];
  const int lane = threadIdx.x;
  const long plane = (long)n_tiles * r;
  const int csz = P::slot_floats(tc);  // a staged chunk
  const int* offsets = item_offsets(work);
  const int* rest = rest_offsets(work, n_tiles);
  int* done = tile_done(work, n_tiles);
  int* led = lead_done(work, n_tiles);
  float* lead_t = lead;
  float* lead_worst = EXIT ? lead + plane : nullptr;
  const int leads = offsets[n_tiles];  // early exit: the items before the rest
  const int total = leads + (EXIT ? rest[n_tiles] : 0);

  // Warp 0 takes the next item from the counter and finds its tile, the
  // last tile whose first item is <= it, by a 32-way search keeping
  // first[lo] <= item < first[hi]; the result lands in s_item[slot] and
  // is read after the next barrier.  Early exit: items [0, leads) are the
  // leads (entry 0 on), the others a tile's later items (item j of a
  // tile from entry (j + 1) * E on).
  auto fetch = [&](int slot) {
    if (lane >= 32) return;
    int item = 0;
    if (lane == 0) item = atomicAdd(work, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    if (item >= total) {
      if (lane == 0) s_item[slot][0] = -1;
      return;
    }
    const bool later = EXIT && item >= leads;
    const int* first = later ? rest : offsets;
    if (later) item -= leads;
    int lo = 0, hi = n_tiles;
    while (hi - lo > 1) {
      const int step = (hi - lo + 31) / 32;
      const int p = lo + lane * step;
      const unsigned m =
          __ballot_sync(0xffffffffu, p < hi && first[p] <= item);
      lo += (31 - __clz(m)) * step;
      hi = min(hi, lo + step);
    }
    if (lane == 0) {
      const int k0 = (item - first[lo] + (later ? 1 : 0)) * E;
      s_item[slot][0] = lo;
      s_item[slot][1] = k0;
      s_item[slot][2] = min(E, counts[lo] - k0);
    }
  };
  auto first_chunk = [&](int slot) {
    return ids[(long)s_item[slot][0] * nc + s_item[slot][1]];
  };

  fetch(0);
  __syncthreads();
  if (s_item[0][0] < 0) return;
  int cur = 0;   // s_item slot of the current item
  int slot = 0;  // ring slot holding the chunk to test next
  P::stage(ring, comp, first_chunk(0), tc);
  for (;;) {
    const int tile = s_item[cur][0], k0 = s_item[cur][1];
    int n = s_item[cur][2];
    // Early exit: every thread has read s_item[cur] and, in the last
    // item, s_worst.
    if (EXIT) __syncthreads();
    fetch(cur ^ 1);  // one item ahead, for the ring
    const long idx = (long)tile * r + P::own_ray();
    const int count = counts[tile];
    const int* list = ids + (long)tile * nc + k0;
    const float* keys_ed = EXIT ? ed + (long)tile * nc + k0 : nullptr;
    if (EXIT) {
      if (lane == 0) {
        float w0 = miss;  // a lead starts unbounded
        if (k0 > 0) {
          // A later item: its lead's snapshot, once stored.
          while (*(volatile const int*)(led + tile) == 0) __nanosleep(100);
          __threadfence();
          w0 = __ldcg(lead_worst + tile);
        }
        s_worst = w0;
      }
      __syncthreads();
      if (!(keys_ed[0] <= s_worst)) n = 0;  // skipped whole (uniform)
    }
    typename P::Best best;
    P::reset(best, miss);
    bool next_staged = false;
    if (n > 0) {
      const typename P::Ray ray = P::template load<MODE>(payload, tile, n_tiles, r);
      // A later item's lane bound: its lead's best t of this lane.
      const float bound = (EXIT && k0 > 0) ? __ldcg(lead_t + idx) : miss;
      // Any-hit: another item of the tile may have blocked the ray already.
      bool blocked = MODE == MODE_ANYHIT && count > E &&
                     *(volatile const bool*)(out_blocked + idx);
      for (int j = 0; j < n; ++j) {
        cp_async_wait_all();
        __syncthreads();  // chunk j has landed; the other ring slot is free
        // Uniform across the block (s_worst was published by the
        // barrier); `!(a <= b)` also stops at a NaN key.
        if (EXIT && !(keys_ed[j] <= s_worst)) break;
        int c_next = -1;
        if (j + 1 < n) {
          c_next = list[j + 1];
        } else if (s_item[cur ^ 1][0] >= 0) {
          c_next = ids[(long)s_item[cur ^ 1][0] * nc + s_item[cur ^ 1][1]];
          next_staged = true;
        }
        if (c_next >= 0) P::stage(ring + (slot ^ 1) * csz, comp, c_next, tc);
        const float* chunk = ring + slot * csz;
        slot ^= 1;
        if (!blocked)
          P::template test<MODE, EXIT>(chunk, ray, list[j], tc, pid_base,
                                       t_min, t_max, eps, best, blocked,
                                       out_blocked, idx);
        if (MODE == MODE_ANYHIT && __syncthreads_and(blocked)) break;
        if constexpr (EXIT) {
          if ((k0 + j) % exit_check == exit_check - 1) {
            // best.t and bound are never NaN (a miss or an accepted w).
            const float m =
                block_max_to_thread0(fminf(best.t, bound), warp_max);
            if (lane == 0) s_worst = m;  // published by the next barrier
          }
        }
      }
    }
    if (EXIT) __syncthreads();  // s_item[cur ^ 1] is published
    const int next_tile = s_item[cur ^ 1][0];
    if (!next_staged) {
      // The item stopped early or was skipped: its next chunk's copy (if
      // any) is moot, and the next item's first chunk is not staged.
      cp_async_wait_all();
      if (next_tile >= 0)
        P::stage(ring + slot * csz, comp, first_chunk(cur ^ 1), tc);
    }
    // The item's best of the ray this thread owns.
    float best_t;
    int best_id;
    P::result(best, best_t, best_id);

    if (EXIT && k0 == 0 && count > E) {
      // The lead of a tile with later items: its snapshot for them.
      lead_t[idx] = best_t;
      keys[idx] = hit_key(best_t, best_id);
      const float m = block_max_to_thread0(best_t, warp_max);
      if (lane == 0) lead_worst[tile] = m;
      __threadfence();
      __syncthreads();
      if (lane == 0) atomicExch(led + tile, 1);
    } else if (MODE != MODE_ANYHIT) {
      bool write = count <= E;  // the tile's only item
      if (!write) {
        if (best_t < miss) {  // a hit: every accepted w is below t_max
          const unsigned long long key = hit_key(best_t, best_id);
          if (key < *(volatile const unsigned long long*)(keys + idx))
            atomicMin(keys + idx, key);
        }
        __threadfence();
        __syncthreads();
        if (lane == 0) {
          // Early exit: the lead is not counted.
          const int n_items = (count + E - 1) / E - (EXIT ? 1 : 0);
          s_last = atomicAdd(done + tile, 1) == n_items - 1;
        }
        __syncthreads();
        write = s_last;
        if (write) {
          __threadfence();
          const unsigned long long key =
              *(volatile const unsigned long long*)(keys + idx);
          best_t = ordered_float((unsigned)(key >> 32));
          best_id = (int)(unsigned)(key & 0xffffffffu);
        }
      }
      if (write) {
        out_t[idx] = best_t;
        out_pid[idx] = best_id;
        if (MODE == MODE_ROWS) {
          const float* src = attr + (long)best_id * 32;
#pragma unroll 4
          for (int j = 0; j < 32; ++j) out_rows[j * plane + idx] = src[j];
        }
      }
    }
    cur ^= 1;
    if (next_tile < 0) break;
  }
  cp_async_wait_all();
}

// The items kernels' launch shape for one (kernel, device, ray tile,
// shared memory): the card's SMs and the resident blocks on all of them.
struct Residency {
  const void* fn;
  int dev, r;
  size_t smem;
  int sms, blocks;
};

// Residency cached for every key seen (a frame alternates ray tiles
// under the `narrow` knob), so that once a frame has run eagerly its
// calls make no attribute or occupancy query: a CUDA graph capture of
// the frame then records launches only, with the grid the eager call
// used.  A ring over 32 KiB opts in to more shared memory first.
// Blocks 0 on failure.
template <typename Kernel>
Residency persistent_blocks(Kernel kernel, int r, size_t smem) {
  constexpr int kKeys = 32;
  static Residency seen[kKeys];
  static int n_seen = 0;
  Residency out{(const void*)kernel, -1, r, smem, 0, 0};
  if (cudaGetDevice(&out.dev) != cudaSuccess) return out;
  for (int i = 0; i < n_seen && i < kKeys; ++i)
    if (seen[i].fn == out.fn && seen[i].dev == out.dev && seen[i].r == r &&
        seen[i].smem == smem)
      return seen[i];
  int per_sm = 0;
  if ((smem > 32 * 1024 &&
       cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem) != cudaSuccess) ||
      cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount,
                             out.dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, r,
                                                    smem) != cudaSuccess ||
      per_sm <= 0) {
    cudaGetLastError();  // not sticky: the caller reports its own code
    return out;
  }
  out.blocks = out.sms * per_sm;
  seen[n_seen++ % kKeys] = out;
  return out;
}

// The prologue's grid: enough blocks for the per-ray state, at most two
// per SM.
inline int prologue_blocks(long plane, int sms) {
  const long blocks = (plane + kPrologueThreads - 1) / kPrologueThreads;
  return (int)(blocks < 2L * sms ? (blocks > 0 ? blocks : 1) : 2L * sms);
}

// A persistent grid of at most `resident` blocks, and no more than
// `most` items could need.
inline int items_grid(long most, int resident) {
  return (int)(most < resident ? (most > 0 ? most : 1) : resident);
}

}  // namespace
