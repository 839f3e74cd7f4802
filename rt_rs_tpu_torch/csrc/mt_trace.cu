// Kernel B: the Möller–Trumbore packet trace.
//
// Replaces rt_rs_tpu/ops/pallas/packet_trace.py::_mt_kernel with its
// per-(chunk, tile) test mt_chunk_test, in three modes:
//   closest (mode 0): t [T, r] f32, pid [T, r] i32;
//   rows    (mode 1): also the winner's 32-float shade row [32, T, r];
//   any-hit (mode 2): blocked [T, r] bool.
// Each tile tests every triangle of every chunk in ids[t, 0:counts[t]]
// (the compacted, ascending chunk list).  A hit is ok iff the
// sign-folded two-sided test passes (adet > eps, 0 <= su <= adet,
// sv >= 0, su + sv <= adet), t_min < w < t_max, and pid != excl
// (payload row 6).  Closest hit: the minimum w, ties to the smallest
// pid, misses (t_max + 1, 0).  Any-hit: some ok hit has w < cap
// (payload row 7).  Tiles with an empty list write misses.  Prim ids
// are global: triangle s of chunk c is 1 + pid_base + c * tc + s (a
// segment of a larger table passes its base), and the rows table is
// indexed by that global id.
//
// What bounds it on this card.  The arithmetic is ~40 f32 ops per
// (ray, triangle) pair, with a chunk's 64 x 9 floats read from shared
// memory as broadcasts; one thread owns one ray.  But a frame's calls
// are a few hundred to a few thousand tiles whose lists are very uneven
// (the canyon's segment calls: mean 0.9-2.2 entries, max 128; torus
// primaries: mean 4-7, max 99), so a grid of one block per tile lasts
// as long as its longest list: the per-tile walk ran at ~10 us per
// entry of the longest tile, ~8-20x its arithmetic bound.  The limit
// was the longest list, not the arithmetic.
//
// Design (closest, rows, any-hit): balanced work items and an exact
// merge.
// * An item is (tile, at most E consecutive list entries), with E a
//   compile-time constant per mode (ITEM_*, below; tuned on the card,
//   PERF.md).  A prologue launch scans ceil(counts / E) into per-tile
//   item offsets (one block), initialises the per-ray merge keys of
//   tiles with more than one item, and writes the misses of empty tiles
//   directly (any-hit: zeroes every flag).
// * The main launch is a persistent grid (SMs x resident blocks, from
//   the occupancy calculator, cached); each block takes items from a
//   global atomic counter (the item count never reaches the host) and
//   finds the item's tile with a 32-way warp search over the offsets.
// * Closest and rows: an item scans its entries in ascending pid order
//   with a strict `<` (the twin's rule), so its best is the
//   (t, pid)-lexicographic minimum over its entries.  A tile with one
//   item writes that best directly; otherwise the item folds it into a
//   per-ray 64-bit key (ordered_bits(t) << 32 | pid) with atomicMin,
//   only where it found a hit and only when the key can still fall.
//   The lexicographic minimum is order-independent and equals the
//   ascending strict scan over the whole list, so the result is
//   bit-equal to the twin whatever order the items run in.  The block
//   that finishes a tile's last item (a per-tile atomicAdd after a
//   __threadfence) decodes the keys and writes t, pid and, in rows
//   mode, the winner's row (one indexed 128-byte load; row 0 of the
//   table is zeros, so misses need no branch).  Zero is canonical in the
//   key: only with t_min < 0, which no configuration uses, could a hit
//   lie at -0.0, and a tile of more than one item then returns +0.0.
// * Any-hit: an item reads its rays' flags first and skips rays already
//   blocked; a blocking hit stores `true` (idempotent, no atomics), and a
//   block-wide vote ends the item once all its rays are blocked.
// * Staging: a double-buffered ring of chunks in shared memory, filled
//   with cp.async, each triangle padded to 12 floats (three 128-bit
//   loads).  The next chunk, or the first chunk of the block's next item
//   (taken one item ahead), is in flight while the current one is
//   tested: one barrier per chunk instead of two.  A ring over 48 KiB
//   (tri_chunk > 511) opts in to Hopper's larger shared memory.
// * The test checks u before it computes q and v (mt_test_u_first): a
//   warp whose 32 rays all miss a triangle's u slab, which is most of
//   them for coherent rays and small triangles, skips the rest.
// Two launches per call.
//
// Early exit (the closest and rows modes with `ed` given; the TPU
// kernel's early_exit branches, packet_trace.py:837-846, :859-891 and
// :926-942) keeps the first port's per-tile walk, not redesigned here:
// its stop rule is sequential along the sorted list.  One block per tile
// walks the tile's whole list, staging each chunk cooperatively between
// two barriers.  The lists are front to back: ed[t, k] is a lower bound
// on the entry distance of entry k's chunk for every ray of the tile,
// and ascends along k.  The block keeps the tile's `worst` (the largest
// best t over all r lanes, invalid and padding lanes included) in shared
// memory, refreshed after every exit_check-th entry with a warp shuffle
// max and one pass over the warps' maxima.  Before staging entry k the
// block compares ed[t, k] with `worst`: both are per tile, so the
// decision is uniform and costs no divergence, and since ed ascends and
// `worst` never rises, the first entry beyond it ends the tile's walk
// outright (the TPU kernel could only skip entry by entry inside its
// fori_loop; the results are the same).  The reordered walk no longer
// meets pids in ascending order, so the update is (t, pid)-lexicographic.
#include "common.cuh"

enum { MODE_CLOSEST = 0, MODE_ROWS = 1, MODE_ANYHIT = 2 };

// Entries per work item of the balanced design, per mode (mirrored by
// ops/packet_trace.py's MT_ITEM_SIZES for the plain-PyTorch mirror).
enum { ITEM_CLOSEST = 2, ITEM_ROWS = 2, ITEM_ANYHIT = 1 };

template <int MODE>
__host__ __device__ constexpr int item_entries() {
  return MODE == MODE_CLOSEST ? ITEM_CLOSEST
                              : (MODE == MODE_ROWS ? ITEM_ROWS : ITEM_ANYHIT);
}

template <int MODE>
__global__ void mt_trace_early_exit_kernel(
    const float* __restrict__ payload, const float* __restrict__ comp,
    const int* __restrict__ ids, const int* __restrict__ counts,
    const float* __restrict__ attr, const float* __restrict__ ed,
    float* __restrict__ out_t, int* __restrict__ out_pid,
    float* __restrict__ out_rows, int n_tiles, int r, int nc, int tc,
    int pid_base, float t_min, float t_max, float eps, float miss,
    int exit_check) {
  extern __shared__ float chunk[];  // [tc, 9]
  __shared__ float worst;           // the tile's worst best t
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

  float best_t = miss;
  int best_id = 0;
  const int* list = ids + (long)tile * nc;
  const float* keys = ed + (long)tile * nc;
  if (lane == 0) worst = miss;
  for (int k = 0; k < count; ++k) {
    const int c = list[k];
    __syncthreads();  // everyone is done with the previous chunk
    // Uniform across the block (`worst` was published by the barrier);
    // `!(a <= b)` also stops at a NaN key, as the TPU kernel skips it.
    if (!(keys[k] <= worst)) break;
    for (int i = lane; i < tc * 9; i += blockDim.x)
      chunk[i] = comp[(long)c * tc * 9 + i];
    __syncthreads();
    const int pid0 = 1 + pid_base + c * tc;
    for (int s = 0; s < tc; ++s) {
      float w;
      if (!mt_test(chunk + s * 9, ox, oy, oz, dx, dy, dz, t_min, t_max, eps,
                   w))
        continue;
      if ((float)(pid0 + s) == excl) continue;
      if (w < best_t || (w == best_t && pid0 + s < best_id)) {
        best_t = w;
        best_id = pid0 + s;
      }
    }
    if (k % exit_check == exit_check - 1) {
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

  out_t[idx] = best_t;
  out_pid[idx] = best_id;
  if (MODE == MODE_ROWS) {
    const float* src = attr + (long)best_id * 32;
    for (int j = 0; j < 32; ++j) out_rows[j * plane + idx] = src[j];
  }
}

namespace {

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Start the copy of one chunk ([tc, 9] floats) into shared memory as
// [tc, 12]: each triangle padded to three 16-byte words, so the tests
// read it with three 128-bit loads instead of nine 32-bit ones.  Each
// thread always copies the same positions, so a thread that waits for
// its own copies may refill them without a barrier.
__device__ __forceinline__ void stage(float* dst, const float* src, int tc) {
  for (int i = threadIdx.x; i < tc * 9; i += blockDim.x)
    cp_async4(dst + i + 3 * (i / 9), src + i);  // float k of triangle s -> 12 s + k
  asm volatile("cp.async.commit_group;\n" ::);
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

// The workspace `work` (int32): [0] the item counter, [1] unused, then
// offsets[0 .. n_tiles] (offsets[t] = the first item of tile t,
// offsets[n_tiles] = the item count), then done[n_tiles] (items of
// each tile finished so far).
__device__ __forceinline__ int* item_offsets(int* work) { return work + 2; }
__device__ __forceinline__ int* tile_done(int* work, int n_tiles) {
  return work + 3 + n_tiles;
}

template <int MODE>
__global__ void __launch_bounds__(kPrologueThreads) mt_trace_prologue_kernel(
    const int* __restrict__ counts, const float* __restrict__ attr,
    float* __restrict__ out_t, int* __restrict__ out_pid,
    float* __restrict__ out_rows, bool* __restrict__ out_blocked,
    unsigned long long* __restrict__ keys, int* __restrict__ work,
    int n_tiles, int r, float miss) {
  constexpr int E = item_entries<MODE>();
  if (blockIdx.x == 0) {
    // Exclusive scan of the tiles' item counts, kPrologueThreads tiles
    // a round: a warp scan, a scan of the warp totals, a running carry.
    __shared__ int warp_sum[32];
    __shared__ int carry;
    int* offsets = item_offsets(work);
    int* done = tile_done(work, n_tiles);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) carry = 0;
    for (int base = 0; base < n_tiles; base += blockDim.x) {
      const int t = base + threadIdx.x;
      const int v = (t < n_tiles) ? (counts[t] + E - 1) / E : 0;
      int x = v;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      __syncthreads();  // carry is published, warp_sum is free
      if (lane == 31) warp_sum[warp] = x;
      __syncthreads();
      if (warp == 0) {
        int s = (lane < (int)(blockDim.x >> 5)) ? warp_sum[lane] : 0;
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, s, off);
          if (lane >= off) s += y;
        }
        warp_sum[lane] = s;
      }
      __syncthreads();
      const int before = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
      if (t < n_tiles) {
        offsets[t] = before;
        done[t] = 0;
      }
      __syncthreads();  // everyone has read carry
      if (threadIdx.x == blockDim.x - 1) carry = before + v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      offsets[n_tiles] = carry;
      work[0] = 0;
    }
  }
  // Every block: the per-ray state.
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
    } else if (count > E) {
      keys[i] = miss_key;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(1024) mt_trace_items_kernel(
    const float* __restrict__ payload, const float* __restrict__ comp,
    const int* __restrict__ ids, const int* __restrict__ counts,
    const float* __restrict__ attr, float* __restrict__ out_t,
    int* __restrict__ out_pid, float* __restrict__ out_rows,
    bool* __restrict__ out_blocked, unsigned long long* __restrict__ keys,
    int* __restrict__ work, int n_tiles, int r, int nc, int tc, int pid_base,
    float t_min, float t_max, float eps, float miss) {
  constexpr int E = item_entries<MODE>();
  extern __shared__ __align__(16) float ring[];  // 2 x [tc, 12]
  __shared__ int s_item[2][3];  // (tile or -1 when none is left, k0, n)
  __shared__ int s_last;
  const int lane = threadIdx.x;
  const long plane = (long)n_tiles * r;
  const int csz = tc * 12;  // a staged chunk
  const int* offsets = item_offsets(work);
  int* done = tile_done(work, n_tiles);
  const int total = offsets[n_tiles];

  // Warp 0 takes the next item from the counter and finds its tile, the
  // last tile whose first item is <= it, by a 32-way search keeping
  // offsets[lo] <= item < offsets[hi]; the result lands in s_item[slot]
  // and is read after the next barrier.
  auto fetch = [&](int slot) {
    if (lane >= 32) return;
    int item = 0;
    if (lane == 0) item = atomicAdd(work, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    if (item >= total) {
      if (lane == 0) s_item[slot][0] = -1;
      return;
    }
    int lo = 0, hi = n_tiles;
    while (hi - lo > 1) {
      const int step = (hi - lo + 31) / 32;
      const int p = lo + lane * step;
      const unsigned m =
          __ballot_sync(0xffffffffu, p < hi && offsets[p] <= item);
      lo += (31 - __clz(m)) * step;
      hi = min(hi, lo + step);
    }
    if (lane == 0) {
      const int k0 = (item - offsets[lo]) * E;
      s_item[slot][0] = lo;
      s_item[slot][1] = k0;
      s_item[slot][2] = min(E, counts[lo] - k0);
    }
  };

  fetch(0);
  __syncthreads();
  if (s_item[0][0] < 0) return;
  int cur = 0;   // s_item slot of the current item
  int slot = 0;  // ring slot holding the chunk to test next
  stage(ring, comp + (long)ids[(long)s_item[0][0] * nc + s_item[0][1]] * tc * 9,
        tc);
  for (;;) {
    const int tile = s_item[cur][0], k0 = s_item[cur][1], n = s_item[cur][2];
    fetch(cur ^ 1);  // one item ahead, for the ring
    const long idx = (long)tile * r + lane;
    const float ox = payload[0 * plane + idx];
    const float oy = payload[1 * plane + idx];
    const float oz = payload[2 * plane + idx];
    const float dx = payload[3 * plane + idx];
    const float dy = payload[4 * plane + idx];
    const float dz = payload[5 * plane + idx];
    const float excl = payload[6 * plane + idx];
    const float cap = payload[7 * plane + idx];
    const int count = counts[tile];
    const int* list = ids + (long)tile * nc + k0;

    float best_t = miss;
    int best_id = 0;
    // Any-hit: another item of the tile may have blocked the ray already.
    bool blocked = MODE == MODE_ANYHIT && count > E &&
                   *(volatile const bool*)(out_blocked + idx);
    bool next_staged = false;
    for (int j = 0; j < n; ++j) {
      cp_async_wait_all();
      __syncthreads();  // chunk j has landed; the other ring slot is free
      int c_next = -1;
      if (j + 1 < n) {
        c_next = list[j + 1];
      } else if (s_item[cur ^ 1][0] >= 0) {
        c_next = ids[(long)s_item[cur ^ 1][0] * nc + s_item[cur ^ 1][1]];
        next_staged = true;
      }
      if (c_next >= 0)
        stage(ring + (slot ^ 1) * csz, comp + (long)c_next * tc * 9, tc);
      const float4* chunk = reinterpret_cast<const float4*>(ring + slot * csz);
      slot ^= 1;
      if (!blocked) {
        const int c = list[j];
        const int pid0 = 1 + pid_base + c * tc;
        for (int s = 0; s < tc; ++s) {
          float w;
          if (!mt_test_u_first(chunk + s * 3, ox, oy, oz, dx, dy, dz, t_min,
                               t_max, eps, w))
            continue;
          if ((float)(pid0 + s) == excl) continue;
          if (MODE == MODE_ANYHIT) {
            if (w < cap) {
              blocked = true;
              out_blocked[idx] = true;
              break;
            }
          } else if (w < best_t) {
            best_t = w;
            best_id = pid0 + s;
          }
        }
      }
      if (MODE == MODE_ANYHIT && __syncthreads_and(blocked)) break;
    }
    const int next_tile = s_item[cur ^ 1][0];
    if (!next_staged) {
      // The item stopped early: its next chunk's copy (if any) is moot.
      cp_async_wait_all();
      if (next_tile >= 0)
        stage(ring + slot * csz,
              comp + (long)ids[(long)next_tile * nc + s_item[cur ^ 1][1]] * tc * 9,
              tc);
    }

    if (MODE != MODE_ANYHIT) {
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
          const int n_items = (count + E - 1) / E;
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

// The items kernel's launch shape for one (device, ray tile, shared
// memory): the card's SMs and the resident blocks on all of them.
struct Residency {
  int dev, r;
  size_t smem;
  int sms, blocks;
};

// Residency per mode, cached for every key seen (a frame alternates ray
// tiles under the `narrow` knob), so that once a frame has run eagerly
// its calls make no attribute or occupancy query: a CUDA graph capture
// of the frame then records launches only, with the grid the eager call
// used.  A ring over the default 48 KiB opts in to more first.  Blocks
// 0 on failure.
template <int MODE>
Residency persistent_blocks(int r, size_t smem) {
  constexpr int kKeys = 8;
  static Residency seen[kKeys];
  static int n_seen = 0;
  Residency out{-1, r, smem, 0, 0};
  if (cudaGetDevice(&out.dev) != cudaSuccess) return out;
  for (int i = 0; i < n_seen && i < kKeys; ++i)
    if (seen[i].dev == out.dev && seen[i].r == r && seen[i].smem == smem)
      return seen[i];
  int per_sm = 0;
  if ((smem > 48 * 1024 &&
       cudaFuncSetAttribute(mt_trace_items_kernel<MODE>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem) != cudaSuccess) ||
      cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount,
                             out.dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mt_trace_items_kernel<MODE>, r, smem) != cudaSuccess ||
      per_sm <= 0) {
    cudaGetLastError();  // not sticky: the caller reports its own code
    return out;
  }
  out.blocks = out.sms * per_sm;
  seen[n_seen++ % kKeys] = out;
  return out;
}

template <int MODE>
int launch_items(const float* payload, const float* comp, const int* ids,
                 const int* counts, const float* attr, float* out_t,
                 int* out_pid, float* out_rows, bool* out_blocked,
                 unsigned long long* keys, int* work, int n_tiles, int r,
                 int nc, int tc, int pid_base, float t_min, float t_max,
                 float eps, float miss, cudaStream_t stream) {
  constexpr int E = item_entries<MODE>();
  const size_t smem = 2 * (size_t)tc * 12 * sizeof(float);
  const Residency res = persistent_blocks<MODE>(r, smem);
  const int resident = res.blocks, sms = res.sms;
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const long plane = (long)n_tiles * r;
  const long pro_blocks = (plane + kPrologueThreads - 1) / kPrologueThreads;
  mt_trace_prologue_kernel<MODE>
      <<<(int)(pro_blocks < 2L * sms ? pro_blocks : 2L * sms),
         kPrologueThreads, 0, stream>>>(counts, attr, out_t, out_pid, out_rows,
                                        out_blocked, keys, work, n_tiles, r,
                                        miss);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // No more blocks than items could exist.
  const long most = (long)n_tiles * ((nc + E - 1) / E);
  const int grid = (int)(most < resident ? (most > 0 ? most : 1) : resident);
  mt_trace_items_kernel<MODE><<<grid, r, smem, stream>>>(
      payload, comp, ids, counts, attr, out_t, out_pid, out_rows, out_blocked,
      keys, work, n_tiles, r, nc, tc, pid_base, t_min, t_max, eps, miss);
  return (int)cudaGetLastError();
}

}  // namespace

// Without `ed`: the balanced design, with scratch the wrapper allocates
// (keys: [T * r] u64 for the closest and rows modes, work: [2 * T + 3]
// i32).  With `ed` (closest and rows): the early-exit walk.
RT_EXPORT int rt_mt_trace(const float* payload, const float* comp,
                          const int* ids, const int* counts,
                          const float* attr, const float* ed, float* out_t,
                          int* out_pid, float* out_rows, bool* out_blocked,
                          unsigned long long* keys, int* work, int n_tiles,
                          int r, int nc, int tc, int pid_base, float t_min,
                          float t_max, float eps, float miss, int mode,
                          int exit_check, cudaStream_t stream) {
  if (mode < MODE_CLOSEST || mode > MODE_ANYHIT)
    return (int)cudaErrorInvalidValue;
  if (ed != nullptr && (mode == MODE_ANYHIT || exit_check < 1))
    return (int)cudaErrorInvalidValue;
  if (ed == nullptr &&
      (work == nullptr || (mode != MODE_ANYHIT && keys == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0) return (int)cudaGetLastError();
  if (ed == nullptr) {
#define RT_ITEMS(M)                                                          \
  launch_items<M>(payload, comp, ids, counts, attr, out_t, out_pid, out_rows, \
                  out_blocked, keys, work, n_tiles, r, nc, tc, pid_base,     \
                  t_min, t_max, eps, miss, stream)
    if (mode == MODE_CLOSEST) return RT_ITEMS(MODE_CLOSEST);
    if (mode == MODE_ROWS) return RT_ITEMS(MODE_ROWS);
    return RT_ITEMS(MODE_ANYHIT);
#undef RT_ITEMS
  }
  const size_t smem = (size_t)tc * 9 * sizeof(float);
#define RT_EARLY_EXIT(M)                                                   \
  mt_trace_early_exit_kernel<M><<<n_tiles, r, smem, stream>>>(             \
      payload, comp, ids, counts, attr, ed, out_t, out_pid, out_rows,      \
      n_tiles, r, nc, tc, pid_base, t_min, t_max, eps, miss, exit_check)
  if (mode == MODE_CLOSEST)
    RT_EARLY_EXIT(MODE_CLOSEST);
  else
    RT_EARLY_EXIT(MODE_ROWS);
#undef RT_EARLY_EXIT
  return (int)cudaGetLastError();
}
