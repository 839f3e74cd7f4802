// wide_build: kernel G's packed wide tree, built anew every frame.
//
// Replaces no pallas_call: the JAX package's DynamicRenderer rebuilds a
// chunk table in XLA ops (rt_rs_tpu/ops/lbvh.py), and no walked
// structure.  DynamicRenderer's walked rebuild runs these kernels each
// frame on the frame's corners pa, pb, pc [P + 1, 3] (row 0 the null
// sentinel), reading nothing back, so a CUDA graph captures them with
// the frame.  The twin is ops/wide_build.py::wide_build_reference, and
// the module's docstring sets out the tree; in order:
//   1. wide_build_box_kernel: the corners' box (one block);
//   2. wide_build_codes_kernel: each prim's 30-bit Morton code, as
//      ops/lbvh.py::centroid_codes computes it, and its bucket's count
//      (the code's top kBucketBits bits);
//   3. wide_build_scan_kernel: each bucket's start (one block);
//   4. wide_build_scatter_kernel: the prims by bucket, in any order;
//   5. wide_build_rank_kernel: each prim's sorted position, its bucket's
//      start plus the prims of its bucket with a smaller (code, index):
//      a stable sort, whatever order the scatter left;
//   6. wide_build_emit_kernel: Karras' radix-tree emit (HPG 2012), one
//      thread an internal node, equal codes split on the sorted index
//      (ops/lbvh.py::karras_splits);
//   7. wide_build_bounds_kernel: each sorted prim's 48-byte record and
//      box, then up the tree: the second thread to reach an internal
//      node (an atomic flag) unions its children's boxes, left then
//      right, and its f64 half surface area;
//   8. wide_build_collapse_kernel: the collapse into kWidth-wide nodes,
//      top down, largest area first under the stack bound, then each
//      wide node's preorder index (one block);
//   9. wide_build_nodes_kernel: the 128-byte node records, the walk's
//      wobble applied as bvh/wide.py::wobbled rounds it; rows past the
//      wide node count zeroed.
// Every size is fixed by P: P - 1 internal nodes, at most max(P - 1, 1)
// wide nodes.  While the trace buffer's flag is set (tracing.py), kernel
// 7 adds the prim records it wrote to rebuild_prims (`counter`) and
// kernel 9 the wide nodes to rebuild_nodes (`counter + 1`).
//
// What bounds it: the one-block phases (1, 3, 8) and the dependent
// loads of the emit's searches and the climb, not bytes: the corners
// and every buffer (a few MB at 18,962 prims) stay in L2.
#include "common.cuh"

namespace {

constexpr int kWidth = 4;         // WIDTH in bvh/wide.py
constexpr int kNodeWords = 32;    // NODE_WORDS
constexpr int kSlots = 8;         // SLOTS: a leaf's most prims (the twin's payload)
constexpr int kBucketBits = 14;   // BUCKET_BITS
constexpr int kBuckets = 1 << kBucketBits;
constexpr int kLocalStack = 64;   // LOCAL_STACK
constexpr int kBlock = 256;
constexpr int kOne = 1024;        // threads of the one-block phases

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

// An exclusive scan of v over the block (every thread calls it, blockDim
// a multiple of 32); *total gets the block's sum.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    warp_sum[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sum[warp - 1] : 0;
  *total = warp_sum[warps - 1];
  __syncthreads();
  return before + x - v;
}

// 1. The box of every corner of rows 1..p; zeroes the bucket counts.
__global__ void __launch_bounds__(kOne)
    wide_build_box_kernel(Corners c, int p, float* __restrict__ box,
                          int* __restrict__ bucket) {
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int r = 1 + threadIdx.x; r <= p; r += blockDim.x) {
    float a[3], b[3], d[3];
    load_row(c.pa, r, a);
    load_row(c.pb, r, b);
    load_row(c.pc, r, d);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = nan_min(lo[k], nan_min(nan_min(a[k], b[k]), d[k]));
      hi[k] = nan_max(hi[k], nan_max(nan_max(a[k], b[k]), d[k]));
    }
  }
  for (int i = threadIdx.x; i <= kBuckets; i += blockDim.x) bucket[i] = 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = nan_min(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
      hi[k] = nan_max(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
    }
  }
  __shared__ float part[32][6];
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
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = nan_min(lo[k], part[w][k]);
        hi[k] = nan_max(hi[k], part[w][3 + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      box[k] = lo[k];
      box[4 + k] = hi[k];
    }
  }
}

// Spread the low 10 bits of v to every 3rd bit (ops/lbvh.py).
__device__ __forceinline__ int expand_bits_10(int v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// 2. Each prim's code (ops/lbvh.py::centroid_codes, op for op) and its
// bucket's count.
__global__ void __launch_bounds__(kBlock)
    wide_build_codes_kernel(Corners c, int p, const float* __restrict__ box,
                            int* __restrict__ codes, int* __restrict__ bucket) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p) return;
  float a[3], b[3], d[3];
  load_row(c.pa, q + 1, a);
  load_row(c.pb, q + 1, b);
  load_row(c.pc, q + 1, d);
  int s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = box[k], hi = box[4 + k];
    const float cent = (a[k] + b[k] + d[k]) * (1.0f / 3.0f);
    const float ext = nan_max(hi - lo, 1e-30f);
    const float v = ((cent - lo) / ext) * 1024.0f;
    // torch.clamp keeps a NaN, which then quantizes to 0
    s[k] = (v != v) ? 0 : (int)fminf(fmaxf(v, 0.0f), 1023.0f);
  }
  const int code =
      (expand_bits_10(s[0]) << 2) | (expand_bits_10(s[1]) << 1) | expand_bits_10(s[2]);
  codes[q] = code;
  atomicAdd(&bucket[code >> (30 - kBucketBits)], 1);
}

// An exclusive scan in place of n ints, in chunks of 4 consecutive a
// thread (every thread of the block calls it); a copy to `copy` if not
// null -> the total.
__device__ int block_scan_in_place(int* __restrict__ x, int n,
                                   int* __restrict__ copy) {
  int carry = 0;
  for (int base = 0; base < n; base += 4 * blockDim.x) {
    const int i = base + 4 * threadIdx.x;
    int v[4], sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = i + k < n ? x[i + k] : 0;
      sum += v[k];
    }
    int total;
    int run = carry + block_scan(sum, &total);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k < n) {
        x[i + k] = run;
        if (copy != nullptr) copy[i + k] = run;
      }
      run += v[k];
    }
    carry += total;
  }
  return carry;
}

// 3. Bucket counts -> starts (bucket[kBuckets] the total), and a copy
// for the scatter's cursors.
__global__ void __launch_bounds__(kOne)
    wide_build_scan_kernel(int* __restrict__ bucket, int* __restrict__ cursor) {
  const int total = block_scan_in_place(bucket, kBuckets, cursor);
  if (threadIdx.x == 0) bucket[kBuckets] = total;
}

// 4. Each prim into a slot of its bucket.
__global__ void __launch_bounds__(kBlock)
    wide_build_scatter_kernel(int p, const int* __restrict__ codes,
                              int* __restrict__ cursor, int* __restrict__ slot) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p) return;
  slot[atomicAdd(&cursor[codes[q] >> (30 - kBucketBits)], 1)] = q;
}

// 5. Each prim's sorted position: its bucket's start plus the prims there
// whose (code, index) is smaller.
__global__ void __launch_bounds__(kBlock)
    wide_build_rank_kernel(int p, const int* __restrict__ codes,
                           const int* __restrict__ bucket,
                           const int* __restrict__ slot, int* __restrict__ order,
                           int* __restrict__ sorted) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p) return;
  const int q = slot[s];
  const int code = codes[q];
  const int b = code >> (30 - kBucketBits);
  const int start = bucket[b], end = bucket[b + 1];
  int before = 0;
  for (int j = start; j < end; ++j) {
    const int r = slot[j];
    const int cr = codes[r];
    before += (cr < code) || (cr == code && r < q);
  }
  order[start + before] = q;
  sorted[start + before] = code;
}

// Common-prefix length of sorted keys i and j (the code, then the
// index); -1 outside [0, p).
__device__ __forceinline__ int delta(const int* __restrict__ sorted, int p,
                                     int i, int ci, int j) {
  if (j < 0 || j >= p) return -1;
  const int x = ci ^ sorted[j];
  return x != 0 ? __clz(x) : 32 + __clz(i ^ j);
}

// 6. Karras' emit: internal node i's range [first, last], its children
// (an internal node, or ~q for sorted prim q) and their parents.
__global__ void __launch_bounds__(kBlock)
    wide_build_emit_kernel(int p, const int* __restrict__ sorted,
                           int4* __restrict__ inner, int* __restrict__ parent,
                           int* __restrict__ leaf_parent, int* __restrict__ flag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p - 1) return;
  const int ci = sorted[i];
  const int up = delta(sorted, p, i, ci, i + 1), down = delta(sorted, p, i, ci, i - 1);
  const int d = up >= down ? 1 : -1;
  const int dmin = delta(sorted, p, i, ci, i - d);
  long long lmax = 2;
  while (delta(sorted, p, i, ci, (int)(i + lmax * d)) > dmin) lmax *= 2;
  int l = 0;
  for (long long t = lmax / 2; t >= 1; t /= 2)
    if (delta(sorted, p, i, ci, (int)(i + (l + t) * d)) > dmin) l += (int)t;
  const int j = i + l * d;
  const int dnode = delta(sorted, p, i, ci, j);
  int s = 0;
  for (int div = 2;; div *= 2) {
    const int t = (l + div - 1) / div;
    if (delta(sorted, p, i, ci, i + (s + t) * d) > dnode) s += t;
    if (t <= 1) break;
  }
  const int gamma = i + s * d + min(d, 0);
  const int first = min(i, j), last = max(i, j);
  const int left = first == gamma ? ~gamma : gamma;
  const int right = last == gamma + 1 ? ~(gamma + 1) : gamma + 1;
  inner[i] = make_int4(first, last, left, right);
  if (left < 0) leaf_parent[gamma] = i; else parent[gamma] = i;
  if (right < 0) leaf_parent[gamma + 1] = i; else parent[gamma + 1] = i;
  if (i == 0) parent[0] = -1;
  flag[i] = 0;
}

__device__ __forceinline__ void load_box(const float4* __restrict__ inner_box,
                                         const float4* __restrict__ leaf_box,
                                         int x, float4& lo, float4& hi) {
  const float4* b = x >= 0 ? inner_box + 2 * (size_t)x : leaf_box + 2 * (size_t)~x;
  lo = __ldcg(b);
  hi = __ldcg(b + 1);
}

// 7. Sorted prim q's record ({a, pid}, {b - a, last}, {c - a, 0}, pid its
// scene row) and box; then up the tree, the second arrival at each
// internal node taking the union of its children's boxes.
__global__ void __launch_bounds__(kBlock)
    wide_build_bounds_kernel(Corners c, int p, const int* __restrict__ order,
                             const int4* __restrict__ inner,
                             const int* __restrict__ parent,
                             const int* __restrict__ leaf_parent,
                             int* __restrict__ flag, float4* __restrict__ inner_box,
                             float4* __restrict__ leaf_box, double* __restrict__ area,
                             int4* __restrict__ prims, int leaf_prims,
                             long long* __restrict__ trace, int counter) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  long long v[1] = {0};
  if (q < p) {
    const int row = order[q] + 1;
    float a[3], b[3], d[3];
    load_row(c.pa, row, a);
    load_row(c.pb, row, b);
    load_row(c.pc, row, d);
    // the leaf holding q: its highest ancestor of at most leaf_prims prims
    int end = q, x = leaf_parent[q];
    while (x >= 0) {
      const int4 in = inner[x];
      if (in.y - in.x + 1 > leaf_prims) break;
      end = in.y;
      x = parent[x];
    }
    int4* rec = prims + 3 * (size_t)q;
    rec[0] = make_int4(__float_as_int(a[0]), __float_as_int(a[1]),
                       __float_as_int(a[2]), row);
    rec[1] = make_int4(__float_as_int(b[0] - a[0]), __float_as_int(b[1] - a[1]),
                       __float_as_int(b[2] - a[2]), end == q);
    rec[2] = make_int4(__float_as_int(d[0] - a[0]), __float_as_int(d[1] - a[1]),
                       __float_as_int(d[2] - a[2]), 0);
    float4 lo = make_float4(nan_min(nan_min(a[0], b[0]), d[0]),
                            nan_min(nan_min(a[1], b[1]), d[1]),
                            nan_min(nan_min(a[2], b[2]), d[2]), 0.0f);
    float4 hi = make_float4(nan_max(nan_max(a[0], b[0]), d[0]),
                            nan_max(nan_max(a[1], b[1]), d[1]),
                            nan_max(nan_max(a[2], b[2]), d[2]), 0.0f);
    leaf_box[2 * (size_t)q] = lo;
    leaf_box[2 * (size_t)q + 1] = hi;
    v[0] = 1;
    for (x = leaf_parent[q]; x >= 0; x = parent[x]) {
      __threadfence();
      if (atomicAdd(&flag[x], 1) == 0) break;  // the sibling is not done
      __threadfence();
      const int4 in = inner[x];
      float4 llo, lhi, rlo, rhi;
      load_box(inner_box, leaf_box, in.z, llo, lhi);
      load_box(inner_box, leaf_box, in.w, rlo, rhi);
      lo = make_float4(nan_min(llo.x, rlo.x), nan_min(llo.y, rlo.y),
                       nan_min(llo.z, rlo.z), 0.0f);
      hi = make_float4(nan_max(lhi.x, rhi.x), nan_max(lhi.y, rhi.y),
                       nan_max(lhi.z, rhi.z), 0.0f);
      inner_box[2 * (size_t)x] = lo;
      inner_box[2 * (size_t)x + 1] = hi;
      const double ex = (double)hi.x - (double)lo.x;
      const double ey = (double)hi.y - (double)lo.y;
      const double ez = (double)hi.z - (double)lo.z;
      area[x] = ex * ey + ey * ez + ez * ex;
    }
  }
  if (!trace_on(trace)) return;  // the flag is the same for the whole block
  block_sum(v);
  if (threadIdx.x == 0) trace_add(trace, counter, v[0]);
}

__device__ __forceinline__ bool interior(const int4* __restrict__ inner, int x,
                                         int leaf_prims) {
  if (x < 0) return false;
  const int4 in = inner[x];
  return in.y - in.x + 1 > leaf_prims;
}

// A child slot's binary node during a collapse: x (an internal node, or
// ~q for sorted prim q), its depth below the wide node, and for an
// interior node its children and area.
struct Elem {
  int x, d, l, r;
  double a;
  bool in;
};

__device__ __forceinline__ Elem load_elem(const int4* __restrict__ inner,
                                          const double* __restrict__ area, int x,
                                          int d, int leaf_prims) {
  Elem e{x, d, 0, 0, 0.0, false};
  if (x >= 0) {
    const int4 in = inner[x];
    if (in.y - in.x + 1 > leaf_prims) {
      e.in = true;
      e.l = in.z;
      e.r = in.w;
      e.a = area[x];
    }
  }
  return e;
}

// One wide node's children (module docstring of ops/wide_build.py):
// from binary node v's two, the interior child of the largest area (the
// first of equals) expanded in place while fewer than kWidth, where
// every interior child then holds at most `slack` entries beyond its
// binary depth; where the largest may not, the next is tried.
__device__ int wide_children(const int4* __restrict__ inner,
                             const double* __restrict__ area, int v, int held,
                             int depth, int slack, int leaf_prims,
                             int (&fx)[kWidth], int (&fd)[kWidth]) {
  const int4 root = inner[v];
  Elem f[kWidth];
  f[0] = load_elem(inner, area, root.z, 1, leaf_prims);
  f[1] = load_elem(inner, area, root.w, 1, leaf_prims);
  int n = 2;
  while (n < kWidth) {
    int tried = 0, best;
    for (;;) {
      best = -1;
      for (int s = 0; s < n; ++s) {
        if (!f[s].in || ((tried >> s) & 1)) continue;
        if (best < 0 || f[s].a > f[best].a) best = s;
      }
      if (best < 0) break;
      Elem g[kWidth];
      for (int s = 0; s < best; ++s) g[s] = f[s];
      g[best] = load_elem(inner, area, f[best].l, f[best].d + 1, leaf_prims);
      g[best + 1] = load_elem(inner, area, f[best].r, f[best].d + 1, leaf_prims);
      for (int s = best + 1; s < n; ++s) g[s + 1] = f[s];
      bool ok = true;
      for (int s = 0; s <= n; ++s)
        if (g[s].in && held + n - s - (depth + g[s].d) > slack) ok = false;
      if (ok) {
        ++n;
        for (int s = 0; s < n; ++s) f[s] = g[s];
        break;
      }
      tried |= 1 << best;
    }
    if (best < 0) break;
  }
  for (int s = 0; s < kWidth; ++s) {
    fx[s] = s < n ? f[s].x : 0;
    fd[s] = s < n ? f[s].d : 0;
  }
  return n;
}

// 8. The collapse, top down a level at a time from the root, then each
// wide node's preorder index: the wide nodes whose first sorted prim
// comes earlier, plus its wide ancestors that share its first.  wide[v]
// is (children, held, depth, index), children 0 for a binary node that
// is no wide node's; count[0] the wide node count.
__global__ void __launch_bounds__(kOne)
    wide_build_collapse_kernel(int p, int slack, int leaf_prims,
                               const int4* __restrict__ inner,
                               const int* __restrict__ parent,
                               const double* __restrict__ area,
                               int4* __restrict__ front, int4* __restrict__ wide,
                               int* __restrict__ queue,
                               int* __restrict__ first_count,
                               int* __restrict__ count) {
  __shared__ int tail;
  if (p < 2 || !interior(inner, 0, leaf_prims)) {  // one wide node, one leaf
    if (threadIdx.x == 0) count[0] = 1;
    return;
  }
  for (int i = threadIdx.x; i < p - 1; i += blockDim.x) wide[i] = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < p; i += blockDim.x) first_count[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    queue[0] = 0;
    tail = 1;
  }
  __syncthreads();
  int head = 0, end = 1;
  while (head < end) {
    for (int it = head + threadIdx.x; it < end; it += blockDim.x) {
      const int v = queue[it];
      const int4 w = wide[v];
      int fx[kWidth], fd[kWidth];
      const int n = wide_children(inner, area, v, w.y, w.z, slack, leaf_prims, fx, fd);
      front[v] = make_int4(fx[0], fx[1], fx[2], fx[3]);
      wide[v] = make_int4(n, w.y, w.z, 0);
      for (int s = 0; s < n; ++s) {
        if (!interior(inner, fx[s], leaf_prims)) continue;
        wide[fx[s]] = make_int4(0, w.y + n - 1 - s, w.z + fd[s], 0);
        queue[atomicAdd(&tail, 1)] = fx[s];
      }
    }
    __syncthreads();
    head = end;
    end = tail;
    __syncthreads();
  }
  for (int it = threadIdx.x; it < end; it += blockDim.x)
    atomicAdd(&first_count[inner[queue[it]].x], 1);
  __syncthreads();
  block_scan_in_place(first_count, p, nullptr);
  __syncthreads();
  for (int it = threadIdx.x; it < end; it += blockDim.x) {
    const int v = queue[it];
    const int first = inner[v].x;
    int index = first_count[first];
    for (int u = parent[v]; u >= 0 && inner[u].x == first; u = parent[u])
      index += wide[u].x > 0;
    wide[v].w = index;
  }
  if (threadIdx.x == 0) count[0] = end;
}

// 9. Each wide node's record at its preorder index: per child slot the
// wobbled box and the child word (the wide child's index, or ~first
// packed prim of a leaf); rows past the count zeroed.
__global__ void __launch_bounds__(kBlock)
    wide_build_nodes_kernel(int p, const int4* __restrict__ inner,
                            const float4* __restrict__ inner_box,
                            const float4* __restrict__ leaf_box,
                            const int4* __restrict__ front,
                            const int4* __restrict__ wide,
                            const int* __restrict__ count, int4* __restrict__ nodes,
                            int leaf_prims, long long* __restrict__ trace,
                            int counter) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int rows = max(p - 1, 1);
  long long v[1] = {0};
  if (t < rows) {
    const int n_wide = count[0];
    const bool one_leaf = p < 2 || !interior(inner, 0, leaf_prims);
    int n = 0, row = -1, fx[kWidth];
    if (one_leaf && t == 0) {
      n = 1;
      row = 0;
      fx[0] = p < 2 ? ~0 : 0;
    } else if (!one_leaf && wide[t].x > 0) {
      const int4 f = front[t];
      n = wide[t].x;
      row = wide[t].w;
      fx[0] = f.x;
      fx[1] = f.y;
      fx[2] = f.z;
      fx[3] = f.w;
    }
    if (row >= 0) {
      int rec[kNodeWords];
#pragma unroll
      for (int k = 0; k < kNodeWords; ++k) rec[k] = 0;
      for (int s = 0; s < n; ++s) {
        const int x = fx[s];
        float4 lo, hi;
        load_box(inner_box, leaf_box, x, lo, hi);
        const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float wob = 2e-6f + 1e-5f * nan_max(fabsf(l[k]), fabsf(h[k]));
          rec[2 * k * kWidth + s] = __float_as_int(l[k] - wob);
          rec[(2 * k + 1) * kWidth + s] = __float_as_int(h[k] + wob);
        }
        const int first = x >= 0 ? inner[x].x : ~x;
        rec[6 * kWidth + s] = interior(inner, x, leaf_prims) ? wide[x].w : ~first;
      }
      int4* out = nodes + (kNodeWords / 4) * (size_t)row;
#pragma unroll
      for (int k = 0; k < kNodeWords / 4; ++k)
        out[k] = make_int4(rec[4 * k], rec[4 * k + 1], rec[4 * k + 2], rec[4 * k + 3]);
      v[0] = 1;
    }
    if (t >= n_wide) {
      int4* out = nodes + (kNodeWords / 4) * (size_t)t;
#pragma unroll
      for (int k = 0; k < kNodeWords / 4; ++k) out[k] = make_int4(0, 0, 0, 0);
    }
  }
  if (!trace_on(trace)) return;  // the flag is the same for the whole block
  block_sum(v);
  if (threadIdx.x == 0) trace_add(trace, counter + 1, v[0]);
}

int blocks(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// pa, pb, pc [p + 1, 3] f32 -> nodes [max(p - 1, 1), 32] and prims [p,
// 12] int32, rewritten; the rest are the build's buffers
// (ops/wide_build.py::workspace, in WORK_ORDER): box [8] f32, codes [p],
// bucket [kBuckets + 1], cursor [kBuckets], slot [p], order [p], sorted
// [p], inner [p - 1, 4], parent [p - 1], leaf_parent [p] (-1 where p is
// 1), flag [p - 1], inner_box [p - 1, 8] f32, leaf_box [p, 8] f32, area
// [p - 1] f64, front [p - 1, 4], wide [p - 1, 4], queue [p - 1],
// first_count [p], count [4]; int32 where not said (p - 1 read as at
// least 1).  leaf_prims (1 to kSlots): the most prims a leaf holds
// (LEAF_PRIMS).
RT_EXPORT int rt_wide_build(const float* pa, const float* pb, const float* pc,
                            int p, float* box, int* codes, int* bucket,
                            int* cursor, int* slot, int* order, int* sorted,
                            int* inner, int* parent, int* leaf_parent,
                            int* flag, float* inner_box, float* leaf_box,
                            double* area, int* front, int* wide, int* queue,
                            int* first_count, int* count, int* nodes,
                            int* prims, int leaf_prims, long long* trace,
                            int counter, cudaStream_t stream) {
  if (p < 1 || leaf_prims < 1 || leaf_prims > kSlots) return (int)cudaErrorInvalidValue;
  int key_bits = 30;
  for (unsigned m = (unsigned)(p - 1); m; m >>= 1) ++key_bits;
  const int slack = kLocalStack - (kWidth - 1) - (key_bits - 1);
  if (slack < 0) return (int)cudaErrorInvalidValue;
  const Corners c{pa, pb, pc};
  auto* inner4 = reinterpret_cast<int4*>(inner);
  auto* ibox = reinterpret_cast<float4*>(inner_box);
  auto* lbox = reinterpret_cast<float4*>(leaf_box);
  cudaError_t err;
#define RT_LAUNCHED()                                 \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  wide_build_box_kernel<<<1, kOne, 0, stream>>>(c, p, box, bucket);
  RT_LAUNCHED();
  wide_build_codes_kernel<<<blocks(p), kBlock, 0, stream>>>(c, p, box, codes, bucket);
  RT_LAUNCHED();
  wide_build_scan_kernel<<<1, kOne, 0, stream>>>(bucket, cursor);
  RT_LAUNCHED();
  wide_build_scatter_kernel<<<blocks(p), kBlock, 0, stream>>>(p, codes, cursor, slot);
  RT_LAUNCHED();
  wide_build_rank_kernel<<<blocks(p), kBlock, 0, stream>>>(p, codes, bucket, slot, order, sorted);
  RT_LAUNCHED();
  if (p > 1) {
    wide_build_emit_kernel<<<blocks(p - 1), kBlock, 0, stream>>>(
        p, sorted, inner4, parent, leaf_parent, flag);
    RT_LAUNCHED();
  }
  wide_build_bounds_kernel<<<blocks(p), kBlock, 0, stream>>>(
      c, p, order, inner4, parent, leaf_parent, flag, ibox, lbox, area,
      reinterpret_cast<int4*>(prims), leaf_prims, trace, counter);
  RT_LAUNCHED();
  wide_build_collapse_kernel<<<1, kOne, 0, stream>>>(
      p, slack, leaf_prims, inner4, parent, area, reinterpret_cast<int4*>(front),
      reinterpret_cast<int4*>(wide), queue, first_count, count);
  RT_LAUNCHED();
  wide_build_nodes_kernel<<<blocks(p > 1 ? p - 1 : 1), kBlock, 0, stream>>>(
      p, inner4, ibox, lbox, reinterpret_cast<const int4*>(front),
      reinterpret_cast<const int4*>(wide), count, reinterpret_cast<int4*>(nodes),
      leaf_prims, trace, counter);
  RT_LAUNCHED();
#undef RT_LAUNCHED
  return (int)cudaSuccess;
}
