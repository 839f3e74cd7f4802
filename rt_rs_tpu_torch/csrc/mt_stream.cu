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
// t_max + 1) and pid [T, 128] i32 (0 on a miss).  Chunk j of a listed
// block is tested where its bit is set, with kernel B's test and
// exclusion (pid != excl, pid = 1 + chunk * tc + slot); the winner is
// the minimum t, ties to the smallest pid.  valid and t_cap are not
// read: they act through the host's cull only, as on the TPU.
//
// Design.  The blocks, words and group lists are the TPU's mechanism
// for streaming blocks through VMEM; the function they define is, per
// tile, the closest hit over the set chunks of its group's listed
// blocks.  The first port walked that list with one CTA per tile,
// staging a whole block (two, double-buffered) even where one chunk bit
// was set; the tiles' lists are very uneven, so the grid lasted as long
// as the longest one (~10x its arithmetic bound).  Here:
// * an expansion launch turns each tile's words into its ascending list
//   of set chunk ids (one warp per tile: the group's listed blocks 32 at
//   a time, a warp scan of their popcounts, each lane writing its
//   block's set bits), which is ascending pid order;
// * kernel B's balanced items (mt_items.cuh) run those lists: a
//   prologue launch and a persistent items launch, ITEM_STREAM entries
//   (chunks) per item, the per-ray (t, pid) key merged with atomicMin.
//   The lexicographic minimum over a tile's set chunks is what the TPU
//   kernel's ascending strict scan keeps, in any order of the items.
// Three launches, no host read.
//
// What bounds it on this card: f32 arithmetic, 39 operations per (ray,
// triangle) pair before the rare division, the chunk read from shared
// memory as a broadcast.
#include "mt_items.cuh"

namespace {

constexpr int kLanes = 128;     // rays per tile (one thread each)
constexpr int kTileGroup = 32;  // tiles per block list
constexpr int kExpandThreads = 256;

// Chunks per work item (mirrored by ops/packet_stream.py's
// STREAM_ITEM_SIZE for the plain-PyTorch mirror).
enum { ITEM_STREAM = 4 };

// ids[t, 0:tile_counts[t]] = the chunks (block * cpb + bit) whose bit is
// set in words[t, b] for the listed blocks b of t's group, ascending.
__global__ void __launch_bounds__(kExpandThreads) mt_stream_expand_kernel(
    const int* __restrict__ words, const int* __restrict__ blockids,
    const int* __restrict__ counts, int* __restrict__ ids,
    int* __restrict__ tile_counts, int n_tiles, int nb, int cpb) {
  const int tile = (int)(((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= n_tiles) return;  // whole warps: n_tiles is per warp
  const int group = tile / kTileGroup;
  const int n = counts[group];
  const int* list = blockids + (long)group * nb;
  const int* tile_words = words + (long)tile * nb;
  int* out = ids + (long)tile * nb * cpb;
  int total = 0;
  for (int base = 0; base < n; base += 32) {
    int blk = 0;
    unsigned w = 0u;
    if (base + lane < n) {
      blk = list[base + lane];
      w = (unsigned)tile_words[blk];
    }
    const int pc = __popc(w);
    int x = pc;  // inclusive warp scan of the popcounts
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    int pos = total + x - pc;
    while (w) {
      out[pos++] = blk * cpb + (__ffs((int)w) - 1);
      w &= w - 1u;
    }
    total += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) tile_counts[tile] = total;
}

__global__ void __launch_bounds__(kPrologueThreads) mt_stream_prologue_kernel(
    const int* __restrict__ tile_counts, float* __restrict__ out_t,
    int* __restrict__ out_pid, unsigned long long* __restrict__ keys,
    int* __restrict__ work, int n_tiles, float miss) {
  items_prologue<MODE_CLOSEST, ITEM_STREAM, false>(
      tile_counts, nullptr, out_t, out_pid, nullptr, nullptr, keys, work,
      n_tiles, kLanes, miss);
}

__global__ void __launch_bounds__(kLanes) mt_stream_items_kernel(
    const float* __restrict__ payload, const float* __restrict__ table,
    const int* __restrict__ ids, const int* __restrict__ tile_counts,
    float* __restrict__ out_t, int* __restrict__ out_pid,
    unsigned long long* __restrict__ keys, int* __restrict__ work,
    int n_tiles, int nc, int tc, float t_min, float t_max, float eps,
    float miss) {
  items_body<ChunkRows, MODE_CLOSEST, ITEM_STREAM, false>(
      payload, table, ids, tile_counts, nullptr, nullptr, nullptr, out_t,
      out_pid, nullptr, nullptr, keys, work, n_tiles, kLanes, nc, tc, 0, t_min,
      t_max, eps, miss, 1);
}

}  // namespace

// Scratch the wrapper allocates: `ids` [T, nb * cpb] and `tile_counts`
// [T] int32 (the expanded lists), `keys` [T * 128] u64, `work` [4 T + 4]
// int32.
RT_EXPORT int rt_mt_stream(const float* payload, const float* table,
                           const int* words, const int* blockids,
                           const int* counts, int* ids, int* tile_counts,
                           unsigned long long* keys, int* work, float* out_t,
                           int* out_pid, int n_tiles, int nb, int cpb, int tc,
                           float t_min, float t_max, float eps, float miss,
                           cudaStream_t stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  const size_t smem = 2 * (size_t)tc * 12 * sizeof(float);
  const Residency res = persistent_blocks(mt_stream_items_kernel, kLanes, smem);
  if (res.blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const long threads = (long)n_tiles * 32;
  mt_stream_expand_kernel<<<(int)((threads + kExpandThreads - 1) /
                                  kExpandThreads),
                            kExpandThreads, 0, stream>>>(
      words, blockids, counts, ids, tile_counts, n_tiles, nb, cpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mt_stream_prologue_kernel<<<prologue_blocks((long)n_tiles * kLanes,
                                              res.sms),
                              kPrologueThreads, 0, stream>>>(
      tile_counts, out_t, out_pid, keys, work, n_tiles, miss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nc = nb * cpb;
  const long most = (long)n_tiles * ((nc + ITEM_STREAM - 1) / ITEM_STREAM);
  mt_stream_items_kernel<<<items_grid(most, res.blocks), kLanes, smem,
                           stream>>>(payload, table, ids, tile_counts, out_t,
                                     out_pid, keys, work, n_tiles, nc, tc,
                                     t_min, t_max, eps, miss);
  return (int)cudaGetLastError();
}
