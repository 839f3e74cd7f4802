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
// Design: balanced work items and an exact merge (mt_items.cuh, shared
// with kernel E).  The per-tile walk it replaces lasted as long as the
// longest list of the call: ~10 us per entry of the longest tile, ~8-20x
// its arithmetic bound (the canyon's segment calls: mean 0.9-2.2
// entries, max 128; torus primaries: mean 4-7, max 99).  Closest, rows
// and any-hit, and early exit (the closest and rows modes with `ed`
// given; the TPU kernel's early_exit branches, packet_trace.py:837-846,
// :859-891 and :926-942): a prologue launch and one items launch.  Early
// exit's items are each listed tile's lead (its first ITEM_EXIT
// entries, the TPU kernel's per-tile stop rule) and its later items,
// bounded by the lead's snapshot; exact on valid rays and deterministic
// (mt_items.cuh).
#include "mt_items.cuh"

namespace {

// Entries per work item of the balanced design, per mode, and of early
// exit's items (mirrored by ops/packet_trace.py's MT_ITEM_SIZES and
// MT_EXIT_ITEM_SIZE for the plain-PyTorch mirrors).
enum { ITEM_CLOSEST = 2, ITEM_ROWS = 2, ITEM_ANYHIT = 1 };
enum { ITEM_EXIT = 4 };

template <int MODE, bool EXIT>
__host__ __device__ constexpr int item_entries() {
  return EXIT ? ITEM_EXIT
              : (MODE == MODE_CLOSEST ? ITEM_CLOSEST
                                      : (MODE == MODE_ROWS ? ITEM_ROWS : ITEM_ANYHIT));
}

template <int MODE, bool EXIT>
__global__ void __launch_bounds__(kPrologueThreads) mt_trace_prologue_kernel(
    const int* __restrict__ counts, const float* __restrict__ attr,
    float* __restrict__ out_t, int* __restrict__ out_pid,
    float* __restrict__ out_rows, bool* __restrict__ out_blocked,
    unsigned long long* __restrict__ keys, int* __restrict__ work,
    int n_tiles, int r, float miss, long long* __restrict__ trace,
    int counter) {
  items_prologue<MODE, item_entries<MODE, EXIT>(), EXIT>(
      counts, attr, out_t, out_pid, out_rows, out_blocked, keys, work, n_tiles,
      r, miss);
  // The entries the call's cull kept, while the trace flag is set.
  if (blockIdx.x == 0 && trace_on(trace)) {
    long long kept[1] = {0};
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) kept[0] += counts[t];
    block_sum(kept);
    if (threadIdx.x == 0) trace_add(trace, counter, kept[0]);
  }
}

template <int MODE, bool EXIT>
__global__ void __launch_bounds__(1024) mt_trace_items_kernel(
    const float* __restrict__ payload, const float* __restrict__ comp,
    const int* __restrict__ ids, const int* __restrict__ counts,
    const float* __restrict__ attr, const float* __restrict__ ed,
    float* __restrict__ lead, float* __restrict__ out_t,
    int* __restrict__ out_pid, float* __restrict__ out_rows,
    bool* __restrict__ out_blocked, unsigned long long* __restrict__ keys,
    int* __restrict__ work, int n_tiles, int r, int nc, int tc, int pid_base,
    float t_min, float t_max, float eps, float miss, int exit_check) {
  items_body<ChunkRows, MODE, item_entries<MODE, EXIT>(), EXIT>(
      payload, comp, ids, counts, attr, ed, lead, out_t, out_pid, out_rows,
      out_blocked, keys, work, n_tiles, r, nc, tc, pid_base, t_min, t_max, eps,
      miss, exit_check);
}

template <int MODE, bool EXIT>
int launch(const float* payload, const float* comp, const int* ids,
           const int* counts, const float* attr, const float* ed, float* lead,
           float* out_t, int* out_pid, float* out_rows, bool* out_blocked,
           unsigned long long* keys, int* work, int n_tiles, int r, int nc,
           int tc, int pid_base, float t_min, float t_max, float eps,
           float miss, int exit_check, long long* trace, int counter,
           cudaStream_t stream) {
  constexpr int E = item_entries<MODE, EXIT>();
  const size_t smem = 2 * (size_t)tc * 12 * sizeof(float);
  const Residency res =
      persistent_blocks(mt_trace_items_kernel<MODE, EXIT>, r, smem);
  if (res.blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  mt_trace_prologue_kernel<MODE, EXIT>
      <<<prologue_blocks((long)n_tiles * r, res.sms), kPrologueThreads, 0,
         stream>>>(counts, attr, out_t, out_pid, out_rows, out_blocked, keys,
                   work, n_tiles, r, miss, trace, counter);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // No more blocks than items could exist.
  const long most = (long)n_tiles * ((nc + E - 1) / E);
  mt_trace_items_kernel<MODE, EXIT>
      <<<items_grid(most, res.blocks), r, smem, stream>>>(
          payload, comp, ids, counts, attr, ed, lead, out_t, out_pid, out_rows,
          out_blocked, keys, work, n_tiles, r, nc, tc, pid_base, t_min, t_max,
          eps, miss, exit_check);
  return (int)cudaGetLastError();
}

}  // namespace

// While the trace buffer's flag is set (tracing.py), the prologue's
// block 0 adds the sum of `counts`, the entries the call's cull kept,
// to counter `counter` (a cull_entries counter; null `trace`: none).
// Scratch the wrapper allocates: `work` [4 T + 4] int32; `keys`
// [T * r] u64 for the closest and rows modes; with `ed`, `lead` [T * r +
// T] f32.  Modes: 0 closest, 1 rows, 2 any-hit; `ed` (closest and rows)
// selects early exit.
RT_EXPORT int rt_mt_trace(const float* payload, const float* comp,
                          const int* ids, const int* counts,
                          const float* attr, const float* ed, float* out_t,
                          int* out_pid, float* out_rows, bool* out_blocked,
                          unsigned long long* keys, int* work, float* lead,
                          int n_tiles, int r, int nc, int tc, int pid_base,
                          float t_min, float t_max, float eps, float miss,
                          int mode, int exit_check, long long* trace,
                          int counter, cudaStream_t stream) {
  if (mode < MODE_CLOSEST || mode > MODE_ANYHIT || work == nullptr ||
      (mode != MODE_ANYHIT && keys == nullptr))
    return (int)cudaErrorInvalidValue;
  if (ed != nullptr &&
      (mode == MODE_ANYHIT || exit_check < 1 || lead == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0) return (int)cudaGetLastError();
#define RT_LAUNCH(M, X)                                                     \
  launch<M, X>(payload, comp, ids, counts, attr, ed, lead, out_t, out_pid,  \
               out_rows, out_blocked, keys, work, n_tiles, r, nc, tc,       \
               pid_base, t_min, t_max, eps, miss, exit_check, trace, counter, \
               stream)
  if (ed != nullptr)
    return mode == MODE_CLOSEST ? RT_LAUNCH(MODE_CLOSEST, true)
                                : RT_LAUNCH(MODE_ROWS, true);
  if (mode == MODE_CLOSEST) return RT_LAUNCH(MODE_CLOSEST, false);
  if (mode == MODE_ROWS) return RT_LAUNCH(MODE_ROWS, false);
  return RT_LAUNCH(MODE_ANYHIT, false);
#undef RT_LAUNCH
}
