"""The card's practical f32 rate: register-resident FMA chains.

Counterpart of part 1 of ``experiments/roofline.py`` (TPU kernel 7,
``_fma_kernel``): 16 independent chains per output element, each
stepped ``iters`` times as ``acc = acc * 0.999999 + 1e-7`` from
``x[8c + r] + c``, then summed in chain order.  Kernel G
(``csrc/fma_peak.cu``, :func:`fma_chains`) computes it with one thread
per output element in two variants: ``fused`` (one explicit ``fmaf``
per step, the FFMA throughput the data sheet's 67 TFLOP/s assumes) and
``separate`` (a rounded multiply then a rounded add, what every
``-fmad=false`` kernel of this port executes for a multiply-add).
:func:`practical_peak` times it at the JAX sizes.

Parts 2 and 3 of the JAX file (a counting frame for the culled list
entries, and the MT kernels' profiler times) have their card
counterparts in ``chip_smoke.py``: the list entries and CUDA-event
kernel times of its kernel-time phase and the ``torch.profiler``
breakdown of its profile phase.
"""

from __future__ import annotations

import time

import torch

from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops.packet_trace import _f32

CHAINS = 16  # independent accumulator chains per output element
ROWS, COLS = 8, 128  # one chain's block
ITERS, GRID, REPS = 4096, 256, 10  # the JAX probe's sizes and reps
STEP_A, STEP_B = 0.999999, 1e-7


def fma_chains_reference(x: torch.Tensor, iters: int, fused: bool) -> torch.Tensor:
    """Plain-PyTorch twin of kernel G: x [grid * 128, 128] -> [grid * 8,
    128].  ``separate`` rounds the multiply and the add (bit-equal to
    the kernel); ``fused`` rounds each step once, through f64, whose
    exact product leaves only a rare double rounding of the sum."""
    g = x.shape[0] // (CHAINS * ROWS)
    dev = x.device
    acc = x.reshape(g, CHAINS, ROWS, COLS).transpose(0, 1)  # [CHAINS, g, 8, 128]
    acc = acc + torch.arange(CHAINS, dtype=torch.float32, device=dev).view(-1, 1, 1, 1)
    a, b = _f32(STEP_A, dev), _f32(STEP_B, dev)
    if fused:
        a64, b64 = a.double(), b.double()
        for _ in range(iters):
            acc = (acc.double() * a64 + b64).float()
    else:
        for _ in range(iters):
            acc = acc * a + b
    out = acc[0]
    for c in range(1, CHAINS):
        out = out + acc[c]
    return out.reshape(g * ROWS, COLS)


def fma_chains(x: torch.Tensor, iters: int = ITERS, fused: bool = True) -> torch.Tensor:
    """Kernel G (csrc/fma_peak.cu), counted as ``fma_peak[fused]`` or
    ``fma_peak[separate]``.  CPU tensors run
    :func:`fma_chains_reference`; CUDA tensors launch the kernel."""
    if x.dim() != 2 or x.shape[1] != COLS or x.shape[0] % (CHAINS * ROWS):
        raise ValueError(f"x: shape {tuple(x.shape)}, expected [grid * 128, 128]")
    if not x.is_cuda:
        return fma_chains_reference(x, iters, fused)
    grid = x.shape[0] // (CHAINS * ROWS)
    cuda.check("x", x, torch.float32, (grid * CHAINS * ROWS, COLS), x.device)
    out = torch.empty((grid * ROWS, COLS), dtype=torch.float32, device=x.device)
    cuda.call(
        "fma_peak[fused]" if fused else "fma_peak[separate]", "rt_fma_peak",
        x.data_ptr(), out.data_ptr(), grid, int(iters), int(bool(fused)),
    )
    return out


def peak_flops(iters: int = ITERS, grid: int = GRID) -> float:
    """f32 operations of one :func:`fma_chains` call: a multiply and an
    add per chain step, fused or not."""
    return 2.0 * iters * CHAINS * ROWS * COLS * grid


def practical_peak(device: str | torch.device = "cuda", fused: bool = True) -> float:
    """Achieved f32 FLOP/s of :func:`fma_chains` at ITERS and GRID (one
    warm-up call, then REPS calls timed with CUDA events on a GPU, the
    host clock on the CPU)."""
    x = torch.ones((GRID * CHAINS * ROWS, COLS), dtype=torch.float32, device=device)
    fma_chains(x, ITERS, fused)  # build + warm
    if x.is_cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(REPS):
            fma_chains(x, ITERS, fused)
        end.record()
        torch.cuda.synchronize(x.device)
        dt = start.elapsed_time(end) / 1e3 / REPS
    else:
        t0 = time.perf_counter()
        for _ in range(REPS):
            fma_chains(x, ITERS, fused)
        dt = (time.perf_counter() - t0) / REPS
    return peak_flops(ITERS, GRID) / dt
