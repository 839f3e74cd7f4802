"""Ranks: one process per device in a ``torch.distributed`` group.

The JAX package renders over ``jax.devices()`` from one process; the
PyTorch idiom is one process per rank.  :func:`run_ranks` is the
port's counterpart of that in-process device list: it spawns one rank
per entry of ``devices``, joins them into one process group on a free
local TCP port, runs ``fn(rank, *args)`` in each and hands the results
back to the caller, or raises.

``fn`` must live in an importable module (not under a bare
``if __name__ == "__main__":`` block and not in a test file), because a
spawned rank starts from a fresh interpreter and imports it by name.
Build every kernel before the spawn (``ops.cuda.build()``,
``native.build()``), so that the ranks only load what is built.

The backend rule, decided here and nowhere else (:func:`backend_for`):
NCCL when every rank has a CUDA device of its own; gloo when ranks
share a card or run on the CPU.  NCCL refuses two ranks on one GPU, so
several ranks on one card run over gloo, which takes CUDA tensors and
moves them through host memory itself.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# Seconds a whole run_ranks call may take by default, spawn and set-up
# included; a collective's own timeout is never shorter (the caller's
# deadline, not the group's, decides that a run hung).
RANK_TIMEOUT_S = 600.0

# This process's rank device, set by the launcher in each rank.
_rank_device: torch.device | None = None


def backend_for(devices: Sequence[str | torch.device]) -> str:
    """``"nccl"`` when every rank has a CUDA device of its own, else
    ``"gloo"`` (ranks that share a card, or CPU ranks)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs):
        idx = [torch.device("cuda", d.index or 0) for d in devs]
        if len(set(idx)) == len(idx):
            return "nccl"
    return "gloo"


def rank_device() -> torch.device:
    """The device of this rank, as :func:`run_ranks` set it."""
    if _rank_device is None:
        raise RuntimeError("not inside a rank: start the ranks with run_ranks")
    return _rank_device


def _free_port() -> int:
    """A TCP port on localhost that nothing listened on just now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, devices, backend, port, timeout_s, fn, args, results) -> None:
    """A rank: join the group, set the device, run ``fn`` and report
    ``(rank, ok, result or traceback)``."""
    global _rank_device
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            # CPU ranks share the host's cores rather than each taking all.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
        _rank_device = device
        dist.init_process_group(
            backend,
            init_method=f"tcp://localhost:{port}",
            world_size=len(devices),
            rank=rank,
            timeout=datetime.timedelta(seconds=max(timeout_s, RANK_TIMEOUT_S)),
        )
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(
    fn: Callable[..., Any],
    devices: Sequence[str | torch.device],
    *args,
    timeout: float = RANK_TIMEOUT_S,
) -> list[Any]:
    """Run ``fn(rank, *args)`` in one spawned process per entry of
    ``devices`` (rank ``i`` on ``devices[i]``), all in one process group
    over :func:`backend_for`'s backend -> the ranks' results in rank
    order.  Results cross processes by pickling: return NumPy arrays
    or plain values, not tensors.  The backend is printed.

    Raises ``RuntimeError`` (with the rank's traceback) when a rank
    raises or dies, and ``TimeoutError`` when the ranks have not all
    finished within ``timeout`` seconds; the other ranks are then
    stopped.  A partial result is never returned."""
    devices = [str(d) for d in devices]
    if not devices:
        raise ValueError("run_ranks needs at least one device")
    backend = backend_for(devices)
    shared = "" if backend == "nccl" else " (ranks share a card or run on the CPU)"
    print(f"[ranks] {len(devices)} ranks on {devices} over {backend}{shared}", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(rank, devices, backend, port, timeout, fn, args, results),
            daemon=True,
        )
        for rank in range(len(devices))
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out: dict[int, Any] = {}
    try:
        # Drain the queue before joining: a rank blocks on exit until
        # its result has been read.
        while len(out) < len(procs):
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [
                    i for i, p in enumerate(procs)
                    if i not in out and not p.is_alive() and p.exitcode != 0
                ]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} died (exit code {procs[dead[0]].exitcode}) "
                        "without a result"
                    ) from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(len(procs))) - set(out))} did not "
                        f"finish within {timeout} s"
                    ) from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} raised:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError(f"rank process {p.pid} did not exit after its result")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(len(procs))]


__all__ = ["RANK_TIMEOUT_S", "backend_for", "rank_device", "run_ranks"]
