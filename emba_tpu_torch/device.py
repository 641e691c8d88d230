"""Device helpers of the port."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def require_cuda() -> torch.device:
    """This process's CUDA device, the current one; raises RuntimeError
    when there is none. A rank of a sharded run has its own card current
    (``dist.init`` maps the rank to it: ``LOCAL_RANK`` or the rank); any
    other process has device 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path runs on the GPU only")
    return torch.device("cuda", torch.cuda.current_device())


def full_precision() -> None:
    """Keep f32 products in full f32: TF32 off for matmuls and cuDNN (the
    reference measured one-pass reduced precision in forming as 42x
    noisier)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def add_at(out, idx, vals):
    """``out[idx] += vals`` with repeated indices summed in a fixed order, so
    that a run repeats bit for bit: ``index_add_`` on the CPU, and on CUDA
    ``index_put_(accumulate=True)``, which sorts the indices (stably) and
    adds each index's values in that order where ``index_add_`` would add
    them by atomics in no fixed order. Returns ``out``."""
    if out.device.type == "cuda":
        return out.index_put_((idx,), vals, accumulate=True)
    return out.index_add_(0, idx, vals)


def cuda_time_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``reps`` runs of ``fn`` after one warm-up,
    each between two CUDA events on the current stream."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_mallocs() -> int:
    """Segments the caching allocator has taken from the driver
    (``cudaMalloc`` calls) in this process so far."""
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def host_time_ms(fn, reps: int = 5) -> float:
    """Median milliseconds the host spends in ``fn`` (its dispatch: the
    call returns before its kernels end) over ``reps`` runs after one
    warm-up, each started on an idle device."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def graph_time_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``reps`` replays of ``fn`` captured in a CUDA
    graph (as the fused window runs its phases: no host work between the
    kernels), after a warm-up off the capturing stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_time_ms(graph.replay, reps)
    del graph
    return ms
