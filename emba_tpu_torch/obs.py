"""Observability: profiler traces, NaN checks, phase timers, structured logs
(counterpart of ``emba_tpu/obs.py``).

* :func:`profiler_trace` — ``torch.profiler`` over a scope, with CUDA
  activity when the device is CUDA; writes a Chrome trace.
* :func:`nan_debug` — within its scope the pipeline checks each window's
  knots, maps and final cost with ``torch.isfinite`` and raises
  ``FloatingPointError`` naming the window (the reference's CHECK_*
  assertions on the numerics). Off by default, and then nothing is checked.
* :class:`PhaseTimer` — accumulating wall-clock phase timer that
  synchronizes the device before it reads the clock.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger("emba_tpu_torch")

_NAN_CHECKS = contextvars.ContextVar("emba_tpu_torch_nan_checks", default=False)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None, device=None):
    """Trace the scope with ``torch.profiler`` (CPU activity, plus CUDA
    activity when ``device`` is a CUDA device) and write
    ``<log_dir>/trace.json`` (Chrome trace format). No-op if dir None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def nan_debug(enabled: bool = True):
    """Turn the per-window finiteness checks on within the scope
    (:func:`check_finite`)."""
    token = _NAN_CHECKS.set(bool(enabled))
    try:
        yield
    finally:
        _NAN_CHECKS.reset(token)


def nan_checks_enabled() -> bool:
    return _NAN_CHECKS.get()


def check_finite(where: str, **values) -> None:
    """Raise FloatingPointError naming ``where`` and the first non-finite
    value (tensors, arrays or scalars)."""
    for name, v in values.items():
        ok = (bool(torch.isfinite(v).all()) if isinstance(v, torch.Tensor)
              else bool(np.isfinite(np.asarray(v)).all()))
        if not ok:
            raise FloatingPointError(f"{where}: non-finite {name}")


class PhaseTimer:
    """Accumulating wall-clock phase timer, mirroring the reference's static
    chrono accumulators (solver.cpp:105-151). A phase given ``block_on``
    (a tensor) ends with a synchronization of that tensor's CUDA device."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if isinstance(block_on, torch.Tensor) and block_on.device.type == "cuda":
            torch.cuda.synchronize(block_on.device)
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


def log_iteration(it: int, lam: float, cost_min: float, cost_new: float, **extra):
    """Structured per-iteration log line (reference VLOG(0) at
    solver.cpp:170-171)."""
    log.info(
        "iter #%d: log10(lambda)=%.2f cost_min=%.6g cost_new=%.6g %s",
        it,
        np.log10(lam),
        cost_min,
        cost_new,
        " ".join(f"{k}={v}" for k, v in extra.items()),
    )
