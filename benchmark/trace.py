"""The traced run: ``torch.profiler`` over the measured window, named host
ranges put around the program's layers from here, and the reduction of the
trace to device time by LM phase, the device's busy time, the top device
operations and the idle gaps by what the host was doing.

The program's fused window replays four CUDA graphs (``lm.GraphedLoop``:
objective, form, solve, schedule). :func:`ranges` wraps
``lm.CapturedPhase.replay`` for the run in a range named after the phase,
and each kernel a replay launches carries the correlation id of the graph
launch made inside that range, which ties the kernel's device time to its
phase. The host ranges (the pipeline's constructor and run, its window
preparation, pose fit, pairing and upload, the fused solve) name the idle
gaps. The program's code is not edited: the wrappers are set and removed
here.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import os
import tempfile
import weakref

import torch

PHASES = ("objective", "form", "solve", "schedule")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench."
# idle gaps shorter than this are summed as "between_ops", unlabelled
SHORT_GAP_US = 20.0


def _wrap(owner, attr, label, kind=None):
    """Replace ``owner.attr`` by a wrapper that runs it in a profiler range
    named ``label``; returns the restore function."""
    orig = owner.__dict__[attr]
    fn = orig.__func__ if kind is classmethod else orig

    @functools.wraps(fn)
    def wrapper(*a, **k):
        with torch.profiler.record_function(PREFIX + label):
            return fn(*a, **k)

    setattr(owner, attr, classmethod(wrapper) if kind is classmethod else wrapper)
    return lambda: setattr(owner, attr, orig)


@contextlib.contextmanager
def ranges():
    """Named ranges around the program's layers and its graph replays."""
    from emba_tpu_torch import lm, model, pairing, pipeline, solver, spline

    names = weakref.WeakKeyDictionary()
    run0, replay0 = lm.GraphedLoop.run, lm.CapturedPhase.replay

    def run(self, *a, **k):
        for name, g in zip(PHASES, (self.g_obj, self.g_form, self.g_solve, self.g_sched)):
            names[g] = name
        return run0(self, *a, **k)

    def replay(self):
        with torch.profiler.record_function(PREFIX + "phase." + names.get(self, "other")):
            return replay0(self)

    lm.GraphedLoop.run, lm.CapturedPhase.replay = run, replay
    undo = [lambda: setattr(lm.GraphedLoop, "run", run0),
            lambda: setattr(lm.CapturedPhase, "replay", replay0)]
    undo += [_wrap(pipeline.EmbaPipeline, "__init__", "pipeline.init"),
             _wrap(pipeline.EmbaPipeline, "run", "pipeline.run"),
             _wrap(pipeline.EmbaPipeline, "_prepare_window", "pipeline.prepare"),
             _wrap(spline, "fit_knots_long", "pipeline.pose_fit"),
             _wrap(pairing, "build_window", "pipeline.pairing"),
             _wrap(model.DeviceWindow, "from_window", "pipeline.upload", classmethod),
             _wrap(solver, "solve_window_fused", "solver.fused_window")]
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


def job_range():
    return torch.profiler.record_function(PREFIX + "job")


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def events(prof) -> list[dict]:
    """The complete events of a finished profile, through its Chrome trace
    (written to a temporary file under TMPDIR and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(evs: list[dict], top: int = 10) -> dict:
    """Reduce a trace (:func:`events`) to seconds: the traced window (from
    the first job range's start to the last one's end), the device's busy
    time in it (the union of its operations), the device time of each LM
    phase, the ``top`` device operations by total time and the ``top``
    idle gaps summed by the innermost host range around each (a gap
    outside every range is ``host``; gaps under ``SHORT_GAP_US`` are
    ``between_ops``)."""
    jobs = [e for e in evs if e.get("name") == PREFIX + "job"
            and e.get("cat") != "gpu_user_annotation"]
    if not jobs:
        return {}
    w0 = min(e["ts"] for e in jobs)
    w1 = max(e["ts"] + e["dur"] for e in jobs)
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev
                   if e["ts"] + e["dur"] > w0 and e["ts"] < w1])
    busy_us = sum(e - s for s, e in busy)

    host = [e for e in evs if str(e.get("name", "")).startswith(PREFIX)
            and e.get("cat") != "gpu_user_annotation"]
    phase_ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX + "phase."):])
                          for e in host if e["name"].startswith(PREFIX + "phase."))
    starts = [r[0] for r in phase_ranges]
    phase_of = {}
    for e in evs:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None or e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and phase_ranges[i][0] <= e["ts"] <= phase_ranges[i][1]:
            phase_of[corr] = phase_ranges[i][2]
    phase_us = collections.Counter()
    ops = collections.Counter()
    for e in dev:
        ops[e["name"]] += e["dur"]
        ph = phase_of.get((e.get("args") or {}).get("correlation"))
        if ph is not None:
            phase_us[ph] += e["dur"]

    gaps = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        if e - s < SHORT_GAP_US:
            gaps["between_ops"] += e - s
            continue
        mid = 0.5 * (s + e)
        inner = [h for h in host if h["ts"] <= mid <= h["ts"] + h["dur"]]
        label = min(inner, key=lambda h: h["dur"])["name"][len(PREFIX):] if inner else "host"
        gaps[label] += e - s
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "phase_s": {k: v * 1e-6 for k, v in phase_us.items()},
        "device_ops": [[n[:160], v * 1e-6] for n, v in ops.most_common(top)],
        "idle_gaps": [[n, v * 1e-6] for n, v in gaps.most_common(top)],
    }
