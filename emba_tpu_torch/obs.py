"""Observability: run records of spans and counters, profiler traces, NaN
checks (counterpart of ``emba_tpu/obs.py``).

* :class:`Record`, :func:`recording`, :func:`span`, :func:`count`,
  :func:`runs` — the run record. One run (``pipeline.EmbaPipeline``, from
  its constructor's first line to ``run()``'s return) opens a
  :class:`Record`; while it is the context's record, :func:`span` records
  each named interval (start, duration, thread, span id and the id of the
  span that caused it) and :func:`count` adds to its counters. A thread
  that runs a copy of the context (``contextvars.copy_context().run``)
  records into the same run. With no record open, both record nothing and
  cost one context-variable read. Spans that repeat once per LM step
  (``repeats=True``) are kept as per-name totals and counts. :func:`runs`
  holds the process's last :data:`KEEP_RUNS` finished records.
* :func:`profiler_trace` — ``torch.profiler`` over a scope, with CUDA
  activity when the device is CUDA; writes a Chrome trace, with the spans
  of the runs' other threads (which the profiler does not record) added.
  While a profiler is active, a span on its run's own thread also opens a
  ``record_function`` range named ``emba.<name>``, so it lands in the
  trace on the device trace's clock.
* :func:`nan_debug` — within its scope the pipeline checks each window's
  knots, maps and final cost with ``torch.isfinite`` and raises
  ``FloatingPointError`` naming the window (the reference's CHECK_*
  assertions on the numerics). Off by default, and then nothing is checked.

Clock: a span's start is ``time.time_ns()``, which is the profiler's CPU
clock (an exported trace's ``ts + baseTimeNanoseconds / 1000``, in µs), and
its duration is ``time.perf_counter_ns()`` over the span.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
import typing

import numpy as np
import torch

# the name prefix of the program's profiler ranges
PREFIX = "emba."
# finished run records kept by the process (runs())
KEEP_RUNS = 64

_NAN_CHECKS = contextvars.ContextVar("emba_tpu_torch_nan_checks", default=False)
_RECORD = contextvars.ContextVar("emba_tpu_torch_record", default=None)
_PARENT = contextvars.ContextVar("emba_tpu_torch_span", default=None)
_RUNS: collections.deque = collections.deque(maxlen=KEEP_RUNS)
_RUN_IDS = itertools.count(1)


class Span(typing.NamedTuple):
    name: str
    start_ns: int  # time.time_ns() at the start
    dur_ns: int  # perf_counter_ns() over the span
    thread: int  # threading.get_native_id() of the thread it ran on
    id: int
    parent: int | None  # the span open where this one was started

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.dur_ns


_THREAD = threading.local()


def _thread_id() -> int:
    """``threading.get_native_id()`` (the id the profiler's trace gives a
    thread), asked of the system once a thread."""
    tid = getattr(_THREAD, "id", None)
    if tid is None:
        tid = _THREAD.id = threading.get_native_id()
    return tid


def _covered_ns(intervals, lo: int, hi: int) -> int:
    """The length of the union of ``intervals`` inside [lo, hi]."""
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


class Record:
    """The spans and counters of one run. ``run_id`` is unique in the
    process; ``thread`` is the thread that opened the run, the only one
    whose spans open profiler ranges. Spans and counters may be added from
    several threads."""

    def __init__(self):
        self.run_id = next(_RUN_IDS)
        self.thread = _thread_id()
        self.start_ns = time.time_ns()
        self.end_ns: int | None = None
        self.spans: list[Span] = []
        self.repeats: dict[str, list] = {}  # name -> [total ns, count]
        self.counters: dict[str, int] = {}
        self._repeat_ns = collections.Counter()  # parent span id -> ns of repeats
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def _add(self, span: Span):
        with self._lock:
            self.spans.append(span)

    def _add_repeat(self, name: str, dur_ns: int, parent: int | None):
        with self._lock:
            tot = self.repeats.setdefault(name, [0, 0])
            tot[0] += dur_ns
            tot[1] += 1
            self._repeat_ns[parent] += dur_ns

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def named(self, name: str) -> list[Span]:
        """The finished spans called ``name``, in the order they ended."""
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def totals(self) -> dict:
        """{name: {"total_s", "self_s", "count"}} over the finished spans. A
        span's self time is its duration less the part of it that its child
        spans cover (repeating children by their summed time)."""
        with self._lock:
            spans = list(self.spans)
            repeats = {k: tuple(v) for k, v in self.repeats.items()}
            repeat_ns = collections.Counter(self._repeat_ns)
        children = collections.defaultdict(list)
        for s in spans:
            children[s.parent].append((s.start_ns, s.end_ns))
        out = {}
        for s in spans:
            covered = _covered_ns(children[s.id], s.start_ns, s.end_ns) + repeat_ns[s.id]
            t = out.setdefault(s.name, {"total_s": 0.0, "self_s": 0.0, "count": 0})
            t["total_s"] += s.dur_ns * 1e-9
            t["self_s"] += max(0, s.dur_ns - covered) * 1e-9
            t["count"] += 1
        for name, (tot, n) in repeats.items():
            out[name] = {"total_s": tot * 1e-9, "self_s": tot * 1e-9, "count": n}
        return out

    def finish(self):
        """End the run: stamp its end and keep it in :func:`runs`."""
        self.end_ns = time.time_ns()
        _RUNS.append(self)


@contextlib.contextmanager
def recording(record: Record):
    """Make ``record`` the context's run record within the scope (its spans
    start with no parent)."""
    rec_token, parent_token = _RECORD.set(record), _PARENT.set(None)
    try:
        yield record
    finally:
        _PARENT.reset(parent_token)
        _RECORD.reset(rec_token)


def runs() -> list[Record]:
    """The process's last :data:`KEEP_RUNS` finished run records, newest
    last."""
    return list(_RUNS)


def profiling() -> bool:
    """Whether a ``torch.profiler`` is recording in this process."""
    return torch.autograd.profiler._is_profiler_enabled


class _Span:
    """The context manager of :func:`span` while a record is open."""

    __slots__ = ("rec", "name", "repeats", "id", "parent", "token", "range", "start",
                 "t0")

    def __init__(self, rec: Record, name: str, repeats: bool):
        self.rec, self.name, self.repeats = rec, name, repeats
        self.range = None

    def __enter__(self):
        rec = self.rec
        self.parent = _PARENT.get()
        if not self.repeats:
            self.id = next(rec._ids)
            self.token = _PARENT.set(self.id)
        self.start = time.time_ns()
        self.t0 = time.perf_counter_ns()
        if profiling() and _thread_id() == rec.thread:
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.repeats:
            self.rec._add_repeat(self.name, dur, self.parent)
        else:
            _PARENT.reset(self.token)
            self.rec._add(Span(self.name, self.start, dur, _thread_id(), self.id,
                               self.parent))
        return False


_NOTHING = contextlib.nullcontext()


def span(name: str, repeats: bool = False):
    """A context manager that records the scope as the span ``name`` in the
    context's run record, if one is open. ``repeats``: a span that recurs
    once per LM step, kept only as a total and a count (it is no parent of
    the spans inside it)."""
    rec = _RECORD.get()
    if rec is None:
        return _NOTHING
    return _Span(rec, name, repeats)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the context's run record, if one
    is open."""
    rec = _RECORD.get()
    if rec is not None:
        rec.count(name, n)


def _add_thread_spans(path: str, since_ns: int) -> None:
    """Add to the Chrome trace at ``path`` the spans that the finished runs
    recorded on threads other than their own since ``since_ns``, as ``X``
    events on the trace's clock (the profiler records no range there)."""
    with open(path) as f:
        data = json.load(f)
    base_us = data.get("baseTimeNanoseconds", 0) / 1e3
    pid = os.getpid()
    added, threads = [], set()
    for rec in runs():
        for s in rec.spans:
            if s.thread == rec.thread or s.start_ns < since_ns:
                continue
            threads.add(s.thread)
            added.append({"ph": "X", "cat": "emba_span", "name": PREFIX + s.name,
                          "pid": pid, "tid": s.thread, "ts": s.start_ns / 1e3 - base_us,
                          "dur": s.dur_ns / 1e3,
                          "args": {"run": rec.run_id, "span": s.id, "parent": s.parent}})
    added += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": "emba worker"}} for tid in sorted(threads)]
    data["traceEvents"].extend(added)
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None, device=None):
    """Trace the scope with ``torch.profiler`` (CPU activity, plus CUDA
    activity when ``device`` is a CUDA device) and write
    ``<log_dir>/trace.json`` (Chrome trace format), with the run records'
    spans of other threads added. No-op if dir None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    since = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_thread_spans(path, since)


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
