"""The port's run record (``emba_tpu_torch.obs``): spans nest with parent ids
and self times, counters add up, ``runs()`` keeps the newest records, a
worker thread's spans join the run that submitted it, nothing is recorded
with no record open, and profiler ranges open only under a profiler, on
the profiler's clock. No JAX here.

Clock: a span's end is its ``time.time_ns()`` start plus its
``perf_counter_ns()`` duration, so a span's end and its parent's may
disagree by clock steps; comparisons of ends allow ``CLOCK_NS``.
"""

import contextvars
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu_torch import obs

CLOCK_NS = 50_000
# a span's start against the profiler's range in it: the span stamps its
# start, then opens the range, which starts later by the range's own entry
TRACE_CLOCK_US = 1000.0


def by_name(rec):
    return {s.name: s for s in rec.spans}


def test_spans_nest_with_parent_ids_and_self_time():
    rec = obs.Record()
    with obs.recording(rec):
        with obs.span("outer"):
            with obs.span("inner"):
                time.sleep(0.01)
                with obs.span("leaf"):
                    time.sleep(0.002)
            for _ in range(3):
                with obs.span("step", repeats=True):
                    time.sleep(0.001)
        with obs.span("second"):
            pass
    rec.finish()
    s = by_name(rec)
    assert s["outer"].parent is None and s["second"].parent is None
    assert s["inner"].parent == s["outer"].id and s["leaf"].parent == s["inner"].id
    assert len({sp.id for sp in rec.spans}) == 4
    assert all(sp.thread == rec.thread == threading.get_native_id() for sp in rec.spans)
    assert s["outer"].start_ns <= s["inner"].start_ns <= s["leaf"].start_ns
    assert s["leaf"].end_ns <= s["inner"].end_ns + CLOCK_NS
    assert s["inner"].end_ns <= s["outer"].end_ns + CLOCK_NS
    assert rec.start_ns <= s["outer"].start_ns and s["second"].end_ns <= rec.end_ns + CLOCK_NS
    assert rec.repeats["step"][1] == 3 and "step" not in s

    tot = rec.totals()
    step_s = rec.repeats["step"][0] * 1e-9
    assert tot["step"] == pytest.approx({"total_s": step_s, "self_s": step_s, "count": 3})
    assert tot["leaf"]["self_s"] == tot["leaf"]["total_s"] >= 0.002
    assert tot["inner"]["self_s"] == pytest.approx(
        tot["inner"]["total_s"] - tot["leaf"]["total_s"], abs=CLOCK_NS * 1e-9)
    assert tot["outer"]["self_s"] == pytest.approx(
        tot["outer"]["total_s"] - tot["inner"]["total_s"] - step_s, abs=CLOCK_NS * 1e-9)
    assert tot["outer"]["count"] == 1 and tot["outer"]["self_s"] >= 0
    assert [sp.name for sp in rec.named("leaf")] == ["leaf"]


def test_self_time_counts_overlapping_children_once():
    rec = obs.Record()
    outer = obs.Span("outer", 0, 100, 1, 1, None)
    rec.spans += [outer, obs.Span("a", 10, 40, 1, 2, 1), obs.Span("b", 30, 40, 2, 3, 1),
                  obs.Span("c", 90, 30, 2, 4, 1)]
    # a and b cover 10-70 together, c 90-100 inside outer
    assert rec.totals()["outer"]["self_s"] == pytest.approx(30e-9)


def test_counters_add_up():
    rec = obs.Record()
    obs.count("outside")
    with obs.recording(rec):
        obs.count("windows")
        obs.count("events", 5)
        obs.count("events", 7)
    obs.count("events", 100)
    assert rec.counters == {"windows": 1, "events": 12}


def test_runs_are_bounded_and_newest_last():
    made = []
    for _ in range(obs.KEEP_RUNS + 5):
        rec = obs.Record()
        rec.finish()
        made.append(rec)
    kept = obs.runs()
    assert len(kept) == obs.KEEP_RUNS
    assert kept == made[5:] and kept[-1] is made[-1]
    assert len({r.run_id for r in made}) == len(made)
    assert all(r.end_ns >= r.start_ns for r in made)


def test_worker_thread_spans_join_the_submitting_run():
    def work():
        with obs.span("work"):
            obs.count("worked")
            return threading.get_native_id()

    rec = obs.Record()
    with ThreadPoolExecutor(max_workers=1) as pool, obs.recording(rec):
        with obs.span("submit"):
            fut = pool.submit(contextvars.copy_context().run, work)
        tid = fut.result(timeout=30)
        # a thread that does not run a copy of the context records nothing
        pool.submit(work).result(timeout=30)
    rec.finish()
    s = by_name(rec)
    assert [sp.name for sp in rec.spans].count("work") == 1
    assert s["work"].thread == tid != rec.thread
    assert s["work"].parent == s["submit"].id
    assert rec.counters == {"worked": 1}


def test_nothing_is_recorded_without_a_record():
    before = obs.runs()
    rec = obs.Record()
    with obs.recording(rec):
        pass
    with obs.span("x") as inner, obs.span("y", repeats=True) as step:
        obs.count("z")
    assert inner is None and step is None and obs.runs() == before
    assert rec.spans == [] and rec.repeats == {} and rec.counters == {}


def test_no_profiler_range_outside_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    rec = obs.Record()
    with obs.recording(rec), obs.span("quiet"), obs.span("step", repeats=True):
        pass
    assert [s.name for s in rec.spans] == ["quiet"]


def trace_events(path):
    data = json.loads(open(path).read())
    return data, [e for e in data["traceEvents"] if e.get("ph") == "X"]


def test_span_in_the_profiler_trace_on_its_clock(tmp_path):
    rec = obs.Record()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.recording(rec), obs.span("probe"):
            torch.ones(16) + 1
    rec.finish()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    data, evs = trace_events(tmp_path / "t.json")
    (ev,) = [e for e in evs if e["name"] == "emba.probe"]
    at_us = ev["ts"] + data["baseTimeNanoseconds"] / 1e3
    assert abs(at_us - rec.spans[0].start_ns / 1e3) <= TRACE_CLOCK_US
    assert not any(e["name"].startswith("bench.") for e in evs)


def test_profiler_trace_adds_the_worker_spans(tmp_path):
    """``obs.profiler_trace`` (``cli run --profile-dir``) writes the spans of
    a run's other threads, which open no profiler range, as ``X`` events
    on the trace's clock."""
    def work():
        with obs.span("work"):
            time.sleep(0.002)

    rec = obs.Record()
    with obs.profiler_trace(str(tmp_path), "cpu"):
        with ThreadPoolExecutor(max_workers=1) as pool, obs.recording(rec), \
                obs.span("main"):
            pool.submit(contextvars.copy_context().run, work).result(timeout=30)
        rec.finish()
    data, evs = trace_events(tmp_path / "trace.json")
    s = by_name(rec)
    (ev,) = [e for e in evs if e["name"] == "emba.work"]
    assert ev["cat"] == "emba_span" and ev["tid"] == s["work"].thread != rec.thread
    assert ev["args"] == {"run": rec.run_id, "span": s["work"].id,
                          "parent": s["main"].id}
    assert ev["ts"] + data["baseTimeNanoseconds"] / 1e3 == pytest.approx(
        s["work"].start_ns / 1e3, abs=1.0)
    assert ev["dur"] == pytest.approx(s["work"].dur_ns / 1e3)
    # the main thread's span is the profiler's own range
    (main,) = [e for e in evs if e["name"] == "emba.main"]
    assert main["cat"] != "emba_span"
