"""The metrics read from the program's run records (``program_spans.py``):
a traced run of the tiny cell, with the new entries listing it, reports
the four host-stage times of the pipeline, each above 0; ``graph_reuse``
is absent there, since the CPU runs the LM loop eagerly and captures no
graph. Records that are not the window's jobs give nothing."""

import json
import types

from benchmark import program_spans, run
from benchmark.tests import tiny

SPAN_METRICS = ("init_ms", "prep_ms", "prep_wait_ms", "upload_ms")


def test_traced_run_reports_the_pipeline_stages(tmp_path, capsys):
    root = tiny.make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in SPAN_METRICS + ("graph_reuse",):
            m["workloads"].append(tiny.CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert run.main(["--workload", tiny.CELL, "--seed", str(2**31 + 23), "--seconds", "0.5",
                     "--trace", "1"], device="cpu", root=root) == 0
    out = tiny.last_line(capsys)
    assert out["correct"] is True
    for name in SPAN_METRICS:
        assert out["metrics"][name]["unit"] == "ms" and out["metrics"][name]["value"] > 0
    assert "graph_reuse" not in out["metrics"]
    assert "host_share" in out["metrics"]


def job_ctx(*jobs):
    return types.SimpleNamespace(jobs=[dict(events=e, iterations=i) for e, i in jobs])


def test_records_must_be_the_window_jobs():
    from emba_tpu_torch import obs

    made = []
    for events, steps, hit in ((100, 5, 0), (100, 7, 1)):
        rec = obs.Record()
        with obs.recording(rec), obs.span("window.upload"):
            obs.count("window.events", events)
            obs.count("lm.steps", steps)
            obs.count("lm.graph_hit", hit)
            obs.count("lm.graph_capture", 1 - hit)
        rec.finish()
        made.append(rec)
    assert program_spans.records(job_ctx((100, 5), (100, 7))) == made
    assert program_spans.records(job_ctx((100, 7))) == made[1:]
    assert program_spans.mean_ms(job_ctx((100, 5), (100, 7)), "window.upload") > 0
    assert program_spans.counter_sum(job_ctx((100, 5), (100, 7)), "lm.graph_hit") == 1
    # out of order, another count, another length, or no jobs: nothing
    for ctx in (job_ctx((100, 7), (100, 5)), job_ctx((101, 5), (100, 7)),
                job_ctx((100, 6)), job_ctx()):
        assert program_spans.records(ctx) is None
        assert program_spans.mean_ms(ctx, "window.upload") is None
    assert program_spans.records(job_ctx(*[(100, 7)] * (obs.KEEP_RUNS + 1))) is None
    # a span no record holds
    assert program_spans.mean_ms(job_ctx((100, 7)), "window.prepare") is None
