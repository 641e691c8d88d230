"""Every piece of a cell is found by its name: a cell, configuration, mix and
metric added as new files and entries only run, and each reader of the
repository's metrics reads a fake result; BENCHMARK.json keeps to the
shapes the harness reads."""

import json
import re
import types

import pytest

from benchmark import registry
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def fake_ctx(trace=True):
    job = dict(wall_s=2.0, solve_s=0.6, setup_s=0.0, events=1000, iterations=10,
               rmse_deg=0.25, active_px_per_form=[100, 110], dim_pose=12, weighted=800.0)
    tr = {"window_s": 4.0, "busy_s": 1.0,
          "phase_s": {"objective": 0.1, "form": 0.05, "solve": 0.2}} if trace else None
    return types.SimpleNamespace(jobs=[job, dict(job)], window_s=4.0, setup_s=12.0,
                                 peak_bytes=3 * 2**30, trace=tr, config={}, traffic={})


def test_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    b = root / "benchmark"
    (b / "configs" / "tiny2.json").write_text((b / "configs" / "tiny.json").read_text())
    mix = json.loads((b / "traffic" / "span.json").read_text())
    mix["walk_sigma_rad"] = 0.01
    (b / "traffic" / "span2.json").write_text(json.dumps(mix))
    (b / "metrics" / "jobs_done.py").write_text(
        "def read(ctx):\n    return len(ctx.jobs) if ctx.jobs else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny2",
                                 file="benchmark/configs/tiny2.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="tiny2.span2",
                                   config="tiny2", traffic="span2"))
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "pipeline",
                               "moves": "job_s", "workloads": ["tiny2.span2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = registry.Registry(root)
    cell = reg.cell("tiny2.span2")
    assert reg.config(cell["config"])["name"] == "tiny"
    assert reg.traffic(cell["traffic"])["walk_sigma_rad"] == 0.01
    got = reg.read_metrics("tiny2.span2", True, fake_ctx())
    assert got["jobs_done"] == {"value": 2.0, "unit": "jobs"}
    assert "jobs_done" not in reg.read_metrics(tiny.CELL, True, fake_ctx())
    with pytest.raises(KeyError):
        reg.cell("no.such")


def test_every_reader_reads_a_fake_result():
    reg = registry.Registry()
    for cell in reg.bench["workloads"]:
        e2e = reg.read_metrics(cell["name"], False, fake_ctx(False))
        assert set(e2e) == {m["name"] for m in reg.metrics(cell["name"], False)}
        layer = reg.read_metrics(cell["name"], True, fake_ctx(True))
        assert set(layer) == {m["name"] for m in reg.metrics(cell["name"], True)}
    assert reg.read_metrics(reg.bench["workloads"][0]["name"], True, fake_ctx(False)) \
        .keys() == {"host_share", "lm_events_per_s"}
    ctx = fake_ctx()
    assert reg.reader("job_s")(ctx) == 2.0
    assert reg.reader("host_share")(ctx) == pytest.approx(70.0)
    assert reg.reader("device_idle")(ctx) == pytest.approx(75.0)
    assert reg.reader("objective_ms")(ctx) == pytest.approx(5.0)


def test_benchmark_json_shape():
    reg = registry.Registry()
    bench = reg.bench
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        conf = reg.config(c["name"])
        assert set(c["reduced"]) <= set(conf) | set(conf["settings"]) | set(conf["scene"])
    cells = bench["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (reg.root / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
