"""The ``dvx_4k.span`` cell's path on the CPU: a tiny root built as
``tiny.py`` builds ``tiny.span``, its configuration shrunk from
``dvxplorer_4k.json`` (a 40x30 sensor of the same field onto a 160x80 map,
4x the sensor's width) and the program's row ceiling set below the map
(4096 rows of 12,800 pixels), so every job defers its compaction cap and
sizes it from the active pixels it counts. A traced run is correct, and
``plan_rows_ms`` and ``row_fill`` read numbers."""

import json

from benchmark import run
from benchmark.tests import tiny

NEW_METRICS = ("plan_rows_ms", "row_fill")


def make_dvx_root(path):
    root = tiny.make_root(path)
    with open(tiny.REPO / "benchmark" / "configs" / "dvxplorer_4k.json") as f:
        conf = json.load(f)
    small = dict(stop_time=0.9, pano_width=160, pano_height=80, outlier_dp_norm=10.0,
                 dtype="float64")
    conf.update(name="tiny", overrides=dict(small))
    conf["settings"].update(small)
    cam = dict(conf["scene"]["camera"], fx=30.0, fy=30.0, cx=19.5, cy=14.5)
    conf["scene"].update(sensor_width=40, sensor_height=30, camera=cam, pano_width=160,
                         pano_height=80, duration_s=1.0, texture_smooth=5)
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(conf))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW_METRICS:
            m["workloads"].append(tiny.CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_deferred_cap_cell_is_correct_and_reads_its_metrics(tmp_path, capsys, monkeypatch):
    from emba_tpu_torch import pipeline

    plan = pipeline.plan_model_config
    monkeypatch.setattr(pipeline, "plan_model_config",
                        lambda *a, **kw: plan(*a, **kw, rows_large=4096))
    root = make_dvx_root(tmp_path)
    assert run.main(["--workload", tiny.CELL, "--seed", str(2**31 + 29), "--seconds", "0.5",
                     "--trace", "1"], device="cpu", root=root) == 0
    out = tiny.last_line(capsys)
    assert out["correct"] is True
    assert out["metrics"]["plan_rows_ms"]["value"] > 0
    assert 0 < out["metrics"]["row_fill"]["value"] <= 100
