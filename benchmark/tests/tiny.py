"""A tiny copy of the benchmark for CPU tests: a checkout root holding
``BENCHMARK.json``, a 40x30-sensor, 128x64-panorama configuration over 1 s
(its BA span 0.1-0.9 s, 17 knots), the ``span`` mix and the metric
readers, run on the CPU (``run.main(..., device="cpu", root=...)``)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import registry

REPO = registry.ROOT
CELL = "tiny.span"


def make_root(path, dtype: str = "float64") -> Path:
    """Write the tiny benchmark under ``path``; the program runs in
    ``dtype`` (float64: it follows the float64 reference to rounding)."""
    root = Path(path)
    (root / "benchmark" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "benchmark" / "traffic").mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "benchmark" / "metrics", root / "benchmark" / "metrics",
                    dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    with open(REPO / "benchmark" / "configs" / "ecrot_bicycle.json") as f:
        conf = json.load(f)
    small = dict(stop_time=0.9, pano_width=128, pano_height=64, dtype=dtype)
    conf.update(name="tiny", overrides=dict(small))
    conf["settings"].update(small)
    cam = dict(conf["scene"]["camera"], fx=33.0, fy=33.0, cx=21.0, cy=14.0)
    conf["scene"].update(sensor_width=40, sensor_height=30, camera=cam, pano_width=128,
                         pano_height=64, duration_s=1.0, texture_smooth=3)
    with open(root / "benchmark" / "configs" / "tiny.json", "w") as f:
        json.dump(conf, f)
    with open(REPO / "benchmark" / "traffic" / "span.json") as f:
        traffic = json.load(f)
    with open(root / "benchmark" / "traffic" / "span.json", "w") as f:
        json.dump(traffic, f)
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="benchmark/configs/tiny.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name=CELL, config="tiny")]
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return root


def last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
