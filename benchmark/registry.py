"""Finds every piece of a cell by the names in ``BENCHMARK.json``: the cell,
its configuration file, its traffic mix (``traffic/<mix>.json``) and the
reader of each metric (``metrics/<metric>.py``, a function ``read(ctx)``
that returns a number, or None where it finds nothing to read). A new cell,
configuration, mix or metric is new files and entries; nothing here names
one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

# the root of the checkout: BENCHMARK.json and the benchmark's folder
ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent.name


class Registry:
    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)
        self._readers = {}

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.root / HERE / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, cell: str, per_layer: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones, or
        with ``per_layer`` the per-layer ones; a metric with a
        ``workloads`` key only in the cells it lists."""
        group = self.bench["per_layer" if per_layer else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        if metric not in self._readers:
            path = self.root / HERE / "metrics" / f"{metric}.py"
            spec = importlib.util.spec_from_file_location(
                f"{HERE}.metrics.{metric.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[metric] = mod.read
        return self._readers[metric]

    def read_metrics(self, cell: str, per_layer: bool, ctx) -> dict:
        """{name: {"value", "unit"}} of every metric whose reader found
        something to read."""
        out = {}
        for m in self.metrics(cell, per_layer):
            v = self.reader(m["name"])(ctx)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out
