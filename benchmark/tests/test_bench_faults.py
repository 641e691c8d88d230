"""The check that decides ``correct``, driven through a whole run (the
harness's look for a chip skipped: a tiny cell on the CPU, the program in
float64, where it follows the float64 reference to rounding): a sound run is
correct; a run with the timed path broken underneath is not, once for each
fault the cell can have: a step that returns its state unchanged, half of
the measurements left out (the cost taken over the rest, scaled up), and an
answer altered where it is produced. (A cell on one chip has no exchange
between chips to leave out.)"""

import dataclasses

import numpy as np
import pytest

from benchmark import check, run
from benchmark.reference import geometry as geo
from benchmark.tests import tiny


def run_tiny(tmp_path, capsys, trace=0):
    root = tiny.make_root(tmp_path)
    assert run.main(["--workload", tiny.CELL, "--seed", str(2**31 + 11), "--seconds", "0.5",
                     "--trace", str(trace)], device="cpu", root=root) == 0
    return tiny.last_line(capsys)


def test_sound_run_is_correct(tmp_path, capsys):
    out = run_tiny(tmp_path, capsys)
    assert out["correct"] is True and out["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_state_unchanged_is_caught(tmp_path, capsys, monkeypatch):
    from emba_tpu_torch import model

    monkeypatch.setattr(model, "update_knots", lambda knots, x1, fix_first=False: knots)
    monkeypatch.setattr(model, "update_map", lambda Gx, Gy, x2, damping, neq: (Gx, Gy))
    out = run_tiny(tmp_path, capsys)
    assert out["correct"] is False
    assert out["checks"]["step1_gap"]["value"] > out["checks"]["step1_gap"]["limit"]


def test_half_the_measurements_left_out_is_caught(tmp_path, capsys, monkeypatch):
    from emba_tpu_torch import model

    def half_cost(e, cfg):
        n = e.shape[0] // 2
        return 2.0 * 0.5 * (e[:n] * e[:n]).sum()

    monkeypatch.setattr(model, "data_cost", half_cost)
    out = run_tiny(tmp_path, capsys)
    assert out["correct"] is False
    assert out["checks"]["cost0_gap"]["value"] > out["checks"]["cost0_gap"]["limit"]


def test_answer_altered_where_produced_is_caught(tmp_path, capsys, monkeypatch):
    from emba_tpu_torch import pipeline

    run0 = pipeline.EmbaPipeline.run
    tilt = geo.exp_so3(__import__("torch").tensor([0.0, 0.0, np.deg2rad(0.2)],
                                                  dtype=__import__("torch").float64)).numpy()

    def altered(self, *a, **k):
        res = run0(self, *a, **k)
        knots = res.trajectory.knots.copy()
        knots[1:] = tilt @ knots[1:]
        return dataclasses.replace(res, trajectory=dataclasses.replace(res.trajectory,
                                                                       knots=knots))

    monkeypatch.setattr(pipeline.EmbaPipeline, "run", altered)
    out = run_tiny(tmp_path, capsys)
    assert out["correct"] is False
    assert out["checks"]["report_gap"]["value"] > out["checks"]["report_gap"]["limit"]


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(tmp_path, capsys, trace):
    out = run_tiny(tmp_path, capsys, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(out["metrics"]) <= {"host_share", "lm_events_per_s", "objective_ms",
                                       "forming_roofline", "solve_ms", "device_idle"}
        assert "host_share" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"job_s", "rmse_deg", "setup_s"}  # no peak on a CPU
    assert out["attempted"] >= 1


def test_result_line_builder():
    dev = {"platform": "gpu", "kind": "k", "count": 1, "memory_peak_bytes": 1}
    plain = run.result_line(True, 3, 0, {}, dev, None, {"a": (1e-3, 1e-2)})
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    traced = run.result_line(False, 3, 1, {}, dev, {"device_ops": [["k", 1.0]],
                                                    "idle_gaps": []},
                             {"a": (float("nan"), 1e-2)})
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "checks"]
    assert traced["checks"]["a"] == {"value": None, "limit": 1e-2}
    # a number that applies to no checked job is None, and within its limit
    assert run.worst_of([None, 1e-3, None]) == 1e-3 and run.worst_of([None]) is None
    assert check.within({"a": None, "b": 1e-3}, {"a": 0.05, "b": 2e-3})
    assert not check.within({"a": 0.06, "b": 1e-3}, {"a": 0.05, "b": 2e-3})
