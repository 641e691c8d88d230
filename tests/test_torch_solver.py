"""The slice as a whole: the port's LM window against the JAX package's
host-driven ``solve_window`` on the CPU in f64, plus the port's synthetic
scene and metrics against the reference modules.

Tolerances: costs relative 1e-9 and knots 1e-8 of their largest magnitude
after 3 LM iterations (rounding differences grow through each Cholesky
solve and state update); the accept/reject sequence must be identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emba_tpu import metrics as jmetrics
from emba_tpu import model as JM
from emba_tpu import pairing
from emba_tpu import solver as JS
from emba_tpu import spline as jspline
from emba_tpu import synth as jsynth
from emba_tpu_torch import convert, lm
from emba_tpu_torch import metrics as tmetrics
from emba_tpu_torch import model as TM
from emba_tpu_torch import solver as TS
from emba_tpu_torch import synth as tsynth

SCENE = dict(pano_width=128, pano_height=64, c_th=0.2, t_end=0.5, dt_knots=0.05,
             num_steps=120, motion_amp=0.3)
CFG = dict(c_th=0.2, pano_width=128, pano_height=64, thres_valid_pixel=3,
           alpha=2.0)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.fixture(scope="module")
def scenes():
    sensor = jsynth.default_sensor(48, 48, f=44.0)
    j = jsynth.generate(np.random.default_rng(11), sensor, **SCENE)
    t = tsynth.generate(np.random.default_rng(11),
                        tsynth.default_sensor(48, 48, f=44.0), **SCENE)
    return sensor, j, t


def test_synth_scene_matches(scenes):
    _sensor, j, t = scenes
    for name in ("x", "y", "pol"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for name in ("t", "gx", "gy", "brightness"):
        assert rel_err(getattr(t, name), getattr(j, name)) <= 1e-12, name
    assert rel_err(t.traj.knots, j.traj.knots) <= 1e-12


def test_solve_window_matches(scenes):
    sensor, scene, _t = scenes
    steps = np.random.default_rng(3).normal(size=(scene.traj.num_knots, 3)) * 0.01
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    traj0 = dataclasses.replace(scene.traj,
                                knots=jspline._np_exp(walk) @ scene.traj.knots)
    win = pairing.build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                               traj0.locate, 100)
    jdev = JM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                       jnp.float64)
    k0, gx0, gy0 = traj0.knots, scene.gx * 0.9, scene.gy * 0.9

    jk, jgx, jgy, jst = JS.solve_window(
        jnp.asarray(k0), jnp.asarray(gx0), jnp.asarray(gy0), jdev,
        JM.ModelConfig(**CFG), JS.LMConfig(max_num_iter=3), fix_first=True)
    seen = []
    tk, tgx, tgy, tst = TS.solve_window(
        *convert.state_from_numpy(k0, gx0, gy0, torch.float64, "cpu"),
        convert.device_window_from_jax(jdev), TM.ModelConfig(**CFG),
        TS.LMConfig(max_num_iter=3), fix_first=True,
        callback=lambda it, gx, gy, info: seen.append(it))

    assert len(tst.iterations) == len(jst.iterations) == 4
    assert seen == [0, 1, 2, 3]
    jc = [r["cost_new"] for r in jst.iterations]
    tc = [r["cost_new"] for r in tst.iterations]
    assert rel_err(tc, jc) <= 1e-9
    assert [r["cost_min"] for r in tst.iterations] == pytest.approx(
        [r["cost_min"] for r in jst.iterations], rel=1e-9)
    assert tst.count_form == jst.count_form
    assert tst.active_px_per_form == jst.active_px_per_form
    assert rel_err(tk, jk) <= 1e-8
    assert rel_err(tgx, jgx) <= 1e-8 and rel_err(tgy, jgy) <= 1e-8

    tt = np.linspace(0.05, 0.45, 50)
    R_gt = np.asarray(scene.traj.evaluate(tt))
    tA = dataclasses.replace(traj0, knots=tk.numpy())
    assert tmetrics.trajectory_rmse_deg(tA, tt, R_gt) == pytest.approx(
        jmetrics.trajectory_rmse_deg(tA, tt, R_gt), rel=1e-10)


def test_unported_solver_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.solve_window(None, torch.zeros(1), None, None, None, use_cg=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.solve_window(None, torch.zeros(1), None, None, None,
                        resume_state={"it": 0})


def test_host_schedule_and_trace_decoders():
    s = lm.HostSchedule(tol_fun=0.1, max_num_iter=5, num_times_tol_fun_sat=2)
    s.start(10.0)
    assert s.step(5.0) and s.lam == pytest.approx(1e-4)
    assert not s.step(6.0) and s.lam == pytest.approx(1e-3) and s.count_tol_sat == 0
    assert s.step(4.9) and s.count_tol_sat == 1
    assert s.step(4.85) and s.converged and not s.running()
    trace = np.array([[1e-3, 10, 5, 1, 7, 0], [1e-4, 5, 6, 0, 7, 0],
                      [1e-3, 5, 4, 1, 8, 0]])
    recs = lm.trace_records(trace, 3)
    assert [r["accepted"] for r in recs] == [True, False, True]
    assert lm.forming_stats_from_trace(trace, 3) == ([7, 7], [0, 0])
