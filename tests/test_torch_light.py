"""Light-trial LM (``ModelConfig.light_trial``: trials evaluate the cost
only, the forming pass recomputes the Jacobians after an accept) in the
port against the port's classic loops and against JAX's light-trial loop,
on the CPU in f64 (mirror of tests/test_e2e.py:275), and the cached graphed
window in light-trial mode with its graphs replaced by the eager stand-in
of ``test_torch_lm.py``.

Tolerances: within the port the light and the classic loop run the same
ops on the same inputs, so the iterations, accepts and results are equal
bit for bit; against JAX, the same iterations and knots and maps to
relative 1e-8 (rounding grows through each Cholesky solve, as in
``test_torch_solver.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu import model as JM
from emba_tpu import pairing, solver as JS, spline, synth
from emba_tpu_torch import lm as TL
from emba_tpu_torch import model as TM
from emba_tpu_torch import solver as TS

from test_torch_lm import EagerPhase

CFG = dict(c_th=0.1, pano_width=192, pano_height=96, thres_valid_pixel=3, alpha=0.5,
           outlier_dp_norm=3.0)
ITERS = 8


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.fixture(scope="module")
def setup():
    """The scene of tests/test_e2e.py at half its render steps, its knots
    moved by a random walk (seed 7, 0.015 rad a knot), both packages'
    windows."""
    rng = np.random.default_rng(42)
    sensor = synth.default_sensor(48, 48, f=44.0)
    B = synth.smooth_random_map(96, 192, rng, smooth=3, amp=3.0)
    scene = synth.generate(rng, sensor, pano_width=192, pano_height=96, c_th=0.1,
                           t_end=1.0, dt_knots=0.05, num_steps=300, motion_amp=0.25,
                           brightness=B)
    steps = np.random.default_rng(7).normal(size=(scene.traj.num_knots, 3)) * 0.015
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    traj0 = dataclasses.replace(scene.traj, knots=spline._np_exp(walk) @ scene.traj.knots)
    win = pairing.build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                               traj0.locate, 100)
    jdev = JM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                       jnp.float64)
    tdev = TM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                       torch.float64, "cpu")
    state = (traj0.knots, scene.gx, scene.gy)
    return dict(jdev=jdev, tdev=tdev, jstate=tuple(jnp.asarray(a) for a in state),
                tstate=tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in state))


def port_fused(s, cfg):
    return TS.solve_window_fused(*s["tstate"], s["tdev"], cfg, 1.0, 1e-3, fix_first=True,
                                 max_num_iter=ITERS, return_trace=True)


@pytest.mark.parametrize("irls", [None, "cauchy"])
def test_light_trial_matches_classic_and_jax(setup, irls):
    """Fused and host light-trial windows against the classic fused window
    (same iterations, accepts and bits) and against JAX's light-trial
    window (same iterations, results to 1e-8). IRLS composes: its weights
    read the residual only."""
    kw = dict(CFG)
    if irls:
        kw.update(use_irls=True, cost_type=irls, eta=0.5)
    cfg, cfg_lt = TM.ModelConfig(**kw), TM.ModelConfig(**kw, light_trial=True)
    classic = port_fused(setup, cfg)
    light = port_fused(setup, cfg_lt)
    assert int(light[4]) == int(classic[4]) and bool(light[5]) == bool(classic[5])
    for a, b in zip(light, classic):
        assert torch.equal(a, b)

    k, gx, gy, st = TS.solve_window(*setup["tstate"], setup["tdev"], cfg_lt,
                                    TS.LMConfig(max_num_iter=ITERS), fix_first=True)
    assert len(st.iterations) == int(classic[4])
    acc = [r["cost_new"] < r["cost_min"] for r in st.iterations]
    assert acc == [bool(a) for a in classic[6][:len(acc), 3]]
    for a, b in zip((k, gx, gy), classic[:3]):
        assert rel_err(a, b) <= 1e-10

    jc = JM.ModelConfig(**kw, light_trial=True)
    jk, jgx, jgy, jcost, jit, jconv = JS.solve_window_fused(
        *setup["jstate"], setup["jdev"], jc, jnp.asarray(1.0), jnp.asarray(1e-3),
        fix_first=True, max_num_iter=ITERS)
    assert int(jit) == int(light[4]) and bool(jconv) == bool(light[5])
    assert float(light[3]) == pytest.approx(float(jcost), rel=1e-10)
    for a, b in zip(light[:3], (jk, jgx, jgy)):
        assert rel_err(a, b) <= 1e-8


def test_light_trial_graphed_window(setup, monkeypatch):
    """The cached graphed window in light-trial mode (the objective graph
    keeps the residual fields, the form graph recomputes the Jacobians),
    with the eager stand-in for the graphs: the eager light loop's bits."""
    monkeypatch.setattr(TL, "CapturedPhase", EagerPhase)
    monkeypatch.setattr(TS, "_GRAPHED", {})
    cfg = TM.ModelConfig(**CFG, light_trial=True)
    want = port_fused(setup, cfg)
    loop, _cg = TS._graphed_window(*setup["tstate"], setup["tdev"], cfg, 1.0, tol_fun=1e-3,
                                   fix_first=True, use_cg=False, max_num_iter=ITERS,
                                   num_times_tol_fun_sat=2)
    stats = TL.LoopStats()
    got = loop.run(*setup["tstate"], stats=stats)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert stats.form_passes == 1 + stats.replays["form"]
