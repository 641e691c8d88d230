"""The port's fused window, checkpoint/resume and CG solve against its own
host loop and against the JAX package, on the CPU in f64 (mirrors of
``tests/test_e2e.py``'s fused, IRLS and resume tests at a smaller scene).

Tolerances: within the port, the fused window and the host loop run the
same f64 operations and must agree bit for bit, and so must a resumed run
and the uninterrupted one. Against JAX: costs relative 1e-9 and states 1e-8
of their largest magnitude (rounding differences grow through each
Cholesky solve and state update, as in ``test_torch_solver.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu import model as JM
from emba_tpu import pairing
from emba_tpu import solver as JS
from emba_tpu import spline as jspline
from emba_tpu import synth as jsynth
from emba_tpu_torch import convert, lm
from emba_tpu_torch import model as TM
from emba_tpu_torch import solver as TS

SCENE = dict(pano_width=128, pano_height=64, c_th=0.2, t_end=0.5, dt_knots=0.05,
             num_steps=120, motion_amp=0.3)
CFG = dict(c_th=0.2, pano_width=128, pano_height=64, thres_valid_pixel=3,
           alpha=2.0)
ITERS = 6


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.fixture(scope="module")
def case():
    sensor = jsynth.default_sensor(48, 48, f=44.0)
    scene = jsynth.generate(np.random.default_rng(11), sensor, **SCENE)
    steps = np.random.default_rng(9).normal(size=(scene.traj.num_knots, 3)) * 0.015
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    traj0 = dataclasses.replace(scene.traj,
                                knots=jspline._np_exp(walk) @ scene.traj.knots)
    win = pairing.build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                               traj0.locate, 100)
    jdev = JM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                       jnp.float64)
    state = (traj0.knots, scene.gx * 0.9, scene.gy * 0.9)
    return dict(jdev=jdev, tdev=convert.device_window_from_jax(jdev, device="cpu"),
                state=state)


def port_state(case):
    return convert.state_from_numpy(*case["state"], torch.float64, "cpu")


def jax_state(case):
    return tuple(jnp.asarray(a) for a in case["state"])


def host(case, cfg=CFG, **kw):
    return TS.solve_window(*port_state(case), case["tdev"], TM.ModelConfig(**cfg),
                           TS.LMConfig(max_num_iter=ITERS), fix_first=True, **kw)


def fused(case, cfg=CFG, **kw):
    return TS.solve_window_fused(*port_state(case), case["tdev"], TM.ModelConfig(**cfg),
                                 1.0, 1e-3, fix_first=True, max_num_iter=ITERS, **kw)


def test_fused_matches_host_loop_bitwise(case):
    kh, gxh, gyh, st = host(case)
    stats = lm.LoopStats()
    kf, gxf, gyf, cost, it, conv, trace = fused(case, return_trace=True, stats=stats)
    assert int(it) == len(st.iterations)
    assert float(cost) == min([r["cost_min"] for r in st.iterations]
                              + [r["cost_new"] for r in st.iterations])
    for a, b in ((kf, kh), (gxf, gxh), (gyf, gyh)):
        assert torch.equal(a, b)
    recs = lm.trace_records(trace.numpy(), int(it))
    assert [r["cost_new"] for r in recs] == [r["cost_new"] for r in st.iterations]
    assert [r["accepted"] for r in recs] == [
        r["cost_new"] < r["cost_min"] for r in st.iterations]
    assert lm.forming_stats_from_trace(trace.numpy(), int(it))[0] == st.active_px_per_form
    assert stats.form_passes == st.count_form


def test_fused_matches_jax_fused(case):
    jk, jgx, jgy, jcost, jit, jconv, jtrace = JS.solve_window_fused(
        *jax_state(case), case["jdev"], JM.ModelConfig(**CFG), jnp.asarray(1.0),
        jnp.asarray(1e-3), fix_first=True, max_num_iter=ITERS, return_trace=True)
    tk, tgx, tgy, tcost, tit, tconv, ttrace = fused(case, return_trace=True)
    assert int(tit) == int(jit) and bool(tconv) == bool(jconv)
    n = int(jit)
    np.testing.assert_array_equal(ttrace.numpy()[:n, 3], np.asarray(jtrace)[:n, 3])
    np.testing.assert_array_equal(ttrace.numpy()[:n, 4:], np.asarray(jtrace)[:n, 4:])
    assert rel_err(ttrace.numpy()[:n, :3], np.asarray(jtrace)[:n, :3]) <= 1e-9
    assert abs(float(tcost) - float(jcost)) <= 1e-9 * abs(float(jcost))
    for got, want in ((tk, jk), (tgx, jgx), (tgy, jgy)):
        assert rel_err(got, want) <= 1e-8


def test_fused_irls_lowers_robust_cost(case):
    """Fused LM with IRLS (cauchy) runs, lowers the robust cost, and
    follows the JAX fused window's iterations."""
    cfg = dict(CFG, use_irls=True, cost_type="cauchy", eta=0.5)
    k, gx, gy, cost, it, conv = fused(case, cfg=cfg)
    tk, tgx, tgy = port_state(case)
    tcfg = TM.ModelConfig(**cfg)
    lin0 = TM.linearize(tk, tgx, tgy, case["tdev"], tcfg)
    cost0 = float(TM.data_cost(lin0.e, tcfg) + TM.reg_cost(tgx, tgy, tcfg.alpha))
    assert float(cost) < 0.8 * cost0
    assert torch.isfinite(k).all()
    jout = JS.solve_window_fused(*jax_state(case), case["jdev"], JM.ModelConfig(**cfg),
                                 jnp.asarray(1.0), jnp.asarray(1e-3), fix_first=True,
                                 max_num_iter=ITERS)
    assert int(it) == int(jout[4])
    assert abs(float(cost) - float(jout[3])) <= 1e-9 * abs(float(jout[3]))


def test_fused_cg_matches_host_loop_cg(case):
    kh, _gx, _gy, st = host(case, use_cg=True)
    stats = lm.LoopStats()
    kf, _gxf, _gyf, cost, it, _conv = fused(case, use_cg=True, stats=stats)
    assert int(it) == len(st.iterations) and torch.equal(kf, kh)
    assert stats.cg_iterations == [r["cg_iterations"] for r in st.iterations]
    assert stats.cg_error == [r["cg_error"] for r in st.iterations]
    assert all(0 < n <= 100 for n in stats.cg_iterations)
    assert float(cost) < st.iterations[0]["cost_min"]


class Stop(Exception):
    pass


def stop_at(n, captured):
    def checkpoint(state):
        captured.update(state)
        if state["it"] >= n:
            raise Stop
    return checkpoint


def test_checkpoint_resume_bitexact(case):
    """Stopped at iteration 3 by the checkpoint callback, the resumed run
    gives the bits of the uninterrupted one."""
    k_ref, gx_ref, gy_ref, st_ref = host(case)
    captured = {}
    with pytest.raises(Stop):
        host(case, checkpoint_cb=stop_at(3, captured), checkpoint_every=1)
    assert captured["it"] == 3
    assert set(captured) == {"knots", "gx", "gy", "lam", "cost_min", "count_tol_sat",
                             "it", "cost_decreased"}
    assert isinstance(captured["knots"], np.ndarray) and isinstance(captured["lam"], float)
    k, gx, gy, st = host(case, resume_state=captured)
    assert len(st.iterations) == len(st_ref.iterations) - 3
    assert st.iterations[-1]["cost_min"] == st_ref.iterations[-1]["cost_min"]
    for a, b in ((k, k_ref), (gx, gx_ref), (gy, gy_ref)):
        assert torch.equal(a, b)


def test_resume_across_packages(case):
    """A JAX lm_state_dict payload resumes in the port, and a port payload
    resumes in JAX: both finish where the uninterrupted JAX run does."""
    jcfg, lmc = JM.ModelConfig(**CFG), JS.LMConfig(max_num_iter=ITERS)
    jk, jgx, jgy, jst = JS.solve_window(*jax_state(case), case["jdev"], jcfg, lmc,
                                        fix_first=True)
    jpay = {}
    with pytest.raises(Stop):
        JS.solve_window(*jax_state(case), case["jdev"], jcfg, lmc, fix_first=True,
                        checkpoint_cb=stop_at(3, jpay), checkpoint_every=1)
    tk, tgx, tgy, tst = host(case, resume_state=jpay)
    assert len(tst.iterations) == len(jst.iterations) - 3
    for got, want in ((tk, jk), (tgx, jgx), (tgy, jgy)):
        assert rel_err(got, want) <= 1e-8

    tpay = {}
    with pytest.raises(Stop):
        host(case, checkpoint_cb=stop_at(3, tpay), checkpoint_every=1)
    assert convert.lm_state_to_numpy(jpay)["it"] == tpay["it"] == 3
    rk, rgx, rgy, rst = JS.solve_window(*jax_state(case), case["jdev"], jcfg, lmc,
                                        fix_first=True, resume_state=tpay)
    assert len(rst.iterations) == len(jst.iterations) - 3
    for got, want in ((rk, jk), (rgx, jgx), (rgy, jgy)):
        assert rel_err(got, want) <= 1e-8


def test_lm_state_payload_conversion():
    pay = dict(knots=torch.eye(3)[None], gx=jnp.zeros((2, 2)), gy=np.ones((2, 2)),
               lam=np.float32(1e-4), cost_min=torch.tensor(3.5), count_tol_sat=np.int64(1),
               it=jnp.asarray(4), cost_decreased=np.bool_(True))
    out = convert.lm_state_to_numpy(pay)
    assert all(isinstance(out[k], np.ndarray) for k in convert.LM_STATE_ARRAYS)
    assert out["knots"].shape == (1, 3, 3) and out["gx"].shape == (2, 2)
    assert [type(out[k]) for k in convert.LM_STATE_SCALARS] == [float, float, int, int,
                                                                bool]
    assert out["it"] == 4 and out["cost_min"] == 3.5 and out["cost_decreased"] is True
    with pytest.raises(KeyError):
        convert.lm_state_to_numpy({k: v for k, v in pay.items() if k != "lam"})
