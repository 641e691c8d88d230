"""Parity of the port's warp, linearization, normal equations and Schur
solve against the JAX package on the CPU in f64 (the JAX side forms the
normal equations on its XLA path). Both sides get the same numpy inputs.

Tolerances are relative to each output's largest magnitude: 1e-11 for the
warp, 1e-10 for every Linearization and NormalEq field, 1e-8 for the
solve, whose Cholesky amplifies rounding by the condition number of S.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu import model as JM
from emba_tpu import pairing, spline, synth
from emba_tpu import warp as JW
from emba_tpu_torch import convert
from emba_tpu_torch import model as TM
from emba_tpu_torch import warp as TW

CFG = dict(c_th=0.2, pano_width=128, pano_height=64, thres_valid_pixel=3,
           alpha=2.0, spline_order=2)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.fixture(scope="module")
def case():
    """The small scene of tests/test_model.py, 0.01 rad knot noise, both
    packages' windows and states from the same arrays."""
    sensor = synth.default_sensor(48, 48, f=44.0)
    scene = synth.generate(np.random.default_rng(11), sensor, pano_width=128,
                           pano_height=64, c_th=0.2, t_end=0.5, dt_knots=0.05,
                           num_steps=120, motion_amp=0.3)
    noise = np.random.default_rng(5).normal(size=(scene.traj.num_knots, 3)) * 0.01
    traj = dataclasses.replace(scene.traj,
                               knots=spline._np_exp(noise) @ scene.traj.knots)
    win = pairing.build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                               traj.locate, 100)
    jdev = JM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                       jnp.float64)
    state = (traj.knots, scene.gx * 0.9, scene.gy * 0.9)
    return dict(win=win, lut=sensor.bearing_lut(), jdev=jdev,
                tdev=convert.device_window_from_jax(jdev, device="cpu"), state=state,
                num_knots=traj.num_knots)


def test_device_window_matches_conversion(case):
    own = TM.DeviceWindow.from_window(case["win"], case["lut"], 48, torch.float64,
                                      "cpu")
    for name in TM.DeviceWindow.__dataclass_fields__:
        assert torch.equal(getattr(own, name), getattr(case["tdev"], name)), name


def test_warp_events_matches(case):
    jdev, tdev = case["jdev"], case["tdev"]
    knots = case["state"][0]
    pano = JM.ModelConfig(**CFG).pano
    (jx, jy), jcp, jd = JW.warp_events(jnp.asarray(knots), jdev.batch_s, jdev.batch_u,
                                       jdev.batch_ids, jdev.bearings, pano, 2)
    (tx, ty), tcp, td = TW.warp_events(torch.from_numpy(knots), tdev.batch_s,
                                       tdev.batch_u, tdev.batch_ids, tdev.bearings,
                                       TM.ModelConfig(**CFG).pano, 2)
    np.testing.assert_array_equal(tcp.numpy(), np.asarray(jcp))
    for got, want in ((tx, jx), (ty, jy), (td, jd)):
        assert rel_err(got, want) <= 1e-11


def _both(case, **kw):
    jcfg, tcfg = JM.ModelConfig(**CFG, **kw), TM.ModelConfig(**CFG, **kw)
    k, gx, gy = case["state"]
    jl = JM.linearize(jnp.asarray(k), jnp.asarray(gx), jnp.asarray(gy), case["jdev"],
                      jcfg)
    tk, tgx, tgy = convert.state_from_numpy(k, gx, gy, torch.float64, "cpu")
    tl = TM.linearize(tk, tgx, tgy, case["tdev"], tcfg)
    jn = JM.form_normal_eq(jl, jnp.asarray(gx), jnp.asarray(gy), jcfg,
                           case["num_knots"])
    tn = TM.form_normal_eq(tl, tgx, tgy, tcfg, case["num_knots"])
    return jl, tl, jn, tn


@pytest.mark.parametrize("kw", [{}, {"sample_mode": "mid"},
                                {"use_irls": True, "cost_type": "huber", "eta": 0.5}],
                         ids=["curr", "mid", "huber"])
def test_linearize_and_form_normal_eq_match(case, kw):
    jl, tl, jn, tn = _both(case, **kw)
    for name in ("inlier", "pm_pix", "num_ev_map", "i_c", "i_p"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)))
    for name in ("e", "dx", "dy", "Jc", "Jp"):
        assert rel_err(getattr(tl, name), getattr(jl, name)) <= 1e-10, name

    hw, dim = 128 * 64, 3 * case["num_knots"]
    for name in ("A11", "b1"):
        assert rel_err(getattr(tn, name), getattr(jn, name)) <= 1e-10, name
    for name in ("a22_xx", "a22_xy", "a22_yy", "b2_x", "b2_y", "active"):
        assert rel_err(getattr(tn, name)[:hw], np.asarray(getattr(jn, name))[:hw]) \
            <= 1e-10, name
    tdp, jdp = tn.A12.shape[1] // 2, jn.A12.shape[1] // 2
    ja12 = np.asarray(jn.A12)
    assert rel_err(tn.A12[:hw, :dim], ja12[:hw, :dim]) <= 1e-10
    assert rel_err(tn.A12[:hw, tdp:tdp + dim], ja12[:hw, jdp:jdp + dim]) <= 1e-10
    np.testing.assert_array_equal(tn.active_pix.numpy(), np.asarray(jn.active_pix))
    assert int(tn.active_count) == int(jn.active_count) > 0


@pytest.mark.parametrize("fix_first", [False, True])
def test_solve_and_update_match(case, fix_first):
    _jl, _tl, jn, tn = _both(case)
    hw = 128 * 64
    jx1, jx2 = JM.solve_normal_eq(jn, 1e-3, fix_first)
    tx1, tx2 = TM.solve_normal_eq(tn, 1e-3, fix_first)
    assert rel_err(tx1, jx1) <= 1e-8
    assert rel_err(tx2[:, :hw], np.asarray(jx2)[:, :hw]) <= 1e-8

    k, gx, gy = case["state"]
    jk = JM.update_knots(jnp.asarray(k), jx1, fix_first)
    tk = TM.update_knots(torch.from_numpy(k), tx1, fix_first)
    assert rel_err(tk, jk) <= 1e-8
    jg = JM.update_map(jnp.asarray(gx), jnp.asarray(gy), jx2, 1.0, jn)
    tg = TM.update_map(torch.from_numpy(gx), torch.from_numpy(gy), tx2, 1.0, tn)
    for got, want in zip(tg, jg):
        assert rel_err(got, want) <= 1e-8


def test_costs_and_gradients_match(case):
    _k, gx, gy = case["state"]
    jgx = JM.second_order_gradients(jnp.asarray(gx), jnp.asarray(gy))
    tgx = TM.second_order_gradients(torch.from_numpy(gx), torch.from_numpy(gy))
    for got, want in zip(tgx, jgx):
        assert rel_err(got, want) <= 1e-12
    e = np.random.default_rng(0).normal(size=1000)
    for kw in ({}, {"use_irls": True, "cost_type": "cauchy", "eta": 0.7},
               {"use_irls": True, "cost_type": "huber", "eta": 0.7}):
        jc, tc = JM.ModelConfig(**CFG, **kw), TM.ModelConfig(**CFG, **kw)
        assert rel_err(TM.data_cost(torch.from_numpy(e), tc),
                       JM.data_cost(jnp.asarray(e), jc)) <= 1e-12
        assert rel_err(TM.irls_weights(torch.from_numpy(e), tc),
                       JM.irls_weights(jnp.asarray(e), jc)) <= 1e-12


@pytest.mark.parametrize("fix_first", [False, True])
def test_cg_solve_matches_jax(case, fix_first):
    """Block-Jacobi CG at its defaults (100 iterations, tol 1e-6): the
    iteration count of JAX's, the solution to 1e-8 of its largest
    magnitude, the relative residual to 1e-6 of itself."""
    _jl, _tl, jn, tn = _both(case)
    hw = 128 * 64
    jx1, jx2, jit, jerr = JM.solve_normal_eq_cg(jn, 1e-2, fix_first)
    tx1, tx2, tit, terr = TM.solve_normal_eq_cg(tn, 1e-2, fix_first)
    assert int(tit) == int(jit) and 0 < int(tit) <= 100
    assert float(terr) <= 1e-6
    assert abs(float(terr) - float(jerr)) <= 1e-6 * float(jerr)
    assert rel_err(tx1, jx1) <= 1e-8
    assert rel_err(tx2[:, :hw], np.asarray(jx2)[:, :hw]) <= 1e-8


def test_cg_solve_agrees_with_schur(case):
    """Mirror of tests/test_model.py::test_cg_solve_agrees_with_schur: CG
    run to tol 1e-10 reaches the Schur solution (atol 1e-6, rtol 1e-4)."""
    _jl, _tl, _jn, tn = _both(case)
    x1s, x2s = TM.solve_normal_eq(tn, 1e-2)
    x1c, x2c, _it, _err = TM.solve_normal_eq_cg(tn, 1e-2, max_iter=500, tol=1e-10)
    np.testing.assert_allclose(x1c.numpy(), x1s.numpy(), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(x2c.numpy(), x2s.numpy(), atol=1e-6, rtol=1e-4)


def test_cg_solve_without_host_reads_gives_the_same_bits(case):
    """In a CUDA graph the CG loop runs all its iterations and freezes once
    the test is met (``early_exit=False``): that loop, run here on the CPU,
    gives the early-exit loop's solution and iteration count exactly."""
    _jl, _tl, _jn, tn = _both(case)
    want = TM.solve_normal_eq_cg(tn, 1e-2, True)
    got = TM.solve_normal_eq_cg(tn, 1e-2, True, early_exit=False)
    assert int(want[2]) < 100
    for g, w in zip(got, want):
        assert torch.equal(g, w)


CONFIG_FIELDS = {"compact_cap": dict(compact_cap=1024),
                 "light_trial": dict(light_trial=True),
                 "stream_chunk": dict(stream_chunk=1024),
                 "stream_light": dict(stream_chunk=1024, stream_light=True)}


@pytest.mark.parametrize("field", list(CONFIG_FIELDS))
def test_ported_config_fields_form_like_jax(case, field):
    """``compact_cap``, ``light_trial``, ``stream_chunk`` and
    ``stream_light`` construct, and the forming pass they select gives
    JAX's normal equations at the same configuration (a cap above the
    active count; the light linearization then its forming pass; the FULL
    and LIGHT streamed tiers' objective then their chunked forming
    pass)."""
    kw = CONFIG_FIELDS[field]
    jc, tc = JM.ModelConfig(**CFG, **kw), TM.ModelConfig(**CFG, **kw)
    k = case["num_knots"]
    jk, jgx, jgy = (jnp.asarray(a) for a in case["state"])
    tk, tgx, tgy = convert.state_from_numpy(*case["state"], torch.float64, "cpu")
    if tc.stream_light:
        jl, _ = JM.linearize_streamed_light(jk, jgx, jgy, case["jdev"], jc)
    elif tc.stream_chunk is not None:
        jl = JM.cost_and_activity_streamed(jk, jgx, jgy, case["jdev"], jc)[1]
    else:
        jl = JM.linearize(jk, jgx, jgy, case["jdev"], jc, not tc.light_trial)
    if tc.stream_chunk is not None:
        jn = JM.form_normal_eq_streamed(jl, jk, jgx, jgy, case["jdev"], jc, k)
    elif tc.light_trial:
        jn = JM.form_normal_eq_light(jl, jk, jgx, jgy, case["jdev"], jc, k)
    else:
        jn = JM.form_normal_eq(jl, jgx, jgy, jc, k)
    mode = TM.window_mode(case["tdev"], tc)
    tn = mode.form(mode.objective(tk, tgx, tgy)[0], tk, tgx, tgy)
    assert int(tn.dropped) == int(jn.dropped) == 0
    assert int(tn.active_count) == int(jn.active_count)
    assert rel_err(tn.A11, jn.A11) <= 1e-10 and rel_err(tn.b1, jn.b1) <= 1e-10
    r = min(tn.b2_x.shape[0], jn.b2_x.shape[0])
    assert rel_err(tn.b2_x[:r], np.asarray(jn.b2_x)[:r]) <= 1e-10


def test_device_window_from_jax_needs_a_device():
    """No device is assumed: the caller names the card or the CPU."""
    with pytest.raises(TypeError, match="device"):
        convert.device_window_from_jax(None)


def test_linearization_meets_cuda_kernel_contract(case):
    """The f32 linearization hands the CUDA kernel what it takes (int32 and
    f32, contiguous (D, N) Jacobians): checked here, launched on the card."""
    from emba_tpu_torch.kernels import a12_accum as TK

    cfg = TM.ModelConfig(**CFG)
    tk, tgx, tgy = convert.state_from_numpy(*case["state"], torch.float32, "cpu")
    dev = convert.device_window_from_jax(case["jdev"], dtype=torch.float32,
                                          device="cpu")
    lin = TM.linearize(tk, tgx, tgy, dev, cfg)
    wA = TM._meas_weights(lin.e, lin.inlier, lin.pm_pix,
                               lin.num_ev_map >= cfg.thres_valid_pixel, cfg,
                               torch.float32)
    TK.check_inputs(lin.pm_pix, lin.i_c, lin.i_p, lin.Jc, lin.Jp, lin.dx, lin.dy,
                    lin.e, wA, cfg.num_pix, 3 * case["num_knots"], cfg.spline_order)
