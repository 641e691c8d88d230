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
                tdev=convert.device_window_from_jax(jdev), state=state,
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


@pytest.mark.parametrize("field", ["compact_cap", "stream_chunk", "light_trial",
                                   "stream_light"])
def test_unported_config_fields_raise(field):
    value = 1024 if field in ("compact_cap", "stream_chunk") else True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.ModelConfig(**CFG, **{field: value})


def test_linearization_meets_cuda_kernel_contract(case):
    """The f32 linearization hands the CUDA kernel what it takes (int32 and
    f32, contiguous (D, N) Jacobians): checked here, launched on the card."""
    from emba_tpu_torch.kernels import a12_accum as TK

    cfg = TM.ModelConfig(**CFG)
    tk, tgx, tgy = convert.state_from_numpy(*case["state"], torch.float32, "cpu")
    dev = convert.device_window_from_jax(case["jdev"], dtype=torch.float32)
    lin = TM.linearize(tk, tgx, tgy, dev, cfg)
    wA = TM._meas_weights(lin.e, lin.inlier, lin.pm_pix,
                               lin.num_ev_map >= cfg.thres_valid_pixel, cfg,
                               torch.float32)
    TK.check_inputs(lin.pm_pix, lin.i_c, lin.i_p, lin.Jc, lin.Jp, lin.dx, lin.dy,
                    lin.e, wA, cfg.num_pix, 3 * case["num_knots"], cfg.spline_order)
