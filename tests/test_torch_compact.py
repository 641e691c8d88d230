"""Active-pixel compaction and the light linearization of the port against
the JAX package on the CPU in f64 (the JAX side forms on its XLA path),
and against the port's own uncompacted and classic paths. Both packages
get the same numpy inputs.

Tolerances: against JAX, relative 1e-10 of each output's largest
magnitude for the Linearization and NormalEq fields and 1e-8 for the
solve (as ``test_torch_model.py``); equal integer fields (pixels, rows,
active and dropped counts) exactly. Within the port, the light
linearization and its forming pass give the classic bits, and a cap
above the active count gives the uncompacted solve to absolute 1e-10 (the
row space is a permutation of the active pixels).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu import model as JM
from emba_tpu import pairing, spline, synth
from emba_tpu_torch import convert
from emba_tpu_torch import model as TM


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


def _case(sensor_px, f, pano_w, pano_h, seed, t_end, steps, motion, brightness=None,
          **cfg):
    sensor = synth.default_sensor(sensor_px, sensor_px, f=f)
    rng = np.random.default_rng(seed)
    if brightness is not None:
        brightness = synth.smooth_random_map(pano_h, pano_w, rng, **brightness)
    scene = synth.generate(rng, sensor, pano_width=pano_w, pano_height=pano_h,
                           c_th=cfg["c_th"], t_end=t_end, dt_knots=0.05,
                           num_steps=steps, motion_amp=motion, brightness=brightness)
    noise = np.random.default_rng(5).normal(size=(scene.traj.num_knots, 3)) * 0.01
    traj = dataclasses.replace(scene.traj, knots=spline._np_exp(noise) @ scene.traj.knots)
    win = pairing.build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                               traj.locate, 100)
    jdev = JM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                       jnp.float64)
    state = (traj.knots, scene.gx * 0.9, scene.gy * 0.9)
    base = dict(pano_width=pano_w, pano_height=pano_h, spline_order=2, **cfg)
    return dict(jdev=jdev, tdev=convert.device_window_from_jax(jdev, device="cpu"),
                jstate=tuple(jnp.asarray(a) for a in state),
                tstate=convert.state_from_numpy(*state, torch.float64, "cpu"),
                num_knots=traj.num_knots, cfg=base)


@pytest.fixture(scope="module")
def small():
    """The scene of tests/test_model.py (238 active pixels at thres 3)."""
    return _case(48, 44.0, 128, 64, 11, 0.5, 120, 0.3, c_th=0.2, thres_valid_pixel=3,
                 alpha=2.0)


@pytest.fixture(scope="module")
def dense():
    """A denser scene (the one of tests/test_e2e.py at thres 2), with more
    active pixels than a cap of 1000 holds."""
    return _case(48, 44.0, 192, 96, 42, 1.0, 600, 0.25,
                 brightness=dict(smooth=3, amp=3.0), c_th=0.1, thres_valid_pixel=2,
                 alpha=0.5, outlier_dp_norm=3.0)


def _both(case, **over):
    cfg = dict(case["cfg"], **over)
    jc, tc = JM.ModelConfig(**cfg), TM.ModelConfig(**cfg)
    jl = JM.linearize(*case["jstate"], case["jdev"], jc, True)
    tl = TM.linearize(*case["tstate"], case["tdev"], tc)
    k = case["num_knots"]
    jn = JM.form_normal_eq(jl, *case["jstate"][1:], jc, k)
    tn = TM.form_normal_eq(tl, *case["tstate"][1:], tc, k)
    return jl, tl, jn, tn


def assert_neq_matches(tn, jn, tol=1e-10):
    """The port's NormalEq against JAX's: the JAX rows are rounded to 512,
    the port's uncompacted rows to 128 (past HW both are inactive and
    zero); A12 is compared on the pose columns of both planes."""
    r = min(tn.a22_xx.shape[0], jn.a22_xx.shape[0])
    for f in ("a22_xx", "a22_xy", "a22_yy", "b2_x", "b2_y"):
        assert rel_err(getattr(tn, f)[:r], np.asarray(getattr(jn, f))[:r]) <= tol, f
    assert rel_err(tn.A11, jn.A11) <= tol and rel_err(tn.b1, jn.b1) <= tol
    dim, tdp, jdp = tn.b1.shape[0], tn.A12.shape[1] // 2, jn.A12.shape[1] // 2
    ja12 = np.asarray(jn.A12)
    for t0, j0 in ((0, 0), (tdp, jdp)):
        assert rel_err(tn.A12[:r, t0:t0 + dim], ja12[:r, j0:j0 + dim]) <= tol
    np.testing.assert_array_equal(tn.active[:r].numpy(), np.asarray(jn.active)[:r])
    np.testing.assert_array_equal(tn.pix2row.numpy(), np.asarray(jn.pix2row))
    np.testing.assert_array_equal(tn.active_pix.numpy(), np.asarray(jn.active_pix))
    assert int(tn.active_count) == int(jn.active_count)
    assert int(tn.dropped) == int(jn.dropped)


LIGHT_FIELDS = ("e", "inlier", "pm_pix", "num_ev_map", "dx", "dy", "i_c", "i_p")


@pytest.mark.parametrize("sample_mode", ["curr", "mid"])
def test_light_linearization_matches_jax(small, sample_mode):
    """linearize(need_deriv=False): JAX's residual fields, no Jacobians,
    and the bits of the port's own classic linearization."""
    cfg = dict(small["cfg"], sample_mode=sample_mode)
    jl = JM.linearize(*small["jstate"], small["jdev"], JM.ModelConfig(**cfg), False)
    tc = TM.ModelConfig(**cfg)
    tl = TM.linearize(*small["tstate"], small["tdev"], tc, need_deriv=False)
    full = TM.linearize(*small["tstate"], small["tdev"], tc)
    for f in LIGHT_FIELDS:
        want, got = np.asarray(getattr(jl, f)), getattr(tl, f).numpy()
        if want.dtype.kind == "f":
            assert rel_err(got, want) <= 1e-10, f
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert torch.equal(getattr(tl, f), getattr(full, f)), f
    assert tuple(tl.Jc.shape) == tuple(jl.Jc.shape) == (tc.dim_block, 0)
    assert tuple(tl.Jp.shape) == (tc.dim_block, 0)


@pytest.mark.parametrize("sample_mode", ["curr", "mid"])
def test_form_normal_eq_light_matches_classic_and_jax(small, sample_mode):
    """The light forming pass recomputes the Jacobians: the classic
    NormalEq bit for bit in the port, JAX's light pass to 1e-10."""
    cfg = dict(small["cfg"], sample_mode=sample_mode)
    jc, tc = JM.ModelConfig(**cfg), TM.ModelConfig(**cfg)
    k = small["num_knots"]
    tl = TM.linearize(*small["tstate"], small["tdev"], tc, need_deriv=False)
    got = TM.window_mode(small["tdev"], dataclasses.replace(tc, light_trial=True)).form(
        tl, *small["tstate"])
    classic = TM.form_normal_eq(TM.linearize(*small["tstate"], small["tdev"], tc),
                                *small["tstate"][1:], tc, k)
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(classic, f.name)), f.name
    jl = JM.linearize(*small["jstate"], small["jdev"], jc, False)
    jn = JM.form_normal_eq_light(jl, *small["jstate"], small["jdev"], jc, k)
    assert_neq_matches(got, jn)


def test_compact_cap_equivalence(small):
    """A cap above the active count (mirror of tests/test_model.py:342):
    the uncompacted solve in the port, and JAX's compacted NormalEq."""
    jl, tl, jn0, tn0 = _both(small)
    n_active = int(tn0.active.sum())
    cap = n_active + 37
    _jl, _tl, jn1, tn1 = _both(small, compact_cap=cap)
    assert tn1.a22_xx.shape[0] == 512 < tn0.a22_xx.shape[0]
    assert int(tn1.active.sum()) == n_active and int(tn1.dropped) == 0
    assert_neq_matches(tn1, jn1)

    x1a, x2a = TM.solve_normal_eq(tn0, 1e-3, True)
    x1b, x2b = TM.solve_normal_eq(tn1, 1e-3, True)
    np.testing.assert_allclose(x1b.numpy(), x1a.numpy(), atol=1e-10)
    G = small["tstate"][1:]
    for a, b in zip(TM.update_map(*G, x2a, 1.0, tn0), TM.update_map(*G, x2b, 1.0, tn1)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-10)
    jx1, _ = JM.solve_normal_eq(jn1, jnp.asarray(1e-3), True)
    assert rel_err(x1b, jx1) <= 1e-8


def test_compact_cap_overflow_drops_rows(small):
    """A cap under the active count (mirror of tests/test_model.py:375):
    no failure, finite solve and map, at most R_pad active rows; JAX's
    row space, dropped count and solve."""
    n_active = int(_both(small)[3].active.sum())
    cap = max(8, n_active // 2)
    _jl, _tl, jn, tn = _both(small, compact_cap=cap)
    assert int(tn.active.sum()) <= -(-cap // 512) * 512
    assert_neq_matches(tn, jn)
    x1, x2 = TM.solve_normal_eq(tn, 1e-3, True)
    assert torch.isfinite(x1).all()
    gx, gy = TM.update_map(*small["tstate"][1:], x2, 1.0, tn)
    assert torch.isfinite(gx).all() and torch.isfinite(gy).all()
    jx1, _ = JM.solve_normal_eq(jn, jnp.asarray(1e-3), True)
    assert rel_err(x1, jx1) <= 1e-8


@pytest.mark.parametrize("cap", [1000, 1500])
def test_compact_cap_overflow_symmetric(dense, cap):
    """An undersized cap that is not a multiple of 512 (mirror of
    tests/test_model.py:400): the row space is the cap rounded up to 512
    as in the reference, so both packages keep the same slots and drop the
    same measurements; ``dropped`` counts them, and they leave every block
    (the pose block equals an uncapped build with them masked out)."""
    cfg = TM.ModelConfig(**dense["cfg"])
    k = dense["num_knots"]
    lin = TM.linearize(*dense["tstate"], dense["tdev"], cfg)
    active = (lin.num_ev_map >= cfg.thres_valid_pixel).numpy()
    r_pad = -(-cap // 512) * 512
    assert active.sum() > r_pad, "the scene must overflow the cap"
    compact_id = np.cumsum(active.astype(np.int64)) - 1
    pix = lin.pm_pix.numpy()
    on_overflow = active[pix] & (compact_id[pix] >= r_pad)
    expected = int(np.sum(lin.inlier.numpy() & on_overflow))
    assert expected > 0

    _jl, _tl, jn, tn = _both(dense, compact_cap=cap)
    assert tn.a22_xx.shape[0] == r_pad
    assert int(tn.dropped) == int(jn.dropped) == expected
    assert_neq_matches(tn, jn)
    np.testing.assert_allclose(tn.A11.numpy(), tn.A11.numpy().T, atol=1e-10)

    mask = torch.from_numpy(on_overflow)
    masked = dataclasses.replace(lin, inlier=lin.inlier & ~mask,
                                 e=torch.where(mask, 0.0, lin.e))
    ref = TM.form_normal_eq(masked, *dense["tstate"][1:], cfg, k)
    np.testing.assert_allclose(tn.A11.numpy(), ref.A11.numpy(), atol=1e-10)
    np.testing.assert_allclose(tn.b1.numpy(), ref.b1.numpy(), atol=1e-10)
    x1, _ = TM.solve_normal_eq(tn, 1e-3, True)
    jx1, _ = JM.solve_normal_eq(jn, jnp.asarray(1e-3), True)
    assert rel_err(x1, jx1) <= 1e-8


def test_compact_cap_must_be_positive():
    with pytest.raises(ValueError, match="compact_cap"):
        TM.ModelConfig(compact_cap=0)


def test_deferred_streamed_window_matches_the_float64_reference(tmp_path, monkeypatch):
    """A tiny window whose panorama (128x64) is above the row ceiling (here
    4096 rows) defers its cap, streams (chunks of 4096 events) and is
    solved by the pipeline in f64 on the CPU: against the benchmark's plain
    float64 reference (``benchmark/reference/ba.py``, through
    ``benchmark.check.numbers``) every number is within the ``span`` mix's
    limits, and the cap came from the counted pixels with none past it."""
    from benchmark import check, registry, run
    from benchmark.reference import ba
    from benchmark.tests import tiny
    from emba_tpu_torch import camera, obs, pipeline
    from emba_tpu_torch import config as ecfg

    plan = pipeline.plan_model_config
    monkeypatch.setattr(pipeline, "plan_model_config",
                        lambda *a, **kw: plan(*a, **kw, rows_large=4096))
    reg = registry.Registry(tiny.make_root(tmp_path))
    conf, traffic = reg.config("tiny"), reg.traffic("span")
    st = run.settings(conf, traffic)

    def make_cfg():
        cfg = run.program_config(ecfg, conf, traffic, st)
        cfg.stream_chunk = 4096
        return cfg

    inp = run.Inputs(conf, traffic, torch.device("cpu"), camera)
    job = run.run_job(pipeline, make_cfg, inp, 0, "cpu", False)
    cnt = obs.runs()[-1].counters
    assert job["events"] > 2 * 4096
    assert 0 < cnt["plan.active_px"] <= cnt["plan.rows"] == 4096
    assert cnt["plan.overflow_px"] == 0
    win = ba.prepare_window(st, inp.events, job["dim_pose"] // 3, "cpu")
    nums = check.numbers(st, win, dict(pose_times=inp.pose_times,
                                       pose_rotations=job["pose_R"], init_gx=inp.gx,
                                       init_gy=inp.gy),
                         dict(knots=job["knots"], gx=job["gx"], gy=job["gy"],
                              iterations=job["its"]), "cpu")
    assert check.within(nums, traffic["limits"]), nums
