"""The port's streamed tiers against the JAX package's on the CPU: the FULL
tier (objective and forming pass recomputed chunk by chunk, the A12
accumulation chained through its carry) and the LIGHT tier (resident (N,)
residual fields, Jacobians recomputed), their windows fused and through the
host loop, and a window pre-padded to a chunk multiple. Chunk sizes 977 and
2048 do not divide the window's event count.

Tolerances, relative to each output's largest magnitude, in f64: 1e-10 for
every NormalEq field against JAX's streamed pass and against the port's
classic pass (the chunked sums run in another order), 1e-12 for costs and
the light linearization's fields; windows against JAX: the same iterations
and accepts, costs and knots to 1e-10; a padded window against the
unpadded one to 1e-12. In f32 the port's streamed forming on the CPU
against JAX's streamed XLA pass: rtol 2e-5, atol 2e-4 (the tolerance of
``tests/test_kernel.py``'s streamed test).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu import lm as JL
from emba_tpu import model as JM
from emba_tpu import pairing, spline, synth
from emba_tpu import solver as JS
from emba_tpu_torch import lm as TL
from emba_tpu_torch import model as TM
from emba_tpu_torch import solver as TS

CFG = dict(c_th=0.2, pano_width=128, pano_height=64, thres_valid_pixel=3,
           alpha=2.0, spline_order=2)
FIELDS = ("A11", "b1", "a22_xx", "a22_xy", "a22_yy", "b2_x", "b2_y", "A12")
CHUNKS = (977, 2048)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.fixture(scope="module")
def case():
    """The small scene of tests/test_model.py with 0.01 rad knot noise, both
    packages' windows and states from the same arrays."""
    sensor = synth.default_sensor(48, 48, f=44.0)
    scene = synth.generate(np.random.default_rng(11), sensor, pano_width=128,
                           pano_height=64, c_th=0.2, t_end=0.5, dt_knots=0.05,
                           num_steps=120, motion_amp=0.3)
    noise = np.random.default_rng(5).normal(size=(scene.traj.num_knots, 3)) * 0.01
    traj = dataclasses.replace(scene.traj, knots=spline._np_exp(noise) @ scene.traj.knots)
    win = pairing.build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                               traj.locate, 100)
    lut = sensor.bearing_lut()
    jdev = JM.DeviceWindow.from_window(win, lut, sensor.width, jnp.float64)
    tdev = TM.DeviceWindow.from_window(win, lut, sensor.width, torch.float64, "cpu")
    n = win.num_events
    assert all(n % sc for sc in CHUNKS), "the chunks must not divide the window"
    state = (traj.knots, scene.gx * 0.9, scene.gy * 0.9)
    return dict(win=win, lut=lut, width=sensor.width, jdev=jdev, tdev=tdev,
                state=state, nk=traj.num_knots,
                j=tuple(jnp.asarray(a) for a in state),
                t=tuple(torch.from_numpy(np.array(a)) for a in state))


def planes(neq):
    """A12's two column planes without their padding (the packages pad the
    pose columns to other multiples)."""
    a12 = np.asarray(neq.A12)
    dim, dp = np.asarray(neq.b1).shape[0], a12.shape[1] // 2
    return a12[:, :dim], a12[:, dp:dp + dim]


def assert_neq(got, want, tol, what):
    for f in FIELDS[:-1]:
        assert rel_err(getattr(got, f), getattr(want, f)) <= tol, f"{what}: {f}"
    for g, w in zip(planes(got), planes(want)):
        assert rel_err(g, w) <= tol, f"{what}: A12"
    for f in ("active", "pix2row", "active_pix"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert int(got.dropped) == int(want.dropped)
    assert int(got.active_count) == int(want.active_count)


def classic(case, cfg):
    lin = TM.linearize(*case["t"], case["tdev"], cfg)
    return lin, TM.form_normal_eq(lin, *case["t"][1:], cfg, case["nk"])


@pytest.mark.parametrize("sc", CHUNKS)
def test_streamed_form_matches_jax_and_classic(case, sc):
    """Mirror of tests/test_model.py:467: the FULL tier's objective gives
    the classic cost and inlier count map, its forming pass the classic
    normal equations and JAX's streamed ones, with compaction too."""
    cfg = TM.ModelConfig(**CFG, stream_chunk=sc)
    jcfg = JM.ModelConfig(**CFG, stream_chunk=sc)
    lin, neq0 = classic(case, TM.ModelConfig(**CFG))
    mode = TM.window_mode(case["tdev"], cfg)
    cost, nem = mode.cost_and_activity(*case["t"])
    assert rel_err(cost, TM.data_cost(lin.e, cfg)) <= 1e-12
    assert torch.equal(nem, lin.num_ev_map)
    jcost, jnem = JM.cost_and_activity_streamed(*case["j"], case["jdev"], jcfg)
    assert rel_err(cost, jcost) <= 1e-12
    np.testing.assert_array_equal(nem.numpy(), np.asarray(jnem))

    neq = mode.form(TM.Activity(nem), *case["t"])
    assert_neq(neq, neq0, 1e-10, f"classic sc={sc}")
    jneq = JM.form_normal_eq_streamed(jnem, *case["j"], case["jdev"], jcfg, case["nk"])
    assert_neq(neq, jneq, 1e-10, f"jax sc={sc}")

    # compaction composes: a cap above the active count, the same solve
    cap = int(neq0.active_count) + 11
    cfg_c = dataclasses.replace(cfg, compact_cap=cap)
    neq_c = TM.window_mode(case["tdev"], cfg_c).form(TM.Activity(nem), *case["t"])
    jneq_c = JM.form_normal_eq_streamed(
        jnem, *case["j"], case["jdev"], dataclasses.replace(jcfg, compact_cap=cap),
        case["nk"])
    assert_neq(neq_c, jneq_c, 1e-10, f"compacted jax sc={sc}")
    x1a, _ = TM.solve_normal_eq(neq0, 1e-3, True)
    x1b, _ = TM.solve_normal_eq(neq_c, 1e-3, True)
    assert rel_err(x1b, x1a) <= 1e-8


@pytest.mark.parametrize("sc", CHUNKS)
def test_streamed_light_form_matches_jax_and_classic(case, sc):
    """Mirror of tests/test_model.py:525: the LIGHT tier's forming pass on
    the one-pass light linearization gives the classic normal equations and
    JAX's, with compaction too."""
    cfg = TM.ModelConfig(**CFG, stream_chunk=sc, stream_light=True)
    jcfg = JM.ModelConfig(**CFG, stream_chunk=sc, stream_light=True)
    _lin, neq0 = classic(case, TM.ModelConfig(**CFG))
    light = TM.linearize(*case["t"], case["tdev"], cfg, need_deriv=False)
    assert light.Jc.shape[1] == 0
    jlight = JM.linearize(*case["j"], case["jdev"], jcfg, False)
    neq = TM.window_mode(case["tdev"], cfg).form(light, *case["t"])
    assert_neq(neq, neq0, 1e-10, f"classic sc={sc}")
    jneq = JM.form_normal_eq_streamed(jlight, *case["j"], case["jdev"], jcfg, case["nk"])
    assert_neq(neq, jneq, 1e-10, f"jax sc={sc}")

    cap = int(neq0.active_count) + 11
    cfg_c = dataclasses.replace(cfg, compact_cap=cap)
    neq_c = TM.window_mode(case["tdev"], cfg_c).form(light, *case["t"])
    x1a, _ = TM.solve_normal_eq(neq0, 1e-3, True)
    x1b, _ = TM.solve_normal_eq(neq_c, 1e-3, True)
    assert rel_err(x1b, x1a) <= 1e-8


@pytest.mark.parametrize("sc", CHUNKS)
def test_linearize_streamed_light_matches_onepass_and_jax(case, sc):
    """Mirror of tests/test_model.py:580: the chunked light linearization
    equals the one-pass one (integer fields exactly, residual fields to
    1e-12: a chunk boundary moves which elements the CPU's vector loops
    round through their scalar tail) and JAX's streamed one."""
    cfg = TM.ModelConfig(**CFG, stream_chunk=sc, stream_light=True)
    ref = TM.linearize(*case["t"], case["tdev"], cfg, need_deriv=False)
    lin, cost, _ = TM.window_mode(case["tdev"], cfg).objective(*case["t"])
    jlin, jcost = JM.linearize_streamed_light(
        *case["j"], case["jdev"], JM.ModelConfig(**CFG, stream_chunk=sc, stream_light=True))
    for f in ("inlier", "pm_pix", "num_ev_map", "i_c", "i_p"):
        assert torch.equal(getattr(lin, f), getattr(ref, f)), f
        np.testing.assert_array_equal(getattr(lin, f).numpy(), np.asarray(getattr(jlin, f)))
    for f in ("e", "dx", "dy"):
        assert rel_err(getattr(lin, f), getattr(ref, f)) <= 1e-12, f
        assert rel_err(getattr(lin, f), getattr(jlin, f)) <= 1e-12, f
    assert lin.Jc.shape == (cfg.dim_block, 0)
    assert rel_err(cost, TM.data_cost(ref.e, cfg)) <= 1e-12
    assert rel_err(cost, jcost) <= 1e-12


def test_streamed_f32_forming_matches_jax_xla(case):
    """Mirror of tests/test_kernel.py:201: the port's streamed f32 forming
    pass on the CPU (the A12 kernel's plain version chained through its
    carry) against JAX's streamed f32 XLA pass."""
    win, lut, width = case["win"], case["lut"], case["width"]
    cfg = TM.ModelConfig(**CFG, stream_chunk=977)
    jcfg = JM.ModelConfig(**CFG, stream_chunk=977)
    tdev = TM.DeviceWindow.from_window(win, lut, width, torch.float32, "cpu")
    jdev = JM.DeviceWindow.from_window(win, lut, width, jnp.float32)
    t = tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in case["state"])
    j = tuple(jnp.asarray(a, jnp.float32) for a in case["state"])
    mode = TM.window_mode(tdev, cfg)
    _, nem = mode.cost_and_activity(*t)
    _, jnem = JM.cost_and_activity_streamed(*j, jdev, jcfg)
    np.testing.assert_array_equal(nem.numpy(), np.asarray(jnem))
    neq = mode.form(TM.Activity(nem), *t)
    jneq = JM.form_normal_eq_streamed(jnem, *j, jdev, jcfg, case["nk"])
    for f in FIELDS[:-1]:
        np.testing.assert_allclose(getattr(neq, f).numpy(), np.asarray(getattr(jneq, f)),
                                   rtol=2e-5, atol=2e-4, err_msg=f)
    for g, w in zip(planes(neq), planes(jneq)):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-4, err_msg="A12")


def test_stream_chunk_map_and_pad_multiple(case):
    """The chunk bounds come from the shapes alone; a pre-padded window
    holds unit-z bearings and no measurement in its padding, so its last
    chunk is full."""
    assert TM.stream_bounds(5000, 2048) == [(0, 2048), (2048, 4096), (4096, 5000)]
    assert TM.stream_bounds(0, 2048) == [(0, 0)]
    n = case["win"].num_events
    pad = TM.DeviceWindow.from_window(case["win"], case["lut"], case["width"],
                                      torch.float64, "cpu", pad_multiple=2048)
    n_pad = pad.pol_signed.shape[0]
    assert n_pad % 2048 == 0 and n < n_pad < n + 2048
    assert all(hi - lo == 2048 for lo, hi in TM.stream_bounds(n_pad, 2048))
    assert torch.equal(pad.bearings[:, n:], torch.tensor([[0.0], [0.0], [1.0]]).expand(
        3, n_pad - n))
    assert not pad.has_prev[n:].any() and not pad.pol_signed[n:].any()
    for f in ("bearings", "pol_signed", "prev_idx", "has_prev", "batch_ids", "sensor_pix"):
        assert torch.equal(getattr(pad, f)[..., :n], getattr(case["tdev"], f)), f


@pytest.fixture(scope="module")
def e2e(case):
    """The windows of tests/test_e2e.py's streamed tests at this file's
    small scene: the model of ``CFG``, the start of ``case``."""
    return dict(case, cfg=CFG)


def jax_fused(e2e, **kw):
    cfg = JM.ModelConfig(**e2e["cfg"], **kw)
    return JS.solve_window_fused(*e2e["j"], e2e["jdev"], cfg, jnp.asarray(1.0),
                                 jnp.asarray(1e-3), fix_first=True, max_num_iter=6,
                                 return_trace=True)


def port_fused(e2e, dev=None, stats=None, **kw):
    cfg = TM.ModelConfig(**e2e["cfg"], **kw)
    return TS.solve_window_fused(*e2e["t"], dev or e2e["tdev"], cfg, 1.0, 1e-3,
                                 fix_first=True, max_num_iter=6, return_trace=True,
                                 stats=stats)


def assert_windows_match(got, want, tol=1e-10):
    k, gx, gy, cost, it, conv, trace = got
    assert int(it) == int(want[4]) and bool(conv) == bool(want[5])
    recs = TL.trace_records(trace.numpy(), int(it))
    jrecs = JL.trace_records(np.asarray(want[6]), int(want[4]))
    assert [r["accepted"] for r in recs] == [r["accepted"] for r in jrecs]
    assert [r["active_px"] for r in recs] == [r["active_px"] for r in jrecs]
    assert rel_err(cost, want[3]) <= tol
    assert rel_err(k, want[0]) <= tol
    assert rel_err(gx, want[1]) <= 1e2 * tol and rel_err(gy, want[2]) <= 1e2 * tol


@pytest.mark.parametrize("light", [False, True])
def test_fused_streamed_window_matches_jax_and_classic(e2e, light):
    """Mirror of tests/test_e2e.py:340 (FULL) and :425 (LIGHT): the port's
    streamed fused window against JAX's and against the port's classic
    window, and the streamed host loop against the fused one. The FULL
    tier's eager loop re-forms at the top of every iteration (a forming
    pass each), as the reference's fused loop does."""
    kw = dict(stream_chunk=2048, stream_light=light)
    stats = TL.LoopStats()
    got = port_fused(e2e, stats=stats, **kw)
    assert_windows_match(got, jax_fused(e2e, **kw))
    assert_windows_match(got, port_fused(e2e), tol=1e-10)
    it = int(got[4])
    accepts = [r["accepted"] for r in TL.trace_records(got[6].numpy(), it)]
    assert stats.form_passes == (1 + sum(accepts[:-1]) if light else it)

    k, gx, _gy, st = TS.solve_window(*e2e["t"], e2e["tdev"], TM.ModelConfig(**e2e["cfg"], **kw),
                                    TS.LMConfig(max_num_iter=6), fix_first=True)
    assert len(st.iterations) == it
    assert [r["cost_new"] < r["cost_min"] for r in st.iterations] == accepts
    assert st.count_form == 1 + sum(accepts[:-1])
    assert rel_err(k, got[0]) <= 1e-10 and rel_err(gx, got[1]) <= 1e-8


def test_fused_padded_window_matches(e2e):
    """Mirror of tests/test_e2e.py:388: a window pre-padded to a chunk
    multiple solves as the unpadded one (its padding measures nothing)."""
    pad = TM.DeviceWindow.from_window(e2e["win"], e2e["lut"], e2e["width"],
                                      torch.float64, "cpu", pad_multiple=2048)
    want = port_fused(e2e, stream_chunk=2048)
    got = port_fused(e2e, dev=pad, stream_chunk=2048)
    assert int(got[4]) == int(want[4])
    for g, w in zip(got[:4], want[:4]):
        assert rel_err(g, w) <= 1e-12


@pytest.mark.parametrize("duration", [4.8, 6.4])
def test_synth_renders_long_spans(duration):
    """The scene of a streamed window above the classic cap spans 6.4 s;
    the port's renderer fits its ground truth there (the reference's fit
    needs two motion samples a knot interval and raises past ~5 s) and is
    the reference's renderer up to that span."""
    from emba_tpu_torch import synth as tsynth

    kw = dict(pano_width=64, pano_height=32, c_th=0.2, t_end=duration, dt_knots=0.05,
              num_steps=int(duration * 100), motion_amp=0.22)
    t = tsynth.generate(np.random.default_rng(11), tsynth.default_sensor(8, 6, f=7.2), **kw)
    assert t.traj.num_knots == int(round(duration / 0.05)) + 1
    assert np.isfinite(t.traj.knots).all() and len(t.t) > 0
    if duration < 5.0:
        j = synth.generate(np.random.default_rng(11), synth.default_sensor(8, 6, f=7.2), **kw)
        np.testing.assert_array_equal(t.x, j.x)
        assert rel_err(t.traj.knots, j.traj.knots) <= 1e-12
    else:
        with pytest.raises(ValueError, match="poses"):
            synth.generate(np.random.default_rng(11), synth.default_sensor(8, 6, f=7.2),
                           **kw)
