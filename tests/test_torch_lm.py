"""The port's on-device LM loop (``lm.lm_while``) against
``emba_tpu.lm.lm_while`` on a scripted scalar problem, and the CUDA-graph
loop (``lm.GraphedLoop``, and the cached one of ``solve_window_fused``)
against it with its graphs replaced by an eager stand-in, so that its
control flow runs on the CPU.

The scripted problem makes the cost of each trial a fixed number, so the
accept/reject sequence is known: the state counts accepted steps and each
trial records its lambda, from which the objective recovers the iteration.
Every comparison is exact: the same f64 operations on the same scalars.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emba_tpu import lm as JL
from emba_tpu_torch import kernels, obs, pairing
from emba_tpu_torch import lm as TL
from emba_tpu_torch import model as TM
from emba_tpu_torch import solver as TS
from emba_tpu_torch import synth

COST0 = 10.0
# trial costs by iteration: A r A r A A(large) A -> converged at it=7 with
# tol_fun 0.1 and two small accepted steps, because an accepted but large
# step (4.8 -> 4.0) keeps the counter and a reject (4.9 -> 7) clears it
SCRIPT = [5.0, 6.0, 4.9, 7.0, 4.8, 4.0, 3.99, 3.5, 3.4, 3.3, 3.2, 3.1, 3.0]
TOL = dict(tol_fun=0.1, num_times_tol_fun_sat=2)


def scripted(xp, script, cost0):
    """(objective, form, solve_update) over the array module ``xp``.
    knots = [accepted steps], Gx = [log10 lambda of the trial], Gy = [0 at
    the start, 1 for a trial]."""
    if xp is torch:
        def rnd(x):
            return torch.round(x).long()
    else:
        def rnd(x):
            return jnp.round(x).astype(jnp.int32)

    def objective(knots, gx, gy):
        i = rnd(2.0 * knots[0] + gx[0] + 1.0)
        cost = xp.where(gy[0] == 0.0, cost0, script[xp.clip(i, 0, len(script) - 1)])
        return cost, knots * 2.0

    def form(aux, knots, gx, gy):
        return aux + knots

    def solve_update(sys, knots, gx, gy, lam):
        return knots + 1.0, gx * 0.0 + xp.log10(lam), gy * 0.0 + 1.0

    return objective, form, solve_update


def run_jax(script=SCRIPT, max_num_iter=20, carry_aux=False, **tol):
    obj, form, upd = scripted(jnp, jnp.asarray(script), COST0)
    z = jnp.zeros(1)
    out = JL.lm_while(z, z, z, objective=obj, form=form, solve_update=upd,
                      max_num_iter=max_num_iter, carry_aux=carry_aux, **(tol or TOL))
    return [np.asarray(x) for x in out]


def run_port(loop=TL.lm_while, script=SCRIPT, max_num_iter=20, stats=None, **kw):
    obj, form, upd = scripted(torch, torch.tensor(script, dtype=torch.float64), COST0)
    z = torch.zeros(1, dtype=torch.float64)
    tol = {k: kw.pop(k) for k in list(kw) if k in TOL}
    out = loop(z, z.clone(), z.clone(), objective=obj, form=form, solve_update=upd,
               max_num_iter=max_num_iter, stats=stats, **(tol or TOL), **kw)
    return [x.numpy() for x in out]


def test_lm_while_matches_jax_trace():
    want = run_jax()
    got = run_port()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    it, converged, trace = int(got[4]), bool(got[5]), got[6]
    # the tol-sat counter resets only on a reject: converged at it=7
    assert it == 7 and converged
    recs = TL.trace_records(trace, it)
    assert [r["accepted"] for r in recs] == [True, False, True, False, True, True, True]
    assert [r["cost_new"] for r in recs] == SCRIPT[:7]
    assert float(got[3]) == 3.99


@pytest.mark.parametrize("max_num_iter", [0, 3])
def test_lm_while_stops_at_max_num_iter_like_jax(max_num_iter):
    """No convergence (tol_fun 0): the loop runs max_num_iter + 1 steps."""
    tol = dict(tol_fun=0.0, num_times_tol_fun_sat=2)
    want = run_jax(max_num_iter=max_num_iter, **tol)
    got = run_port(max_num_iter=max_num_iter, **tol)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert int(got[4]) == max_num_iter + 1 and not bool(got[5])


def test_lm_while_counts_forming_passes_and_carries_aux():
    """Classic mode forms at the start and after each accept the loop goes
    on from; with ``carry_aux`` (the FULL streamed tier's eager loop) it
    carries the forming input and forms at the top of every iteration, and
    its results and trace equal JAX's ``lm_while(carry_aux=True)``, whose
    loop forms once an iteration."""
    stats = TL.LoopStats()
    run_port(stats=stats)
    # the start, then each accept the loop goes on from (4 of the 5)
    assert stats.form_passes == 5 and stats.loop_s > 0
    want = run_jax(carry_aux=True)
    carried = TL.LoopStats()
    got = run_port(stats=carried, carry_aux=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert carried.form_passes == int(want[4]) == 7
    # the carried aux is the accepted state's: the same steps as classic
    for g, w in zip(got, run_port()):
        np.testing.assert_array_equal(g, w)


def copy_into(dst, src):
    """Write ``src`` into the tensors of ``dst`` (same structure)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            copy_into(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            copy_into(d, s)


class EagerPhase:
    """Stand-in for ``lm.CapturedPhase`` on the CPU with a graph's contract:
    ``out`` is a fixed set of buffers that each replay rewrites, and a
    capture moves no launch count."""

    def __init__(self, fn):
        before = kernels.launch_counts()
        self.fn = fn
        self.out = fn()
        kernels.set_launch_counts(before)
        self.replays = 0

    def replay(self):
        copy_into(self.out, self.fn())
        self.replays += 1


@pytest.fixture
def eager_graphs(monkeypatch):
    monkeypatch.setattr(TL, "CapturedPhase", EagerPhase)


def graphed(knots, Gx, Gy, *, stats=None, **kw):
    """A GraphedLoop built for and run on one start state."""
    return TL.GraphedLoop(knots, Gx, Gy, **kw).run(knots, Gx, Gy, stats=stats)


def test_graphed_loop_control_flow_matches_lm_while(eager_graphs):
    want = run_port()
    stats = TL.LoopStats()
    got = run_port(loop=graphed, stats=stats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # one replay per phase per step, form after the 4 accepts it goes on from
    assert stats.replays == {"objective": 8, "form": 5, "solve": 7, "schedule": 7}
    assert stats.form_passes == 6  # the warm-up's, then the replays


def test_graphed_loop_reruns_without_set_up(eager_graphs):
    """A second run of one GraphedLoop starts from its own state, pays no
    warm-up, and returns tensors that a later run does not overwrite."""
    obj, form, upd = scripted(torch, torch.tensor(SCRIPT, dtype=torch.float64), COST0)
    z = torch.zeros(1, dtype=torch.float64)
    loop = TL.GraphedLoop(z, z, z, objective=obj, form=form, solve_update=upd,
                          max_num_iter=20, **TOL)
    first, again = TL.LoopStats(), TL.LoopStats()
    out1 = loop.run(z, z, z, stats=first)
    kept = [t.clone() for t in out1]
    out2 = loop.run(z, z, z, stats=again)
    for a, b, c in zip(out1, kept, out2):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert first.form_passes == 6 and again.form_passes == 5
    assert first.setup_s > 0 and again.setup_s == 0.0
    assert again.replays == first.replays


def small_window(pol_sign=1.0):
    sensor = synth.default_sensor(48, 48, f=44.0)
    scene = synth.generate(np.random.default_rng(11), sensor, pano_width=128,
                           pano_height=64, c_th=0.2, t_end=0.5, dt_knots=0.05,
                           num_steps=120, motion_amp=0.3)
    win = pairing.build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                               scene.traj.locate, 100)
    dev = TM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                      torch.float64, "cpu")
    return scene, dev


def test_cached_graphed_window_runs_windows_like_lm_while(eager_graphs, monkeypatch):
    """The cached loop of solve_window_fused (graphs replaced by the eager
    stand-in): built on one window, then loaded with a second window of the
    same shapes and another start state, it gives the bits of the eager loop
    on each, and the second call reuses the first call's loop."""
    monkeypatch.setattr(TS, "_GRAPHED", {})
    scene, dev = small_window()
    other = dataclasses.replace(dev, pol_signed=-dev.pol_signed)
    cfg = TM.ModelConfig(c_th=0.2, pano_width=128, pano_height=64,
                         thres_valid_pixel=3, alpha=2.0)
    settings = dict(tol_fun=1e-3, fix_first=True, use_cg=False, max_num_iter=4,
                    num_times_tol_fun_sat=2)
    loops = []
    for win, scale in ((dev, 0.9), (other, 0.7)):
        start = [torch.from_numpy(a) for a in (scene.traj.knots, scene.gx * scale,
                                               scene.gy * scale)]
        want = TS.solve_window_fused(*start, win, cfg, 1.0, 1e-3, fix_first=True,
                                     max_num_iter=4, return_trace=True)
        loop, _cg = TS._graphed_window(*start, win, cfg, start[0].shape[0], 1.0,
                                       **settings)
        stats = TL.LoopStats()
        got = loop.run(*start, stats=stats)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert stats.replays["solve"] == int(got[4])
        loops.append(loop)
    assert loops[0] is loops[1] and len(TS._GRAPHED) == 1
    assert not torch.equal(TS._GRAPHED[next(iter(TS._GRAPHED))][0].pol_signed,
                           dev.pol_signed)


def test_graphed_window_cache_counts_in_the_run_record(eager_graphs, monkeypatch):
    """The cached graphed window in the run record (graphs replaced by the
    eager stand-in): the first window captures, a second of the same shapes
    hits, a window of other shapes captures again and evicts the first;
    each build is an lm.capture span, each run adds its replays of each
    phase, and each host read of the status is an lm.status_wait."""
    monkeypatch.setattr(TS, "_GRAPHED", {})
    scene, dev = small_window()
    sensor = synth.default_sensor(48, 48, f=44.0)
    n = len(scene.t) // 2
    fewer = TM.DeviceWindow.from_window(
        pairing.build_window(scene.t[:n], scene.x[:n], scene.y[:n], scene.pol[:n],
                             sensor.width, scene.traj.locate, 100),
        sensor.bearing_lut(), sensor.width, torch.float64, "cpu")
    cfg = TM.ModelConfig(c_th=0.2, pano_width=128, pano_height=64,
                         thres_valid_pixel=3, alpha=2.0)
    settings = dict(tol_fun=1e-3, fix_first=True, use_cg=False, max_num_iter=4,
                    num_times_tol_fun_sat=2)
    start = [torch.from_numpy(a) for a in (scene.traj.knots, scene.gx, scene.gy)]
    rec = obs.Record()
    replays = []
    with obs.recording(rec):
        for win in (dev, dev, fewer):
            loop, _cg = TS._graphed_window(*start, win, cfg, start[0].shape[0], 1.0,
                                           **settings)
            stats = TL.LoopStats()
            loop.run(*start, stats=stats)
            replays.append(stats.replays)
    rec.finish()
    lm_counts = {k: v for k, v in rec.counters.items() if k.startswith("lm.graph")}
    assert lm_counts == {"lm.graph_capture": 2, "lm.graph_hit": 1, "lm.graph_evict": 1}
    for phase in ("objective", "form", "solve", "schedule"):
        assert rec.counters[f"lm.replays.{phase}"] == sum(r[phase] for r in replays)
    assert [s.name for s in rec.spans] == ["lm.capture", "lm.capture"]
    assert rec.repeats["lm.status_wait"][1] == sum(r["solve"] for r in replays)


def test_graphed_window_counts_the_rows_its_solves_listed(eager_graphs, monkeypatch):
    """The cached graphed window (graphs replaced by the eager stand-in):
    the solve phase adds each solve's listed rows to the device scalar of
    its records, the host reads the status once a step as before (one
    lm.status_wait a solve replay), and a run zeroed first counts its own
    replays only."""
    from emba_tpu_torch.kernels import schur_rows as SR

    monkeypatch.setattr(TS, "_GRAPHED", {})
    listed = []
    row_list = SR.row_list

    def counting(mask):
        rows, count = row_list(mask)
        listed.append(int(count))
        return rows, count

    monkeypatch.setattr(SR, "row_list", counting)
    scene, dev = small_window()
    cfg = TM.ModelConfig(c_th=0.2, pano_width=128, pano_height=64,
                         thres_valid_pixel=3, alpha=2.0)
    start = [torch.from_numpy(a) for a in (scene.traj.knots, scene.gx, scene.gy)]
    loop, recs = TS._graphed_window(*start, dev, cfg, start[0].shape[0], 1.0, tol_fun=1e-3,
                                    fix_first=True, use_cg=False, max_num_iter=4,
                                    num_times_tol_fun_sat=2)
    recs.rows.zero_()
    del listed[:]
    rec = obs.Record()
    stats = TL.LoopStats()
    with obs.recording(rec):
        loop.run(*start, stats=stats)
    rec.finish()
    assert len(listed) == stats.replays["solve"] > 0
    assert int(recs.rows) == sum(listed) > 0
    assert rec.repeats["lm.status_wait"][1] == stats.replays["solve"]


def test_schedule_step_and_keep_running():
    f64 = torch.float64

    def t(x, dt=f64):
        return torch.tensor(x, dtype=dt)

    acc, lam, cmin, count, conv = TL.schedule_step(t(1e-3), t(10.0), t(1, torch.int64),
                                                   t(9.5), 0.1, 2)
    assert bool(acc) and float(lam) == 1e-4 and float(cmin) == 9.5
    assert int(count) == 2 and bool(conv)
    acc, lam, cmin, count, conv = TL.schedule_step(t(1e-3), t(10.0), t(1, torch.int64),
                                                   t(11.0), 0.1, 2)
    assert not bool(acc) and float(lam) == pytest.approx(1e-2) and float(cmin) == 10.0
    assert int(count) == 0 and not bool(conv)
    run = TL.keep_running(t(1e-3), t(10.0), t(3, torch.int64), t(False, torch.bool), 3)
    assert bool(run)
    assert not bool(TL.keep_running(t(1e-3), t(10.0), t(4, torch.int64),
                                    t(False, torch.bool), 3))
    assert not bool(TL.keep_running(t(2e3), t(10.0), t(0, torch.int64),
                                    t(False, torch.bool), 3))
    assert not bool(TL.keep_running(t(1e-3), t(1e-17), t(0, torch.int64),
                                    t(False, torch.bool), 3))
