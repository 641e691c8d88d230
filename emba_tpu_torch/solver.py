"""Levenberg-Marquardt loops for one time window (counterpart of
``emba_tpu/solver.py``: classic, light-trial and streamed windows).

* :func:`solve_window`: the host-driven loop. Same control flow as the
  reference: lambda schedule and convergence from :class:`lm.HostSchedule`,
  relinearization only after an accepted step (the trial evaluation is
  reused; with ``light_trial`` a trial evaluates the cost alone and the
  forming pass recomputes the Jacobians), gauge fixing of the first knot by masking, per-phase timers,
  the Schur or CG solve, and mid-window checkpoint/resume through
  :func:`lm_state_dict`. Each phase ends with a device synchronization
  before the clock is read, so a phase time is the device time of that
  phase plus its host overhead.
* :func:`solve_window_fused`: the whole window through :func:`lm.lm_while`
  (eager on the CPU) or a cached :class:`lm.GraphedLoop` (CUDA graphs on
  the card), with no per-phase timers.

Both loops run the device work of a window through :class:`Phases`, made
by the window's placement: :data:`LOCAL` (one device holds the whole
window) or ``dist.Sharded`` (the window's events split over ranks).

With ``cfg.stream_chunk`` both loops stream: the objective is
:func:`model.cost_and_activity_streamed` (FULL tier) or
:func:`model.linearize_streamed_light` (LIGHT tier, ``stream_light``), the
forming pass :func:`model.form_normal_eq_streamed`, and the prev-event
records (:func:`model.prev_records`) are gathered once a window and handed
to every pass.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from . import lm as lm_mod
from . import model as M
from . import obs


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Reference ``LMSettings``."""

    max_num_iter: int = 50
    tol_fun: float = 1e-3
    num_times_tol_fun_sat: int = 2
    lambda_init: float = 1e-3
    lambda_max: float = 1e3
    lambda_min: float = 1e-300


@dataclasses.dataclass
class LMStats:
    """Per-window instrumentation: per-iteration records, phase times and
    counts, the active-pixel count per forming pass. ``setup_s`` is the
    fused window's warm-up and graph captures (``lm.LoopStats.setup_s``; 0
    for the host loop and for a fused call that reused its graphs);
    ``lm_mode`` the execution mode the pipeline chose for the window."""

    iterations: list = dataclasses.field(default_factory=list)
    time_form_s: float = 0.0
    time_solve_s: float = 0.0
    time_objective_s: float = 0.0
    time_total_s: float = 0.0
    setup_s: float = 0.0
    count_form: int = 0
    count_solve: int = 0
    count_objective: int = 0
    num_events: int = 0
    active_px_per_form: list = dataclasses.field(default_factory=list)
    dropped_meas_per_form: list = dataclasses.field(default_factory=list)
    # active pixels beyond the compaction cap, observed after the window
    # (the pipeline's retune; 0 uncompacted)
    overflow_active_pixels: int = 0
    converged: bool = False
    sync_method: str = "device-synchronize"
    lm_mode: str = ""
    # a multi-start window: each variant's data cost under the reference
    # model, iterations (its coarse stage's apart) and seconds (pipeline)
    variants: list = dataclasses.field(default_factory=list)

    @property
    def num_active_pixels(self) -> int:
        return self.active_px_per_form[-1] if self.active_px_per_form else 0

    def note_active_pixels(self, np_count: int):
        self.active_px_per_form.append(int(np_count))

    def events_per_second(self) -> dict:
        """Throughput per phase; None for a phase with no measured time."""
        out = {}
        for name, t, c in [
            ("form", self.time_form_s, self.count_form),
            ("solve", self.time_solve_s, self.count_solve),
            ("objective", self.time_objective_s, self.count_objective),
        ]:
            out[name] = (self.num_events * c / t) if t > 0 else None
        total = self.time_total_s or (
            self.time_form_s + self.time_solve_s + self.time_objective_s
        )
        n_iter = max(self.count_objective, 1)
        out["total"] = self.num_events * n_iter / total if total > 0 else None
        return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _init_costs(knots, Gx, Gy, dev, cfg):
    """Linearization + costs at a state."""
    lin = M.linearize(knots, Gx, Gy, dev, cfg)
    return lin, M.data_cost(lin.e, cfg), M.reg_cost(Gx, Gy, cfg.alpha)


def _init_costs_trial(knots, Gx, Gy, dev, cfg):
    """The ``light_trial`` objective: the costs and the light
    linearization, with no (D, N) Jacobians and no prev gather of their
    rows; :func:`model.form_normal_eq_light` recomputes them after an
    accepted step only (the reference relinearizes only on accept)."""
    lin = M.linearize(knots, Gx, Gy, dev, cfg, need_deriv=False)
    return lin, M.data_cost(lin.e, cfg), M.reg_cost(Gx, Gy, cfg.alpha)


def _init_costs_streamed(knots, Gx, Gy, dev, cfg, pb, pbid):
    """The FULL streamed tier's objective: the (HW,) inlier count map and
    the costs, chunk by chunk, with no event-sized output; ``pb`` and
    ``pbid`` are the window's prev records (:func:`model.prev_records`)."""
    cost_data, nem = M.cost_and_activity_streamed(knots, Gx, Gy, dev, cfg, pb, pbid)
    return nem, cost_data, M.reg_cost(Gx, Gy, cfg.alpha)


def _init_costs_light(knots, Gx, Gy, dev, cfg, pb, pbid):
    """The LIGHT streamed tier's objective: the light linearization,
    computed chunk by chunk, and the costs."""
    lin, cost_data = M.linearize_streamed_light(knots, Gx, Gy, dev, cfg, pb, pbid)
    return lin, cost_data, M.reg_cost(Gx, Gy, cfg.alpha)


def _objective_fn(cfg, prev=None):
    """The objective of the window's mode, ``(knots, Gx, Gy, dev, cfg) ->
    (aux, cost_data, cost_reg)``; a streamed one reads the prev records
    ``prev``."""
    if cfg.stream_chunk is not None:
        base = _init_costs_light if cfg.stream_light else _init_costs_streamed

        def streamed(knots, Gx, Gy, dev, cfg_):
            return base(knots, Gx, Gy, dev, cfg_, *prev)
        return streamed
    return _init_costs_trial if cfg.light_trial else _init_costs


def _form(aux, knots, Gx, Gy, dev, cfg, num_knots, prev=None):
    """The forming pass of the window's mode (light trial: Jacobians
    recomputed; streamed: the whole chunk chain, or its Jacobians in the
    LIGHT tier)."""
    if cfg.stream_chunk is not None:
        return M.form_normal_eq_streamed(aux, knots, Gx, Gy, dev, cfg, num_knots,
                                         prev_bearings=prev[0], prev_bids=prev[1])
    if cfg.light_trial:
        return M.form_normal_eq_light(aux, knots, Gx, Gy, dev, cfg, num_knots)
    return M.form_normal_eq(aux, Gx, Gy, cfg, num_knots)


def _prev(dev_win, cfg):
    """The window's prev records when it streams, else None."""
    return M.prev_records(dev_win) if cfg.stream_chunk is not None else None


def _neq_stats(neq):
    return neq.active_count, neq.dropped


@dataclasses.dataclass(frozen=True)
class Phases:
    """The device work of one window's LM loop, shared by the host loop and
    the device loops:

    * ``objective(knots, Gx, Gy) -> (aux, cost_data, cost_reg)``: the costs
      at a state and the forming input ``aux``;
    * ``form(aux, knots, Gx, Gy) -> system``: the normal equations;
    * ``solve(system, knots, Gx, Gy, lam, early_exit, rows_total) ->
      (knots', Gx', Gy', cg_it, cg_err)``: damped solve and trial state
      (CG's iterations and relative residual, None for the Schur solve);
      the Schur solve adds the map rows it ran over to ``rows_total`` (a
      0-d int64 device tensor) if given;
    * ``sys_stats(system) -> (active pixels, dropped measurements)``."""

    objective: Callable
    form: Callable
    solve: Callable
    sys_stats: Callable = _neq_stats


class Local:
    """The placement of a window that one device holds whole (the default
    of both loops). A placement makes a window's :class:`Phases` and its
    prev records, takes its share of a whole window (``shard``), solves
    the map-only step on it (``solve_map_only``), and says whether a CUDA window may capture its phases
    in graphs (``graphs``), whether the CPU loop carries the forming input
    (``carry_aux``), and what else keys a cached graphed loop (``key``)."""

    graphs = True
    key = ()

    def prev(self, dev_win, cfg):
        return _prev(dev_win, cfg)

    def shard(self, dev_win):
        return dev_win

    def solve_map_only(self, knots, Gx, Gy, dev_win, cfg, num_iters: int = 1):
        return M.solve_map_only(knots, Gx, Gy, dev_win, cfg, num_iters)

    def carry_aux(self, cfg):
        return cfg.stream_chunk is not None and not cfg.stream_light

    def num_events(self, dev_win) -> int:
        return int(dev_win.pol_signed.shape[0])

    def phases(self, dev_win, cfg, num_knots, damping, fix_first, use_cg, prev) -> Phases:
        init_costs = _objective_fn(cfg, prev)

        def objective(knots, Gx, Gy):
            return init_costs(knots, Gx, Gy, dev_win, cfg)

        def form(aux, knots, Gx, Gy):
            return _form(aux, knots, Gx, Gy, dev_win, cfg, num_knots, prev)

        def solve(neq, knots, Gx, Gy, lam, early_exit=True, rows_total=None):
            return _solve_update(knots, Gx, Gy, neq, lam, damping, fix_first, use_cg,
                                 early_exit, rows_total)

        return Phases(objective=objective, form=form, solve=solve)

    def cost_and_activity(self, knots, Gx, Gy, dev_win, cfg):
        """(data cost, (HW,) inlier count map) at a state: the light
        linearization's, or a streamed window's chunked objective's, which
        holds nothing event-sized."""
        if cfg.stream_chunk is not None:
            return M.cost_and_activity_streamed(knots, Gx, Gy, dev_win, cfg)
        lin = M.linearize(knots, Gx, Gy, dev_win, cfg, need_deriv=False)
        return M.data_cost(lin.e, cfg), lin.num_ev_map


LOCAL = Local()


def _solve_update(knots, Gx, Gy, neq, lam, damping, fix_first, use_cg,
                  early_exit=True, rows_total=None):
    """Schur or CG solve + trial state. Returns (knots', Gx', Gy', cg_it,
    cg_err): CG's iterations and relative residual as 0-d tensors, None
    for the Schur solve. ``early_exit=False`` for a solve captured in a
    CUDA graph (see :func:`model.solve_normal_eq_cg`); ``rows_total``: as
    in :func:`model.solve_normal_eq`."""
    if use_cg:
        x1, x2, cg_it, cg_err = M.solve_normal_eq_cg(neq, lam, fix_first,
                                                     early_exit=early_exit)
    else:
        (x1, x2), cg_it, cg_err = M.solve_normal_eq(
            neq, lam, fix_first, rows_total=rows_total), None, None
    knots_new = M.update_knots(knots, x1, fix_first)
    gx_new, gy_new = M.update_map(Gx, Gy, x2, damping, neq)
    return knots_new, gx_new, gy_new, cg_it, cg_err


def lm_state_dict(sched, knots, Gx, Gy) -> dict:
    """Mid-window LM checkpoint payload: the accepted (knots, Gx, Gy) as
    numpy arrays and the schedule state (lambda, cost_min, tol-sat counter,
    iteration, re-form flag) as Python scalars. The payload has the keys
    and types of ``emba_tpu.solver.lm_state_dict``, so either package
    resumes from the other's (``convert.lm_state_to_numpy``)."""
    return dict(
        knots=knots.detach().cpu().numpy(),
        gx=Gx.detach().cpu().numpy(),
        gy=Gy.detach().cpu().numpy(),
        lam=float(sched.lam),
        cost_min=float(sched.cost_min),
        count_tol_sat=int(sched.count_tol_sat),
        it=int(sched.it),
        cost_decreased=bool(sched.cost_decreased),
    )


def solve_window(
    knots,
    Gx,
    Gy,
    dev_win: M.DeviceWindow,
    cfg: M.ModelConfig,
    lm: LMConfig = LMConfig(),
    damping_factor: float = 1.0,
    fix_first: bool = False,
    use_cg: bool = False,
    callback=None,
    checkpoint_cb=None,
    checkpoint_every: int = 0,
    resume_state: dict | None = None,
    placement=LOCAL,
):
    """Run LM on (trajectory knots + gradient map) for one window.

    Args:
      knots: (K, 3, 3) tensor of control poses; Gx, Gy: (H, W) maps, on the
        device of ``dev_win``.
      use_cg: solve each damped system by block-Jacobi CG
        (:func:`model.solve_normal_eq_cg`) instead of the Schur complement;
        each iteration record then has ``cg_iterations`` and ``cg_error``.
      callback: optional fn(iter, Gx, Gy, info), called before each solve.
      checkpoint_cb: optional fn(state_dict), called every
        ``checkpoint_every`` iterations with :func:`lm_state_dict`.
      resume_state: an :func:`lm_state_dict` payload (of this package or of
        ``emba_tpu``) to resume from. Every LM decision depends only on the
        restored state and schedule, and forming is deterministic, so the
        resumed run gives the bits of the uninterrupted one.
      placement: :data:`LOCAL`, or a ``dist.Sharded`` placement with
        ``dev_win`` this rank's shard; every rank then takes the same steps.

    Returns (knots, Gx, Gy, LMStats).
    """
    num_knots = knots.shape[0]
    device = Gx.device
    dt = Gx.dtype
    stats = LMStats(num_events=placement.num_events(dev_win))
    sched = lm_mod.HostSchedule(
        tol_fun=lm.tol_fun,
        max_num_iter=lm.max_num_iter,
        num_times_tol_fun_sat=lm.num_times_tol_fun_sat,
        lam=lm.lambda_init,
        lambda_min=lm.lambda_min,
        lambda_max=lm.lambda_max,
    )
    if resume_state is not None:
        from . import convert

        resume_state = convert.lm_state_to_numpy(resume_state)
        knots, Gx, Gy = convert.state_from_numpy(
            resume_state["knots"], resume_state["gx"], resume_state["gy"], dt, device)
        sched.lam = resume_state["lam"]
        sched.count_tol_sat = resume_state["count_tol_sat"]
        sched.it = resume_state["it"]
        sched.cost_decreased = resume_state["cost_decreased"]

    t_loop0 = time.perf_counter()
    phases = placement.phases(dev_win, cfg, num_knots, damping_factor, fix_first, use_cg,
                              placement.prev(dev_win, cfg))
    lin, cost_data_t, cost_reg_t = phases.objective(knots, Gx, Gy)
    cost_data, cost_reg = float(cost_data_t), float(cost_reg_t)
    stats.time_objective_s += time.perf_counter() - t_loop0
    stats.count_objective += 1
    if resume_state is None:
        sched.start(cost_data + cost_reg)
    else:
        # the stored scalar is the source of truth (it equals the cost at
        # the restored state)
        sched.cost_min = resume_state["cost_min"]

    neq = None
    rows_total = torch.zeros((), dtype=torch.int64, device=device)
    while sched.running():
        # on resume the system is formed once even if the interrupted run's
        # last step was a reject: forming is deterministic in the state
        if sched.cost_decreased or neq is None:
            t0 = time.perf_counter()
            neq = phases.form(lin, knots, Gx, Gy)
            active_px, dropped = (int(v) for v in phases.sys_stats(neq))
            _sync(device)
            stats.time_form_s += time.perf_counter() - t0
            stats.count_form += 1
            stats.note_active_pixels(active_px)
            stats.dropped_meas_per_form.append(dropped)

        if callback is not None:
            callback(sched.it, Gx, Gy, dict(lam=sched.lam, cost_min=sched.cost_min))

        t0 = time.perf_counter()
        knots_new, gx_new, gy_new, cg_it, cg_err = phases.solve(
            neq, knots, Gx, Gy, sched.lam, rows_total=rows_total)
        _sync(device)
        t1 = time.perf_counter()
        stats.time_solve_s += t1 - t0
        stats.count_solve += 1

        lin_new, cost_data_new_t, cost_reg_new_t = phases.objective(knots_new, gx_new,
                                                                    gy_new)
        cost_data_new = float(cost_data_new_t)
        cost_reg_new = float(cost_reg_new_t)
        stats.time_objective_s += time.perf_counter() - t1
        stats.count_objective += 1
        cost_new = cost_data_new + cost_reg_new

        rec = dict(
            iter=sched.it + 1,
            log10_lambda=np.log10(sched.lam),
            cost_min=sched.cost_min,
            cost_new=cost_new,
            cost_data=cost_data,
            cost_reg=cost_reg,
        )
        if use_cg:
            rec["cg_iterations"] = int(cg_it)
            rec["cg_error"] = float(cg_err)
        stats.iterations.append(rec)

        if sched.step(cost_new):
            knots, Gx, Gy = knots_new, gx_new, gy_new
            lin = lin_new
            cost_data, cost_reg = cost_data_new, cost_reg_new
            if sched.converged:
                stats.converged = True
                break

        if checkpoint_cb is not None and checkpoint_every > 0 and (
                sched.it % checkpoint_every == 0):
            checkpoint_cb(lm_state_dict(sched, knots, Gx, Gy))

    stats.time_total_s = time.perf_counter() - t_loop0
    _count_rows(use_cg, rows_total)
    return knots, Gx, Gy, stats


def _count_rows(use_cg, rows_total):
    """Counts ``solve.rows`` in the run record (:mod:`obs`): the map rows the
    window's Schur solves ran over, summed on the device in ``rows_total``
    and read once, after the loop's last host read."""
    if not use_cg:
        obs.count("solve.rows", int(rows_total))


@dataclasses.dataclass(frozen=True)
class _Recs:
    """Device tensors a loop's solves write: CG's iterations and relative
    residual of the last solve (2,), the Schur solves' listed rows ()."""

    cg: torch.Tensor
    rows: torch.Tensor

    @staticmethod
    def zeros(dtype, device) -> "_Recs":
        return _Recs(torch.zeros(2, dtype=dtype, device=device),
                     torch.zeros((), dtype=torch.int64, device=device))


def _loop_phases(phases: Phases, use_cg, early_exit, recs: _Recs):
    """The callables of :func:`lm.lm_while` from a window's :class:`Phases`.
    With ``use_cg``, each solve writes its CG iterations and relative
    residual into ``recs.cg``; a Schur solve adds its listed rows to
    ``recs.rows``."""

    def objective(knots_, gx_, gy_):
        lin, cost_data, cost_reg = phases.objective(knots_, gx_, gy_)
        return cost_data + cost_reg, lin

    def solve_update(neq, knots_, gx_, gy_, lam):
        knots_new, gx_new, gy_new, cg_it, cg_err = phases.solve(neq, knots_, gx_, gy_, lam,
                                                                early_exit, recs.rows)
        if use_cg:
            recs.cg.copy_(torch.stack([cg_it.to(recs.cg.dtype), cg_err.to(recs.cg.dtype)]))
        return knots_new, gx_new, gy_new

    return dict(objective=objective, form=phases.form, solve_update=solve_update,
                sys_stats=phases.sys_stats)


# The graphed loop of the last solve_window_fused call on CUDA, under a key
# of everything its graphs hold fixed; a call with the same key loads its
# window and start state into the graphs' buffers and replays them, as a
# jit cache reruns a compiled program. One entry: a new key drops the old
# graphs before it captures its own.
_GRAPHED: dict = {}


def _graphed_window(knots, Gx, Gy, dev_win, cfg, num_knots, damping, tol_fun,
                    fix_first, use_cg, max_num_iter, num_times_tol_fun_sat,
                    placement=LOCAL):
    """The cached (:class:`lm.GraphedLoop`, :class:`_Recs`) of this call's key,
    with ``dev_win`` loaded into the window its graphs read (and, for a
    streamed window, its prev records gathered into theirs). Counts, in the
    run record (:mod:`obs`), ``lm.graph_hit`` for a cached loop, else
    ``lm.graph_capture`` and, when it drops the cached one, ``lm.graph_evict``."""
    tensors = {f.name: getattr(dev_win, f.name) for f in dataclasses.fields(dev_win)
               if getattr(dev_win, f.name) is not None}
    key = (tuple((name, tuple(t.shape), t.dtype) for name, t in tensors.items()),
           tuple(knots.shape), tuple(Gx.shape), Gx.dtype, Gx.device, cfg, damping,
           tol_fun, fix_first, use_cg, max_num_iter, num_times_tol_fun_sat, placement.key)
    hit = _GRAPHED.get(key)
    if hit is not None:
        obs.count("lm.graph_hit")
        win, prev, recs, loop = hit
        for name, t in tensors.items():
            getattr(win, name).copy_(t)
        if prev is not None:
            for buf, t in zip(prev, placement.prev(win, cfg)):
                buf.copy_(t)
        return loop, recs
    if _GRAPHED:
        obs.count("lm.graph_evict")
    obs.count("lm.graph_capture")
    _GRAPHED.clear()
    torch.cuda.empty_cache()  # the dropped graphs' pools, before the new capture
    win = dataclasses.replace(dev_win, **{name: t.clone() for name, t in tensors.items()})
    prev = placement.prev(win, cfg)
    recs = _Recs.zeros(Gx.dtype, Gx.device)
    phases = placement.phases(win, cfg, num_knots, damping, fix_first, use_cg, prev)
    loop = lm_mod.GraphedLoop(
        knots, Gx, Gy, **_loop_phases(phases, use_cg, False, recs),
        tol_fun=tol_fun, max_num_iter=max_num_iter,
        num_times_tol_fun_sat=num_times_tol_fun_sat)
    _GRAPHED[key] = (win, prev, recs, loop)
    return loop, recs


def solve_window_fused(
    knots,
    Gx,
    Gy,
    dev_win: M.DeviceWindow,
    cfg: M.ModelConfig,
    damping,
    tol_fun,
    fix_first: bool = False,
    use_cg: bool = False,
    max_num_iter: int = 50,
    num_times_tol_fun_sat: int = 2,
    return_trace: bool = False,
    stats: lm_mod.LoopStats | None = None,
    placement=LOCAL,
):
    """The whole LM window as one loop over device state (counterpart of
    ``emba_tpu.solver.solve_window_fused``): the control flow of
    :func:`solve_window` with the schedule held in device tensors, and the
    reference's fixed schedule constants (``lm.LAMBDA_*``).

    On the CPU it runs :func:`lm.lm_while` eagerly; a FULL-tier streamed
    window runs it with ``carry_aux``, as the reference's fused loop does
    (a forming pass each iteration). On CUDA it runs an
    :class:`lm.GraphedLoop` (in the streamed tiers too, forming after
    accepts only): each phase is captured once in a CUDA graph and
    replayed; a capture that fails raises. Both take the host loop's
    steps. The loop is kept for the next
    call with the same window shapes and settings, which then pays no
    warm-up and no capture (``stats.setup_s`` is 0). ``stats``, if given,
    receives the loop wall time, the forming passes and replays, and with
    ``use_cg`` the CG iterations and relative residual of each solve.
    ``placement``: as in :func:`solve_window`; a CUDA window runs the
    graphed loop when its placement's collectives can be captured
    (``placement.graphs``), else :func:`lm.lm_while`.

    Returns (knots, Gx, Gy, cost_min, iterations_used, converged) [+ the
    per-iteration trace when ``return_trace``, see ``lm.TRACE_COLS``].
    """
    num_knots = knots.shape[0]
    damping = float(damping)
    tol_fun = float(tol_fun)
    sched = dict(tol_fun=tol_fun, max_num_iter=max_num_iter,
                 num_times_tol_fun_sat=num_times_tol_fun_sat)
    if Gx.device.type == "cuda" and placement.graphs:
        loop, recs = _graphed_window(knots, Gx, Gy, dev_win, cfg, num_knots, damping,
                                     fix_first=fix_first, use_cg=use_cg,
                                     placement=placement, **sched)
        recs.rows.zero_()  # the build's warm-up solve ran through it
        run = loop.run
    else:
        recs = _Recs.zeros(Gx.dtype, Gx.device)
        phases = _loop_phases(
            placement.phases(dev_win, cfg, num_knots, damping, fix_first, use_cg,
                             placement.prev(dev_win, cfg)), use_cg, True, recs)
        carry_aux = placement.carry_aux(cfg)

        def run(knots, Gx, Gy, **kw):
            return lm_mod.lm_while(knots, Gx, Gy, **phases, **sched, carry_aux=carry_aux,
                                   **kw)

    def on_step():
        it, err = recs.cg.tolist()
        stats.cg_iterations.append(int(it))
        stats.cg_error.append(err)

    out = run(knots, Gx, Gy, on_step=on_step if (use_cg and stats is not None) else None,
              stats=stats)
    _count_rows(use_cg, recs.rows)
    return out if return_trace else out[:6]
