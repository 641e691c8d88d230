"""The LM accept/reject schedule (counterpart of ``emba_tpu/lm.py``), held
once and shared by every loop of the port:

* :func:`lm_while` — the whole window as one loop over device tensors,
  parameterized by (objective, form, solve_update) callables: the
  counterpart of the reference's ``lax.while_loop``. It runs eagerly and
  reads the loop condition on the host once per iteration.
* :class:`GraphedLoop` — the same loop on CUDA, each phase captured once
  in a CUDA graph and replayed, for as many windows of one shape as it is
  run on.
* :class:`HostSchedule` — the same schedule as host scalars, for the
  host-driven ``solver.solve_window``.

Also the decoders of the per-iteration trace (``TRACE_COLS``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import kernels, obs

LAMBDA_INIT = 1e-3
LAMBDA_MIN = 1e-300
LAMBDA_MAX = 1e3
LAMBDA_DOWN = 10.0  # accepted: lambda /= 10
LAMBDA_UP = 10.0  # rejected: lambda *= 10
COST_FLOOR = 1e-16  # stop when the cost is numerically zero
REL_EPS = 1e-10  # denominator guard in the relative-change test

TRACE_COLS = ("lambda", "cost_min", "cost_new", "accept", "active_px", "dropped")


@dataclasses.dataclass
class LoopStats:
    """What one run of :func:`lm_while` or :meth:`GraphedLoop.run` saw.

    ``setup_s`` is the eager warm-up and the captures that this run paid
    (graph path only; 0 when it reused a loop built before);
    ``loop_s`` the loop from the first objective to the last decision,
    ending in a device synchronization. ``form_passes`` counts every
    forming pass of the run, the warm-up's included; ``replays`` counts the replays of
    each captured phase; ``cg_iterations`` and ``cg_error`` hold one entry
    per solve when the caller records them (``solver.solve_window_fused``
    with ``use_cg``)."""

    setup_s: float = 0.0
    loop_s: float = 0.0
    form_passes: int = 0
    replays: dict = dataclasses.field(default_factory=dict)
    cg_iterations: list = dataclasses.field(default_factory=list)
    cg_error: list = dataclasses.field(default_factory=list)


def _no_sys_stats(sys):
    del sys
    return torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32)


def keep_running(lam, cost_min, it, converged, max_num_iter: int):
    """The loop condition, a 0-d bool tensor."""
    return ((it <= max_num_iter) & (cost_min > COST_FLOOR) & (lam <= LAMBDA_MAX)
            & (lam >= LAMBDA_MIN) & torch.logical_not(converged))


def schedule_step(lam, cost_min, count_tol, cost_new, tol_fun,
                  num_times_tol_fun_sat: int):
    """One accept/reject decision on 0-d tensors. Returns (accept, lam,
    cost_min, count_tol, converged) after it. The tol-sat counter resets
    only on a reject; an accepted but large step keeps it."""
    accept = cost_new < cost_min
    rel = torch.abs(1.0 - cost_new / (cost_min + REL_EPS))
    count_tol = torch.where(
        accept, torch.where(rel < tol_fun, count_tol + 1, count_tol),
        torch.zeros_like(count_tol))
    return (accept, torch.where(accept, lam / LAMBDA_DOWN, lam * LAMBDA_UP),
            torch.where(accept, cost_new, cost_min), count_tol,
            count_tol >= num_times_tol_fun_sat)


def _record(trace, it, lam, cost_min, cost_new, accept, np_, dropped):
    """Write row ``it`` of the trace (``TRACE_COLS``) on the device."""
    dt = trace.dtype
    row = torch.stack([lam.to(dt), cost_min.to(dt), cost_new.to(dt), accept.to(dt),
                       np_.to(device=trace.device, dtype=dt),
                       dropped.to(device=trace.device, dtype=dt)])
    trace.index_copy_(0, it.reshape(1), row[None])


def _schedule_state(cost_min, max_num_iter, dt, device):
    """(lam, cost_min, count_tol, it, converged, trace) at the start."""
    return (torch.full((), LAMBDA_INIT, dtype=dt, device=device),
            cost_min, torch.zeros((), dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.bool, device=device),
            torch.zeros((max_num_iter + 1, len(TRACE_COLS)), dtype=dt, device=device))


def _where_tree(cond, new, old):
    """``torch.where(cond, new, old)`` over a tensor or a dataclass of
    tensors (a Linearization)."""
    if isinstance(new, torch.Tensor):
        return torch.where(cond, new, old)
    return dataclasses.replace(new, **{
        f.name: torch.where(cond, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(new)})


def lm_while(knots, Gx, Gy, *, objective, form, solve_update, sys_stats=None,
             tol_fun, max_num_iter: int, num_times_tol_fun_sat: int,
             carry_aux: bool = False, on_step=None, stats: LoopStats | None = None):
    """Run the whole LM window as one loop over device tensors.

    Callables:
      * ``objective(knots, Gx, Gy) -> (cost, aux)``: the cost at a state
        and the forming input (a Linearization);
      * ``form(aux, knots, Gx, Gy) -> sys``: the normal equations;
      * ``solve_update(sys, knots, Gx, Gy, lam) -> (knots', Gx', Gy')``:
        damped solve and trial state;
      * ``sys_stats(sys) -> (active_px, dropped)`` int scalars for the
        trace (zeros by default);
      * ``on_step()``: called after each decision, if given.

    Classic mode: the system is re-formed only after an accepted step, from
    the trial linearization; a reject keeps it. (The reference also forms
    after the accept that ends the loop; that system is never used, so
    this loop skips it.) With ``carry_aux`` (the reference's fused FULL
    streamed tier) the loop carries the forming input ``aux`` instead of
    the system, merged with ``torch.where`` on accept, and re-forms at the
    top of every iteration: a forming pass an iteration, rejects included,
    as the reference's loop counts them; forming is deterministic in the
    state, so the steps are those of classic mode.

    Returns ``(knots, Gx, Gy, cost_min, it, converged, trace)`` with
    ``trace`` of shape ``(max_num_iter + 1, 6)`` holding ``TRACE_COLS``
    rows for iterations ``[0, it)``.
    """
    sys_stats = sys_stats or _no_sys_stats
    t0 = time.perf_counter()
    cost0, aux = objective(knots, Gx, Gy)
    forms = 0
    if not carry_aux:
        sys = form(aux, knots, Gx, Gy)
        forms = 1
    lam, cost_min, count_tol, it, converged, trace = _schedule_state(
        cost0, max_num_iter, Gx.dtype, Gx.device)
    while bool(keep_running(lam, cost_min, it, converged, max_num_iter)):
        if carry_aux:
            sys = form(aux, knots, Gx, Gy)
            forms += 1
        knots_new, gx_new, gy_new = solve_update(sys, knots, Gx, Gy, lam)
        cost_new, aux_new = objective(knots_new, gx_new, gy_new)
        accept, lam_new, cost_min_new, count_tol, converged = schedule_step(
            lam, cost_min, count_tol, cost_new, tol_fun, num_times_tol_fun_sat)
        _record(trace, it, lam, cost_min, cost_new, accept, *sys_stats(sys))
        knots = torch.where(accept, knots_new, knots)
        Gx = torch.where(accept, gx_new, Gx)
        Gy = torch.where(accept, gy_new, Gy)
        lam, cost_min, it = lam_new, cost_min_new, it + 1
        if on_step is not None:
            on_step()
        if carry_aux:
            aux = _where_tree(accept, aux_new, aux)
        elif bool(accept) and bool(keep_running(lam, cost_min, it, converged,
                                                max_num_iter)):
            sys = form(aux_new, knots, Gx, Gy)
            forms += 1
    if stats is not None:
        stats.loop_s = time.perf_counter() - t0
        stats.form_passes = forms
    return knots, Gx, Gy, cost_min, it, converged, trace


class CapturedPhase:
    """One phase of the loop captured once in a CUDA graph.

    ``out`` holds what ``fn`` returned at capture, in the graph's own memory
    pool, rewritten by every :meth:`replay`. The capture launches nothing,
    so the kernel launch counts it moved are restored, and each replay adds
    them again: a replay is where a captured kernel really runs. A capture
    that fails raises. ``name`` is the phase's (set by :class:`GraphedLoop`);
    while a profiler records, a replay runs in the range ``emba.lm.<name>``,
    and every kernel the replay launches carries that range's graph
    launch."""

    def __init__(self, fn):
        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        after = kernels.launch_counts()
        kernels.set_launch_counts(before)
        self.launches = {k: after[k] - before[k] for k in before if after[k] != before[k]}
        self.replays = 0
        self.name = "phase"

    def replay(self):
        if obs.profiling():
            with torch.profiler.record_function(f"{obs.PREFIX}lm.{self.name}"):
                self.graph.replay()
        else:
            self.graph.replay()
        kernels.add_launches(self.launches)
        self.replays += 1


def _warm_up(fn, device):
    """Run ``fn`` once before capture: on CUDA on a side stream, as
    ``torch.cuda.graphs`` asks, then wait for it."""
    if device.type != "cuda":
        fn()
        return
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
    main.wait_stream(side)
    torch.cuda.synchronize(device)


class GraphedLoop:
    """:func:`lm_while` on CUDA, its phases replayed from CUDA graphs.

    Built once (``GraphedLoop(knots, Gx, Gy, objective=..., ...)``), with
    the callables of :func:`lm_while` and a start state that fixes the
    shapes; :meth:`run` then solves any start state of those shapes, as
    often as it is called. Building runs the callables once eagerly on a
    side stream (it builds and loads the kernels and creates the cuBLAS and
    cuSOLVER handles), then captures four phases (:class:`CapturedPhase`),
    each into its own memory pool:

    * objective: the trial state -> cost and linearization;
    * form: that linearization and the accepted state -> normal equations;
    * solve: the normal equations, accepted state and lambda -> trial state;
    * schedule: the decision of :func:`schedule_step`, the trace row, the
      accepted state and a two-word status (running, accepted).

    The graphs read and write fixed buffers (state, trial state, schedule
    scalars, trace, status); :meth:`run` loads its start state into them.
    A graph holds no branch that depends on data, so the host reads the
    status once per iteration (one small copy that waits for the iteration)
    and replays ``form`` only after an accept that the loop goes on from:
    the forming passes and the result bits of :func:`lm_while`. Every
    decision is taken on the device. The callables must read whatever else
    changes between runs from tensors they hold, not from Python values.

    The streamed tiers run through the same four graphs: ``aux`` is the
    (HW,) inlier count map's record (``model.Activity``) in the FULL tier
    and the light linearization in the LIGHT tier, and each chunk's work is
    captured unrolled (the chunk count follows from the window's shape).
    Here too the system is formed
    only after an accept, as the reference's host loop does for streamed
    windows; the reference's fused FULL-tier loop re-forms on rejects as
    well (:func:`lm_while` with ``carry_aux``), only so that XLA does not
    hold A12 double-buffered across its while loop, and a graph's outputs
    are static buffers, so the card gains no memory from it.

    In the run record (:mod:`obs`): the build is the span ``lm.capture``,
    each host read of the status the repeating span ``lm.status_wait``, and
    each run adds its replays of each phase to ``lm.replays.<phase>``.
    """

    def __init__(self, knots, Gx, Gy, *, objective, form, solve_update,
                 sys_stats=None, tol_fun, max_num_iter: int,
                 num_times_tol_fun_sat: int):
        sys_stats = sys_stats or _no_sys_stats
        device = Gx.device
        with obs.span("lm.capture"):  # the warm-up and the four captures
            t0 = time.perf_counter()
            self.max_num_iter = max_num_iter
            self.state = state = [t.clone() for t in (knots, Gx, Gy)]
            self.trial = trial = [t.clone() for t in (knots, Gx, Gy)]
            lam, cost_min, count_tol, it, converged, trace = _schedule_state(
                torch.zeros((), dtype=Gx.dtype, device=device), max_num_iter, Gx.dtype,
                device)
            self.sched = (lam, cost_min, count_tol, it, converged, trace)
            status = self.status = torch.zeros(2, dtype=torch.int32, device=device)

            def warm_up():
                cost, aux = objective(*trial)
                sys = form(aux, *state)
                solve_update(sys, *state, lam)
                schedule_step(lam, cost, count_tol, cost, tol_fun, num_times_tol_fun_sat)

            _warm_up(warm_up, device)

            self.g_obj = CapturedPhase(lambda: objective(*trial))
            self.g_obj.name = "objective"
            cost_new, aux = self.g_obj.out
            self.cost_new = cost_new
            self.g_form = CapturedPhase(lambda: form(aux, *state))
            self.g_form.name = "form"
            sys = self.g_form.out

            def solve():
                for buf, new in zip(trial, solve_update(sys, *state, lam)):
                    buf.copy_(new)

            def schedule():
                accept, lam_new, cost_min_new, count_tol_new, converged_new = schedule_step(
                    lam, cost_min, count_tol, cost_new, tol_fun, num_times_tol_fun_sat)
                _record(trace, it, lam, cost_min, cost_new, accept, *sys_stats(sys))
                for buf, new in zip(state, trial):
                    buf.copy_(torch.where(accept, new, buf))
                lam.copy_(lam_new)
                cost_min.copy_(cost_min_new)
                count_tol.copy_(count_tol_new)
                converged.copy_(converged_new)
                it.add_(1)
                running = keep_running(lam, cost_min, it, converged, max_num_iter)
                status.copy_(torch.stack([running, accept]).to(torch.int32))

            self.g_solve = CapturedPhase(solve)
            self.g_solve.name = "solve"
            self.g_sched = CapturedPhase(schedule)
            self.g_sched.name = "schedule"
            # what the first run reports as its set-up: these seconds and the
            # warm-up's forming pass
            self._setup = (time.perf_counter() - t0, 1)

    def run(self, knots, Gx, Gy, *, on_step=None, stats: LoopStats | None = None):
        """Solve from (knots, Gx, Gy): the return of :func:`lm_while`, in
        tensors of their own (a later run does not overwrite them).
        ``stats.setup_s`` and ``stats.form_passes`` include the build's
        seconds and warm-up forming pass on the first run only."""
        lam, cost_min, count_tol, it, converged, trace = self.sched
        device = Gx.device
        for buf, src in zip(self.state + self.trial, (knots, Gx, Gy) * 2):
            buf.copy_(src)
        lam.fill_(LAMBDA_INIT)
        for t in (count_tol, it, converged, trace):
            t.zero_()
        phases = {"objective": self.g_obj, "form": self.g_form,
                  "solve": self.g_solve, "schedule": self.g_sched}
        for g in phases.values():
            g.replays = 0
        t1 = time.perf_counter()

        self.g_obj.replay()  # at the start the trial state is the initial state
        cost_min.copy_(self.cost_new)
        self.g_form.replay()
        running = bool(keep_running(lam, cost_min, it, converged, self.max_num_iter))
        while running:
            self.g_solve.replay()
            self.g_obj.replay()
            self.g_sched.replay()
            # the host waits here for the step's device work
            with obs.span("lm.status_wait", repeats=True):
                running, accepted = self.status.tolist()
            if on_step is not None:
                on_step()
            if running and accepted:
                self.g_form.replay()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s, warm_forms = self._setup
        self._setup = (0.0, 0)
        for k, g in phases.items():
            obs.count(f"lm.replays.{k}", g.replays)
        if stats is not None:
            stats.setup_s = setup_s
            stats.loop_s = time.perf_counter() - t1
            stats.form_passes = warm_forms + self.g_form.replays
            stats.replays = {k: g.replays for k, g in phases.items()}
        return tuple(t.clone() for t in (*self.state, cost_min, it, converged, trace))


def trace_records(trace: np.ndarray, n_iter: int) -> list[dict]:
    """Decode a (iterations, TRACE_COLS) trace into per-iteration dicts."""
    out = []
    for i in range(int(n_iter)):
        lam, cost_min, cost_new, accept, np_, dropped = (float(x) for x in trace[i])
        out.append(
            dict(
                iter=i + 1,
                log10_lambda=float(np.log10(lam)) if lam > 0 else float("-inf"),
                cost_min=cost_min,
                cost_new=cost_new,
                accepted=bool(accept),
                active_px=int(np_),
                dropped=int(dropped),
            )
        )
    return out


def forming_stats_from_trace(trace: np.ndarray, n_iter: int):
    """(active_px_per_form, dropped_per_form): one entry per fresh forming
    pass — iteration 0's system plus each post-accept relinearization."""
    active, dropped = [], []
    fresh = True
    for i in range(int(n_iter)):
        if fresh:
            active.append(int(trace[i, 4]))
            dropped.append(int(trace[i, 5]))
        fresh = bool(trace[i, 3])
    return active, dropped


@dataclasses.dataclass
class HostSchedule:
    """The LM schedule as host-side scalars::

        sched = HostSchedule(tol_fun, max_num_iter, num_times_tol_fun_sat)
        while sched.running():
            ...
            if sched.step(cost_new):   # True = accepted
                <take trial state>
    """

    tol_fun: float
    max_num_iter: int
    num_times_tol_fun_sat: int
    lam: float = LAMBDA_INIT
    lambda_min: float = LAMBDA_MIN
    lambda_max: float = LAMBDA_MAX
    cost_min: float = 1e99
    count_tol_sat: int = 0
    it: int = 0
    converged: bool = False
    cost_decreased: bool = True  # re-form needed (True at start)

    def start(self, cost0: float):
        self.cost_min = cost0

    def running(self) -> bool:
        return (
            not self.converged
            and self.it <= self.max_num_iter
            and self.cost_min > COST_FLOOR
            and self.lambda_min <= self.lam <= self.lambda_max
        )

    def step(self, cost_new: float) -> bool:
        """Accept/reject ``cost_new``; True when accepted."""
        self.it += 1
        if cost_new < self.cost_min:
            self.cost_decreased = True
            self.lam /= LAMBDA_DOWN
            rel = abs(1.0 - cost_new / (self.cost_min + REL_EPS))
            self.cost_min = cost_new
            if rel < self.tol_fun:
                self.count_tol_sat += 1
                if self.count_tol_sat >= self.num_times_tol_fun_sat:
                    self.converged = True
            # an accepted-but-large step does not reset the counter
            return True
        self.cost_decreased = False
        self.lam *= LAMBDA_UP
        self.count_tol_sat = 0
        return False
