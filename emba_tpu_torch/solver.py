"""Levenberg-Marquardt loop for one time window (counterpart of the
host-driven ``emba_tpu.solver.solve_window``).

Same control flow as the reference: lambda schedule and convergence from
:class:`lm.HostSchedule`, relinearization only after an accepted step (the
trial evaluation is reused), gauge fixing of the first knot by masking, and
per-phase timers. Each phase ends with a device synchronization before the
clock is read, so a phase time is the device time of that phase plus its
host overhead.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import lm as lm_mod
from . import model as M


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
    counts, the active-pixel count per forming pass."""

    iterations: list = dataclasses.field(default_factory=list)
    time_form_s: float = 0.0
    time_solve_s: float = 0.0
    time_objective_s: float = 0.0
    time_total_s: float = 0.0
    count_form: int = 0
    count_solve: int = 0
    count_objective: int = 0
    num_events: int = 0
    active_px_per_form: list = dataclasses.field(default_factory=list)
    dropped_meas_per_form: list = dataclasses.field(default_factory=list)
    converged: bool = False
    sync_method: str = "device-synchronize"

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


def _solve_update(knots, Gx, Gy, neq, lam, damping, fix_first):
    """Schur solve + trial state."""
    x1, x2 = M.solve_normal_eq(neq, lam, fix_first)
    knots_new = M.update_knots(knots, x1, fix_first)
    gx_new, gy_new = M.update_map(Gx, Gy, x2, damping, neq)
    return knots_new, gx_new, gy_new


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
):
    """Run LM on (trajectory knots + gradient map) for one window.

    Args:
      knots: (K, 3, 3) tensor of control poses; Gx, Gy: (H, W) maps, on the
        device of ``dev_win``.
      callback: optional fn(iter, Gx, Gy, info), called before each solve.

    Returns (knots, Gx, Gy, LMStats).
    """
    if use_cg:
        raise NotImplementedError("use_cg: not ported yet, see ROADMAP queue 1 item 10")
    if checkpoint_cb is not None or checkpoint_every or resume_state is not None:
        raise NotImplementedError(
            "checkpoint/resume (lm_state_dict): not ported yet, see ROADMAP queue 1 item 7"
        )
    num_knots = knots.shape[0]
    device = Gx.device
    stats = LMStats(num_events=int(dev_win.pol_signed.shape[0]))
    sched = lm_mod.HostSchedule(
        tol_fun=lm.tol_fun,
        max_num_iter=lm.max_num_iter,
        num_times_tol_fun_sat=lm.num_times_tol_fun_sat,
        lam=lm.lambda_init,
        lambda_min=lm.lambda_min,
        lambda_max=lm.lambda_max,
    )

    t_loop0 = time.perf_counter()
    lin, cost_data_t, cost_reg_t = _init_costs(knots, Gx, Gy, dev_win, cfg)
    cost_data, cost_reg = float(cost_data_t), float(cost_reg_t)
    stats.time_objective_s += time.perf_counter() - t_loop0
    stats.count_objective += 1
    sched.start(cost_data + cost_reg)

    neq = None
    while sched.running():
        if sched.cost_decreased or neq is None:
            t0 = time.perf_counter()
            neq = M.form_normal_eq(lin, Gx, Gy, cfg, num_knots)
            dropped = int(neq.dropped)
            _sync(device)
            stats.time_form_s += time.perf_counter() - t0
            stats.count_form += 1
            stats.note_active_pixels(int(neq.active_count))
            stats.dropped_meas_per_form.append(dropped)

        if callback is not None:
            callback(sched.it, Gx, Gy, dict(lam=sched.lam, cost_min=sched.cost_min))

        t0 = time.perf_counter()
        knots_new, gx_new, gy_new = _solve_update(
            knots, Gx, Gy, neq, sched.lam, damping_factor, fix_first
        )
        _sync(device)
        t1 = time.perf_counter()
        stats.time_solve_s += t1 - t0
        stats.count_solve += 1

        lin_new, cost_data_new_t, cost_reg_new_t = _init_costs(
            knots_new, gx_new, gy_new, dev_win, cfg
        )
        cost_data_new = float(cost_data_new_t)
        cost_reg_new = float(cost_reg_new_t)
        stats.time_objective_s += time.perf_counter() - t1
        stats.count_objective += 1
        cost_new = cost_data_new + cost_reg_new

        stats.iterations.append(dict(
            iter=sched.it + 1,
            log10_lambda=np.log10(sched.lam),
            cost_min=sched.cost_min,
            cost_new=cost_new,
            cost_data=cost_data,
            cost_reg=cost_reg,
        ))

        if sched.step(cost_new):
            knots, Gx, Gy = knots_new, gx_new, gy_new
            lin = lin_new
            cost_data, cost_reg = cost_data_new, cost_reg_new
            if sched.converged:
                stats.converged = True
                break

    stats.time_total_s = time.perf_counter() - t_loop0
    return knots, Gx, Gy, stats
