"""The LM accept/reject schedule (counterpart of ``emba_tpu/lm.py``): the
reference constants, the host-side :class:`HostSchedule` that drives
``solver.solve_window``, and the decoders of a per-iteration trace.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LAMBDA_INIT = 1e-3
LAMBDA_MIN = 1e-300
LAMBDA_MAX = 1e3
LAMBDA_DOWN = 10.0  # accepted: lambda /= 10
LAMBDA_UP = 10.0  # rejected: lambda *= 10
COST_FLOOR = 1e-16  # stop when the cost is numerically zero
REL_EPS = 1e-10  # denominator guard in the relative-change test

TRACE_COLS = ("lambda", "cost_min", "cost_new", "accept", "active_px", "dropped")


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
