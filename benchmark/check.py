"""What decides ``correct``: a job's outputs against the plain reference's
solve of the same inputs (``reference.ba``, float64 on the run's device).

For each checked job the reference works out the window and its start
from the inputs the job handed the program, solves it, and compares:

* ``cost0_gap``: the program's cost at its start (its first step's
  ``cost_min``) against the reference's, relative: the cut, pose fit,
  pairing, map filter, warp and objective;
* ``step1_gap``: the cost after the program's first step (its first
  ``cost_new``) against the reference's first step's, relative: forming
  and the solve, before the two paths can part on a decision;
* ``steps_gap``: the same over the steps before the first decision on
  which the two disagree, the largest;
* ``report_gap``: the program's final cost against the reference's cost
  at the program's refined knots and maps, relative: the answer it returns
  is the state its loop ended on, at the cost it reports;
* ``knot_gap_deg``: the largest angle between the program's refined knots
  and the reference's, in degrees;
* ``knot_gap_same_deg``: the same, on a job whose two paths took the same
  decisions to the end (each step accepted or rejected alike, as many
  steps); None on the others;
* ``final_gap``: the reference's cost at the program's refined knots and
  maps against the reference's own final cost, relative;
* ``map_gap``: the relative distance of the refined gradient maps.

Where a decision of the float32 program and the float64 reference parts
their paths (a step accepted on one side only), they can end in different
basins of the cost: ``knot_gap_deg`` then reads far more than on a job
whose paths stay together, which ``knot_gap_same_deg`` holds tightly.
Each number the traffic mix gives a limit (``limits``; a configuration may
give its own) is compared; a job is correct when every one is within its
limit (a None, a number that does not apply to the job, is within).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference import ba
from .reference import geometry as geo

def numbers(st: dict, win: ba.Window, inputs: dict, out: dict, device) -> dict:
    """The compared numbers of one job. ``inputs``: the pose times and
    rotations and the initial maps handed to the program; ``out``: its
    refined knots and maps and its steps (``LMStats.iterations``)."""
    s0 = ba.start_state(st, inputs["pose_times"], inputs["pose_rotations"],
                        inputs["init_gx"], inputs["init_gy"], device)
    if s0.knots.shape[0] != win.num_knots:
        raise ValueError("check: the start's knots do not match the window's")
    ref = ba.solve(st, win, s0)
    c0 = ref.trace[0][1]
    prog = ba.State(torch.as_tensor(out["knots"]).to(device, torch.float64),
                    torch.as_tensor(out["gx"]).to(device, torch.float64),
                    torch.as_tensor(out["gy"]).to(device, torch.float64))
    its = out["iterations"]
    nan = float("nan")
    G_ref = torch.stack([ref.state.gx, ref.state.gy])
    G_prog = torch.stack([prog.gx, prog.gy])
    knots_ok = prog.knots.shape == ref.state.knots.shape
    steps = []
    for p, r in zip(its, ref.trace):
        steps.append(abs(p["cost_new"] - r[2]) / r[2])
        if p["accepted"] != r[3]:
            break
    same_path = len(its) == len(ref.trace) and all(
        p["accepted"] == r[3] for p, r in zip(its, ref.trace))
    knot_gap = float(torch.max(geo.angle_deg(prog.knots, ref.state.knots))) \
        if knots_ok else nan
    cost_at_prog = float(ba.objective(st, win, prog).cost)
    if its:
        last = its[-1]
        reported = last["cost_new"] if last["accepted"] else last["cost_min"]
    return {
        "cost0_gap": abs(its[0]["cost_min"] - c0) / c0 if its else nan,
        "step1_gap": steps[0] if steps else nan,
        "steps_gap": max(steps, key=lambda v: v if np.isfinite(v) else np.inf)
        if steps else nan,
        "report_gap": abs(reported - cost_at_prog) / cost_at_prog if its else nan,
        "knot_gap_deg": knot_gap,
        "knot_gap_same_deg": knot_gap if same_path else None,
        "final_gap": abs(cost_at_prog - ref.cost) / ref.cost,
        "map_gap": float(torch.linalg.norm(G_prog - G_ref) / torch.linalg.norm(G_ref))
        if G_prog.shape == G_ref.shape else nan,
        "ref_steps": len(ref.trace),
        "prog_steps": len(its),
        "same_steps": len(steps),
        "costs_prog": [its[0]["cost_min"], its[0]["cost_new"], reported] if its else [],
        "costs_ref": [c0, ref.trace[0][2], ref.cost, cost_at_prog],
    }


def reference_as_program(st: dict, win: ba.Window, inputs: dict, device, dtype) -> dict:
    """The plain reference put in the program's place, computed in
    ``dtype`` (the control): its per-event arithmetic and its state in
    ``dtype``, its sums in ``ba.accumulator(dtype)``; the outputs
    :func:`numbers` reads."""
    s0 = ba.start_state(st, inputs["pose_times"], inputs["pose_rotations"],
                        inputs["init_gx"], inputs["init_gy"], device, dtype)
    low = dataclasses.replace(win, bear=win.bear.to(dtype), pol=win.pol.to(dtype),
                              bu=win.bu.to(dtype))
    res = ba.solve(st, low, s0)
    return dict(knots=res.state.knots.double().cpu().numpy(),
                gx=res.state.gx.double().cpu().numpy(),
                gy=res.state.gy.double().cpu().numpy(),
                iterations=[dict(cost_min=c_min, cost_new=c_new, accepted=acc)
                            for _lam, c_min, c_new, acc in res.trace])


def within(nums: dict, limits: dict) -> bool:
    """Every limited number that applies to the job is a number and within
    its limit."""
    return all(nums[k] is None or (np.isfinite(nums[k]) and nums[k] <= lim)
               for k, lim in limits.items())
