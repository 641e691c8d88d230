"""Sharded windows on the card: what ``chip_smoke.py``'s phase 14 runs on
each rank of a process group (``dist.spawn`` pickles these functions by
name, so they live in the port, which imports no JAX).

* :func:`save_window` / :func:`load_window`: a device window, its model
  configuration and start state through a file, so that every rank solves
  the parent's window bit for bit without rendering it again;
* :func:`window_rank`: the rank's shard of that window: the A12 kernel on
  the rank's own first forming pass against its plain version, the seconds
  of that pass's reductions, the host-driven and the fused sharded window
  (``lm.lm_while`` over gloo), the sharded map-only step twice, and
  ``dist.dryrun``'s variants;
* :func:`cli_rank`: ``cli.main`` on a rank (the rank path of ``cli run
  --num-devices``), its first mid-window checkpoint kept aside;
* :func:`fault_rank` and :func:`main`: what phase 14d's gate reads on a
  two-rank run with one fault planted in the sharded window:

      python -m emba_tpu_torch.probes.sharded [--faults none,halo,a12,events]
          [--ranks 2] [--max-num-iter 50] [--out PATH]

  renders the suite row (``probes.suite_run.write_suite_scene``), runs
  ``cli run`` on it on one device (phase 11's run 1), then ``cli run
  --num-devices 2 --dist-backend gloo`` with each fault of
  :data:`FAULTS` on both ranks, and prints for each the final cost
  relative to one device's, the rotation RMSE, the steps and each rank's
  A12 launches against its forming passes; one JSON line at the end (also
  written to PATH with ``--out``). It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from .. import dist, kernels, lm, model as M, solver
from ..device import full_precision
from ..kernels import a12_accum as K


def save_window(path, dev: M.DeviceWindow, cfg: M.ModelConfig, start, num_sensor_pix,
                map_knots):
    """``map_knots``: the trajectory the map-only step solves from."""
    torch.save(dict(dev={f.name: getattr(dev, f.name).cpu() for f in dataclasses.fields(dev)},
                    cfg=dataclasses.asdict(cfg), start=[t.cpu() for t in start],
                    num_sensor_pix=num_sensor_pix, map_knots=map_knots.cpu()), path)


def load_window(path, device):
    """(DeviceWindow, ModelConfig, start state, sensor pixels, map knots) on
    ``device``."""
    z = torch.load(path)
    dev = M.DeviceWindow(**{k: v.to(device) for k, v in z["dev"].items()})
    return (dev, M.ModelConfig(**z["cfg"]), [t.to(device) for t in z["start"]],
            z["num_sensor_pix"], z["map_knots"].to(device))


def _rel(got, want):
    if not want.numel():
        return 0.0
    err = float(torch.max(torch.abs(got.double() - want.double())))
    mag = float(torch.max(torch.abs(want)))
    return err / mag if mag > 0 else err


def _kernel_case(args, r_pad, dim_pose, order):
    """The A12 kernel against its plain version on one forming pass's
    inputs: {output: relative error}, the largest absolute error, and the
    kernel's launches in the call (1)."""
    kernels.reset_launch_counts()
    got = K.a12_accumulate(*args, r_pad, dim_pose, order)
    launched = kernels.launch_counts()["a12_accum"]
    want = K.a12_accumulate_plain(*args, r_pad, dim_pose, order)
    dp = got[0].shape[1] // 2

    def parts(out):
        a12, px5, a11b = out
        return {"A12_gx": a12[:, :dim_pose], "A12_gy": a12[:, dp:dp + dim_pose],
                "px5": px5[:, :5], "A11": a11b[:dim_pose, :dim_pose], "b1": a11b[dp, :dim_pose]}

    g, w = parts(got), parts(want)
    rel = {k: _rel(g[k], w[k]) for k in g}
    finite = all(bool(torch.isfinite(g[k]).all()) for k in g)
    max_abs = max(float(torch.max(torch.abs(g[k] - w[k]))) for k in g)
    return dict(rel=rel, max_abs_err=max_abs, finite=finite, launches=launched)


def _accepts(records):
    return "".join("A" if r["cost_new"] < r["cost_min"] else "r" for r in records)


def window_rank(comm, path, max_num_iter: int):
    """Phase 14b, 14c and 14e on this rank (see the module doc). Returns a
    dict of plain values and numpy maps."""
    full_precision()
    dev, cfg, start, nsp, map_knots = load_window(path, comm.device)
    shard = dist.shard_window(dev, comm)
    del dev
    torch.cuda.empty_cache()
    place = dist.Sharded(comm, nsp)
    knots0, gx0, gy0 = start
    dim_pose = 3 * knots0.shape[0]
    out = {"events": int(shard.pol_signed.shape[0])}

    # the rank's first forming pass: its own halo-resolved inputs
    lin = dist.linearize_sharded(knots0, gx0, gy0, shard, cfg, comm, nsp)
    rows, wA, r_pad, _, _ = M.forming_inputs(lin, cfg, lin.e.dtype)
    args = (rows, lin.i_c, lin.i_p, lin.Jc, lin.Jp, lin.dx, lin.dy, lin.e, wA)
    out["kernel"] = _kernel_case(args, r_pad, dim_pose, cfg.spline_order)
    out["kernel"]["measurements"] = int((wA > 0).sum())
    neq = M.form_normal_eq(lin, gx0, gy0, cfg, knots0.shape[0],
                           1.0 if comm.rank == 0 else 0.0)
    del lin, args, rows, wA
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comm.reduce_scatter_sum(neq.A12)
    torch.cuda.synchronize()
    out["a12_reduce_scatter_s"] = time.perf_counter() - t0
    out["a12_bytes"] = neq.A12.numel() * neq.A12.element_size()
    del neq
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    _k, _gx, _gy, st = solver.solve_window(
        *start, shard, cfg, solver.LMConfig(max_num_iter=max_num_iter, tol_fun=0.0),
        fix_first=True, placement=place)
    torch.cuda.synchronize()
    out["host"] = dict(accepts=_accepts(st.iterations), iterations=len(st.iterations),
                       final_cost=min(min(r["cost_min"], r["cost_new"])
                                      for r in st.iterations),
                       cost0=st.iterations[0]["cost_min"], forms=st.count_form,
                       launches=kernels.launch_counts()["a12_accum"],
                       seconds=st.time_total_s, form_s=st.time_form_s,
                       solve_s=st.time_solve_s, objective_s=st.time_objective_s,
                       finite=all(bool(torch.isfinite(t).all()) for t in (_k, _gx, _gy)))
    del _k, _gx, _gy

    kernels.reset_launch_counts()
    loop = lm.LoopStats()
    k, gx, gy, cost, it, conv, trace = solver.solve_window_fused(
        *start, shard, cfg, 1.0, 0.0, fix_first=True, max_num_iter=max_num_iter,
        return_trace=True, stats=loop, placement=place)
    torch.cuda.synchronize()
    recs = lm.trace_records(trace.cpu().double().numpy(), int(it))
    out["fused"] = dict(accepts="".join("A" if r["accepted"] else "r" for r in recs),
                        iterations=int(it), final_cost=float(cost),
                        forms=loop.form_passes,
                        launches=kernels.launch_counts()["a12_accum"],
                        seconds=loop.loop_s,
                        finite=all(bool(torch.isfinite(t).all()) for t in (k, gx, gy)))
    out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    del k, gx, gy

    z = torch.zeros_like(gx0)
    maps = []
    for _ in range(2):
        t0 = time.perf_counter()
        gxm, gym, costs = place.solve_map_only(map_knots, z, z.clone(), shard, cfg)
        torch.cuda.synchronize()
        maps.append((gxm, gym, costs, time.perf_counter() - t0))
    out["map_only"] = dict(
        gx=maps[0][0].cpu().numpy(), gy=maps[0][1].cpu().numpy(), costs=maps[0][2],
        seconds=[m[3] for m in maps],
        repeat_equal=bool(torch.equal(maps[0][0], maps[1][0])
                          and torch.equal(maps[0][1], maps[1][1])))
    del maps, shard
    torch.cuda.empty_cache()
    out["dryrun"] = dist._dryrun_rank(comm)
    return out


def cli_rank(comm, argv, snapshot=None):
    """``cli.main(argv)`` on this rank (the process group exists, so the
    CLI runs its pipeline here), the A12 launches counted from 0 and the
    peaks reset; with ``snapshot``, rank 0 copies its first mid-window
    checkpoint to that path. Returns (RunResult, A12 launches, peak reserved
    bytes)."""
    from .. import cli, pipeline

    if snapshot is not None and comm.rank == 0:
        save = pipeline.EmbaPipeline.save_checkpoint
        taken = []

        def keep_first(self, path, window_idx, lm_state=None):
            save(self, path, window_idx, lm_state=lm_state)
            if lm_state is not None and not taken:
                shutil.copy(path, snapshot)
                taken.append(path)

        pipeline.EmbaPipeline.save_checkpoint = keep_first
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = cli.main(argv)
    torch.cuda.synchronize()
    return res, kernels.launch_counts()["a12_accum"], torch.cuda.max_memory_reserved()


# The faults :func:`fault_rank` plants, each in one place of the sharded
# window: "none" (the sound run); "halo" (the halo fold delivers nothing: an
# event whose prev lies on an earlier rank pairs with an empty record);
# "a12" (each rank keeps its own rows of its own A12, not summed over the
# ranks: the Schur complement misses the other ranks' cross terms, while
# the cost stays exact); "events" (the last rank's events make no
# measurement).
FAULTS = ("none", "halo", "a12", "events")


def _plant(fault):
    if fault == "halo":
        dist.Comm.shift = lambda self, xs, d: [torch.zeros_like(x) for x in xs]
    elif fault == "a12":
        reduce = dist.reduce_normal_eq

        def unreduced(neq, comm):
            rows = neq.A12.shape[0] // comm.world
            mine = neq.A12[comm.rank * rows:(comm.rank + 1) * rows].clone()
            return dataclasses.replace(reduce(neq, comm), A12=mine)

        dist.reduce_normal_eq = unreduced
    elif fault == "events":
        shard = dist.shard_window

        def dropped(dev, comm):
            sh = shard(dev, comm)
            if comm.rank == comm.world - 1:
                sh = dataclasses.replace(sh, has_prev=torch.zeros_like(sh.has_prev))
            return sh

        dist.shard_window = dropped
    elif fault != "none":
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")


def fault_rank(comm, argv, fault):
    """:func:`cli_rank` with ``fault`` (:data:`FAULTS`) planted in this
    rank's process (a spawned rank's own: nothing outside it changes)."""
    _plant(fault)
    return cli_rank(comm, argv)


def _final_cost(st):
    return min(min(r["cost_min"], r["cost_new"]) for r in st.iterations)


def main(argv=None) -> int:
    from .. import cli
    from ..device import card_name_and_power_limit, require_cuda
    from .suite_run import suite_argv, write_suite_scene

    ap = argparse.ArgumentParser(description="planted faults of the sharded window")
    ap.add_argument("--faults", default=",".join(FAULTS),
                    help=f"comma-separated, of {','.join(FAULTS)} (default all)")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--max-num-iter", type=int, default=50,
                    help="the LM's --max-num-iter on every run (default 50)")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    faults = args.faults.split(",")
    for f in faults:
        if f not in FAULTS:
            ap.error(f"unknown fault {f!r}")
    require_cuda()
    full_precision()
    line = {"device": card_name_and_power_limit(), "ranks": args.ranks}
    with tempfile.TemporaryDirectory() as d:
        _n, kept, p = write_suite_scene(d)
        base = ["run"] + suite_argv(p, max_num_iter=args.max_num_iter)

        def rmse(traj, name):
            path = os.path.join(d, f"{name}.txt")
            traj.write_tum(path)
            return cli.main(["eval", "--traj", path, "--gt", p["traj_gt.txt"]])[
                "rotation_rmse_deg"]

        res1 = cli.main(base)
        one = res1.window_stats[0]
        cost1 = _final_cost(one)
        line["one_device"] = dict(events=kept, final_cost=cost1, steps=len(one.iterations),
                                  accepts=_accepts(one.iterations),
                                  rmse_deg=rmse(res1.trajectory, "one"))
        print(f"sharded faults: one device {line['one_device']}", flush=True)
        argv_n = base + ["--num-devices", str(args.ranks), "--dist-backend", "gloo"]
        for fault in faults:
            t0 = time.perf_counter()
            ranks = dist.spawn(fault_rank, args.ranks, "gloo", args=(argv_n, fault),
                               device="cuda", threads=2, timeout_s=900)
            res = ranks[0][0]
            st = res.window_stats[0]
            cost = _final_cost(st)
            line[fault] = dict(
                final_cost=cost, rel=abs(cost - cost1) / abs(cost1), steps=len(st.iterations),
                accepts=_accepts(st.iterations), rmse_deg=rmse(res.trajectory, fault),
                launches=[n for _, n, _ in ranks],
                forms=[sum(w.count_form for w in r.window_stats) for r, _, _ in ranks],
                seconds=time.perf_counter() - t0)
            print(f"sharded faults: {fault}: {json.dumps(line[fault])}", flush=True)
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
