"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size: for each job index, the job of that index drawn from the
mix's ``pool_seed`` (indices below ``pool_jobs`` are the pool's jobs that
runs time; those above are further front-ends of the same kind), and the
numbers of ``check.py`` against the plain reference. ``--control``:

* ``none``: the program as the configuration states it (float32, TF32
  off): the sound readings;
* ``tf32``: the program with TF32 on for its matrix products;
* ``bf16``: the plain reference put in the program's place and computed in
  bfloat16: its per-event arithmetic and its state in bfloat16, its sums,
  normal equations and solve in float32, as bfloat16 units accumulate.

    python -m benchmark.control --workload NAME --jobs 0,1,2
        --control none|tf32|bf16 [--out PATH]

One process renders the cell's scene once, runs one warm-up job, then the
jobs; it prints a JSON line per job and, last, one with them all (written
to PATH when given). It needs a CUDA device, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, registry, run
from .reference import ba


def readings(workload: str, jobs, control: str, device=None, root=None) -> list[dict]:
    reg = registry.Registry(root or run.ROOT)
    cell = reg.cell(workload)
    conf, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    if device is None:
        dev, prog_device = torch.device("cuda", torch.cuda.current_device()), None
    else:
        dev, prog_device = torch.device(device), device
    from emba_tpu_torch import camera, pipeline
    from emba_tpu_torch import config as ecfg

    st = run.settings(conf, traffic)

    def make_cfg():
        return run.program_config(ecfg, conf, traffic, st)

    torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
    inp = run.Inputs(conf, traffic, dev, camera)
    run.run_job(pipeline, make_cfg, inp, jobs[0], prog_device, False)
    out, win = [], None
    for k in jobs:
        j = run.run_job(pipeline, make_cfg, inp, k, prog_device, False)
        if win is None:
            win = ba.prepare_window(st, inp.events, j["dim_pose"] // 3, dev)
        inputs = dict(pose_times=inp.pose_times, pose_rotations=j["pose_R"], init_gx=inp.gx,
                      init_gy=inp.gy)
        if control == "bf16":
            res = check.reference_as_program(st, win, inputs, dev, torch.bfloat16)
        else:
            res = dict(knots=j["knots"], gx=j["gx"], gy=j["gy"], iterations=j["its"])
        nums = check.numbers(st, win, inputs, res, dev)
        nums.update(job=k, control=control, wall_s=j["wall_s"],
                    iterations=len(res["iterations"]),
                    rmse_deg=inp.rmse_deg(res["knots"], j["t_beg"], j["dt"]))
        print(json.dumps(nums), flush=True)
        out.append(nums)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--jobs", required=True, help="comma-separated job indices")
    ap.add_argument("--control", choices=("none", "tf32", "bf16"), default="none")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    res = readings(args.workload, [int(s) for s in args.jobs.split(",")], args.control)
    line = json.dumps({"workload": args.workload, "control": args.control,
                       "card": torch.cuda.get_device_name(), "readings": res})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
