"""Run one cell of ``BENCHMARK.json`` on this machine's GPU and print its
result as the last line of standard output:

    python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

Set-up renders the cell's scene on the card (``scene.render``, from the
configuration's own scene seed: the recording is the configuration's),
hands all its events and its gradient maps to the program, and runs the
traffic mix's warm-up jobs. A job is one
``emba_tpu_torch.pipeline.EmbaPipeline(cfg, camera, events, pose_times,
pose_rotations, init_gx, init_gy).run()`` with ``cfg`` the configuration's
preset; its front-end poses are the ground-truth knots moved by a random
walk, sampled at ``pose_rate_hz``. The mix holds a pool of ``pool_jobs``
such front-ends, drawn from its ``pool_seed``: every seed runs the same
jobs, so every run does the same work. Jobs run back to back, one at a
time, in rounds of the whole pool, each round in an order drawn from
``--seed``; the measured window ends at the first round boundary after
``--seconds`` of jobs. With ``--trace 1`` the window runs
under ``torch.profiler`` (``trace.py``) and the per-layer metrics are
reported instead of the end-to-end ones.

After the window, with the peak memory read, the plain reference
(``check.py``) solves ``check_jobs`` of the pool's jobs again (the one
with the most LM steps and others drawn from the seed) and ``correct`` says
whether each is within the limits. The numbers compared, each beside its
limit, are the last lines of standard error and the last key of the result.

The run fails, printing no result, without a CUDA device (or fewer than
the cell's chips), and when JAX or the JAX package was loaded. Every build
and kernel cache goes under ``build/`` in the checkout.
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / "benchmark_cache" / _sub)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import check, registry, scene, trace  # noqa: E402
from .reference import ba, rmse  # noqa: E402
from .reference import geometry as geo  # noqa: E402

# top-level module names no run may load (compared whole: the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "emba_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def job_seed(seed: int, job: int) -> int:
    """The seed of draw ``job`` from ``seed``."""
    return (int(seed) * 1_000_003 + int(job) + 7) % (1 << 63)


def round_order(seed: int, rnd: int, pool: int, device) -> list[int]:
    """The order of the pool's jobs in round ``rnd`` of a run with ``seed``."""
    return torch.randperm(pool, generator=scene.generator(job_seed(seed, rnd), device),
                          device=device).tolist()


def settings(conf: dict, traffic: dict) -> dict:
    """The run's settings: the configuration's, the mix's on top, and the
    sensor's size and calibration (what the reference reads)."""
    st = dict(conf["settings"], **traffic.get("settings", {}))
    sc = conf["scene"]
    st.update(sensor_width=sc["sensor_width"], sensor_height=sc["sensor_height"],
              camera=sc["camera"])
    return st


def program_config(ecfg, conf: dict, traffic: dict, st: dict):
    """The program's BAConfig: the preset with the configuration's and the
    mix's overrides; raises if the preset no longer states a setting the
    configuration file holds."""
    cfg = ecfg.preset(conf["preset"], **conf.get("overrides", {}),
                      **traffic.get("settings", {}))
    for k, v in st.items():
        if hasattr(cfg, k) and getattr(cfg, k) != v:
            raise ValueError(f"preset {conf['preset']!r} has {k} = {getattr(cfg, k)!r}, "
                             f"the configuration {v!r}")
    return cfg


class Inputs:
    """What every job of a run shares: the kept events, the maps, the
    camera, the ground truth at the pose times; and each job's poses."""

    def __init__(self, conf, traffic, dev, camera_mod):
        sc = conf["scene"]
        scn = scene.render(sc, sc["seed"], dev)
        self.rendered = scn.rendered
        self.events = (scn.t.cpu().numpy(), scn.x.cpu().numpy(), scn.y.cpu().numpy(),
                       scn.pol.cpu().numpy())
        self.gx, self.gy = scn.gx.cpu().numpy(), scn.gy.cpu().numpy()
        rate = traffic["pose_rate_hz"]
        self.pose_times = np.arange(int(np.floor(sc["duration_s"] * rate))) / rate
        self.knots, self.dt_knots = scn.knots, scn.dt_knots
        self.gt = scene.rotations(scn.knots, scn.dt_knots, self.pose_times).cpu().numpy()
        c = sc["camera"]
        self.camera = camera_mod.PinholeCamera.from_calib(
            sc["sensor_width"], sc["sensor_height"],
            np.array([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]]),
            c.get("dist"))
        self.sigma, self.pool_seed, self.dev = (traffic["walk_sigma_rad"],
                                                traffic["pool_seed"], dev)

    def poses(self, job: int) -> np.ndarray:
        """The front-end poses of job ``job`` of the mix's pool."""
        gen = scene.generator(job_seed(self.pool_seed, job), self.dev)
        kp = scene.perturbed_knots(self.knots, self.sigma, gen)
        return scene.rotations(kp, self.dt_knots, self.pose_times).cpu().numpy()

    def span(self, t_beg, dt, num_knots):
        """The pose times inside a spline's span."""
        t_end = t_beg + (num_knots - 1) * dt
        return (self.pose_times >= t_beg) & (self.pose_times < t_end)

    def rmse_deg(self, knots, t_beg, dt) -> float:
        """The refined spline against the ground truth at the pose times
        inside its span."""
        m = self.span(t_beg, dt, len(knots))
        s, u = geo.locate(self.pose_times[m], t_beg, dt, len(knots))
        R = geo.spline_eval(torch.as_tensor(knots, dtype=torch.float64), s, u).numpy()
        return rmse.rotation_rmse_deg(R, self.gt[m])

    def rmse0_deg(self, pose_R, t_beg, dt, num_knots) -> float:
        """The front-end's poses against the ground truth over the same
        pose times: where the job started."""
        m = self.span(t_beg, dt, num_knots)
        return rmse.rotation_rmse_deg(pose_R[m], self.gt[m])


def run_job(pipeline, make_cfg, inp: Inputs, job: int, prog_device, tracing: bool) -> dict:
    pose_R = inp.poses(job)
    cfg = make_cfg()
    faults0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
    t0 = time.perf_counter()
    with trace.job_range() if tracing else contextlib.nullcontext():
        res = pipeline.EmbaPipeline(cfg, inp.camera, inp.events, inp.pose_times, pose_R,
                                    inp.gx, inp.gy, device=prog_device).run()
        if torch.cuda.is_available() and prog_device is None:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - faults0
    if len(res.window_stats) != 1:
        raise RuntimeError(f"job {job}: {len(res.window_stats)} windows, the mix has one")
    st = res.window_stats[0]
    return dict(job=job, wall_s=wall, events=st.num_events, iterations=len(st.iterations),
                solve_s=st.time_total_s, setup_s=st.setup_s, form_passes=st.count_form,
                active_px_per_form=list(st.active_px_per_form), lm_mode=st.lm_mode,
                dim_pose=3 * res.trajectory.num_knots, knots=res.trajectory.knots.copy(),
                t_beg=res.trajectory.t_beg, dt=res.trajectory.dt, gx=res.gx, gy=res.gy,
                its=list(st.iterations), pose_R=pose_R, page_faults=faults)


def worst_of(values):
    """The largest of ``values`` (a NaN counts as the largest), leaving out
    each None (a number that does not apply to a job); None if all are."""
    vals = [v for v in values if v is not None]
    return max(vals, key=lambda v: v if np.isfinite(v) else np.inf) if vals else None


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                trace_summary: dict | None, checks: dict) -> dict:
    """The run's result: ``correct``, ``attempted``, ``failed``, ``metrics``
    and ``device``; ``breakdown`` (the top device operations and idle gaps)
    when the run was traced; and last ``checks``, each compared number (the
    worst over the checked jobs; None if it is not a number or applies to
    none of them) beside its limit: ``{name: (value, limit)}``."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if trace_summary is not None:
        out["breakdown"] = {"device_ops": trace_summary.get("device_ops", []),
                            "idle_gaps": trace_summary.get("idle_gaps", [])}
    out["checks"] = {k: {"value": v if v is not None and np.isfinite(v) else None,
                         "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None, device=None, root=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    reg = registry.Registry(root or ROOT)
    cell = reg.cell(args.workload)
    conf, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s), "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        dev, prog_device = torch.device("cuda", torch.cuda.current_device()), None
    else:
        dev, prog_device = torch.device(device), device
    try:
        from emba_tpu_torch import camera, kernels, pipeline
        from emba_tpu_torch import config as ecfg
    except ImportError as exc:
        print(f"benchmark: the program is not in this checkout: {exc}", file=sys.stderr)
        return 3

    st = settings(conf, traffic)
    program_config(ecfg, conf, traffic, st)

    def make_cfg():
        return program_config(ecfg, conf, traffic, st)

    cuda = dev.type == "cuda"
    inp = Inputs(conf, traffic, dev, camera)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    pool = traffic["pool_jobs"]
    for w in range(traffic["warmup_jobs"]):
        run_job(pipeline, make_cfg, inp, w % pool, prog_device, False)
    kernels.reset_launch_counts()
    t_window = time.perf_counter()

    jobs, window_s = [], 0.0
    tracing = bool(args.trace)
    with (trace.ranges() if tracing else contextlib.nullcontext()), \
            (trace.profiler() if tracing else contextlib.nullcontext()) as prof:
        rnd = 0
        while window_s < args.seconds or not jobs:
            for k in round_order(args.seed, rnd, pool, dev):
                jobs.append(run_job(pipeline, make_cfg, inp, k, prog_device, tracing))
                window_s += jobs[-1]["wall_s"]
            rnd += 1
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    launches = kernels.launch_counts()
    setup_s = t_window - T_START
    tr = trace.reduce(trace.events(prof)) if tracing else None

    for j in jobs:
        j["rmse_deg"] = inp.rmse_deg(j["knots"], j["t_beg"], j["dt"])
        j["rmse0_deg"] = inp.rmse0_deg(j["pose_R"], j["t_beg"], j["dt"], len(j["knots"]))
    win = ba.prepare_window(st, inp.events, jobs[0]["dim_pose"] // 3, dev)
    if tracing:
        # the weighted measurements of the forming passes: at the job's start
        # and at its refined state, by the reference's objective
        for j in jobs:
            s0 = ba.start_state(st, inp.pose_times, j["pose_R"], inp.gx, inp.gy, dev)
            s1 = ba.State(*(torch.as_tensor(a).to(dev, torch.float64)
                            for a in (j["knots"], j["gx"], j["gy"])))
            used = [int(torch.sum(ba.objective(st, win, s).used)) for s in (s0, s1)]
            j["weighted"] = 0.5 * sum(used)
            j["weighted_start_end"] = used

    # the check, once the window is closed and its peak read
    limits = dict(traffic["limits"], **conf.get("limits", {}))
    first = {}
    for i, j in enumerate(jobs):
        first.setdefault(j["job"], i)
    longest = max(first.values(), key=lambda i: jobs[i]["iterations"])
    rest = [i for i in first.values() if i != longest]
    rng = np.random.default_rng(int(args.seed) % (1 << 63))
    picked = [longest] + sorted(rng.choice(rest, size=min(len(rest),
                                                           traffic["check_jobs"] - 1),
                                           replace=False).tolist())
    checked = []
    for i in picked:
        j = jobs[i]
        nums = check.numbers(st, win, dict(pose_times=inp.pose_times,
                                           pose_rotations=j["pose_R"],
                                           init_gx=inp.gx, init_gy=inp.gy),
                             dict(knots=j["knots"], gx=j["gx"], gy=j["gy"],
                                  iterations=j["its"]), dev)
        nums["job"] = j["job"]
        checked.append(nums)
    failed = sum(not check.within(n, limits) for n in checked)

    ctx = types.SimpleNamespace(jobs=jobs, window_s=window_s, setup_s=setup_s,
                                peak_bytes=peak, trace=tr, config=conf, traffic=traffic)
    metrics = reg.read_metrics(args.workload, bool(args.trace), ctx)

    n_form = sum(j["form_passes"] for j in jobs)
    print(f"benchmark: {args.workload} seed {args.seed}: {len(jobs)} jobs in {window_s:.3f} s "
          f"(pool jobs {[j['job'] for j in jobs]}); "
          f"rendered {inp.rendered} events, {jobs[0]['events']} a job, "
          f"{jobs[0]['dim_pose'] // 3} knots, lm {jobs[0]['lm_mode']}", file=sys.stderr)
    print("benchmark: job walls " + json.dumps([round(j["wall_s"], 4) for j in jobs])
          + " solves " + json.dumps([round(j["solve_s"], 4) for j in jobs])
          + " host page faults " + json.dumps([j["page_faults"] for j in jobs]), file=sys.stderr)
    print("benchmark: rmse_deg front-end -> refined " + json.dumps(
        [[round(j["rmse0_deg"], 4), round(j["rmse_deg"], 4)] for j in jobs]), file=sys.stderr)
    print("benchmark: iterations " + json.dumps([j["iterations"] for j in jobs])
          + " forming passes " + json.dumps([j["form_passes"] for j in jobs])
          + f" (sum {n_form}) A12 launches {launches.get('a12_accum')}", file=sys.stderr)
    print("benchmark: active pixels a pass (first job) "
          + json.dumps(jobs[0]["active_px_per_form"]), file=sys.stderr)
    if tracing:
        print("benchmark: weighted measurements at start, end "
              + json.dumps([j["weighted_start_end"] for j in jobs]), file=sys.stderr)
        print("benchmark: trace " + json.dumps({k: tr.get(k) for k in
                                                ("window_s", "busy_s", "phase_s")}),
              file=sys.stderr)
    for n in checked:
        print("benchmark: checked " + json.dumps(n), file=sys.stderr)
    worst = {k: worst_of([n[k] for n in checked]) for k in limits}
    for k, lim in limits.items():
        print(f"check {k} {worst[k]!r} limit {lim!r}", file=sys.stderr)

    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell["chips"],
        "memory_peak_bytes": int(peak),
    }
    if tracing:
        device_info.update(busy_s=tr.get("busy_s", 0.0), window_s=tr.get("window_s", 0.0))
    out = result_line(failed == 0 and len(checked) > 0, len(jobs), failed, metrics,
                      device_info, tr if tracing else None,
                      {k: (worst[k], lim) for k, lim in limits.items()})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
