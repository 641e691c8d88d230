"""Where the time of an LM window goes on the card: device time against
wall time for the host loop, the fused loop and the fused loop with CG.

    python -m emba_tpu_torch.probes.profile_fused [--out PATH]

The window is the bench problem (:func:`main_window`): 2,000,000 events,
a 1024x512 panorama, a 97-knot order-2 spline, f32, ``fix_first``,
``tol_fun`` 0. Each loop is run with ``max_num_iter`` 8 (9 trial steps)
and 0 (1 trial step) under ``torch.profiler`` (CUDA activity only), after
an unprofiled call with the same settings (so the fused loop's graphs are
built and cached before the profiled call). The difference of the two
runs is 8 steps with the set-up and the first objective cancelled:

* ``wall_ms``: host clock, device synchronized at both ends;
* ``device_ms``: the sum of the device activities (kernels, copies,
  fills) the profiler recorded;
* ``idle``: 1 - device_ms / wall_ms;
* ``phase_ms`` (host loop only): its objective, form and solve seconds as
  ``solver.LMStats`` clocks them, each phase ending in a synchronization;
* ``cuda_mallocs``: the allocator's ``cudaMalloc`` calls in the long and
  the short run (0 when its cache already holds every buffer).

``REPS`` repetitions of each. ``top`` lists the device activities of the
last 9-step run of each loop by total time (name, count, ms). It prints
one JSON line, with ``device`` naming the card and its power limit, and
writes it to PATH only when ``--out`` is given. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .. import solver, spline, synth
from .. import model as M
from ..device import card_name_and_power_limit, cuda_mallocs, full_precision, require_cuda
from ..pairing import build_window

STEPS = (8, 0)  # max_num_iter of the long and the short run
REPS = 2


def bench_scene(pano_height=512):
    """The bench problem's scene (``bench.py``'s at ``BENCH_PANO_H``): a
    128x128 sensor over a smooth random brightness map of ``pano_height``
    x 2 ``pano_height`` (seed 7, smooth 4, amplitude 3), 4.8 s, 600
    render steps, C_th 0.1, and its trajectory perturbed by a random walk
    (seed 1, 0.01 rad a knot). Returns (scene, perturbed start, sensor)."""
    rng = np.random.default_rng(7)
    sensor = synth.default_sensor(128, 128, f=128 * 0.9)
    B = synth.smooth_random_map(pano_height, 2 * pano_height, rng, smooth=4, amp=3.0)
    scene = synth.generate(rng, sensor, pano_width=2 * pano_height,
                           pano_height=pano_height, c_th=0.1, t_end=4.8, dt_knots=0.05,
                           num_steps=600, motion_amp=0.22, brightness=B)
    steps = np.random.default_rng(1).normal(size=(scene.traj.num_knots, 3)) * 0.01
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    traj0 = dataclasses.replace(scene.traj, knots=spline._np_exp(walk) @ scene.traj.knots)
    return scene, traj0, sensor


def bench_window(scene, traj0, sensor, n, device, compact_cap=None, pad_multiple=1):
    """The first ``n`` events of a :func:`bench_scene` on ``device`` in f32,
    with the bench's model (thres_valid_pixel 3, alpha 0.5, outlier cut 3
    px; ``compact_cap`` if given), the window padded to ``pad_multiple``.
    Returns a dict with ``scene``, ``traj0``, ``sensor``, ``n`` (events
    used), ``cfg``, ``win`` (the host EventWindow), ``dev`` (the
    DeviceWindow) and ``start`` (knots, Gx, Gy tensors)."""
    n = min(len(scene.t), n)
    H, W = scene.gx.shape
    cfg = M.ModelConfig(c_th=0.1, pano_width=W, pano_height=H, thres_valid_pixel=3,
                        alpha=0.5, outlier_dp_norm=3.0, compact_cap=compact_cap)
    win = build_window(scene.t[:n], scene.x[:n], scene.y[:n], scene.pol[:n],
                       sensor.width, traj0.locate, 100)
    dev = M.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                     torch.float32, device, pad_multiple=pad_multiple)
    start = tuple(torch.as_tensor(a).to(device=device, dtype=torch.float32)
                  for a in (traj0.knots, scene.gx, scene.gy))
    return dict(scene=scene, traj0=traj0, sensor=sensor, n=n, cfg=cfg, win=win, dev=dev,
                start=start)


def main_window(device):
    """The bench problem on ``device`` in f32: the first 2,000,000 events of
    the 1024x512 :func:`bench_scene` (:func:`bench_window`)."""
    return bench_window(*bench_scene(), 2_000_000, device)


def _loops(w):
    """name -> fn(max_num_iter) running that loop on the window once."""
    def host(iters):
        return solver.solve_window(*w["start"], w["dev"], w["cfg"],
                                   solver.LMConfig(max_num_iter=iters, tol_fun=0.0),
                                   fix_first=True)[3]

    def fused(iters, use_cg=False):
        solver.solve_window_fused(*w["start"], w["dev"], w["cfg"], 1.0, 0.0,
                                  fix_first=True, use_cg=use_cg, max_num_iter=iters)

    return {"host": host, "fused": fused, "fused_cg": lambda i: fused(i, True)}


def _profiled(fn):
    """(wall ms, device ms, device activities) of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    acts = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    device = sum(ms for _, ms in acts)
    if device <= 0:
        raise RuntimeError("profile_fused: the profiler recorded no device time")
    return wall, device, acts


def _top(acts, k=25):
    total, count = collections.Counter(), collections.Counter()
    for name, ms in acts:
        total[name] += ms
        count[name] += 1
    return [[name, count[name], ms] for name, ms in total.most_common(k)]


def run(device) -> dict:
    """The measurements on ``device``, keyed as the module doc says."""
    w = main_window(device)
    res, top = {}, {}
    for name, loop in _loops(w).items():
        res[name] = []
        for _ in range(REPS):
            walls, devs, stats, mallocs = [], [], [], []
            for iters in STEPS:
                loop(iters)  # builds and caches the fused loop's graphs
                out = {}
                m0 = cuda_mallocs()
                wall, dev_ms, acts = _profiled(lambda: out.update(st=loop(iters)))
                mallocs.append(cuda_mallocs() - m0)
                walls.append(wall)
                devs.append(dev_ms)
                stats.append(out["st"])
                if iters == STEPS[0]:
                    top[name] = _top(acts)
            wall, dev_ms = walls[0] - walls[1], devs[0] - devs[1]
            rec = {"wall_ms": wall, "device_ms": dev_ms, "idle": 1.0 - dev_ms / wall,
                   "cuda_mallocs": mallocs}
            if stats[0] is not None:  # the host loop's own phase clocks
                rec["phase_ms"] = {
                    p: 1e3 * (getattr(stats[0], f"time_{p}_s") - getattr(stats[1], f"time_{p}_s"))
                    for p in ("objective", "form", "solve")}
            res[name].append(rec)
        print(f"profile_fused: {name} {json.dumps(res[name])}", file=sys.stderr, flush=True)
    return {"steps": STEPS[0] - STEPS[1], "loops": res, "top": top}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    device = require_cuda()
    full_precision()
    res = {"device": card_name_and_power_limit(), **run(device)}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
