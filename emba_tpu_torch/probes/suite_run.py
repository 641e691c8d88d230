"""The synthetic accuracy suite's ``ecrot_bicycle_like`` row as the files a
user gives ``cli run``, runs of the port's command line on them with their
device memory measured, and a probe of the classic-window cap.

    python -m emba_tpu_torch.probes.suite_run [--max-num-iter N]
        [--stream off,full,light] [--duration S] [--out PATH]

:func:`write_suite_scene` renders the row with the port's ``synth`` (240x180
sensor, f = 216, 1024x512 panorama, 4.8 s, 1500 steps; seed, motion and
texture of ``emba_tpu/eval_suite.py``). :func:`measured_run` runs
``cli.main(["run", ...])`` on the card from an empty graph and allocator
cache and returns its summary: windows, events, iterations, the call's
wall, each window's solve (``window_s``: ``LMStats.time_total_s``, a fused
window's set-up included), set-up and loop (the solve less its set-up),
events/s a window (``LMStats.events_per_second``, from ``window_s``), peak
device bytes (allocated and reserved, also per event of the largest
window), A12 launches against forming passes, and the streaming chunk and
tier the run's plan chose.

The probe (``main``) keeps every event of the scene, so its whole-span
window (0.1-4.7 s, 93 knots) holds about 8 times the 3.67M events of
``chip_smoke.py``'s pipeline phase, just under
``pipeline.CLASSIC_CAP_SMALL_ROWS``. ``--duration`` renders the row over
another span at the same steps a second (its window 0.1 s in from either
end). For each mode of ``--stream`` (``off``: the classic window;
``full`` and ``light``: streamed in chunks of
``pipeline.AUTO_STREAM_CHUNK`` in that tier) it runs that window fused and
then recording (host loop, ``--out``), each for ``--max-num-iter``
iterations, and prints one JSON line: the card and its power limit, and
each run's summary (events/s, peak bytes) with the cap its reserved bytes
per event give. It writes the line to PATH only when ``--out`` is given.
It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

# The accuracy suite's ecrot_bicycle_like row (emba_tpu/eval_suite.py,
# scripts/r4_suite.py): seed, motion, texture smooth and amplitude,
# duration; at its full size.
SUITE_ROW = dict(seed=11, motion=0.22, smooth=3, amp=3.0, duration=4.8)
SUITE_EVENTS = 4_000_000  # the suite's max_events: 1 event in 8 kept
SUITE_STEPS = 1500  # render steps over the row's 4.8 s
# The classic-window cap is this share of the card's memory (80 GB by its
# name) over a run's peak reserved bytes an event.
CAP_MEMORY_SHARE = 0.8
CARD_BYTES = 80e9
FILES = ("events.npz", "frontend.txt", "traj_gt.txt", "calib.yaml", "Gx.bin", "Gy.bin")


def perturbed(traj, rng, sigma):
    """``traj`` with its knots moved by a random walk of ``sigma`` rad a
    knot, the first knot kept."""
    from .. import spline

    steps = rng.normal(size=(traj.num_knots, 3)) * sigma
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    return dataclasses.replace(traj, knots=spline._np_exp(walk) @ traj.knots)


def write_suite_scene(out_dir, max_events=SUITE_EVENTS, duration=None):
    """The suite row's scene written into ``out_dir`` as :data:`FILES`:
    events.npz (kept 1 in ceil(N / max_events), all with ``None``), the
    front-end poses (the ground truth's knots perturbed by the suite's
    random walk, sigma 0.005, sampled at 400 Hz), the ground truth at the
    same times, calib.yaml and the ground-truth maps. ``duration``: render
    over this many seconds instead of the row's 4.8, at the same steps a
    second. Returns (scene events, kept events, {file: path})."""
    from .. import io as eio
    from .. import synth
    from ..pipeline import systematic_subsample

    r = SUITE_ROW
    duration = duration or r["duration"]
    steps = int(round(SUITE_STEPS * duration / r["duration"]))
    rng = np.random.default_rng(r["seed"])
    cam = synth.default_sensor(240, 180, f=240 * 0.9)
    B = synth.smooth_random_map(512, 1024, rng, r["smooth"], r["amp"])
    scene = synth.generate(rng, cam, pano_width=1024, pano_height=512, c_th=0.2,
                           t_end=duration, dt_knots=0.05, num_steps=steps,
                           motion_amp=r["motion"], brightness=B)
    ev = (scene.t, scene.x, scene.y, scene.pol)
    if max_events is not None:
        ev = systematic_subsample(*ev, int(np.ceil(len(scene.t) / max_events)))
    front = perturbed(scene.traj, rng, 0.005)
    tt = np.arange(0.0, duration, 1.0 / 400)
    p = {k: os.path.join(out_dir, k) for k in FILES}
    eio.save_events_npz(p["events.npz"], *ev)
    eio.save_tum_trajectory(p["frontend.txt"], tt, front.evaluate(tt).numpy())
    eio.save_tum_trajectory(p["traj_gt.txt"], tt, scene.traj.evaluate(tt).numpy())
    eio.save_map_bin(p["Gx.bin"], p["Gy.bin"], scene.gx, scene.gy)
    eio.save_calib_yaml(p["calib.yaml"], cam.width, cam.height, cam.K)
    return len(scene.t), len(ev[0]), p


def suite_argv(p, max_num_iter=50, duration=SUITE_ROW["duration"]):
    """``cli run`` arguments of the suite row's whole span (0.1 s in from
    either end of ``duration``: 0.1-4.7 s for the row)."""
    return ["--events", p["events.npz"], "--poses", p["frontend.txt"], "--calib",
            p["calib.yaml"], "--map-gx", p["Gx.bin"], "--map-gy", p["Gy.bin"],
            "--start-time", "0.1", "--stop-time", f"{duration - 0.1:g}", "--c-th", "0.2",
            "--alpha", "0.5", "--outlier-dp", "3.0", "--thres-valid-pixel", "3",
            "--max-num-iter", str(max_num_iter)]


def cap_from(bytes_per_event):
    """The classic-window cap these bytes an event give, rounded down to a
    million events."""
    return int(CAP_MEMORY_SHARE * CARD_BYTES / bytes_per_event // 1e6 * 1e6)


def measured_run(argv):
    """``cli.main(["run"] + argv)`` on the card, from an empty graph and
    allocator cache with the allocator's peaks reset and the A12 launches
    counted from 0. Returns (RunResult, summary dict)."""
    from .. import cli, kernels, solver

    solver._GRAPHED.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = cli.main(["run"] + argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = res.window_stats
    n_ev = [st.num_events for st in stats]
    peak_a, peak_r = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    summary = dict(
        windows=len(stats), events=n_ev, knots=res.trajectory.num_knots,
        iterations=[len(st.iterations) for st in stats],
        lm_mode=[st.lm_mode for st in stats], wall_s=wall,
        window_s=[st.time_total_s for st in stats], setup_s=[st.setup_s for st in stats],
        loop_s=[st.time_total_s - st.setup_s for st in stats],
        events_per_s=[st.events_per_second()["total"] for st in stats],
        peak_allocated_bytes=peak_a, peak_reserved_bytes=peak_r,
        baseline_allocated_bytes=base,
        bytes_per_event_allocated=peak_a / max(n_ev),
        bytes_per_event_reserved=peak_r / max(n_ev),
        a12_launches=kernels.launch_counts()["a12_accum"],
        forming_passes=sum(st.count_form for st in stats),
        stream_chunk=res.model_config.stream_chunk,
        stream_light=res.model_config.stream_light)
    return res, summary


# The streaming arguments of each mode of --stream.
STREAM_MODES = {"off": ["--stream-chunk", "0"],
                "full": ["--stream-chunk", "{chunk}", "--stream-light", "0"],
                "light": ["--stream-chunk", "{chunk}", "--stream-light", "1"]}


def stream_modes(text):
    """``off,full,light`` -> a list of modes of :data:`STREAM_MODES`."""
    modes = text.split(",")
    bad = [m for m in modes if m not in STREAM_MODES]
    if bad:
        raise argparse.ArgumentTypeError(f"unknown --stream modes {bad}; "
                                         f"choose from {','.join(STREAM_MODES)}")
    return modes


def main(argv=None) -> int:
    from ..device import card_name_and_power_limit, full_precision, require_cuda
    from ..pipeline import AUTO_STREAM_CHUNK, CLASSIC_CAP_SMALL_ROWS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-num-iter", type=int, default=3,
                    help="LM iterations of each run (default 3)")
    ap.add_argument("--stream", type=stream_modes, default=["off"],
                    help="comma-separated modes: off (classic), full, light "
                    "(streamed tiers); default off")
    ap.add_argument("--duration", type=float, default=SUITE_ROW["duration"],
                    help=f"seconds rendered (default {SUITE_ROW['duration']})")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    require_cuda()
    full_precision()
    line = {"device": card_name_and_power_limit(),
            "classic_cap_small_rows": CLASSIC_CAP_SMALL_ROWS, "duration": args.duration}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        n_scene, n_kept, p = write_suite_scene(d, max_events=None, duration=args.duration)
        line.update(scene_events=n_scene, kept_events=n_kept,
                    scene_s=time.perf_counter() - t0)
        print(f"suite_run: {n_scene} events rendered and written in "
              f"{line['scene_s']:.1f} s", flush=True)
        run = suite_argv(p, args.max_num_iter, args.duration)
        for mode in args.stream:
            stream = [a.format(chunk=AUTO_STREAM_CHUNK) for a in STREAM_MODES[mode]]
            for name, extra in (("fused", []),
                                ("recording", ["--out", os.path.join(d, f"rec_{mode}")])):
                _, s = measured_run(run + stream + extra)
                s["cap_from_reserved"] = cap_from(s["bytes_per_event_reserved"])
                key = name if mode == "off" else f"{mode}_{name}"
                print(f"suite_run {key}: {json.dumps(s)}", flush=True)
                line[key] = s
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
