"""The synthetic accuracy suite (counterpart of ``emba_tpu/eval_suite.py``).

Renders rotating-camera sequences (textures and motions of their own),
perturbs the ground-truth trajectory as an imperfect front end would, runs
the BA window and reports rotation RMSE (initial -> refined) and the
event-based photometric error (initial -> refined), the two quantities of
the paper's quantitative table.

    python -m emba_tpu_torch.eval_suite [OUT.json] [--ecrot] [--full]
        [--multi-start] [--sequences a,b,...] [--device cuda|cpu]

Runs on the first CUDA device unless ``--device cpu`` (``device="cpu"``)
is asked for; without a GPU the default raises. Windows solve through the
host-driven LM loop (``solver.solve_window``), as in the reference suite.
A sequence whose kept events exceed ``stream_over`` (the port's
classic-window cap) streams in chunks of :data:`STREAM_CHUNK` events, as
does any with ``stream=True``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from . import metrics, model, pairing, pipeline, solver, spline, synth
from .device import card_name_and_power_limit, require_cuda

SEQUENCES = {
    # name: (seed, motion_amp, texture_smooth, texture_amp, duration)
    "synth_slow": (1, 0.15, 3, 3.0, 1.0),
    "synth_medium": (2, 0.25, 3, 3.0, 1.0),
    "synth_fast": (3, 0.40, 3, 3.0, 1.0),
    "synth_fine_texture": (4, 0.25, 2, 3.5, 1.0),
    "synth_coarse_texture": (5, 0.25, 5, 2.5, 1.0),
    "synth_long": (6, 0.25, 3, 3.0, 2.0),
}

# ECRot-shaped suite: DAVIS240-like sensor (240x180), 1024x512 panorama,
# 4.8 s BA span, dt_knots 0.05 (97 knots): the reference experiments'
# problem shape.
ECROT_LIKE = {
    "ecrot_bicycle_like": (11, 0.22, 3, 3.0, 4.8),
    "ecrot_city_like": (12, 0.30, 2, 3.5, 4.8),
    "ecrot_street_like": (13, 0.18, 3, 3.0, 4.8),
    "ecrot_town_like": (14, 0.26, 4, 2.8, 4.8),
    "ecrot_bay_like": (15, 0.22, 5, 2.5, 4.8),
    "ecrot_playroom_like": (16, 0.35, 3, 3.0, 2.3),
    # ECD-like rows (their presets use 10 s windows; 4.8 s rendered at
    # matched texture character)
    "ecd_shapes_like": (17, 0.28, 8, 3.5, 4.8),
    "ecd_poster_like": (18, 0.24, 2, 3.8, 4.8),
    "ecd_boxes_like": (19, 0.24, 3, 3.2, 4.8),
    "ecd_dynamic_like": (20, 0.20, 4, 3.0, 4.8),
}

# The variants of a multi-start row, in the reference suite's order:
# (sample_mode, coarse_to_fine).
MULTI_START = (("curr", False), ("mid", False), ("curr", True), ("mid", True))

# The chunk of a streamed row, the reference suite's.
STREAM_CHUNK = 1 << 20


def _contaminated(ev, seed, contaminate):
    """``ev`` with ``contaminate`` of its count added as gross errors that
    pass the |dp| outlier gate: half polarity flips, half same-polarity
    burst duplicates of random events 0.01-1 ms later (the hot-pixel
    signature). The trajectory and ground truth are untouched."""
    crng = np.random.default_rng(seed + 1000)
    n_noise = int(contaminate * len(ev[0]))
    pol_c = np.array(ev[3], copy=True)
    idx_f = crng.choice(len(pol_c), size=n_noise // 2, replace=False)
    pol_c[idx_f] = 1 - pol_c[idx_f]
    n_b = n_noise - len(idx_f)
    idx_b = crng.integers(0, len(pol_c), size=n_b)
    bt = ev[0][idx_b] + crng.uniform(1e-5, 1e-3, size=n_b)
    order = np.argsort(np.concatenate([ev[0], bt]), kind="stable")
    return (
        np.concatenate([ev[0], bt])[order],
        np.concatenate([ev[1], ev[1][idx_b]])[order],
        np.concatenate([ev[2], ev[2][idx_b]])[order],
        np.concatenate([pol_c, np.ones(n_b, pol_c.dtype)])[order],
    )


def run_sequence(
    name: str,
    seed: int,
    motion: float,
    smooth: int,
    amp: float,
    duration: float,
    pano_height: int = 128,
    sensor: int = 48,
    sensor_h: int | None = None,
    perturb: float = 0.02,
    max_iter: int = 30,
    num_steps: int | None = None,
    c_th: float = 0.1,
    dtype=None,
    max_events: int = 4_000_000,
    stream_over: int = pipeline.CLASSIC_CAP_SMALL_ROWS,
    stream: bool | None = None,
    stream_light: bool = False,
    compact_cap: int | None = None,
    outlier_dp: float = 3.0,
    spline_order: int = 2,
    light_trial: bool = False,
    alpha: float = 0.5,
    sample_mode: str = "curr",
    coarse_to_fine: bool = False,
    irls: str | None = None,
    eta: float = 1.0,
    contaminate: float = 0.0,
    multi_start: bool = False,
    device=None,
) -> dict:
    """One suite row; the arguments are the reference's.

    ``outlier_dp``: pairing-displacement cut in pano pixels (scale it with
    the panorama). ``spline_order=4`` refits the ground truth as a cubic
    spline. ``light_trial``: cost-only LM trials. ``sample_mode``: LEGM map
    sampling point, "curr" (reference) or "mid". ``coarse_to_fine``: the
    pose pre-solved at a half-resolution panorama
    (:func:`pipeline.coarse_config`; skipped, with a log line, for an odd
    panorama). ``irls``: "huber" or "cauchy" with scale ``eta``.
    ``contaminate``: that fraction of gross-error events added.
    ``multi_start``: the four (sample_mode x coarse_to_fine) variants, the
    one with the lowest refined photometric error under the reference
    model (``sample_mode="curr"``) kept and reported as
    ``selected_variant``. ``lm_iterations``, ``wall_s`` and
    ``events_per_s`` cover every solve of the row: all variants and their
    coarse stages. ``stream_over``: the kept-event count above which the
    row streams (chunks of :data:`STREAM_CHUNK`, the window padded to a
    multiple); ``stream`` forces it on or off, and ``stream_light`` picks
    the LIGHT tier of a streamed row.
    ``device``: the first CUDA device by default; "cpu" runs on the CPU.
    ``dtype``: torch.float32 by default."""
    device = require_cuda() if device is None else torch.device(device)
    if device.type == "cuda":
        require_cuda()
    dtype = torch.float32 if dtype is None else dtype
    rng = np.random.default_rng(seed)
    cam = synth.default_sensor(sensor, sensor_h if sensor_h else sensor, f=sensor * 0.9)
    B = synth.smooth_random_map(pano_height, 2 * pano_height, rng, smooth, amp)
    scene = synth.generate(
        rng, cam, pano_width=2 * pano_height, pano_height=pano_height, c_th=c_th,
        t_end=duration, dt_knots=0.05,
        num_steps=num_steps if num_steps else int(600 * duration),
        motion_amp=motion, brightness=B,
    )
    cfg = model.ModelConfig(
        c_th=c_th, pano_width=2 * pano_height, pano_height=pano_height,
        thres_valid_pixel=3, alpha=alpha, outlier_dp_norm=outlier_dp,
        spline_order=spline_order, light_trial=light_trial, sample_mode=sample_mode,
        use_irls=irls is not None, cost_type=irls or "quadratic", eta=eta,
        compact_cap=compact_cap or None,
    )
    base_traj = scene.traj
    if spline_order != 2:
        # the ground truth refit as an order-`spline_order` spline
        tt_f = np.linspace(0.0, duration, max(int(duration * 400), 50))
        R_f = scene.traj.evaluate(tt_f).numpy()
        base_traj = spline.Trajectory.from_poses(tt_f, R_f, 0.0, duration, 0.05,
                                                 order=spline_order)
    # systematic subsampling to a memory budget (the reference's
    # event_sampling_rate; max_events=0 keeps every event)
    ev = (scene.t, scene.x, scene.y, scene.pol)
    if max_events and len(scene.t) > max_events:
        rate = int(np.ceil(len(scene.t) / max_events))
        ev = pipeline.systematic_subsample(*ev, rate)
    if contaminate:
        ev = _contaminated(ev, seed, contaminate)
    if stream if stream is not None else len(ev[0]) > stream_over:
        cfg = dataclasses.replace(cfg, stream_chunk=STREAM_CHUNK, stream_light=stream_light)

    # front-end-like perturbation: smooth random walk on the knots
    steps = rng.normal(size=(base_traj.num_knots, 3)) * perturb
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    traj0 = dataclasses.replace(base_traj, knots=spline._np_exp(walk) @ base_traj.knots)
    win = pairing.build_window(ev[0], ev[1], ev[2], ev[3], cam.width, traj0.locate, 100)
    dev = model.DeviceWindow.from_window(win, cam.bearing_lut(), cam.width, dtype, device,
                                         pad_multiple=cfg.stream_chunk or 1)
    tt = np.linspace(0.02 * duration, 0.98 * duration, 300)
    R_gt = scene.traj.evaluate(tt).numpy()

    def state(knots, gx, gy):
        return tuple(torch.as_tensor(np.asarray(a, np.float64)).to(device=device,
                                                                   dtype=dtype)
                     for a in (knots, gx, gy))

    lm = solver.LMConfig(max_num_iter=max_iter)
    lin0 = model.linearize(*state(traj0.knots, scene.gx, scene.gy), dev, cfg,
                           need_deriv=False)
    pe0 = metrics.photometric_error(lin0.e)
    del lin0

    runs = []  # LMStats of every solve of the row
    t0 = time.perf_counter()

    def solve_variant(sm: str, c2f: bool):
        """One BA solve with this sampling mode and coarse-to-fine choice:
        (knots, Gx, Gy, LMStats)."""
        vcfg = dataclasses.replace(cfg, sample_mode=sm)
        knots0 = traj0.knots
        if c2f:
            cfg_c = pipeline.coarse_config(vcfg)
            if cfg_c is None:
                print(f"# {name}: coarse presolve skipped: odd panorama "
                      f"{vcfg.pano_width}x{vcfg.pano_height}", file=sys.stderr)
            else:
                k_c, _, _, st_c = solver.solve_window(
                    *state(knots0, pipeline.pool2(scene.gx), pipeline.pool2(scene.gy)),
                    dev, cfg_c, lm, fix_first=True)
                runs.append(st_c)
                knots0 = k_c.detach().to("cpu", torch.float64).numpy()
        k, gx, gy, st = solver.solve_window(*state(knots0, scene.gx, scene.gy), dev,
                                            vcfg, lm, fix_first=True)
        runs.append(st)
        return k, gx, gy, st

    if multi_start:
        # the photometric error of each refined variant under one fixed
        # evaluation model (the reference's "curr" sampling) picks the
        # winner: no ground truth is read
        cfg_eval = dataclasses.replace(cfg, sample_mode="curr", light_trial=False)
        best = None
        for sm, c2f in MULTI_START:
            k, gx, gy, st = solve_variant(sm, c2f)
            lin = model.linearize(k, gx, gy, dev, cfg_eval, need_deriv=False)
            pe = metrics.photometric_error(lin.e)
            del lin
            if best is None or pe < best[0]:
                best = (pe, sm + ("+c2f" if c2f else ""), k, st)
        pe1, selected, knots, st = best
    else:
        knots, gx, gy, st = solve_variant(sample_mode, coarse_to_fine)
        lin1 = model.linearize(knots, gx, gy, dev, cfg, need_deriv=False)
        pe1 = metrics.photometric_error(lin1.e)
        del lin1
        selected = None
    wall = time.perf_counter() - t0
    every = pipeline._merged_stats(st, runs)
    trajR = dataclasses.replace(traj0, knots=knots.detach().to("cpu", torch.float64).numpy())

    out = dict(
        sequence=name,
        num_events=win.num_events,
        rmse_init_deg=metrics.trajectory_rmse_deg(traj0, tt, R_gt),
        rmse_refined_deg=metrics.trajectory_rmse_deg(trajR, tt, R_gt),
        photometric_init=pe0,
        photometric_refined=pe1,
        lm_iterations=sum(len(r.iterations) for r in runs),
        converged=st.converged,
        wall_s=wall,
        events_per_s=every.events_per_second()["total"],
    )
    if selected is not None:
        out["selected_variant"] = selected
    return out


def run_suite(out_path: str | None = None, sequences=None, **kw) -> list[dict]:
    """Every row of ``sequences`` (default :data:`SEQUENCES`) through
    :func:`run_sequence` with ``kw``; prints a line a row and writes the
    list of rows to ``out_path`` as JSON when given."""
    results = []
    for name, (seed, motion, smooth, amp, duration) in (sequences or SEQUENCES).items():
        res = run_sequence(name, seed, motion, smooth, amp, duration, **kw)
        results.append(res)
        print(
            f"{name}: rmse {res['rmse_init_deg']:.3f} -> "
            f"{res['rmse_refined_deg']:.3f} deg | photometric "
            f"{res['photometric_init']:.1f} -> {res['photometric_refined']:.1f} "
            f"| {res['lm_iterations']} iters, {res['wall_s']:.1f}s"
            + (f" | {res['selected_variant']}" if "selected_variant" in res else ""),
            flush=True,
        )
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


def run_ecrot_like(out_path: str | None = None, max_iter: int = 30, sequences=None,
                   **kw):
    """The reference-shaped suite: 240x180 sensor, 1024x512 panorama,
    4.8 s (``sequences``: a subset of :data:`ECROT_LIKE`, all by default).
    ``max_events=0`` keeps every event; ``max_iter=50`` is the reference's
    launch-file setting."""
    return run_suite(
        out_path, sequences=sequences or ECROT_LIKE, pano_height=512, sensor=240,
        sensor_h=180, c_th=0.2, perturb=0.005, max_iter=max_iter, num_steps=1500,
        **kw,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", help="results JSON (default suite_results.json, "
                    "or suite_ecrot_like.json with --ecrot)")
    ap.add_argument("--ecrot", action="store_true", help="the ECRot-shaped rows")
    ap.add_argument("--full", action="store_true", help="keep every event")
    ap.add_argument("--multi-start", action="store_true")
    ap.add_argument("--max-iter", type=int, help="LM iterations (default: the suite's)")
    ap.add_argument("--sequences", help="comma-separated subset of the rows")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    table = ECROT_LIKE if args.ecrot else SEQUENCES
    rows = table
    if args.sequences:
        rows = {k: table[k] for k in args.sequences.split(",")}
    kw = dict(device=args.device, multi_start=args.multi_start)
    if args.full:
        kw["max_events"] = 0
    if args.max_iter:
        kw["max_iter"] = args.max_iter
    if args.device == "cuda":
        require_cuda()
        print(card_name_and_power_limit(), flush=True)
    if args.ecrot:
        run_ecrot_like(args.out or "suite_ecrot_like.json", sequences=rows, **kw)
    else:
        run_suite(args.out or "suite_results.json", sequences=rows, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
