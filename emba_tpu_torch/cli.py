"""Command-line interface of the port (counterpart of ``emba_tpu/cli.py``,
which replaces the reference's ROS node + launch files).

Subcommands:
  run          full EMBA on a sequence (events + front-end trajectory [+ map])
  convert-bag  rosbag -> events.npz
  synth        generate a synthetic dataset (events + GT trajectory + maps)
  eval         rotation RMSE of a trajectory against ground truth
  suite        the synthetic accuracy suite (``eval_suite``)

``run`` and ``suite`` take ``--device {cuda,cpu}`` (default cuda): without
a CUDA device, ``--device cuda`` raises; the CPU runs only when asked for.
``run --num-devices N`` (N > 1) spawns N ranks (``dist.spawn``) over
``--dist-backend`` (nccl, the default: one GPU a rank; gloo: CPU ranks, or
several ranks on one GPU through the host); each rank runs the pipeline on
the same files and solves its shard of every window; rank 0 prints and
writes, and its result is the call's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _run_rank(comm, args):
    del comm  # the pipeline finds the rank's process group (dist.current)
    return _cmd_run(args)


def _cmd_run(args):
    from . import dist
    from . import config as C
    from . import io as eio
    from . import rosbag as rb
    from .camera import PinholeCamera, load_camera_yaml
    from .obs import nan_debug, profiler_trace
    from .pipeline import EmbaPipeline

    cfg = C.preset(args.preset) if args.preset else C.BAConfig()

    # Reference directory-layout mode (docs/execution.md in the reference;
    # emba.cpp:252-253,535-543 and pose_manager.cpp:47-51): given the three
    # root dirs + front-end name, derive all input paths.
    if args.dataset_root_dir or args.input_data_dir:
        if not args.preset:
            sys.exit("--dataset-root-dir/--input-data-dir require --preset")
        seq, ds = cfg.sequence, cfg.dataset
        ft = args.filename_raw_traj
        if args.dataset_root_dir and not args.events:
            args.events = f"{args.dataset_root_dir}/{ds}/{seq}/events.bag"
        if args.input_data_dir:
            if not args.poses:
                args.poses = (
                    f"{args.input_data_dir}/{ds}/{seq}/traj/interpolation/{ft}.txt"
                )
            map_dir = f"{args.input_data_dir}/{ds}/{seq}/map/frontend/{ft}/bin"
            if not args.map_gx and os.path.exists(f"{map_dir}/Gx.bin"):
                args.map_gx = f"{map_dir}/Gx.bin"
                args.map_gy = f"{map_dir}/Gy.bin"
    if not args.events or not args.poses:
        sys.exit("need --events and --poses (or the reference-layout dirs)")
    if (args.num_devices or 1) > 1 and dist.current() is None:
        return dist.spawn(_run_rank, args.num_devices, args.dist_backend, args=(args,),
                          timeout_s=None, device=args.device)[0]
    rank0 = dist.current() is None or dist.current().rank == 0  # logs and writes
    for k in (
        "start_time",
        "stop_time",
        "c_th",
        "alpha",
        "dt_knots",
        "max_num_iter",
        "event_sampling_rate",
        "pano_height",
        "dtype",
        "outlier_dp_norm",
        "sample_mode",
        "thres_valid_pixel",
        "compact_cap",
        "stream_chunk",
        "stream_light",
        "num_devices",
        "time_window_size",
        "sliding_window_stride",
        "super_res_height",
    ):
        v = getattr(args, k, None)
        if v is not None:
            setattr(cfg, k, v)
    if args.pano_height:
        cfg.pano_width = 2 * args.pano_height
    if args.use_cg:
        cfg.use_cg = True
    if args.coarse_to_fine:
        cfg.coarse_to_fine = True
    if args.multi_start:
        cfg.multi_start = True
    if args.irls:
        cfg.use_irls = True
        cfg.cost_type = args.irls
    if args.spline_order:
        cfg.spline_order = args.spline_order

    # --- events + camera ---------------------------------------------------
    cam_info = None
    if args.events.endswith(".bag"):
        (t, x, y, pol), cam_info = rb.parse_rosbag(
            args.events,
            args.events_topic,
            args.camera_info_topic,
            tmin=cfg.start_time + cfg.time_offset,
            tmax=cfg.stop_time + cfg.time_offset,
        )
    else:
        t, x, y, pol, _meta = eio.load_events_npz(args.events)

    if args.calib:
        camera = load_camera_yaml(args.calib)
    elif cam_info is not None:
        camera = PinholeCamera.from_calib(
            cam_info.width, cam_info.height, cam_info.K, cam_info.D, cam_info.R,
            cam_info.P,
        )
    else:
        sys.exit("need --calib YAML or a bag with camera_info")

    # --- front-end trajectory ----------------------------------------------
    times, rots = eio.load_tum_trajectory(args.poses, time_offset=cfg.time_offset)

    # Clamp the BA interval to the data actually available when the user did
    # not pin it explicitly (the reference requires start/stop in the launch
    # file, emba.cpp:76-80; defaults beyond the pose/event span would
    # otherwise fail spline fitting with an obscure "need >= 2 poses" error).
    span_end = float(min(times[-1], t[-1])) - cfg.time_offset
    span_start = float(max(times[0], t[0])) - cfg.time_offset
    if args.stop_time is None and cfg.stop_time > span_end:
        if rank0:
            print(f"# clamping stop_time {cfg.stop_time} -> {span_end:.4f} "
                  "(end of data)", file=sys.stderr)
        cfg.stop_time = span_end
    if args.start_time is None and cfg.start_time < span_start:
        if rank0:
            print(f"# clamping start_time {cfg.start_time} -> {span_start:.4f} "
                  "(start of data)", file=sys.stderr)
        cfg.start_time = span_start

    # --- initial map ---------------------------------------------------------
    gx = gy = None
    if args.map_gx and args.map_gy:
        gx, gy = eio.load_map_bin(args.map_gx, args.map_gy)
        cfg.init_map_available = True
    else:
        cfg.init_map_available = False

    pipe = EmbaPipeline(
        cfg,
        camera,
        (t, x, y, pol),
        times,
        rots,
        init_gx=gx,
        init_gy=gy,
        result_dir=args.out,
        record_data=args.out is not None,
        record_maps=args.record_maps,
        device=args.device,
    )
    with nan_debug(args.debug_nans), profiler_trace(args.profile_dir if rank0 else None,
                                                    pipe.device):
        res = pipe.run(resume_from=args.resume)
    if not rank0:
        return res
    eps = res.window_stats[-1].events_per_second() if res.window_stats else {}
    print(
        json.dumps(
            {
                "windows": len(res.window_stats),
                "num_knots": res.trajectory.num_knots,
                "events_per_second": eps,
                "result_dir": res.result_dir,
            }
        )
    )
    return res


def _cmd_convert_bag(args):
    from . import io as eio
    from . import rosbag as rb

    (t, x, y, pol), cam = rb.parse_rosbag(
        args.bag, args.events_topic, args.camera_info_topic
    )
    eio.save_events_npz(args.out, t, x, y, pol)
    print(f"wrote {len(t)} events -> {args.out}")
    if cam is not None and args.calib_out:
        eio.save_calib_yaml(args.calib_out, cam.width, cam.height, cam.K, D=cam.D,
                            R=cam.R, P=cam.P, distortion_model=cam.distortion_model)
        print(f"wrote calib -> {args.calib_out}")


def _cmd_synth(args):
    from . import io as eio
    from . import synth

    rng = np.random.default_rng(args.seed)
    sensor = synth.default_sensor(args.sensor, args.sensor, f=args.sensor * 0.9)
    # Sharp texture keeps inter-event displacements small — the regime the
    # LEGM linearization is accurate in.
    B = synth.smooth_random_map(
        args.pano_height, 2 * args.pano_height, rng, smooth=args.texture_smooth,
        amp=args.texture_amp,
    )
    scene = synth.generate(
        rng,
        sensor,
        pano_width=2 * args.pano_height,
        pano_height=args.pano_height,
        c_th=args.c_th,
        t_end=args.duration,
        dt_knots=0.05,
        num_steps=args.steps,
        motion_amp=args.motion,
        brightness=B,
    )
    os.makedirs(args.out, exist_ok=True)
    eio.save_events_npz(
        os.path.join(args.out, "events.npz"), scene.t, scene.x, scene.y, scene.pol
    )
    eio.save_map_bin(
        os.path.join(args.out, "Gx.bin"), os.path.join(args.out, "Gy.bin"),
        scene.gx, scene.gy,
    )
    tt = np.linspace(0.0, args.duration - 1e-6, 400)
    R = scene.traj.evaluate(tt).numpy()
    eio.save_tum_trajectory(os.path.join(args.out, "traj_gt.txt"), tt, R)
    eio.save_calib_yaml(os.path.join(args.out, "calib.yaml"), sensor.width,
                        sensor.height, sensor.K)
    print(f"wrote {len(scene.t)} events + GT to {args.out}")


def _cmd_eval(args):
    import torch

    from . import io as eio
    from . import lie, metrics

    t_est, r_est = eio.load_tum_trajectory(args.traj)
    t_gt, r_gt = eio.load_tum_trajectory(args.gt)
    # interpolate GT at estimate times (clipped to the GT span)
    m = (t_est >= t_gt[0]) & (t_est <= t_gt[-1])
    t_q = t_est[m]
    idx = np.clip(np.searchsorted(t_gt, t_q) - 1, 0, len(t_gt) - 2)
    a = (t_q - t_gt[idx]) / np.maximum(t_gt[idx + 1] - t_gt[idx], 1e-12)
    r_interp = lie.slerp(torch.from_numpy(r_gt[idx]), torch.from_numpy(r_gt[idx + 1]),
                         torch.from_numpy(a)).numpy()
    rmse = metrics.rotation_rmse_deg(r_est[m], r_interp, align=not args.no_align)
    out = {"rotation_rmse_deg": rmse, "num_poses": int(m.sum())}
    print(json.dumps(out))
    return out


def _cmd_suite(args):
    from .eval_suite import run_suite

    return run_suite(args.out, device=args.device)


def main(argv=None):
    """Parse ``argv`` (default: the command line) and run the subcommand.
    Called in process with an ``argv`` list, it returns what the subcommand
    returns (``run``: the ``pipeline.RunResult``; ``eval``: its JSON
    object; ``suite``: its rows); from the command line it returns None, so the exit status is
    0."""
    p = argparse.ArgumentParser(prog="emba-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run EMBA on a sequence")
    r.add_argument("--preset", help="sequence preset (e.g. bicycle, playroom)")
    r.add_argument("--events", help="events .npz or .bag")
    r.add_argument("--poses", help="front-end TUM trajectory txt")
    r.add_argument(
        "--dataset-root-dir", dest="dataset_root_dir",
        help="reference-layout dataset root (events at <root>/<ds>/<seq>/events.bag)",
    )
    r.add_argument(
        "--input-data-dir", dest="input_data_dir",
        help="reference-layout input root (traj/interpolation + map/frontend)",
    )
    r.add_argument(
        "--filename-raw-traj", dest="filename_raw_traj",
        default="cmaxw_traj_interp",
        help="front-end trajectory name in the reference layout",
    )
    r.add_argument("--map-gx")
    r.add_argument("--map-gy")
    r.add_argument("--calib", help="camera calibration YAML")
    r.add_argument("--events-topic", default="/dvs/events")
    r.add_argument("--camera-info-topic", default="/dvs/camera_info")
    r.add_argument("--out", help="result directory")
    r.add_argument("--record-maps", action="store_true")
    r.add_argument("--resume", help="checkpoint.npz to resume from")
    r.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the windows are solved (default cuda; raises "
                   "when there is no CUDA device)")
    r.add_argument("--start-time", dest="start_time", type=float)
    r.add_argument("--stop-time", dest="stop_time", type=float)
    r.add_argument("--c-th", dest="c_th", type=float)
    r.add_argument("--alpha", type=float)
    r.add_argument("--dt-knots", dest="dt_knots", type=float)
    r.add_argument("--max-num-iter", dest="max_num_iter", type=int)
    r.add_argument("--event-sampling-rate", dest="event_sampling_rate", type=int)
    r.add_argument("--pano-height", dest="pano_height", type=int)
    r.add_argument("--dtype", choices=["float32", "float64"])
    r.add_argument("--outlier-dp", dest="outlier_dp_norm", type=float)
    r.add_argument(
        "--sample-mode", dest="sample_mode", choices=["curr", "mid"],
        help="LEGM map sampling point: curr (reference) or mid "
        "(midpoint-rule quadrature, halves large-|dp| model error)",
    )
    r.add_argument(
        "--coarse-to-fine", action="store_true",
        help="half-resolution pose pre-solve per window",
    )
    r.add_argument(
        "--multi-start", action="store_true",
        help="solve each window with the four (sample mode x coarse-to-fine) "
        "variants and keep the one of lowest data cost",
    )
    r.add_argument("--thres-valid-pixel", dest="thres_valid_pixel", type=int)
    r.add_argument("--use-cg", action="store_true")
    r.add_argument(
        "--compact-cap", dest="compact_cap", type=int,
        help="active-pixel compaction cap (default: chosen by the pipeline "
        "for panoramas of 2M pixels or more)",
    )
    r.add_argument(
        "--stream-chunk", dest="stream_chunk", type=int,
        help="streamed forming chunk size in events (0 disables; default: "
        "2^21 for a window above the classic-window cap)",
    )
    r.add_argument(
        "--stream-light", dest="stream_light", type=int, choices=(0, 1),
        help="streaming tier: 0 = FULL (no event-sized array survives a pass; "
        "the default), 1 = LIGHT (resident residual fields, Jacobians "
        "recomputed)",
    )
    r.add_argument(
        "--num-devices", dest="num_devices", type=int,
        help="solve every window sharded over this many ranks, which this "
        "command spawns (one GPU each over nccl)",
    )
    r.add_argument(
        "--dist-backend", dest="dist_backend", choices=["nccl", "gloo"], default="nccl",
        help="collectives of a sharded run: nccl (one GPU a rank) or gloo (CPU ranks "
        "with --device cpu; on CUDA, tensors staged through the host, so several "
        "ranks can share one GPU)",
    )
    r.add_argument(
        "--time-window-size", dest="time_window_size", type=float,
        help="sliding-window length [s] (reference time_window_size; "
        "default: the whole BA span, as in the experiments)",
    )
    r.add_argument(
        "--sliding-window-stride", dest="sliding_window_stride", type=float,
        help="sliding-window stride [s] (reference sliding_window_stride)",
    )
    r.add_argument("--irls", choices=["huber", "cauchy"])
    r.add_argument("--spline-order", dest="spline_order", type=int, choices=[2, 4])
    r.add_argument(
        "--super-res-height", dest="super_res_height", type=int,
        help="after BA, solve a full-grid super-resolution map at this "
        "panorama height (width 2x) from the refined trajectory by the "
        "map-only step; saves Gx_sr/Gy_sr, HSV and Poisson PNGs and "
        "super_res.json (needs --out)",
    )
    r.add_argument(
        "--debug-nans", action="store_true",
        help="check each window's knots, maps and final cost for NaN/Inf and "
        "raise FloatingPointError naming the window",
    )
    r.add_argument(
        "--profile-dir",
        help="write a torch.profiler Chrome trace (trace.json) to this directory",
    )
    r.set_defaults(fn=_cmd_run)

    c = sub.add_parser("convert-bag", help="rosbag -> events.npz")
    c.add_argument("--bag", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--events-topic", default="/dvs/events")
    c.add_argument("--camera-info-topic", default="/dvs/camera_info")
    c.add_argument("--calib-out")
    c.set_defaults(fn=_cmd_convert_bag)

    s = sub.add_parser("synth", help="generate a synthetic dataset")
    s.add_argument("--out", required=True)
    s.add_argument("--sensor", type=int, default=64)
    s.add_argument("--pano-height", dest="pano_height", type=int, default=128)
    s.add_argument("--c-th", dest="c_th", type=float, default=0.1)
    s.add_argument("--duration", type=float, default=1.0)
    s.add_argument("--steps", type=int, default=600)
    s.add_argument("--motion", type=float, default=0.25)
    s.add_argument("--texture-smooth", dest="texture_smooth", type=int, default=3)
    s.add_argument("--texture-amp", dest="texture_amp", type=float, default=3.0)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=_cmd_synth)

    e = sub.add_parser("eval", help="rotation RMSE vs ground truth")
    e.add_argument("--traj", required=True)
    e.add_argument("--gt", required=True)
    e.add_argument("--no-align", action="store_true")
    e.set_defaults(fn=_cmd_eval)

    sv = sub.add_parser("suite", help="synthetic accuracy/throughput suite")
    sv.add_argument("--out", default="suite_results.json")
    sv.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the rows are solved (default cuda; raises when "
                    "there is no CUDA device)")
    sv.set_defaults(fn=_cmd_suite)

    args = p.parse_args(argv)
    out = args.fn(args)
    return out if argv is not None else None


if __name__ == "__main__":
    main()
