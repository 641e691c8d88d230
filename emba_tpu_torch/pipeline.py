"""Orchestration: data loading, the sliding-window loop, artifact outputs
(counterpart of ``emba_tpu/pipeline.py``, the reference's ``EMBA``
orchestrator ``src/emba/emba.cpp``):

* constructor duties (``emba.cpp:25-385``): event BA-interval cut and
  systematic subsampling, front-end poses, initial map (loaded or random)
  with a 3x3 median blur, the bearing LUT;
* ``run()`` (``emba.cpp:400-471``): the sliding-window loop — event subset,
  pose-subset spline fit, alignment of the new control poses to the
  trajectory's tail, the window's LM solve (fused on CUDA graphs, or the
  host-driven loop when recording; streamed above the classic-window cap),
  segment commit, window slide. The host
  preparation of window k+1 runs on a worker thread while window k solves;
  it is numpy only, so it makes no CUDA call while the main thread captures
  a window's CUDA graphs;
* the window's variants: a coarse-to-fine pose pre-solve at half the
  panorama's resolution, and multi-start (four variants, the one of lowest
  data cost kept); the automatic active-pixel compaction cap of large
  panoramas, retuned after each window from its active-pixel count;
* data recording (params.txt, iterations.txt, per-iteration map dumps,
  refined TUM trajectory, maps, runtime.json) and window-boundary and
  mid-window checkpoints with resume;
* the super-resolution map (``super_res_height``): after the run, the full
  grid at that height solved by the closed-form map-only step from the
  refined trajectory (:meth:`EmbaPipeline.solve_super_res_map`).

The device: ``EmbaPipeline(..., device=None)`` runs on this process's CUDA
device (``device.require_cuda``) and raises when there is none; only an
explicit ``device="cpu"`` runs on the CPU.

Sharded windows (``num_devices`` > 1): every rank of a process group
(``dist.init``, ``dist.spawn``; ``cli run --num-devices`` spawns its ranks)
runs the same pipeline on the same files, prepares the same windows and
keeps its shard of each (``dist.shard_window``); every solve (fused or
host, coarse stages, multi-start variants, the super-resolution map, the
compaction retune's count) runs sharded (``dist.Sharded``). Only rank 0
writes outputs, logs and checkpoints. A checkpoint does not depend on the
ranks: one taken at one world size resumes at another, or at one device.
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import convert, dist, kernels, lm as lm_mod, model, obs, pairing, recon, solver
from . import spline
from . import io as eio
from .camera import PinholeCamera
from .config import BAConfig
from .device import require_cuda

# The chunk of a window the pipeline streams by itself (above the
# classic-window cap), the reference's.
AUTO_STREAM_CHUNK = 1 << 21
# The chunk of the super-resolution map's passes unless stream_chunk is set.
SUPER_RES_CHUNK = 1 << 20
# The variants of a multi-start window, in the reference pipeline's order:
# (sample_mode, coarse_to_fine).
MULTI_START = (("curr", False), ("curr", True), ("mid", False), ("mid", True))


def median_blur_3x3(img: np.ndarray) -> np.ndarray:
    """3x3 median filter with replicated borders (reference
    ``emba.cpp:358-364`` uses cv::medianBlur on CV_32F)."""
    p = np.pad(img.astype(np.float32), 1, mode="edge")
    stack = np.stack(
        [p[i : i + img.shape[0], j : j + img.shape[1]] for i in range(3) for j in range(3)]
    )
    return np.median(stack, axis=0).astype(np.float64)


def auto_compact_cap(hw: int, num_events: int, thres_valid_pixel: int):
    """The compaction cap the pipeline turns on by itself for large
    panoramas: a pixel needs ``thres_valid_pixel`` events to be active, so
    actives <= num_events / thres, rounded up to a power of two (few
    distinct shapes, so few graph captures). None when compaction would
    not shrink the solve domain (panoramas below 2M pixels, dense
    coverage)."""
    bound = num_events // max(1, thres_valid_pixel) + 1
    cap = 1 << max(12, int(np.ceil(np.log2(bound))))
    if hw >= 2 * 1024 * 1024 and cap < hw // 2:
        return cap
    return None


def retune_compact_cap(observed_active: int, hw: int) -> int:
    """The cap for the next window from the active pixels observed in the
    window just solved: next_pow2(2 * observed), floored at 4096 and
    clamped to next_pow2(hw). The power-of-two grid and the 2x headroom
    give hysteresis: the cap changes only when the observed count leaves
    (cap/4, cap/2] of the current cap."""
    desired = 1 << max(12, int(np.ceil(np.log2(max(1, 2 * observed_active)))))
    return min(desired, 1 << int(np.ceil(np.log2(hw))))


def count_active_pixels(knots, gx, gy, dev, mcfg, placement) -> int:
    """Active pixels of a solved window: pano pixels with at least
    ``thres_valid_pixel`` inlier events at its state, on the window's
    device; the one host read of the count. The map comes from the light
    linearization, or for a streamed window from the FULL tier's chunked
    objective, which holds nothing event-sized (``placement``: over every
    rank's events when sharded)."""
    nem = placement.cost_and_activity(knots, gx, gy, dev, mcfg)[1]
    return int(torch.sum((nem >= mcfg.thres_valid_pixel).to(torch.int32)))


def data_cost_at(knots, gx, gy, dev, mcfg, placement) -> float:
    """The data cost of a state (a streamed window's by the chunked
    objective); one host read."""
    return float(placement.cost_and_activity(knots, gx, gy, dev, mcfg)[0])


def coarse_config(mcfg: model.ModelConfig):
    """The model of a coarse-to-fine pre-solve: the panorama at half
    resolution (|dp| in pixels halves, the LEGM linearization's error
    axis), the outlier cut halved (at least 1.5 px), no compaction. None
    for a panorama of odd size, which has no 2x2 pooling: the caller skips
    the coarse stage and logs it."""
    if mcfg.pano_height % 2 or mcfg.pano_width % 2:
        return None
    return dataclasses.replace(
        mcfg, pano_width=mcfg.pano_width // 2, pano_height=mcfg.pano_height // 2,
        outlier_dp_norm=max(0.5 * mcfg.outlier_dp_norm, 1.5), compact_cap=None)


def pool2(g) -> np.ndarray:
    """A gradient map at half resolution: 2x the mean of each 2x2 block (a
    big pixel's gradient is twice the small pixels' mean)."""
    g = np.asarray(g)
    h, w = g.shape
    return 2.0 * g.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))


# Largest window (events) the classic path takes: 80% of the card's 80 GB
# over the peak device bytes per event of a fused window, rounded down to a
# million. Measured by chip_smoke.py's pipeline phase on an NVIDIA H100
# 80GB HBM3 at a 700 W power limit: the 1024x512 whole-span window of
# 3,671,400 events and 93 knots peaked at 2,102 bytes an event reserved
# (1,507 allocated), so 0.8 * 80e9 / 2102 = 30.4M. The map-sized buffers
# are counted per event there, which errs low: near the cap, a window of
# 29,371,700 events (probes/suite_run.py, same card) peaked at 25.0 GB
# reserved fused and 20.4 GB recording (852 and 694 bytes an event).
# Row spaces above 2^20 (a compacted 4K panorama): the 4096x2048 window of
# 4,000,000 events compacted to 2^21 rows (chip_smoke.py phase 12c, same
# card) peaked at 29.96 GB reserved through the host loop (25.52 GB
# fused), 7,490 bytes an event: 0.8 * 80e9 / 7490 = 8.5M. Above the cap
# the window streams (AUTO_STREAM_CHUNK), as the reference's does.
CLASSIC_CAP_SMALL_ROWS = 30_000_000
CLASSIC_CAP_LARGE_ROWS = 8_000_000
ROWS_SMALL = 1 << 20
# The largest row space a joint window runs at: a limit of the card's
# memory, not of the events. Fitted to the two windows near 25-30 GB above
# (2^19 rows and 29.4M events, 2^21 rows and 4M), a window takes about
# 13 KB a row (A12 and its Schur products, at ~95 knots) and 600 bytes an
# event; an uncompacted 4K panorama (2^23 rows, which auto_compact_cap
# leaves uncompacted from ~6.3M events on) would need over 100 GB for its
# A12 alone, however few its events. Streaming does not shrink it: every
# chunk adds into the same A12. So a row space above this raises, and the
# per-window retune stays under it; a full 4K grid is solved by the
# map-only step instead (``super_res_height``), which holds no A12.
ROWS_LARGE = 1 << 21


def plan_model_config(
    mcfg: model.ModelConfig,
    cfg: BAConfig,
    t: np.ndarray,
    t_ba_beg: float,
    t_ba_end: float,
    win_size: float,
    win_stride: float,
    n_dev: int,
    classic_cap_small: int = CLASSIC_CAP_SMALL_ROWS,
    classic_cap_large: int = CLASSIC_CAP_LARGE_ROWS,
):
    """The reference's pre-run decisions (``emba_tpu/pipeline.py:100-157``):
    first the compaction cap, which the pipeline picks by itself for a
    panorama of 2M pixels or more (:func:`auto_compact_cap`), then the
    classic-window cap of the row space after compaction: a window above
    it streams in chunks of :data:`AUTO_STREAM_CHUNK` events unless
    ``cfg.stream_chunk`` was set (0 keeps it classic). The FULL tier is the
    default; ``cfg.stream_light`` chooses the tier when it is set. A row
    space above :data:`ROWS_LARGE` raises: streaming does not shrink A12.

    The largest-window count is exact: events are time-sorted, so each
    window's count is two searchsorteds, and only window starts whose
    window runs (the loop requires t_win_end < t_ba_end + 1e-3) enter it.

    Returns ``(mcfg, auto_cap)``: ``auto_cap`` is True when the cap was
    chosen here, and the run then retunes it after each window."""
    auto_cap = mcfg.compact_cap is None
    if auto_cap:
        cap = auto_compact_cap(
            mcfg.pano_width * mcfg.pano_height, len(t), mcfg.thres_valid_pixel
        )
        if cap is not None:
            mcfg = dataclasses.replace(mcfg, compact_cap=cap)
    auto_cap = auto_cap and mcfg.compact_cap is not None

    edges_beg = np.arange(t_ba_beg, t_ba_end, win_stride)
    edges_beg = edges_beg[edges_beg + win_size < t_ba_end + 1e-3]
    max_win_events = int(
        np.max(
            np.searchsorted(t, edges_beg + win_size + 1e-3)
            - np.searchsorted(t, edges_beg - 1e-3)
        )
    ) if len(edges_beg) else len(t)
    per_dev = max_win_events / max(1, n_dev)
    rows = mcfg.compact_cap or (mcfg.pano_width * mcfg.pano_height)
    if rows > ROWS_LARGE:
        raise NotImplementedError(
            f"a row space of {rows} rows is above pipeline.ROWS_LARGE = {ROWS_LARGE}: "
            f"its A12 alone would not fit the card's memory, and streamed forming "
            f"adds every chunk into the same A12, so it does not shrink it. Set a "
            f"compact_cap of at most {ROWS_LARGE}, or solve the full grid with the "
            f"map-only step (super_res_height, cli --super-res-height)")
    classic_cap = classic_cap_small if rows <= ROWS_SMALL else classic_cap_large
    if cfg.stream_chunk is None and per_dev > classic_cap:
        mcfg = dataclasses.replace(mcfg, stream_chunk=AUTO_STREAM_CHUNK)
    if mcfg.stream_chunk is not None and cfg.stream_light is not None:
        mcfg = dataclasses.replace(mcfg, stream_light=bool(cfg.stream_light))
    return mcfg, auto_cap


def systematic_subsample(t, x, y, pol, rate: int):
    """Keep every ``rate``-th event (reference ``emba.cpp:282-304``)."""
    if rate < 2:
        return t, x, y, pol
    idx = np.arange(rate - 1, len(t), rate)
    return t[idx], x[idx], y[idx], pol[idx]


@dataclasses.dataclass
class RunResult:
    trajectory: spline.Trajectory
    gx: np.ndarray
    gy: np.ndarray
    window_stats: list
    result_dir: str | None = None
    # the model configuration of the last window as the run planned it
    # (compaction cap, streaming chunk and tier)
    model_config: model.ModelConfig | None = None


@dataclasses.dataclass
class _PreparedWindow:
    """Host-side window preparation product (see ``_prepare_window``)."""

    new_cps: np.ndarray  # fitted control poses for this window (pre-alignment)
    win: pairing.EventWindow  # the window's events and batches (paired on the device)
    seg_num_knots: int  # predicted knot count of the window segment
    pushed: int  # knots this window's pushback would add


def _host(a) -> np.ndarray:
    """A tensor (any device) or array -> f64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def _merged_stats(selected, runs):
    """``selected``'s LMStats with the counts and seconds of every run of
    its window (coarse stages and multi-start variants), so that events/s
    and the wall cover all of them and ``count_form`` equals the A12
    launches; the iteration records and per-form lists stay the selected
    run's."""
    if len(runs) == 1:
        return selected
    out = dataclasses.replace(selected)
    for name in ("time_form_s", "time_solve_s", "time_objective_s", "time_total_s",
                 "setup_s", "count_form", "count_solve", "count_objective"):
        setattr(out, name, sum(getattr(st, name) for st in runs))
    return out


class EmbaPipeline:
    """End-to-end EMBA run over an event stream."""

    def __init__(
        self,
        cfg: BAConfig,
        camera: PinholeCamera,
        events: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
        pose_times: np.ndarray,
        pose_rotations: np.ndarray,
        init_gx: np.ndarray | None = None,
        init_gy: np.ndarray | None = None,
        result_dir: str | None = None,
        record_data: bool = False,
        record_maps: bool = False,
        seed: int = 0,
        device=None,
    ):
        self.record = obs.Record()
        self._launches0 = kernels.launch_counts()
        with obs.recording(self.record), obs.span("pipeline.init"):
            device = torch.device("cuda" if device is None else device)
            if device.type == "cuda" and device.index is None:
                device = require_cuda()
            elif device.type == "cuda":
                require_cuda()
            self.device = device
            self.cfg = cfg
            self.camera = camera
            # a sharded run: this process's rank of a process group of
            # num_devices ranks, on this pipeline's device
            self.comm = None
            self.placement = solver.LOCAL
            if (cfg.num_devices or 1) > 1:
                self.comm = dist.current()
                if self.comm is None or self.comm.world != cfg.num_devices:
                    raise RuntimeError(
                        f"BAConfig.num_devices={cfg.num_devices} needs a process group of "
                        f"as many ranks (dist.init, dist.spawn, cli run --num-devices); "
                        f"this process has "
                        f"{'none' if self.comm is None else self.comm.world}")
                if self.comm.device != device:
                    raise ValueError(f"the rank works on {self.comm.device}, the "
                                     f"pipeline on {device}")
                self.placement = dist.Sharded(self.comm, camera.width * camera.height)
            # only rank 0 writes; every rank runs the same loops
            self._writer = self.comm is None or self.comm.rank == 0
            self.record_data = record_data and result_dir is not None
            self.record_maps = record_maps
            self.result_dir = result_dir
            self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32

            with obs.span("init.sort_cut"):
                t, x, y, pol = events
                order = np.argsort(t, kind="stable")
                t, x, y, pol = t[order], x[order], y[order], pol[order]
                # BA interval cut (+ time offset already applied upstream)
                t0 = cfg.start_time + cfg.time_offset
                t1 = cfg.stop_time + cfg.time_offset
                m = (t >= t0 + 1e-6) & (t <= t1)
                t, x, y, pol = t[m], x[m], y[m], pol[m]
                self.t, self.x, self.y, self.pol = systematic_subsample(
                    t, x, y, pol, cfg.event_sampling_rate
                )

            self.pose_times = np.asarray(pose_times, np.float64)
            self.pose_rotations = np.asarray(pose_rotations, np.float64)

            # Initial map (reference emba.cpp:333-364).
            H, W = cfg.pano_height, cfg.pano_width
            if init_gx is None:
                rng = np.random.default_rng(seed)
                if cfg.use_cg:
                    init_gx = np.zeros((H, W))
                    init_gy = np.zeros((H, W))
                else:
                    init_gx = rng.normal(0.0, 0.1 * cfg.c_th, size=(H, W))
                    init_gy = rng.normal(0.0, 0.1 * cfg.c_th, size=(H, W))
            else:
                H, W = init_gx.shape
                cfg.pano_height, cfg.pano_width = H, W
            with obs.span("init.map_filter"):
                self.gx = median_blur_3x3(np.asarray(init_gx))
                self.gy = median_blur_3x3(np.asarray(init_gy))

            with obs.span("init.bearing_lut"):
                self.bearing_lut = camera.bearing_lut()

            # Sliding-window state (reference emba.cpp:309-331).
            self.t_ba_beg = t0
            self.t_ba_end = t1
            self.win_size = cfg.window_size
            self.win_stride = cfg.sliding_window_stride
            self.cp_stride = int(round(cfg.sliding_window_stride / cfg.dt_knots))
            self.traj = spline.Trajectory.empty(t0, cfg.dt_knots, cfg.spline_order)
            self._resume_lm = None

            if self.record_data and self._writer:
                eio.ensure_dir(result_dir)
                eio.ensure_dir(os.path.join(result_dir, "final_results"))
                for d in ("Gx_evo", "Gy_evo", "G_hsv_evo", "map_poisson_evo",
                          "map_opt"):
                    eio.ensure_dir(os.path.join(result_dir, d))
                self._write_params()
                self._iter_log = open(
                    os.path.join(result_dir, "final_results", "iterations.txt"), "w"
                )
            else:
                self._iter_log = None

    # -- recording ----------------------------------------------------------

    def _write_params(self):
        cfg = self.cfg
        with open(os.path.join(self.result_dir, "params.txt"), "w") as f:
            for k, v in dataclasses.asdict(cfg).items():
                f.write(f"{k} = {v}\n")

    def _brightness(self, gx, gy) -> np.ndarray:
        """Poisson brightness of a map pair, solved on the pipeline's device."""
        g = [torch.as_tensor(a).to(self.device, self.dtype) for a in (gx, gy)]
        return _host(recon.reconstruct_from_gradient(*g))

    def _save_maps(self, tag: str, win_id: int, it: int, gx=None, gy=None):
        if not (self.record_data and self.record_maps and self._writer):
            return
        gx = _host(self.gx if gx is None else gx)
        gy = _host(self.gy if gy is None else gy)
        base = os.path.join(self.result_dir, tag)
        pre = f"win_{win_id:04d}_"
        eio.save_png(os.path.join(base, f"{pre}Gx_{it:04d}.png"), gx)
        eio.save_png(os.path.join(base, f"{pre}Gy_{it:04d}.png"), gy)
        hsv = eio.gradient_hsv_image(gx, gy)
        eio.save_png(os.path.join(base, f"{pre}G_hsv_{it:04d}.png"), hsv)
        eio.save_png(os.path.join(base, f"{pre}poisson_{it:04d}.png"),
                     self._brightness(gx, gy))

    def _save_evo(self, win_id: int, it: int, gx, gy):
        """Per-LM-iteration evolution dumps (reference ``saveEvoData``,
        solver.cpp:370-425): the evolving Gx/Gy/HSV images plus the Poisson
        brightness snapshot, one file set per iteration."""
        if not (self.record_data and self.record_maps and self._writer):
            return
        gx, gy = _host(gx), _host(gy)
        pre = f"win_{win_id:04d}_"
        for d, img in (("Gx_evo", gx), ("Gy_evo", gy),
                       ("G_hsv_evo", eio.gradient_hsv_image(gx, gy)),
                       ("map_poisson_evo", self._brightness(gx, gy))):
            eio.save_png(os.path.join(self.result_dir, d, f"{pre}{it:04d}.png"), img)

    # -- checkpointing (new vs reference) ------------------------------------

    def save_checkpoint(self, path: str, window_idx: int,
                        lm_state: dict | None = None):
        """Persist the BA state, with the keys of the reference's
        checkpoint (either package resumes from the other's).
        Window-boundary checkpoints carry the committed trajectory + maps +
        the NEXT window index. Mid-window checkpoints (``lm_state`` from
        :func:`solver.lm_state_dict`) also carry the in-flight LM state —
        current seg knots, LM maps, lambda, iteration, cost_min, tol counter
        — so an interrupted window resumes bit for bit. The write is atomic
        (tmp + rename): a kill mid-write never corrupts the previous
        checkpoint."""
        payload = dict(
            knots=self.traj.knots,
            t_beg=self.traj.t_beg,
            dt=self.traj.dt,
            order=self.traj.order,
            gx=np.asarray(self.gx),
            gy=np.asarray(self.gy),
            window_idx=window_idx,
        )
        if lm_state is not None:
            payload.update(
                mid_window=True,
                lm_knots=lm_state["knots"],
                lm_gx=lm_state["gx"],
                lm_gy=lm_state["gy"],
                lm_lam=lm_state["lam"],
                lm_cost_min=lm_state["cost_min"],
                lm_count_tol_sat=lm_state["count_tol_sat"],
                lm_it=lm_state["it"],
                lm_cost_decreased=lm_state["cost_decreased"],
            )
        tmp = path + ".tmp.npz"  # np.savez appends .npz to bare names
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> int:
        z = np.load(path)
        self.traj = spline.Trajectory(
            t_beg=float(z["t_beg"]),
            dt=float(z["dt"]),
            knots=z["knots"],
            order=int(z["order"]),
        )
        self.gx, self.gy = z["gx"], z["gy"]
        if "mid_window" in z and bool(z["mid_window"]):
            # in-flight LM state: run() resumes INSIDE this window
            self._resume_lm = dict(
                knots=z["lm_knots"],
                gx=z["lm_gx"],
                gy=z["lm_gy"],
                lam=float(z["lm_lam"]),
                cost_min=float(z["lm_cost_min"]),
                count_tol_sat=int(z["lm_count_tol_sat"]),
                it=int(z["lm_it"]),
                cost_decreased=bool(z["lm_cost_decreased"]),
            )
        else:
            self._resume_lm = None
        return int(z["window_idx"])

    # -- window preparation (host-side, prefetchable) -----------------------

    def _prepare_window(
        self,
        count_window: int,
        first_window: bool,
        t_win_beg: float,
        t_win_end: float,
        t_pose_beg: float,
        t_pose_end: float,
        base_num_knots: int,
        already_pushed: bool = False,
    ) -> _PreparedWindow:
        """All host-side work for one window that does NOT depend on any
        earlier window's solution: event-subset extraction (reference
        ``getEventSubset``, emba.cpp:473-510), front-end pose-subset spline
        fitting (emba.cpp:412-417), and the event batching
        (``pairing.build_window``; the events are paired on the device, in
        the upload). Numpy only: it runs on the worker thread
        while the previous window solves, and must make no CUDA call (a
        CUDA call from another thread breaks a CUDA-graph capture). Its spans
        (``window.prepare`` and its stages) are kept in the run's record
        only: a span off the run's thread opens no profiler range.

        ``base_num_knots``: trajectory knot count before this window's
        pushback (exact at submission time — the prefetch is submitted after
        the current window's pushback). ``already_pushed``: the window's
        pushback is already in the trajectory (mid-window checkpoint
        resume), so the segment knot count is ``base - idx_cp_beg``.
        """
        cfg = self.cfg
        with obs.span("window.prepare"):
            with obs.span("prepare.cut"):
                lo = np.searchsorted(self.t, t_win_beg + 1e-3, side="right")
                hi = np.searchsorted(self.t, t_win_end - 1e-3, side="right")
                ev = (self.t[lo:hi], self.x[lo:hi], self.y[lo:hi], self.pol[lo:hi])

            with obs.span("prepare.pose_fit"):
                pm = (self.pose_times > t_pose_beg) & (self.pose_times < t_pose_end)
                new_cps = spline.fit_knots_long(
                    self.pose_times[pm],
                    self.pose_rotations[pm],
                    t_pose_beg,
                    t_pose_end,
                    cfg.dt_knots,
                    cfg.spline_order,
                )
            pushed = len(new_cps) if first_window else len(new_cps) - 1
            idx_cp_beg = count_window * self.cp_stride
            seg_num_knots = (
                base_num_knots + (0 if already_pushed else pushed) - idx_cp_beg
            )
            seg_t_beg = self.t_ba_beg + idx_cp_beg * cfg.dt_knots

            def loc(tq):
                return spline.locate(
                    tq, seg_t_beg, cfg.dt_knots, seg_num_knots, cfg.spline_order
                )

            with obs.span("prepare.batches"):
                win = pairing.build_window(
                    ev[0], ev[1], ev[2], ev[3], self.camera.width, loc,
                    cfg.event_batch_size,
                )
        return _PreparedWindow(
            new_cps=new_cps,
            win=win,
            seg_num_knots=seg_num_knots,
            pushed=pushed,
        )

    @staticmethod
    def _stats_from_trace(num_events, n_it, conv, trace, total_s, loop):
        """LMStats for a fused window from its per-iteration trace
        (lm.TRACE_COLS) and its ``lm.LoopStats``. ``count_form`` is every
        forming pass the call ran (``loop.form_passes``: on the card the
        capturing call's eager warm-up pass too), so it equals the A12
        kernel's launches; the per-form lists hold the loop's own passes.
        Only the total wall time is measured (one device program: phase
        times stay 0)."""
        n_it = int(n_it)
        tr = trace.detach().to("cpu", torch.float64).numpy()
        stats = solver.LMStats(num_events=num_events)
        stats.converged = bool(conv)
        stats.count_objective = n_it
        stats.count_solve = n_it
        stats.iterations = lm_mod.trace_records(tr, n_it)
        stats.active_px_per_form, stats.dropped_meas_per_form = (
            lm_mod.forming_stats_from_trace(tr, n_it)
        )
        stats.count_form = loop.form_passes
        stats.setup_s = loop.setup_s
        stats.time_total_s = total_s
        return stats

    # -- the sliding-window loop (reference Run(), emba.cpp:400-471) --------

    def run(self, resume_from: str | None = None) -> RunResult:
        """Run the sliding-window loop (from the checkpoint ``resume_from``,
        if given). The run record (``self.record``, then ``obs.runs()``)
        ends here, with the kernel launches of the run among its counters;
        a second run of this pipeline opens a record of its own."""
        if self.record.end_ns is not None:
            self.record = obs.Record()
            self._launches0 = kernels.launch_counts()
        try:
            with obs.recording(self.record), obs.span("pipeline.run"):
                return self._run(resume_from)
        finally:
            for name, n in kernels.launch_counts().items():
                self.record.count(f"launches.{name}", n - self._launches0[name])
            self.record.finish()

    def _run(self, resume_from):
        cfg = self.cfg
        n_dev = self.comm.world if self.comm is not None else 1
        mcfg, auto_cap = plan_model_config(
            cfg.model_config(), cfg, self.t, self.t_ba_beg, self.t_ba_end,
            self.win_size, self.win_stride, n_dev,
        )
        lm = cfg.lm_config()

        t_win_beg = self.t_ba_beg
        t_win_end = t_win_beg + self.win_size
        t_pose_beg, t_pose_end = t_win_beg, t_win_end
        first_window = True
        count_window = 0
        pose_latest = None
        window_stats = []

        resume_lm = None
        if resume_from:
            count_window = self.load_checkpoint(resume_from)
            # mid-window checkpoint: count_window is the IN-FLIGHT window;
            # its pushback/alignment are already in the restored trajectory
            # and the LM resumes from the stored schedule state
            resume_lm = self._resume_lm
            first_window = count_window == 0
            t_win_beg += count_window * self.win_stride
            t_win_end += count_window * self.win_stride
            t_pose_beg = t_win_end - self.win_stride if count_window else t_win_beg
            t_pose_end = t_win_end
            if not first_window:
                tq = t_win_end - self.win_stride - 1e-6
                pose_latest = (tq, np.asarray(self.traj.evaluate(tq))[0])

        # Window pipelining: the host-side preparation of window k+1 (event
        # subset, pose-subset spline fit, event batches — none of which read
        # window k's solution) runs on a worker thread overlapped with
        # window k's solve. Single worker => preparations stay ordered. It
        # runs in a copy of this context, so its spans join the run's record.
        executor = ThreadPoolExecutor(max_workers=1)
        next_fut = executor.submit(
            contextvars.copy_context().run, self._prepare_window, count_window,
            first_window, t_win_beg, t_win_end, t_pose_beg, t_pose_end,
            self.traj.num_knots, resume_lm is not None,
        )
        try:
            while t_win_end < self.t_ba_end + 1e-3:
                with obs.span("window.prep_wait"):
                    prep = next_fut.result()
                obs.count("windows")
                obs.count("window.events", prep.win.num_events)

                new_cps = prep.new_cps
                if resume_lm is None:
                    if not first_window:
                        # align to the tail of the current trajectory
                        # (emba.cpp:420-428)
                        R0_inv = new_cps[0].T
                        new_cps = np.einsum(
                            "ij,jk,nkl->nil", pose_latest[1], R0_inv, new_cps
                        )
                        new_cps = new_cps[1:]  # drop the shared first knot
                    self.traj.pushback(new_cps)
                # else: mid-window resume — the checkpointed trajectory
                # already contains this window's aligned pushback

                idx_cp_beg = count_window * self.cp_stride
                seg = self.traj.segment(idx_cp_beg, self.traj.num_knots)
                if seg.num_knots != prep.seg_num_knots:
                    raise RuntimeError(
                        f"window {count_window}: segment has {seg.num_knots} knots, "
                        f"its preparation {prep.seg_num_knots}")

                # Prefetch the NEXT window's preparation before solving this
                # one (the knot base count is exact now that pushback has
                # happened).
                nt_win_beg = t_win_beg + self.win_stride
                nt_win_end = t_win_end + self.win_stride
                if nt_win_end < self.t_ba_end + 1e-3:
                    next_fut = executor.submit(
                        contextvars.copy_context().run, self._prepare_window,
                        count_window + 1, False, nt_win_beg, nt_win_end, t_win_end,
                        nt_win_end, self.traj.num_knots,
                    )

                # The window's upload and its pairing on the device, on this
                # thread.
                win = prep.win
                with obs.span("window.upload"):
                    # a streamed window is padded to a chunk multiple: its
                    # last chunk is full, and its chunk count follows from
                    # its shape (a sharded one to a multiple of the ranks,
                    # as the reference's)
                    dev = model.DeviceWindow.from_window(
                        win, self.bearing_lut, self.camera.width, self.dtype, self.device,
                        pad_multiple=(mcfg.stream_chunk or 1) if self.comm is None else 1)
                    dev = self.placement.shard(dev)
                win_id = count_window
                with obs.span("window.solve"):
                    if cfg.multi_start and resume_lm is None:
                        knots, gx_j, gy_j, stats, final_cost = self._solve_multi_start(
                            win_id, win.num_events, seg.knots, dev, mcfg, lm,
                            first_window)
                    else:
                        knots0 = seg.knots
                        coarse = []
                        if cfg.coarse_to_fine and resume_lm is None:
                            # skipped on a mid-window resume: the resumed
                            # knots are past the coarse regime already
                            knots0 = self._coarse_presolve(win_id, win.num_events,
                                                           knots0, dev, mcfg, lm,
                                                           first_window, coarse)
                        knots, gx_j, gy_j, stats, final_cost = self._solve(
                            win_id, win.num_events, knots0, dev, mcfg, lm, first_window,
                            resume_lm)
                        stats = _merged_stats(stats, coarse + [stats])
                # the window's LM iterations as its LMStats gives them
                obs.count("lm.steps", len(stats.iterations))
                resume_lm = None  # consumed by the resumed window
                with obs.span("window.result"):
                    if obs.nan_checks_enabled():
                        obs.check_finite(f"window {win_id}", knots=knots, gx=gx_j,
                                         gy=gy_j, cost=final_cost)
                    if auto_cap:
                        mcfg = self._retune(stats, knots, gx_j, gy_j, dev, mcfg)
                    self.gx, self.gy = _host(gx_j), _host(gy_j)
                    seg = dataclasses.replace(seg, knots=_host(knots))
                    self.traj.replace_with(seg, seg.num_knots, 0, idx_cp_beg)
                    window_stats.append(stats)
                    self._save_maps("map_opt", win_id, len(stats.iterations))

                    # Latest pose for the next window's alignment
                    # (emba.cpp:458-460).
                    tq = t_win_end - 1e-6
                    pose_latest = (tq, np.asarray(self.traj.evaluate(tq))[0])

                # Slide (emba.cpp:512-532).
                t_win_beg += self.win_stride
                t_pose_beg = t_win_end
                t_win_end += self.win_stride
                t_pose_end = t_win_end
                count_window += 1
                first_window = False

                if self.record_data and self._writer:
                    with obs.span("pipeline.write"):
                        self.save_checkpoint(
                            os.path.join(self.result_dir, "final_results",
                                         "checkpoint.npz"),
                            count_window,
                        )
        finally:
            executor.shutdown(wait=True, cancel_futures=True)

        super_res = (self.solve_super_res_map(cfg.super_res_height)
                     if self.record_data and cfg.super_res_height else None)
        if self.record_data and self._writer:
            with obs.span("pipeline.write"):
                self.traj.write_tum(
                    os.path.join(
                        self.result_dir, "final_results", "trajectory_refined.txt"
                    ),
                    time_offset=cfg.time_offset,
                )
                eio.save_map_bin(
                    os.path.join(self.result_dir, "final_results", "Gx.bin"),
                    os.path.join(self.result_dir, "final_results", "Gy.bin"),
                    self.gx,
                    self.gy,
                )
                if super_res is not None:
                    self._write_super_res(cfg.super_res_height, *super_res)
                self._write_runtime(window_stats)
                self._iter_log.close()

        return RunResult(
            trajectory=self.traj,
            gx=self.gx,
            gy=self.gy,
            window_stats=window_stats,
            result_dir=self.result_dir,
            model_config=mcfg,
        )

    def solve_super_res_map(self, height: int, width: int | None = None,
                            num_iters: int | None = None):
        """The super-resolution map: the full pixel grid at ``height``
        (width ``2 * height`` unless given) solved from the refined
        trajectory over every event in its time support, by the closed-form
        map-only step (:func:`model.solve_map_only`): with the pose fixed
        the residual is affine in the map, so one per-pixel 2x2 solve is
        the exact minimizer of the regularized quadratic cost, with no A11
        or A12 and no compaction at any resolution. The outlier cut scales
        with the resolution (it is in panorama pixels). The events stream
        in chunks of ``stream_chunk`` (:data:`SUPER_RES_CHUNK` unless set)
        on the pipeline's device, over the ranks' shards in a sharded run
        (the placement's ``solve_map_only``). ``num_iters`` defaults to 3
        with IRLS (weight refreshes), else 1. Returns (gx, gy, data costs) as
        numpy maps and floats (the last cost at the solved map)."""
        W = width or 2 * height
        cfg0 = self.cfg.model_config()
        chunk = cfg0.stream_chunk or SUPER_RES_CHUNK
        mcfg = dataclasses.replace(
            cfg0, pano_width=W, pano_height=height,
            outlier_dp_norm=cfg0.outlier_dp_norm * height / cfg0.pano_height,
            compact_cap=None, stream_chunk=chunk)
        m = (self.t >= self.traj.t_beg) & (self.t <= self.traj.t_end - 1e-9)
        win = pairing.build_window(self.t[m], self.x[m], self.y[m], self.pol[m],
                                   self.camera.width, self.traj.locate,
                                   self.cfg.event_batch_size)
        dev = model.DeviceWindow.from_window(win, self.bearing_lut, self.camera.width,
                                             self.dtype, self.device, pad_multiple=chunk)
        z = torch.zeros((height, W), dtype=self.dtype, device=self.device)
        k = torch.as_tensor(self.traj.knots).to(self.device, self.dtype)
        if num_iters is None:
            num_iters = 3 if mcfg.use_irls else 1
        gx, gy, costs = self.placement.solve_map_only(k, z, z.clone(),
                                                      self.placement.shard(dev), mcfg,
                                                      num_iters)
        return _host(gx), _host(gy), costs

    def _write_super_res(self, height: int, gx, gy, costs):
        """The super-resolution outputs in final_results: Gx_sr.bin,
        Gy_sr.bin, G_hsv_sr.png, poisson_sr.png (reconstructed on the
        pipeline's device) and super_res.json (height, width, data
        costs), the reference's files; ``gx``, ``gy``, ``costs`` from
        :meth:`solve_super_res_map`."""
        fr = os.path.join(self.result_dir, "final_results")
        eio.save_map_bin(os.path.join(fr, "Gx_sr.bin"), os.path.join(fr, "Gy_sr.bin"),
                         gx, gy)
        eio.save_png(os.path.join(fr, "G_hsv_sr.png"), eio.gradient_hsv_image(gx, gy))
        eio.save_png(os.path.join(fr, "poisson_sr.png"), self._brightness(gx, gy))
        with open(os.path.join(fr, "super_res.json"), "w") as f:
            json.dump({"height": height, "width": gx.shape[1], "data_costs": costs}, f,
                      indent=2)

    def _log(self, line: str):
        if self._iter_log is not None:
            self._iter_log.write(line + "\n")

    def _retune(self, stats, knots, gx, gy, dev, mcfg):
        """After a window under the automatic compaction cap: count its
        active pixels on the device (one host read), record the overflow
        past the cap (those pixels were dropped from this window's solve)
        and return the configuration with the cap retuned for the next
        window (:func:`retune_compact_cap`), which also repairs an
        undersized cap. The cap stays within :data:`ROWS_LARGE`: active
        pixels past it drop from the solve and are counted as here."""
        observed = count_active_pixels(knots, gx, gy, dev, mcfg, self.placement)
        if not stats.active_px_per_form:
            stats.note_active_pixels(observed)
        stats.overflow_active_pixels = max(0, observed - mcfg.compact_cap)
        cap = min(retune_compact_cap(observed, mcfg.pano_width * mcfg.pano_height),
                  ROWS_LARGE)
        return mcfg if cap == mcfg.compact_cap else dataclasses.replace(
            mcfg, compact_cap=cap)

    def _coarse_presolve(self, win_id, num_events, seg_knots, dev, mcfg, lm,
                         first_window, stats_out):
        """Coarse-to-fine pose pre-solve: the window's pose solved at a
        half-resolution panorama (:func:`coarse_config`) from the current
        map pooled 2x (:func:`pool2`), on the same fused-or-host path and
        fence as the main solve; the coarse map is discarded. The window
        data does not depend on the panorama (bearings and pairing), so the
        stage reuses it. Appends the stage's LMStats to ``stats_out`` and
        returns the refined knots (f64 numpy), or ``seg_knots`` for a
        panorama of odd size, with a log line."""
        mc = coarse_config(mcfg)
        if mc is None:
            msg = (f"win {win_id} coarse presolve skipped: odd panorama "
                   f"{mcfg.pano_width}x{mcfg.pano_height}")
            print(f"# {msg}", file=sys.stderr)
            self._log(msg)
            return seg_knots
        knots, _gx, _gy, st, _cost = self._solve(
            win_id, num_events, seg_knots, dev, mc, lm, first_window, None,
            maps=(pool2(self.gx), pool2(self.gy)), variant=True)
        stats_out.append(st)
        self._log(f"coarse presolve: {len(st.iterations)} iters at "
                  f"{mc.pano_width}x{mc.pano_height}")
        return _host(knots)

    def _solve_multi_start(self, win_id, num_events, seg_knots, dev, mcfg, lm,
                           first_window):
        """A multi-start window: the four (sample_mode x coarse-to-fine)
        variants of :data:`MULTI_START`, each from the window's start, and
        the one with the lowest data cost under the reference model
        (``sample_mode="curr"``, :func:`data_cost_at`) kept: a selection
        without ground truth. Variants run without per-iteration callbacks
        and mid-window checkpoints (window-boundary checkpoints still
        cover the run). The window's LMStats are the winner's records with
        the counts and seconds of every variant, coarse stages included,
        and ``variants`` lists each one's cost, iterations and seconds;
        ``lm_mode`` names the winner. Returns what :meth:`_solve` does."""
        eval_cfg = dataclasses.replace(mcfg, sample_mode="curr")
        best, every, variants = None, [], []
        for sm, c2f in MULTI_START:
            vcfg = dataclasses.replace(mcfg, sample_mode=sm)
            coarse = []
            k0 = seg_knots
            if c2f:
                k0 = self._coarse_presolve(win_id, num_events, k0, dev, vcfg, lm,
                                           first_window, coarse)
            out = self._solve(win_id, num_events, k0, dev, vcfg, lm, first_window,
                              None, variant=True)
            kv, gxv, gyv, stv, _ = out
            cost = data_cost_at(kv, gxv, gyv, dev, eval_cfg, self.placement)
            sel = sm + ("+c2f" if c2f else "")
            self._log(f"win {win_id} multi-start {sel}: data cost {cost}")
            every += coarse + [stv]
            variants.append(dict(
                variant=sel, data_cost=cost, iterations=len(stv.iterations),
                coarse_iterations=sum(len(c.iterations) for c in coarse),
                setup_s=sum(st.setup_s for st in coarse + [stv]),
                time_total_s=sum(st.time_total_s for st in coarse + [stv])))
            if best is None or cost < best[0]:
                best = (cost, sel, out)
        _cost, sel, (knots, gx, gy, stats, final_cost) = best
        stats = _merged_stats(stats, every)
        stats.lm_mode += f"+multistart:{sel}"
        stats.variants = variants
        return knots, gx, gy, stats, final_cost

    def _solve(self, win_id, num_events, seg_knots, dev, mcfg, lm, first_window,
               resume_lm, maps=None, variant=False):
        """One window's LM solve on the path the configuration selects, from
        ``maps`` ((Gx, Gy) numpy; the pipeline's maps by default). A
        ``variant`` (a multi-start variant or a coarse stage) runs without
        the per-iteration callback and mid-window checkpoints. Returns
        (knots, Gx, Gy, LMStats, final cost)."""
        cfg = self.cfg
        fused = cfg.fused_lm if cfg.fused_lm is not None else not self.record_data
        if resume_lm is not None:
            # a mid-window resume restores host-schedule state; the fused
            # loop carries its own: the host loop gives the same results
            fused = False
        # Fused-window fence: beyond the cap (events a rank), the
        # host-driven loop (recorded in runtime.json lm_mode).
        n_dev = self.comm.world if self.comm is not None else 1
        fallback = (fused and cfg.fused_event_cap is not None
                    and num_events / n_dev > cfg.fused_event_cap)
        fused = fused and not fallback
        gx0, gy0 = maps if maps is not None else (self.gx, self.gy)
        knots0, gx0, gy0 = convert.state_from_numpy(
            seg_knots, gx0, gy0, self.dtype, self.device)

        if fused:
            loop = lm_mod.LoopStats()
            t0 = time.perf_counter()
            knots, gx_j, gy_j, cost_min, n_it, conv, trace = solver.solve_window_fused(
                knots0, gx0, gy0, dev, mcfg, cfg.damping_factor, cfg.tol_fun,
                fix_first=first_window, use_cg=cfg.use_cg,
                max_num_iter=cfg.max_num_iter,
                num_times_tol_fun_sat=cfg.num_times_tol_fun_sat,
                return_trace=True, stats=loop, placement=self.placement,
            )
            stats = self._stats_from_trace(num_events, n_it, conv, trace,
                                           time.perf_counter() - t0, loop)
            final_cost = float(cost_min)
        else:
            def cb(it, gx, gy, info):
                self._log(f"win {win_id} iter {it} log10(lambda)="
                          f"{np.log10(info['lam']):.2f} cost_min={info['cost_min']}")
                self._save_evo(win_id, it, gx, gy)

            # Mid-window LM checkpointing (host loops only; the fused loop
            # has no host re-entry).
            ck_every = cfg.lm_checkpoint_every if self.record_data and not variant else 0
            ck_cb = None
            if ck_every and self._writer:
                ck_path = os.path.join(self.result_dir, "final_results",
                                       "checkpoint.npz")

                def ck_cb(state):
                    self.save_checkpoint(ck_path, win_id, lm_state=state)

            knots, gx_j, gy_j, stats = solver.solve_window(
                knots0, gx0, gy0, dev, mcfg, lm,
                damping_factor=cfg.damping_factor, fix_first=first_window,
                use_cg=cfg.use_cg, callback=None if variant else cb, checkpoint_cb=ck_cb,
                checkpoint_every=ck_every, resume_state=resume_lm,
                placement=self.placement,
            )
            # the window's events, not its padded length (a streamed window)
            stats.num_events = num_events
            last = stats.iterations[-1] if stats.iterations else None
            final_cost = min(last["cost_min"], last["cost_new"]) if last else 0.0
        stats.lm_mode = ("fused" if fused else "host") + (
            "-sharded" if self.comm is not None else "") + (
            "(fused-cap-fallback)" if fallback else "")
        return knots, gx_j, gy_j, stats, final_cost

    def _write_runtime(self, window_stats):
        """Per-phase runtime logs (reference runtime_*.txt,
        solver.cpp:147-151, 218-222, 290-294) + events/s, with the keys of
        the reference's runtime.json plus ``setup_s``, ``spans_s`` and
        ``counters`` (the run record's, :mod:`obs`)."""
        rec = self.record
        agg = {"form": 0.0, "solve": 0.0, "objective": 0.0}
        counts = {"form": 0, "solve": 0, "objective": 0}
        n_ev = 0
        for st in window_stats:
            agg["form"] += st.time_form_s
            agg["solve"] += st.time_solve_s
            agg["objective"] += st.time_objective_s
            counts["form"] += st.count_form
            counts["solve"] += st.count_solve
            counts["objective"] += st.count_objective
            n_ev += st.num_events
        out = {
            "phases_s": agg,
            "phase_counts": counts,
            "num_events": n_ev,
            # host loop: phase times end in a device synchronization; fused
            # mode reports total_s only (phases_s stay 0)
            "sync_method": window_stats[-1].sync_method if window_stats else "",
            "total_s": sum(st.time_total_s for st in window_stats),
            # per window: the fused loop's warm-up and CUDA-graph captures
            # (each window's own event count gives it graphs of its own)
            "setup_s": [st.setup_s for st in window_stats],
            # Np per form call per window (reference solver.cpp:283-293)
            "num_active_pixels": [st.active_px_per_form for st in window_stats],
            "dropped_measurements": [
                st.dropped_meas_per_form for st in window_stats
            ],
            "overflow_active_pixels": [
                st.overflow_active_pixels for st in window_stats
            ],
            # Window pipelining: host prep cost per window vs the time the
            # main loop actually blocked on it (the run record's spans)
            "window_prep_s": [sp.dur_ns * 1e-9 for sp in rec.named("window.prepare")],
            "window_prep_wait_s": [sp.dur_ns * 1e-9
                                   for sp in rec.named("window.prep_wait")],
            # LM execution mode per window ("(fused-cap-fallback)" marks
            # the fused->host fence)
            "lm_mode": [st.lm_mode for st in window_stats],
            "events_per_second": window_stats[-1].events_per_second()
            if window_stats
            else {},
            # the run record so far: each span's total and self seconds and
            # count, and the counters
            "spans_s": rec.totals(),
            "counters": dict(rec.counters),
        }
        with open(
            os.path.join(self.result_dir, "final_results", "runtime.json"), "w"
        ) as f:
            json.dump(out, f, indent=2)
