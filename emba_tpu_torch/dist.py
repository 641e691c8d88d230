"""Sharded windows on ``torch.distributed`` (counterpart of
``emba_tpu/dist.py``).

One process a rank, one rank axis of size ``world``. Rank r holds the
events ``[r*nl, (r+1)*nl)`` of a window padded to a multiple of the ranks
(:func:`pad_window`, :func:`shard_window`); ``prev_idx`` stays global, and
the per-batch pose tables, the knots and the maps are whole on every rank.
The reference's ``("ev", "tile")`` mesh is flattened the same way: every
window it solves uses an ``(n, 1)`` mesh.

* :class:`Comm`: the one place the collectives live (``all_reduce_sum``,
  ``reduce_scatter_sum``, ``all_gather``, ``shift``), over ``nccl`` (each
  rank's own GPU) or ``gloo`` (CPU tensors; CUDA tensors copied to the host
  and back, the only way to put several ranks on one card). The caller
  chooses the backend; nothing falls back.
* the halo: exact cross-rank pairing. Only the first local event at a
  sensor pixel can have its prev on an earlier rank, and that prev is the
  last event at the pixel on the latest earlier rank that saw the pixel.
  Each rank exports one record a sensor pixel and folds the earlier ranks'
  records in ``ceil(log2(world))`` rounds of ``shift`` (a selection, so the
  result is exact): a linearization (:func:`linearize_sharded`) ships the
  warped positions, Jacobian rows and segments; :func:`prev_records` ships
  the bearings and batch ids once a streamed window.
* :class:`Sharded`: the placement of ``solver.solve_window`` and
  ``solver.solve_window_fused`` for a rank's shard. It wraps the model's
  mode of the shard (``model.window_mode`` with the halo's linearization
  and prev records): the passes run on the rank's events (the A12 kernel
  at the global row space, L2 regularizer on rank 0 only), the inlier
  count map and the data cost are summed over the ranks, the pose block
  summed and the map rows reduce-scattered into chunks
  (:func:`reduce_normal_eq`), and the solves run on the chunks
  (``model.solve_normal_eq`` or CG, with the ranks' partial sums reduced
  and x2 gathered). The results are whole on every
  rank, so every rank takes the same accept/reject decisions. Over NCCL a
  CUDA window captures its phases, collectives included, in CUDA graphs;
  over gloo a CUDA graph cannot hold a collective that goes through the
  host, so the fused window runs ``lm.lm_while``.
  Its ``solve_map_only`` is the map-only step on the shards: the five
  per-pixel sums reduce-scattered as one ``(5, HW_pad)`` tensor and the 2x2
  solves on each rank's pixels.
* :func:`spawn` runs a function on ``world`` ranks of their own processes;
  :func:`dryrun` runs every sharded configuration on a tiny problem.

The reference's GSPMD cross-check (``make_sharded_step``) and its 2-D mesh
(``make_mesh``) are not ported (ROADMAP). A sharded window with
``light_trial`` forms from the full linearization, as the reference's does,
with the same steps (``model.window_mode``).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import pickle
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as tdist

from . import model as M
from . import solver, warp

BACKENDS = ("nccl", "gloo")
# Seconds a collective waits for the other ranks before it fails: a rank
# that died or hangs fails the others within this.
COLLECTIVE_TIMEOUT_S = 60.0
# torch 2.13 renamed the tensor-tiled collectives (the old names warn)
_ALL_GATHER = getattr(tdist, "all_gather_single", None) or tdist.all_gather_into_tensor
_REDUCE_SCATTER = (getattr(tdist, "reduce_scatter_single", None)
                   or tdist.reduce_scatter_tensor)


class Comm:
    """The collectives of one rank. Each takes and returns tensors on the
    rank's ``device`` (another device raises) and leaves its input alone.
    Over ``gloo`` a CUDA tensor is copied to the host, reduced there and
    copied back (``staged``)."""

    def __init__(self, world: int, rank: int, backend: str, device: torch.device):
        self.world, self.rank, self.backend, self.device = world, rank, backend, device

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _check(self, x):
        if x.device != self.device:
            raise ValueError(f"dist: a tensor on {x.device}, rank {self.rank} works on "
                             f"{self.device}")

    def _out(self, x, copy: bool = False):
        """``x`` contiguous where the backend reads it (the host when
        staged: page-locked, which torch's host allocator keeps for the
        next call), a copy of its own if ``copy``."""
        self._check(x)
        if self.staged:
            return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
        return x.clone(memory_format=torch.contiguous_format) if copy else x.contiguous()

    def _back(self, x):
        return x.to(self.device) if self.staged else x

    def all_reduce_sum(self, x):
        """The sum of ``x`` over the ranks (``psum``)."""
        y = self._out(x, copy=True)
        tdist.all_reduce(y)
        return self._back(y)

    def reduce_scatter_sum(self, x, dim: int = 0):
        """This rank's chunk along ``dim`` of the sum of ``x`` over the ranks
        (``psum_scatter(..., tiled=True)``); ``x.shape[dim]`` is a multiple
        of the ranks."""
        if x.shape[dim] % self.world:
            raise ValueError(f"dist: reduce-scatter of {x.shape[dim]} rows over "
                             f"{self.world} ranks")
        y = self._out(x.movedim(dim, 0))
        out = torch.empty((y.shape[0] // self.world, *y.shape[1:]), dtype=y.dtype,
                          device=y.device)
        _REDUCE_SCATTER(out, y)
        return self._back(out).movedim(0, dim)

    def all_gather(self, x, dim: int = 0):
        """The ranks' ``x`` concatenated along ``dim`` in rank order
        (``all_gather(..., tiled=True)``)."""
        y = self._out(x.movedim(dim, 0))
        out = torch.empty((y.shape[0] * self.world, *y.shape[1:]), dtype=y.dtype,
                          device=y.device)
        _ALL_GATHER(out, y)
        return self._back(out).movedim(0, dim)

    def shift(self, xs, d: int):
        """``ppermute`` with pairs (s, s + d): each tensor of ``xs`` goes to
        rank + d, and what rank - d sent comes back; a rank with no source
        gets zeros."""
        src, dst = self.rank - d, self.rank + d
        host = "cpu" if self.staged else self.device
        got = [torch.zeros(x.shape, dtype=x.dtype, device=host) for x in xs]
        ops = []
        if dst < self.world:
            ops += [tdist.P2POp(tdist.isend, self._out(x), dst) for x in xs]
        if src >= 0:
            ops += [tdist.P2POp(tdist.irecv, y, src) for y in got]
        if ops:
            for req in tdist.batch_isend_irecv(ops):
                req.wait()
        return [self._back(y) for y in got]


_COMM: Comm | None = None


def current() -> Comm | None:
    """This process's communicator (:func:`init`), or None."""
    return _COMM


def init(world: int, rank: int, backend: str = "nccl", init_method: str | None = None,
         device="cuda") -> Comm:
    """Join a process group of ``world`` ranks as ``rank`` and return its
    communicator. ``device``: "cuda" (the rank's GPU: ``LOCAL_RANK`` or the
    rank; over gloo, ranks past the visible GPUs share them, round robin) or
    "cpu" (gloo only). ``nccl`` raises on a CPU device and for more ranks
    than visible GPUs. One eager collective runs here, so that NCCL creates
    its communicator before any CUDA graph captures a collective."""
    global _COMM
    if backend not in BACKENDS:
        raise ValueError(f"dist: backend {backend!r} not in {BACKENDS}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dist: no CUDA device: a CPU rank asks for device 'cpu'")
        count = torch.cuda.device_count()
        index = int(os.environ.get("LOCAL_RANK", rank)) if device.index is None else device.index
        if backend == "nccl" and (world > count or index >= count):
            raise RuntimeError(f"dist: nccl with {world} ranks needs {world} GPUs, {count} "
                               "visible (several ranks on one GPU: backend gloo)")
        device = torch.device("cuda", index % count)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("dist: nccl runs on CUDA devices; a CPU rank needs gloo")
    tdist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                             timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    comm = Comm(world, rank, backend, device)
    if comm.staged:
        print(f"dist: rank {rank} of {world} on {device} over gloo: every collective "
              "copies its tensors to the host and back; a fused window runs "
              "lm.lm_while (a CUDA graph cannot hold a host-staged collective)",
              file=sys.stderr, flush=True)
    comm.all_reduce_sum(torch.zeros(1, device=device))
    _COMM = comm
    return comm


def destroy() -> None:
    global _COMM
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _COMM = None


def _rank_main(rank, fn, world, backend, store, out_dir, device, threads, args):
    torch.set_num_threads(threads)
    comm = init(world, rank, backend, f"file://{store}", device)
    try:
        out = fn(comm, *args)
    finally:
        destroy()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world: int, backend: str = "nccl", args=(), timeout_s: float | None = 600.0,
          device="cuda", threads: int = 1) -> list:
    """Run ``fn(comm, *args)`` on ``world`` ranks, one spawned process each
    (:func:`init` with a file store in a fresh temporary directory, so no
    port is taken and concurrent runs do not meet), each rank with
    ``threads`` torch threads. ``fn`` must be importable by name (it is
    pickled). Returns each rank's return value, in rank order. A rank that
    fails fails the call at once, the others killed; past ``timeout_s``
    (None: no limit; a hang in a collective still fails within
    :data:`COLLECTIVE_TIMEOUT_S`) every rank is killed and TimeoutError
    raised."""
    tmp = tempfile.mkdtemp(prefix="emba_dist_")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, backend, os.path.join(tmp, "store"), tmp, device,
                          threads, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"dist.spawn: {world} ranks of {fn.__name__} still "
                                   f"running after {timeout_s} s")
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The window's shards.
# ---------------------------------------------------------------------------


def pad_window(dev: M.DeviceWindow, multiple: int) -> M.DeviceWindow:
    """Pad the per-event arrays to a multiple of ``multiple``. Padded events
    are no measurements: ``has_prev=False``, a unit-z bearing, batch 0."""
    n = dev.pol_signed.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return dev

    def pad_arr(a, value=0):
        return torch.nn.functional.pad(a, (0, pad), value=value)

    bearings = pad_arr(dev.bearings)
    bearings[2, n:] = 1.0
    return dataclasses.replace(
        dev, bearings=bearings, pol_signed=pad_arr(dev.pol_signed),
        prev_idx=pad_arr(dev.prev_idx), has_prev=pad_arr(dev.has_prev, False),
        batch_ids=pad_arr(dev.batch_ids),
        sensor_pix=None if dev.sensor_pix is None else pad_arr(dev.sensor_pix))


def shard_window(dev: M.DeviceWindow, comm: Comm) -> M.DeviceWindow:
    """This rank's shard of a whole window: the window padded to a multiple
    of the ranks, and this rank's contiguous run of its events (copies, so
    the whole window can be freed); ``prev_idx`` keeps its global values,
    the pose tables stay whole."""
    dev = pad_window(dev, comm.world)
    nl = dev.pol_signed.shape[0] // comm.world
    sl = slice(comm.rank * nl, (comm.rank + 1) * nl)
    return dataclasses.replace(
        dev, bearings=dev.bearings[:, sl].contiguous(),
        **{name: getattr(dev, name)[sl].clone()
           for name in ("pol_signed", "prev_idx", "has_prev", "batch_ids", "sensor_pix")})


def _prev_features(dev: M.DeviceWindow, comm: Comm, num_sensor_pix: int, feats, ids,
                   fill=None):
    """Each local event's prev-event features: ``feats`` (F, nl) floats and
    ``ids`` (I, nl) int32 of the local events, gathered at the prev where it
    is local and from the halo fold where it lies on an earlier rank (a
    pixel no earlier rank saw gets ``fill`` (F,), zeros by default).
    Returns ((F, nl), (I, nl))."""
    nl = feats.shape[1]
    device = feats.device
    local_prev = dev.prev_idx.long() - comm.rank * nl
    in_shard = (local_prev >= 0) & (local_prev < nl)
    lp = torch.clamp(local_prev, 0, max(nl - 1, 0))
    spix = dev.sensor_pix.long()
    # this rank's record: its last event a sensor pixel
    last = torch.full((num_sensor_pix,), -1, dtype=torch.int64, device=device)
    last.scatter_reduce_(0, spix, torch.arange(nl, device=device), "amax")
    valid = last >= 0
    li = torch.clamp(last, min=0)
    acc_f = torch.where(valid, feats[:, li], torch.zeros((), dtype=feats.dtype,
                                                          device=device))
    acc_i = torch.cat([valid[None].to(torch.int32),
                       torch.where(valid, ids[:, li], 0).to(torch.int32)])
    # exclusive prefix fold: start from the predecessor's record; after the
    # round of shift d a rank holds the latest record of the 2d ranks before
    # it (the later rank wins where it has one); ranks with no source get
    # zeros, i.e. no record
    acc_f, acc_i = comm.shift([acc_f, acc_i], 1)
    cov = 1
    while cov < comm.world - 1:
        r_f, r_i = comm.shift([acc_f, acc_i], cov)
        have = acc_i[0] != 0
        acc_f = torch.where(have, acc_f, r_f)
        acc_i = torch.where(have, acc_i, r_i)
        cov *= 2
    if fill is not None:
        acc_f = torch.where(acc_i[0] != 0, acc_f, fill[:, None])
    prev_f = torch.where(in_shard, feats[:, lp], acc_f[:, spix])
    prev_i = torch.where(in_shard, ids[:, lp].to(torch.int32), acc_i[1:, spix])
    return prev_f, prev_i


def linearize_sharded(knots, Gx, Gy, dev: M.DeviceWindow, cfg: M.ModelConfig, comm: Comm,
                      num_sensor_pix: int, need_deriv: bool = True) -> M.Linearization:
    """This rank's linearization with exact cross-rank pairing: the local
    events' warp, the prev events' positions, Jacobian rows and segments
    from the halo (``model.linearize_from_warp`` on them). Each field is
    the single-device linearization's on this rank's events, bit for bit;
    the inlier count map counts this rank's events (:class:`Sharded` sums
    it over the ranks: a pixel's activity depends on every rank's)."""
    pm, cp_idx, dpm = warp.warp_events(knots, dev.batch_s, dev.batch_u, dev.batch_ids,
                                       dev.bearings, cfg.pano, cfg.spline_order, need_deriv)
    pmx, pmy = pm
    d = cfg.dim_block
    rows = [pmx[None], pmy[None]] + ([dpm.reshape(2 * d, -1)] if need_deriv else [])
    prev_f, prev_i = _prev_features(dev, comm, num_sensor_pix, torch.cat(rows),
                                    cp_idx[None])
    dpm_prev = prev_f[2:].reshape(2, d, -1) if need_deriv else None
    return M.linearize_from_warp(pmx, pmy, cp_idx, dpm, prev_f[:2], dpm_prev, prev_i[0],
                                 dev.has_prev, dev.pol_signed, Gx, Gy, cfg, need_deriv)


def prev_records(dev: M.DeviceWindow, comm: Comm, num_sensor_pix: int):
    """``model.prev_records`` of this rank's events: each event's prev
    bearing (3, nl) and prev batch id (nl,), through the halo where the
    prev lies on an earlier rank. They do not depend on the state: a
    streamed window resolves them once. A pixel no earlier rank saw keeps
    a unit-z bearing (a zero bearing warps to NaN, which a zero weight does
    not cancel)."""
    fill = torch.zeros(3, dtype=dev.bearings.dtype, device=dev.bearings.device)
    fill[2] = 1.0
    pb, pbid = _prev_features(dev, comm, num_sensor_pix, dev.bearings, dev.batch_ids[None],
                              fill)
    return pb, pbid[0]


def reduce_normal_eq(neq: M.NormalEq, comm: Comm) -> M.NormalEq:
    """The ranks' normal equations summed: A11, b1 and ``dropped`` whole on
    every rank; the map rows (the five per-row planes and A12) reduce-
    scattered, so each rank holds the sum of its chunk of rows
    ``[rank*rows, (rank+1)*rows)`` only, with its chunk of ``active``;
    ``pix2row``, ``active_pix`` and ``active_count`` stay whole (they follow
    from the summed inlier count map). The row space must split evenly."""
    r_pad = neq.a22_xx.shape[0]
    if r_pad % comm.world:
        raise ValueError(f"map row space {r_pad} not divisible by {comm.world} ranks "
                         "(pad ROW_ALIGN / compact_cap)")
    rows = r_pad // comm.world
    a11b = comm.all_reduce_sum(torch.cat([neq.A11, neq.b1[None]]))
    planes = comm.reduce_scatter_sum(torch.stack(
        [neq.a22_xx, neq.a22_xy, neq.a22_yy, neq.b2_x, neq.b2_y]), dim=1)
    return dataclasses.replace(
        neq, A11=a11b[:-1], b1=a11b[-1], a22_xx=planes[0], a22_xy=planes[1],
        a22_yy=planes[2], b2_x=planes[3], b2_y=planes[4],
        A12=comm.reduce_scatter_sum(neq.A12),
        active=neq.active[comm.rank * rows:(comm.rank + 1) * rows],
        dropped=comm.all_reduce_sum(neq.dropped))


def solve_rowchunks(red: M.NormalEq, lam, fix_first: bool, comm: Comm,
                    rows_total=None):
    """The Schur solve of a reduced system (:func:`reduce_normal_eq`): each
    rank's chunk adds its part of S and of the right-hand side (summed over
    the ranks in one call), the small Cholesky solve runs on every rank,
    x2 is solved on the chunks and gathered. Each rank lists its own
    chunk's rows (``rows_total`` counts them, as in
    ``model.solve_normal_eq``). Returns x1, x2 (2, R_pad)."""
    return M.solve_normal_eq(red, lam, fix_first, reduce=comm.all_reduce_sum,
                             gather=lambda x2: comm.all_gather(x2, dim=1),
                             rows_total=rows_total)


def solve_cg_rowchunks(red: M.NormalEq, lam, fix_first: bool, comm: Comm,
                       early_exit: bool = True):
    """Block-preconditioned CG on a reduced system: the pose vectors whole
    on every rank, the map vectors in chunks, the A12 cross term and each
    inner product's map part summed over the ranks. Returns (x1, x2,
    iterations, relative residual)."""
    return M.solve_normal_eq_cg(red, lam, fix_first, early_exit=early_exit,
                                reduce=comm.all_reduce_sum,
                                gather=lambda x2: comm.all_gather(x2, dim=1))


@dataclasses.dataclass(frozen=True)
class Sharded(solver.Local):
    """The placement of a window whose events are split over the ranks of
    ``comm`` (``solver.solve_window`` / ``solve_window_fused`` with
    ``placement=``; their ``dev_win`` is this rank's :func:`shard_window`).
    ``num_sensor_pix``: the sensor's pixels, the size of a halo record."""

    comm: Comm
    num_sensor_pix: int

    @property
    def graphs(self) -> bool:
        return self.comm.backend == "nccl"

    @property
    def key(self):
        c = self.comm
        return (c.world, c.rank, c.backend, self.num_sensor_pix)

    def num_events(self, dev_win) -> int:
        return int(dev_win.pol_signed.shape[0]) * self.comm.world

    def mode(self, dev_win, cfg) -> M.WindowMode:
        """The model's mode of this rank's shard, its pairing through the
        halo, the regularizer on rank 0 only, wrapped: the inlier count map
        of the forming input and the data cost summed over the ranks, the
        normal equations reduced (:func:`reduce_normal_eq`). No pass
        carries its forming input (``carry_aux``), as in the reference's
        sharded window."""
        comm, nsp = self.comm, self.num_sensor_pix
        halo = (functools.partial(linearize_sharded, dev=dev_win, cfg=cfg, comm=comm,
                                  num_sensor_pix=nsp),
                functools.partial(prev_records, dev_win, comm, nsp))
        local = M.window_mode(dev_win, cfg, 1.0 if comm.rank == 0 else 0.0, halo)

        def objective(knots, Gx, Gy):
            aux, cost_data, cost_reg = local.objective(knots, Gx, Gy)
            aux = dataclasses.replace(aux, num_ev_map=comm.all_reduce_sum(aux.num_ev_map))
            return aux, comm.all_reduce_sum(cost_data), cost_reg

        def form(aux, knots, Gx, Gy):
            return reduce_normal_eq(local.form(aux, knots, Gx, Gy), comm)

        def cost_and_activity(knots, Gx, Gy):
            cost, nem = local.cost_and_activity(knots, Gx, Gy)
            return comm.all_reduce_sum(cost), comm.all_reduce_sum(nem)

        return dataclasses.replace(local, objective=objective, form=form,
                                   cost_and_activity=cost_and_activity, carry_aux=False)

    def damped_solve(self, red, lam, fix_first, use_cg, early_exit=True, rows_total=None):
        if use_cg:
            return solve_cg_rowchunks(red, lam, fix_first, self.comm, early_exit)
        return (*solve_rowchunks(red, lam, fix_first, self.comm, rows_total), None, None)

    def shard(self, dev_win):
        return shard_window(dev_win, self.comm)

    def solve_map_only(self, knots, Gx, Gy, dev_win, cfg, num_iters: int = 1):
        """``model.solve_map_only`` on this rank's shard: the prev records
        resolved once through the halo, every step's five per-pixel sums
        reduce-scattered as one (5, HW_pad) tensor, the 2x2 solves on the
        rank's pixels."""
        return M.solve_map_only(knots, Gx, Gy, dev_win, cfg, num_iters,
                                *prev_records(dev_win, self.comm, self.num_sensor_pix),
                                comm=self.comm)


# ---------------------------------------------------------------------------
# Dry run of every sharded configuration.
# ---------------------------------------------------------------------------

DRYRUN_VARIANTS = ("classic", "streamed+compact", "host", "cg+irls", "streamed-light",
                   "order4", "map-only")


def _dryrun_rank(comm: Comm):
    """Every :data:`DRYRUN_VARIANTS` entry on this rank's shard of the tiny
    problem (32x32 sensor, 128x64 panorama, f32); returns {variant: (first
    cost, last cost)}."""
    from . import pairing, spline, synth

    sensor = synth.default_sensor(32, 32, f=30.0)
    scene = synth.generate(np.random.default_rng(0), sensor, pano_width=128,
                           pano_height=64, c_th=0.15, t_end=0.5, dt_knots=0.05,
                           num_steps=150, motion_amp=0.2)
    cfg = M.ModelConfig(c_th=0.15, pano_width=128, pano_height=64, thres_valid_pixel=2,
                        alpha=1.0)
    device, dt = comm.device, torch.float32
    place = Sharded(comm, sensor.width * sensor.height)

    def shard(traj):
        win = pairing.build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                                   traj.locate, 100)
        dev = M.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width, dt,
                                         device)
        return shard_window(dev, comm)

    def state(knots):
        return tuple(torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)
                     for a in (knots, 0.8 * scene.gx, 0.8 * scene.gy))

    dev = shard(scene.traj)
    out = {}
    fused = dict(damping=1.0, tol_fun=1e-3, fix_first=True, max_num_iter=3,
                 return_trace=True, placement=place)
    for name, vcfg, kw in (
            ("classic", cfg, {}),
            ("streamed+compact", dataclasses.replace(cfg, stream_chunk=512, compact_cap=512),
             {}),
            ("cg+irls", dataclasses.replace(cfg, use_irls=True, cost_type="cauchy", eta=0.5),
             dict(use_cg=True)),
            ("streamed-light", dataclasses.replace(cfg, stream_chunk=512, stream_light=True),
             {})):
        k, gx, gy, cost, it, conv, trace = solver.solve_window_fused(
            *state(scene.traj.knots), dev, vcfg, **fused, **kw)
        out[name] = (float(trace[0, 1]), float(cost))
    k, gx, gy, st = solver.solve_window(*state(scene.traj.knots), dev, cfg,
                                        solver.LMConfig(max_num_iter=2), fix_first=True,
                                        placement=place)
    out["host"] = (st.iterations[0]["cost_min"],
                   min(min(r["cost_min"], r["cost_new"]) for r in st.iterations))
    tt = np.linspace(0.0, 0.5, 200)
    traj4 = spline.Trajectory.from_poses(tt, np.asarray(scene.traj.evaluate(tt)), 0.0, 0.5,
                                         0.05, order=4)
    k, gx, gy, cost, it, conv, trace = solver.solve_window_fused(
        *state(traj4.knots), shard(traj4), dataclasses.replace(cfg, spline_order=4),
        **fused)
    out["order4"] = (float(trace[0, 1]), float(cost))
    z = torch.zeros((64, 128), dtype=dt, device=device)
    k0 = state(scene.traj.knots)[0]
    _gx, _gy, costs = place.solve_map_only(k0, z, z.clone(), dev, cfg)
    out["map-only"] = (costs[0], costs[-1])
    return out


def dryrun(world: int, backend: str = "gloo", device="cuda") -> dict:
    """Every sharded configuration (classic, streamed + compact, host-
    driven, CG + IRLS, streamed LIGHT, order 4, map-only) on a tiny
    problem over ``world`` spawned ranks (counterpart of the reference's
    ``dryrun_multichip`` without its GSPMD step, which is not ported).
    Raises unless every variant is finite and lowers its cost and the ranks
    agree; returns rank 0's {variant: (first cost, last cost)}."""
    return check_dryrun(spawn(_dryrun_rank, world, backend, device=device), backend)


def check_dryrun(results, backend: str) -> dict:
    """The gates of :func:`dryrun` on each rank's :func:`_dryrun_rank`
    results: every variant finite, its cost falling, the ranks agreeing.
    Prints a line a variant; returns rank 0's results."""
    world = len(results)
    for name in DRYRUN_VARIANTS:
        first, last = results[0][name]
        if not (np.isfinite([first, last]).all() and last < first):
            raise RuntimeError(f"dist.dryrun({world}): {name}: cost {first} -> {last}")
        if any(r[name] != results[0][name] for r in results[1:]):
            raise RuntimeError(f"dist.dryrun({world}): {name}: the ranks disagree")
        print(f"dist.dryrun({world}, {backend}): {name}: cost {first:.6g} -> {last:.6g}",
              flush=True)
    return results[0]
