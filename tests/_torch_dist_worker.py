"""What the ranks of the sharded-window tests run (``dist.spawn`` pickles
these functions by name). Imports no JAX: a spawned rank starts from a
fresh interpreter and imports this module and the port only.

Each ``*_rank`` function takes the rank's communicator and the problem's
arrays (``tests/test_torch_dist.py``'s ``problem_arrays``) and returns numpy
results; the test process compares them with JAX's ``dist`` and with the
port's single-device functions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from emba_tpu_torch import dist, model as M, pairing, pipeline, solver, spline
from emba_tpu_torch import config as TC

F64 = torch.float64


def window(data, order=2, cfg_kw=None):
    """(full window, ModelConfig, (knots, Gx, Gy)) of the problem in f64 on
    the CPU; ``order`` 4 refits the trajectory as a cubic spline."""
    traj = spline.Trajectory(t_beg=0.0, dt=data["dt"], knots=data["knots"], order=2)
    if order != 2:
        tt = np.linspace(0.0, data["t_end"], 200)
        traj = spline.Trajectory.from_poses(tt, traj.evaluate(tt).numpy(), 0.0,
                                            data["t_end"], data["dt"], order=order)
    win = pairing.build_window(data["t"], data["x"], data["y"], data["pol"], data["width"],
                               traj.locate, 100)
    dev = M.DeviceWindow.from_window(win, data["lut"], data["width"], F64, "cpu")
    cfg = M.ModelConfig(**{**data["cfg"], "spline_order": order, **(cfg_kw or {})})
    state = tuple(torch.from_numpy(np.array(a)) for a in
                  (traj.knots, data["gx"], data["gy"]))
    return dev, cfg, state


def _neq(neq):
    return {f.name: getattr(neq, f.name).numpy() for f in dataclasses.fields(neq)}


def units_rank(comm, data, compact_cap=None):
    """The halo linearization, the reduced normal equations and the row-chunk
    solves (Schur; CG) at lambda 1e-3 with the first knot fixed, the
    map-only solve (quadratic; Cauchy IRLS, 3 steps), and whether the
    uncompacted row space splits over the ranks."""
    dev, cfg, (k, gx, gy) = window(data)
    nsp = data["width"] * data["height"]
    sh = dist.shard_window(dev, comm)
    mode = dist.Sharded(comm, nsp).mode(sh, cfg)
    lin = mode.objective(k, gx, gy)[0]
    out = {"lin": {f.name: getattr(lin, f.name).numpy() for f in dataclasses.fields(lin)},
           "has_prev": sh.has_prev.numpy()}
    ccfg = dataclasses.replace(cfg, compact_cap=compact_cap)
    try:
        mode.form(lin, k, gx, gy)
        out["split_error"] = ""
    except ValueError as err:
        out["split_error"] = str(err)
    lin_c = dist.Sharded(comm, nsp).mode(sh, ccfg).objective(k, gx, gy)[0]
    red = dist.reduce_normal_eq(M.form_normal_eq(lin_c, gx, gy, ccfg, k.shape[0],
                                                 1.0 if comm.rank == 0 else 0.0), comm)
    out["red"] = _neq(red)
    x1, x2 = dist.solve_rowchunks(red, 1e-3, True, comm)
    out["schur"] = (x1.numpy(), x2.numpy())
    x1, x2, it, rel = dist.solve_cg_rowchunks(red, 1e-3, True, comm)
    out["cg"] = (x1.numpy(), x2.numpy(), int(it), float(rel))
    z = torch.zeros_like(gx)
    for name, mcfg, iters in (("quadratic", cfg, 1),
                              ("irls", dataclasses.replace(cfg, use_irls=True,
                                                           cost_type="cauchy", eta=0.5), 3)):
        place = dist.Sharded(comm, nsp)
        gxm, gym, costs = place.solve_map_only(k, z, z.clone(), sh, mcfg, num_iters=iters)
        again = place.solve_map_only(k, z, z.clone(), sh, mcfg, num_iters=iters)
        out[f"map_{name}"] = (gxm.numpy(), gym.numpy(), costs,
                              bool(torch.equal(gxm, again[0]) and torch.equal(gym, again[1])))
    return out


# The sharded windows of the tests: name -> (ModelConfig fields, spline
# order, use_cg). Chunks of 1100 and caps of 1500 divide neither a rank's
# events nor the row space's alignment.
WINDOWS = {
    "classic": ({}, 2, False),
    "compact": ({"compact_cap": 1536}, 2, False),
    "stream_full": ({"stream_chunk": 1100}, 2, False),
    "stream_light": ({"stream_chunk": 1100, "stream_light": True}, 2, False),
    "irls": ({"use_irls": True, "cost_type": "huber", "eta": 0.05}, 2, False),
    "cg": ({}, 2, True),
    "order4": ({}, 4, False),
}
WINDOW_ITERS = 5


def windows_rank(comm, data, names):
    """Each named window of :data:`WINDOWS` through the host loop and the
    fused loop (``lm.lm_while``: gloo) with the trace; returns per name the
    knots, maps, the host loop's iteration records and forming stats, and
    the fused loop's trace and results."""
    nsp = data["width"] * data["height"]
    place = dist.Sharded(comm, nsp)
    out = {}
    for name in names:
        cfg_kw, order, use_cg = WINDOWS[name]
        dev, cfg, state = window(data, order, cfg_kw)
        sh = dist.shard_window(dev, comm)
        k, gx, gy, st = solver.solve_window(*state, sh, cfg,
                                            solver.LMConfig(max_num_iter=WINDOW_ITERS),
                                            fix_first=True, use_cg=use_cg, placement=place)
        fk, fgx, fgy, cost, it, conv, trace = solver.solve_window_fused(
            *state, sh, cfg, 1.0, 1e-3, fix_first=True, use_cg=use_cg,
            max_num_iter=WINDOW_ITERS, return_trace=True, placement=place)
        out[name] = dict(
            host=(k.numpy(), gx.numpy(), gy.numpy()), iterations=st.iterations,
            active=st.active_px_per_form, dropped=st.dropped_meas_per_form,
            fused=(fk.numpy(), fgx.numpy(), fgy.numpy(), float(cost), int(it), bool(conv),
                   trace[:int(it)].numpy()))
    return out


def resume_rank(comm, data, state=None, stop_at=4):
    """The host loop of the classic window (8 iterations): uninterrupted,
    and, without ``state``, stopped after iteration ``stop_at`` by its
    checkpoint callback and resumed from that payload at this world size;
    with ``state``, resumed from it. Returns the results and the payload."""
    nsp = data["width"] * data["height"]
    place = dist.Sharded(comm, nsp)
    dev, cfg, start = window(data)
    sh = dist.shard_window(dev, comm)
    lm = solver.LMConfig(max_num_iter=8)

    def run(**kw):
        k, gx, gy, st = solver.solve_window(*start, sh, cfg, lm, fix_first=True,
                                            placement=place, **kw)
        return k.numpy(), gx.numpy(), gy.numpy(), [r["cost_new"] for r in st.iterations]

    if state is not None:
        return {"resumed": run(resume_state=state)}
    saved = []

    class Stop(Exception):
        pass

    def checkpoint(s):
        saved.append(s)
        if s["it"] >= stop_at:
            raise Stop

    try:
        run(checkpoint_cb=checkpoint, checkpoint_every=1)
    except Stop:
        pass
    return {"full": run(), "state": saved[-1], "resumed": run(resume_state=saved[-1])}


def pipeline_rank(comm, data_dir, runs, device="cpu"):
    """``EmbaPipeline`` with ``num_devices`` = the world on the CLI's synth
    scene in ``data_dir``: each of ``runs`` is (name, BAConfig fields,
    pipeline keywords, resume checkpoint or None). A ``snapshot`` keyword
    (window, writes, path) copies the checkpoint file to ``path`` when rank 0
    has written the ``writes``-th mid-window checkpoint of that window.
    Returns {name: RunResult}, and under "a12_launches" {name: this rank's
    A12 kernel launches in that run}."""
    from emba_tpu_torch import kernels

    import os

    from emba_tpu_torch import io as tio
    from emba_tpu_torch.camera import load_camera_yaml

    t, x, y, pol, _ = tio.load_events_npz(os.path.join(data_dir, "events.npz"))
    times, rots = tio.load_tum_trajectory(os.path.join(data_dir, "traj_gt.txt"))
    gx, gy = tio.load_map_bin(os.path.join(data_dir, "Gx.bin"),
                              os.path.join(data_dir, "Gy.bin"))
    cam = load_camera_yaml(os.path.join(data_dir, "calib.yaml"))
    out = {"a12_launches": {}}
    for name, cfg_kw, kw, resume in runs:
        kw = dict(kw)
        snapshot = kw.pop("snapshot", None)
        cfg = TC.BAConfig(**cfg_kw, num_devices=comm.world)
        pipe = pipeline.EmbaPipeline(cfg, cam, (t, x, y, pol), times, rots,
                                     init_gx=gx.copy(), init_gy=gy.copy(),
                                     device=comm.device if device != "cpu" else "cpu", **kw)
        if snapshot is not None:
            pipe.save_checkpoint = _snapshotting(pipe.save_checkpoint, *snapshot)
        kernels.reset_launch_counts()
        out[name] = pipe.run(resume_from=resume)
        out["a12_launches"][name] = kernels.launch_counts()["a12_accum"]
    return out


def fail_rank(comm, hang: bool):
    """Rank 1 raises (or, with ``hang``, sleeps) while the others wait for it
    in a collective."""
    import time

    if comm.rank == 1:
        if hang:
            time.sleep(600)
        raise ValueError("rank 1 fails on purpose")
    comm.all_reduce_sum(torch.ones(1))


def _snapshotting(save, window, writes, dest):
    import shutil

    count = []

    def save_checkpoint(path, window_idx, lm_state=None):
        save(path, window_idx, lm_state=lm_state)
        if lm_state is not None and window_idx == window:
            count.append(path)
            if len(count) == writes:
                shutil.copy(path, dest)

    return save_checkpoint


def jax_modules_rank(comm):
    """The JAX modules a spawned rank has loaded (none, for the port)."""
    import sys

    del comm
    return sorted(m for m in sys.modules
                  if m in ("jax", "emba_tpu") or m.startswith(("jax.", "jaxlib", "emba_tpu.")))
