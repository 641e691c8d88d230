#!/usr/bin/env python3
"""Smoke test of the emba_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own lines:

1. device: torch / CUDA versions and the card (``nvidia-smi``);
2. build: compiles both CUDA kernels from ``emba_tpu_torch/kernels/csrc``,
   one ``nvcc`` each, in parallel;
3. kernel check: the A12 accumulation kernel against its plain torch
   version on the same GPU tensors, at the main path's shapes and at edge
   cases; repeated runs must give the same bits;
4. gather check: the gather-sum kernel in both disciplines against its
   plain torch version and an f64 sum, at N = 2M with R = 8 and 16 (the
   probe's shapes) and 32 (several passes of the row sweep), and at edge
   cases (one chunk, repeated ids, R = 1, MC = 1, R = 3 at MC = 100);
   repeated runs, and the batched kernel with one row a pass, must give
   the same bits; each case prints its rows per pass, the timed ones their
   bound and sector bound;
5. probe: ``emba_tpu_torch.probes.gather_probe``, the gather kernel's own
   entry point (its JSON line);
6. reference check: a small window solved on the GPU in f32 against the
   plain CPU path in f64;
7. main path, host loop: one LM window of 2,000,000 events on a 1024x512
   panorama with a 97-knot order-2 spline (the problem of ``bench.py``),
   ``LMConfig(max_num_iter=8, tol_fun=0)`` (9 trial steps); then the A12
   kernel on that window's own linearization at the start state against
   its plain version, with the window's row and key occupancy;
8. main path, fused: the same window through ``solve_window_fused`` (CUDA
   graphs) with ``bench.py``'s settings (damping 1, ``tol_fun`` 0), twice:
   the first call captures the graphs, the second reuses them and must
   give the same bits. Each is held against the host loop: iterations,
   accept sequence, final cost, and kernel launches against forming
   passes;
9. resume: the host loop stopped at iteration 4 by its checkpoint
   callback, then resumed from the payload, equals the uninterrupted run
   bit for bit;
10. CG: the fused window with ``use_cg=True`` lowers the cost;
11. pipeline: the port's command line (``emba_tpu_torch.cli.main``) on
    the synthetic accuracy suite's ``ecrot_bicycle_like`` scene, built with
    the port's ``synth`` (240x180 sensor, f = 216, 1024x512 panorama, 4.8 s,
    1500 steps, events kept 1 in 8 as the suite did; front-end poses the
    ground truth perturbed by the suite's random walk, at 400 Hz): a fused
    whole-span window of up to 50 LM iterations, then the A12 kernel on
    that window's first forming pass against its plain version; the same
    run recording
    (host loop, checkpoints, runtime.json), held against it; ``eval`` of the
    refined trajectory against ground truth (refined RMSE under half the
    initial); three sliding windows, each capturing its own CUDA graphs
    while the next window is prepared on the worker thread, then the A12
    kernel on the last window's first forming pass against its plain
    version; the Poisson
    reconstruction of the refined maps on the card against the port's f64
    CPU result. Every run's A12 launches must equal its forming passes; the
    fused run prints its peak device bytes per event, from which
    ``pipeline.CLASSIC_CAP_SMALL_ROWS`` is set.

Each kernel line gives its time beside its bound, the least time the card
could take (``a12_bound``: bytes at 3.35 TB/s or f32 operations at 67
TFLOP/s, whichever is longer). The line before the last is the kernel
report ``{"kernels": [...]}``: a kernel's ``ms`` is its eager wrapper call
(for A12 on the synthetic main-shape case), and A12 adds its CUDA-graph
replay and the main window's case as further keys; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before that line. There is no CPU path: without a CUDA
device the script exits with code 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

# Relative tolerance of the kernel against its plain version, as a fraction
# of each output's largest magnitude: both sum in f32, in different orders
# (sorted rows and per-block partials against chunked products and
# index_add_), which moves sums by a few ulps of their largest terms.
KERNEL_REL_TOL = 1e-5
# Error of a gather sum (kernel or plain) against the f64 sum of the same
# columns, as a fraction of the row's sum of magnitudes. Summing 2M f32
# terms of random sign in chunks of 256 leaves an error of order 1e-8 of
# that; 1e-6 also holds for any fixed order of summation at these sizes,
# and a lost chunk (256 of 2M columns, ~1e-4) fails it.
GATHER_REL_TOL = 1e-6
# Final cost of the fused window against the host loop on the card. Both
# run in f32, but the host loop keeps lambda and the cost sum in f64 on the
# host, the fused loop in f32 on the device: lambda differs by an ulp after
# a few steps, which moves the trial states by rounding only.
FUSED_COST_REL_TOL = 1e-5
MAIN_ITERS = 8  # LM max_num_iter of the main window, as bench.py sets it
# Run 2 (host loop, recording) against run 1 (fused) of the pipeline phase:
# knots to relative 1e-5 of their largest magnitude after up to 50 f32
# steps (lambda and the cost sum are f32 on the device, f64 on the host).
PIPELINE_KNOTS_REL_TOL = 1e-5
# The Poisson reconstruction in f32 on the card against f64 on the CPU, as
# a fraction of the f64 result's largest magnitude: an f32 FFT solve is
# good to a few 1e-6 at 1024x512 (1.5e-6 in f32 on the CPU).
RECON_REL_TOL = 1e-4
# Published peaks of one NVIDIA H100 SXM at its 700 W limit (data sheet):
# device memory rate and f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def _bound(nbytes, flops):
    """(least ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def a12_bound(n, num_pix, dim_pose, order, carry=False):
    """Bound of one a12_accumulate call: A12, px5 and a11b written once (and
    read once under ``carry``), 3 int32 + 2D + 4 f32 read per measurement;
    D multiply-adds per A12 plane and half, 5 px5 terms and the (2D+1)^2 / 2
    cells of A11/b1 a measurement."""
    from emba_tpu_torch.kernels.a12_accum import padded_dims

    d = 3 * order
    r_pad, dp_pad = padded_dims(num_pix, dim_pose)
    out = 4 * (r_pad * 2 * dp_pad + r_pad * 8 + (dp_pad + 8) * dp_pad)
    out *= 2 if carry else 1
    inputs = 4 * n * (3 + 2 * d + 4)
    flops = n * (2 * 4 * d + 2 * 5 + (2 * d + 1) * (2 * d + 2))
    return _bound(out + inputs, flops)


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _outputs(out, num_pix, dim_pose):
    """Unpadded views of (a12, px5, a11b): the compared outputs."""
    a12, px5, a11b = out
    dp = a12.shape[1] // 2
    return {
        "A12_gx": a12[:num_pix, :dim_pose],
        "A12_gy": a12[:num_pix, dp:dp + dim_pose],
        "px5": px5[:num_pix, :5],
        "A11": a11b[:dim_pose, :dim_pose],
        "b1": a11b[dp, :dim_pose],
    }


def _rel(got, want):
    """max |got - want| over max |want| (the absolute error if want is 0)."""
    import torch

    if not want.numel():
        return 0.0
    err = float(torch.max(torch.abs(got.double() - want.double())))
    mag = float(torch.max(torch.abs(want)))
    return err / mag if mag > 0 else err


def check_kernel_case(name, args, num_pix, knots, order, carry_args=None,
                      exact=False, graphed=False):
    """Kernel vs plain version on the same GPU tensors. With ``exact``, both
    are also held against the plain version in f64 (printed); with
    ``graphed``, the call is also timed as a CUDA graph replay. Returns the
    case's (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by, graph_ms
    or None)."""
    import torch

    from emba_tpu_torch.device import cuda_time_ms, graph_time_ms
    from emba_tpu_torch.kernels import a12_accum as K

    dim_pose = 3 * knots

    def kernel():
        if carry_args is None:
            return K.a12_accumulate(*args, num_pix, dim_pose, order)
        out = K.a12_accumulate(*carry_args, num_pix, dim_pose, order)
        return K.a12_accumulate(*args, num_pix, dim_pose, order, carry=out)

    def plain():
        if carry_args is None:
            return K.a12_accumulate_plain(*args, num_pix, dim_pose, order)
        cat = [torch.cat([a, b], dim=-1) for a, b in zip(carry_args, args)]
        return K.a12_accumulate_plain(*cat, num_pix, dim_pose, order)

    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        _require(torch.equal(x, y), f"{name}: repeated kernel runs differ")
    want = plain()
    torch.cuda.synchronize()
    g, w = _outputs(got, num_pix, dim_pose), _outputs(want, num_pix, dim_pose)
    if exact:
        # the plain version on the same values in f64: which side errs
        ref = K.a12_accumulate_plain(
            *[a.double() if a.is_floating_point() else a for a in args],
            num_pix, dim_pose, order)
        r = _outputs(ref, num_pix, dim_pose)
        print(f"kernel {name}: against the plain version in f64: " + "; ".join(
            f"{key} kernel {_rel(g[key], r[key]):.3e} plain {_rel(w[key], r[key]):.3e}"
            for key in g), flush=True)
        del ref, r
    max_abs = 0.0
    parts = []
    for key in g:
        err = float(torch.max(torch.abs(g[key] - w[key]))) if g[key].numel() else 0.0
        rel = _rel(g[key], w[key])
        _require(torch.isfinite(g[key]).all().item(), f"{name}: {key} not finite")
        _require(rel <= KERNEL_REL_TOL,
                 f"{name}: {key} rel err {rel:.3e} > {KERNEL_REL_TOL:.0e}")
        parts.append(f"{key} abs {err:.3e} rel {rel:.3e}")
        max_abs = max(max_abs, err)
    del got, again, want
    k_ms = cuda_time_ms(kernel)
    g_ms = graph_time_ms(kernel) if graphed else None
    p_ms = cuda_time_ms(plain)
    torch.cuda.empty_cache()
    b_ms, b_by = a12_bound(args[0].shape[0], num_pix, dim_pose, order,
                           carry=carry_args is not None)
    if carry_args is not None:  # the chain's first call
        b_ms += a12_bound(carry_args[0].shape[0], num_pix, dim_pose, order)[0]
    print(f"kernel {name}: bitwise-repeatable; " + "; ".join(parts)
          + f"; kernel {k_ms:.3f} ms eager" + ("" if g_ms is None else
                                                 f", {g_ms:.3f} ms graph replay")
          + f", plain {p_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), share of bound "
          f"{b_ms / k_ms:.3f} eager" + ("" if g_ms is None else
                                        f", {b_ms / g_ms:.3f} graph replay"),
          flush=True)
    return max_abs, k_ms, p_ms, b_ms, b_by, g_ms


def phase_kernels(device):
    """Every listed case; returns the main-shape case's numbers."""
    from emba_tpu_torch.probes.a12_parts import synthetic_inputs

    rng = np.random.default_rng(1234)
    hw, knots = 1024 * 512, 97
    main = check_kernel_case(
        "main N=2000000 HW=524288 K=97 order=2",
        synthetic_inputs(rng, 2_000_000, hw, knots, 2, device), hw, knots, 2,
        exact=True, graphed=True)
    check_kernel_case(
        "order4 N=500000", synthetic_inputs(rng, 500_000, hw, knots, 4, device),
        hw, knots, 4)
    check_kernel_case("N=1", synthetic_inputs(rng, 1, hw, knots, 2, device),
                      hw, knots, 2)
    check_kernel_case(
        "all-zero weights",
        synthetic_inputs(rng, 100_000, hw, knots, 2, device, zero_w=True),
        hw, knots, 2)
    pix = rng.integers(0, hw, 100_000)
    pix[rng.permutation(100_000)[:10_000]] = 77_777
    check_kernel_case(
        "one row with 10^4 measurements",
        synthetic_inputs(rng, 100_000, hw, knots, 2, device, pix=pix), hw, knots, 2)
    check_kernel_case(
        "carry chain (2 calls vs 1 concatenated)",
        synthetic_inputs(rng, 700_000, hw, knots, 2, device), hw, knots, 2,
        carry_args=synthetic_inputs(rng, 1_300_000, hw, knots, 2, device))
    return main


def check_gather_case(name, payload, idx, timed=False):
    """The gather kernel in both disciplines against its plain version on
    the same GPU tensors and against an f64 sum of the same columns; the
    batched kernel with one row a pass must give the bits of the rule's
    passes. Returns (max |kernel - plain|, rows per pass of the rule,
    {discipline: (kernel ms, plain ms, kernel ms as a CUDA graph replay)})."""
    import torch

    from emba_tpu_torch.device import cuda_time_ms, graph_time_ms
    from emba_tpu_torch.kernels import gather_sum as G

    cols = payload.double().index_select(1, idx.reshape(-1).long())
    want = cols.sum(dim=1, keepdim=True)
    scale = cols.abs().sum(dim=1, keepdim=True).clamp(min=1e-30)
    del cols
    plain = G.gather_sum_plain(payload, idx)
    rule = G.device_pass_size(payload)
    max_abs, times, parts = 0.0, {}, []
    for serial in (False, True):
        tag = "serial" if serial else "batched"
        got = G.gather_sum(payload, idx, serial)
        again = G.gather_sum(payload, idx, serial)
        torch.cuda.synchronize()
        _require(got.shape == (payload.shape[0], 1), f"gather {name}: shape {got.shape}")
        _require(torch.equal(got, again), f"gather {name} {tag}: repeated runs differ")
        _require(torch.isfinite(got).all().item(), f"gather {name} {tag}: not finite")
        if not serial:
            one = G.gather_sum(payload, idx, False, rows_per_pass=1)
            _require(torch.equal(got, one),
                     f"gather {name}: one row a pass differs from {rule} rows a pass")
        for who, out in ((tag, got), ("plain", plain)):
            rel = float(((out.double() - want).abs() / scale).max())
            _require(rel <= GATHER_REL_TOL,
                     f"gather {name} {who}: rel err {rel:.3e} > {GATHER_REL_TOL:.0e}")
            parts.append(f"{who} {rel:.2e}")
        max_abs = max(max_abs, float((got - plain).abs().max()))
        if timed:
            def kernel():
                return G.gather_sum(payload, idx, serial, check_ids=False)
            times[tag] = (cuda_time_ms(kernel),
                          cuda_time_ms(lambda: G.gather_sum_plain(payload, idx)),
                          graph_time_ms(kernel))
    print(f"gather {name}: rows per pass {rule}; bitwise-repeatable, one row a pass "
          f"gives the same bits; err / sum|x| vs f64: " + ", ".join(parts)
          + f"; max |kernel - plain| {max_abs:.3e}"
          + "".join(f"; {t} kernel {k:.3f} ms ({g:.3f} ms graph replay), plain {p:.3f} ms"
                    for t, (k, p, g) in times.items()), flush=True)
    return max_abs, rule, times


def gather_bounds(rows, cols):
    """(bound ms, "bytes" or "operations", sector bound ms) of one gather
    call over ``cols`` ids: the payload's gathered elements and the ids read
    once and (R, 1) written, R adds a column; the sector bound moves a
    32-byte sector from device memory for every gathered element."""
    b_ms, b_by = _bound(4 * (rows * cols + cols + rows), rows * cols)
    return b_ms, b_by, 32 * rows * cols / HBM_BYTES_PER_S * 1e3


def phase_gather(device):
    """Every gather case; returns the R=16 case's numbers: max abs err over
    all cases, batched kernel ms, its plain ms, bound ms, bound kind,
    index_select + sum ms, rows per pass, sector bound ms, and the kernel's
    and index_select + sum's ms as CUDA graph replays."""
    import torch

    from emba_tpu_torch.device import cuda_time_ms, graph_time_ms
    from emba_tpu_torch.kernels.gather_sum import MC

    rng = np.random.default_rng(5)
    n = 2_000_000
    max_abs, main = 0.0, None

    def gpu(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    for rows in (8, 16, 32):
        payload = gpu(rng.standard_normal((rows, n)), torch.float32)
        perm = rng.permutation(n).astype(np.int32)
        idx = gpu(perm[:n // MC * MC].reshape(-1, MC), torch.int32)
        err, rule, times = check_gather_case(f"R={rows} N={n} chunks={n // MC}",
                                             payload, idx, timed=True)
        max_abs = max(max_abs, err)
        b_ms, b_by, s_ms = gather_bounds(rows, idx.numel())
        src = idx.reshape(-1).long()

        def library():
            return payload.index_select(1, src).sum(dim=1, keepdim=True)
        lib_ms, lib_g_ms = cuda_time_ms(library), graph_time_ms(library)
        k_ms, k_plain_ms, k_g_ms = times["batched"]
        print(f"gather R={rows}: rows per pass {rule}; bound {b_ms:.4f} ms ({b_by}), "
              f"sector bound {s_ms:.4f} ms; index_select + sum {lib_ms:.3f} ms "
              f"({lib_g_ms:.3f} ms graph replay); batched kernel {k_ms:.3f} ms "
              f"({k_g_ms:.3f} ms graph replay): share of bound {b_ms / k_ms:.3f}, "
              f"sector bound / kernel {s_ms / k_ms:.3f} ({s_ms / k_g_ms:.3f} graph "
              f"replay)", flush=True)
        if rows == 16:
            main = (k_ms, k_plain_ms, b_ms, b_by, lib_ms, rule, s_ms, k_g_ms, lib_g_ms)
            p16, idx16 = payload, idx
        del payload
    edge = [
        ("one chunk", p16, idx16[:1].contiguous()),
        ("repeated ids", p16, gpu(rng.integers(0, 64, (40, MC)), torch.int32)),
        ("R=1", gpu(rng.standard_normal((1, n)), torch.float32), idx16),
        ("MC=1, last column", p16, gpu(np.full((3, 1), n - 1), torch.int32)),
        ("R=3, MC=100", gpu(rng.standard_normal((3, n)), torch.float32),
         gpu(perm[:n // 100 * 100].reshape(-1, 100), torch.int32)),
    ]
    for name, p_, i_ in edge:
        max_abs = max(max_abs, check_gather_case(name, p_, i_)[0])
    return (max_abs, *main)


def phase_probe():
    """The probe's own entry point; returns the gather kernel's launches."""
    from emba_tpu_torch import kernels
    from emba_tpu_torch.probes import gather_probe

    kernels.reset_launch_counts()
    _require(gather_probe.main([]) == 0, "probe failed")
    launches = kernels.launch_counts()["gather_sum"]
    _require(launches > 0, "probe: the gather kernel was not launched")
    print(f"probe: gather_sum launches {launches}", flush=True)
    return launches


def _window(scene, traj, n, cfg_dtype, device, sensor):
    from emba_tpu_torch import model as M
    from emba_tpu_torch.pairing import build_window

    win = build_window(scene.t[:n], scene.x[:n], scene.y[:n], scene.pol[:n],
                       sensor.width, traj.locate, 100)
    return M.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                      cfg_dtype, device)


def phase_reference(device):
    """Small window: GPU f32 (kernel) against the CPU f64 plain path."""
    import torch

    from emba_tpu_torch import model as M
    from emba_tpu_torch import solver, synth
    from emba_tpu_torch.probes.suite_run import perturbed

    sensor = synth.default_sensor(48, 48, f=44.0)
    scene = synth.generate(np.random.default_rng(11), sensor, pano_width=128,
                           pano_height=64, c_th=0.2, t_end=0.5, dt_knots=0.05,
                           num_steps=120, motion_amp=0.3)
    cfg = M.ModelConfig(c_th=0.2, pano_width=128, pano_height=64,
                        thres_valid_pixel=3, alpha=2.0)
    traj0 = perturbed(scene.traj, np.random.default_rng(5), 0.01)
    runs = {}
    for dev_name, dt in (("cpu", torch.float64), (device, torch.float32)):
        dev = _window(scene, traj0, len(scene.t), dt, dev_name, sensor)
        k, gx, gy = (torch.as_tensor(a).to(device=dev_name, dtype=dt)
                     for a in (traj0.knots, scene.gx * 0.9, scene.gy * 0.9))
        k, gx, gy, st = solver.solve_window(k, gx, gy, dev, cfg,
                                            solver.LMConfig(max_num_iter=3),
                                            fix_first=True)
        runs[str(dev_name)] = (k.double().cpu().numpy(), st)
    (k_ref, st_ref), (k_gpu, st_gpu) = runs["cpu"], runs[str(device)]
    c_ref = np.array([r["cost_new"] for r in st_ref.iterations])
    c_gpu = np.array([r["cost_new"] for r in st_gpu.iterations])
    _require(len(c_ref) == len(c_gpu), "reference: iteration counts differ")
    rel = float(np.max(np.abs(c_gpu - c_ref) / np.abs(c_ref)))
    dk = float(np.max(np.abs(k_gpu - k_ref)))
    print(f"reference (48x48 sensor, 128x64 pano, {len(scene.t)} events, 3 LM "
          f"iterations): cost rel err {rel:.3e}, knot max abs err {dk:.3e}",
          flush=True)
    # f32 against f64 through ~5e3 residuals and a 3K x 3K Cholesky
    _require(rel <= 1e-3, f"reference: cost trace rel err {rel:.3e} > 1e-3")
    _require(dk <= 1e-4, f"reference: knots max abs err {dk:.3e} > 1e-4")


def phase_main(device):
    """The bench problem through the host loop. Returns the window, its
    settings and the run's results for the phases after it."""
    import torch

    from emba_tpu_torch import kernels, metrics, solver
    from emba_tpu_torch.device import cuda_mallocs
    from emba_tpu_torch.probes.profile_fused import main_window

    t0 = time.perf_counter()
    w = main_window(device)
    scene, traj0, n, cfg, dev = (w[k] for k in ("scene", "traj0", "n", "cfg", "dev"))
    knots0, Gx0, Gy0 = w["start"]
    print(f"main: scene {len(scene.t)} events, window {int(dev.pol_signed.shape[0])} "
          f"events, {traj0.num_knots} knots, set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    _require(traj0.num_knots == 97, f"expected 97 knots, got {traj0.num_knots}")

    # tol_fun 0 as bench.py's fused window: no early convergence
    lm = solver.LMConfig(max_num_iter=MAIN_ITERS, tol_fun=0.0)
    # warm-up (CUDA context, cuBLAS / cuSOLVER handles), not counted
    solver.solve_window(knots0, Gx0, Gy0, dev, cfg, solver.LMConfig(max_num_iter=1),
                        fix_first=True)
    peaks = _reset_peak_memory()
    kernels.reset_launch_counts()
    mallocs = cuda_mallocs()
    knots, Gx, Gy, st = solver.solve_window(knots0, Gx0, Gy0, dev, cfg, lm,
                                            fix_first=True)
    torch.cuda.synchronize()
    mallocs = cuda_mallocs() - mallocs
    launches = kernels.launch_counts()["a12_accum"]
    peak = peaks()

    _require(knots.shape == knots0.shape and Gx.shape == Gx0.shape, "output shapes")
    for name, t in (("knots", knots), ("Gx", Gx), ("Gy", Gy)):
        _require(torch.isfinite(t).all().item(), f"main: NaN/Inf in {name}")
    cost0 = st.iterations[0]["cost_min"]
    cost_min = min([r["cost_min"] for r in st.iterations]
                   + [r["cost_new"] for r in st.iterations])
    _require(cost_min < cost0, f"main: cost did not fall ({cost0} -> {cost_min})")
    _require(launches == st.count_form,
             f"main: {launches} kernel launches != {st.count_form} forming passes")

    tt = np.linspace(scene.t[0], scene.t[n - 1], 200)
    R_gt = np.asarray(scene.traj.evaluate(tt))
    traj1 = dataclasses.replace(traj0, knots=knots.double().cpu().numpy())
    eps = st.events_per_second()
    print(f"main: {len(st.iterations)} LM iterations, forms {st.count_form}, "
          f"solves {st.count_solve}, objectives {st.count_objective}", flush=True)
    print(f"main: seconds form {st.time_form_s:.4f} solve {st.time_solve_s:.4f} "
          f"objective {st.time_objective_s:.4f} total {st.time_total_s:.4f}", flush=True)
    print("main: events/s " + json.dumps(eps), flush=True)
    print("main: cost trace " + json.dumps(
        [[r["cost_min"], r["cost_new"]] for r in st.iterations]), flush=True)
    print(f"main: rotation RMSE vs GT {metrics.trajectory_rmse_deg(traj0, tt, R_gt):.4f}"
          f" -> {metrics.trajectory_rmse_deg(traj1, tt, R_gt):.4f} deg", flush=True)
    print(f"main: peak device memory {peak}; cudaMalloc calls in the loop {mallocs} "
          "(the allocator's cache was emptied before it)", flush=True)
    # the same loop again with the allocator's cache full: the phases
    # without the driver's allocations
    mallocs = cuda_mallocs()
    warm = solver.solve_window(knots0, Gx0, Gy0, dev, cfg, lm, fix_first=True)[3]
    torch.cuda.synchronize()
    print(f"main: again, cache full: seconds form {warm.time_form_s:.4f} solve "
          f"{warm.time_solve_s:.4f} objective {warm.time_objective_s:.4f} total "
          f"{warm.time_total_s:.4f}; cudaMalloc calls {cuda_mallocs() - mallocs}",
          flush=True)
    print(f"main: a12_accumulate launches {launches} == count_form {st.count_form}",
          flush=True)
    return dict(dev=dev, cfg=cfg, start=(knots0, Gx0, Gy0), lm=lm, n=n,
                host=(knots, Gx, Gy, st))


def phase_window_kernel(ctx, name="real window", graphed=True):
    """The A12 kernel on a window's own linearization at its start state
    (the first forming pass's inputs; ``ctx`` holds ``dev``, ``cfg`` and
    ``start``), against its plain version, and the window's occupancy: rows
    with a weighted measurement, the largest row, distinct (i_c, i_p) keys.
    Returns the case's numbers."""
    import torch

    from emba_tpu_torch.probes.a12_parts import forming_inputs

    args, r_pad, knots, order = forming_inputs(ctx)
    pm_pix, i_c, i_p, wA = args[0], args[1], args[2], args[8]
    n = pm_pix.shape[0]
    used = wA > 0
    counts = torch.bincount(pm_pix[used].long(), minlength=r_pad)
    keys = torch.unique(i_c[used].long() * knots + i_p[used].long())
    back = (i_c[used] - i_p[used]).long()
    print(f"{name} occupancy: {n} measurements, {int(used.sum())} with weight > 0; "
          f"rows with >= 1 of them {int((counts > 0).sum())} of {r_pad}, largest row "
          f"{int(counts.max())}; distinct (i_c, i_p) keys {keys.numel()} of "
          f"{knots * knots}; i_c - i_p in [{int(back.min())}, {int(back.max())}]",
          flush=True)
    return check_kernel_case(f"{name} N={n} K={knots} order={order}", args,
                             r_pad, knots, order, exact=True, graphed=graphed)


def _reset_peak_memory():
    """Free the allocator's cache and reset its peaks; returns a function
    that describes the peaks since. A CUDA graph keeps the memory of what
    its capture freed in its private pool, which counts as reserved and not
    as allocated, so both peaks are reported."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def peaks():
        return (f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB allocated, "
                f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB reserved")
    return peaks


def _fused(ctx, use_cg=False):
    """One solve_window_fused call on the main window; returns (outputs,
    LoopStats, a12 launches, peak memory, call seconds)."""
    import torch

    from emba_tpu_torch import kernels, lm, solver

    stats = lm.LoopStats()
    peaks = _reset_peak_memory()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = solver.solve_window_fused(
        *ctx["start"], ctx["dev"], ctx["cfg"], 1.0, 0.0, fix_first=True,
        use_cg=use_cg, max_num_iter=MAIN_ITERS, return_trace=True, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()["a12_accum"]
    return out, stats, launches, peaks(), wall


def _finite(name, tensors):
    import torch

    for t in tensors:
        _require(torch.isfinite(t).all().item(), f"{name}: NaN/Inf in the state")


def phase_fused(ctx):
    """The main window through solve_window_fused twice: the first call
    builds and captures the graphs, the second reuses them. Each is held
    against the host loop on the card, and the two against each other bit
    for bit. Returns the a12 kernel launches of the second call."""
    import torch

    from emba_tpu_torch import lm

    first = _fused(ctx)
    (k, gx, gy, cost, it, conv, trace), st, launches, peak, wall = _fused(ctx)
    _finite("fused", (k, gx, gy))
    _require(st.setup_s == 0.0 and first[1].setup_s > 0.0,
             "fused: the second call did not reuse the first call's graphs")
    _require(all(torch.equal(a, b) for a, b in zip(first[0], (k, gx, gy, cost, it,
                                                               conv, trace))),
             "fused: the call that reused the graphs differs from the first")
    n_it = int(it)
    recs = lm.trace_records(trace.cpu().double().numpy(), n_it)
    host = ctx["host"][3]
    host_acc = [r["cost_new"] < r["cost_min"] for r in host.iterations]
    fused_acc = [r["accepted"] for r in recs]
    host_cost = min([r["cost_min"] for r in host.iterations]
                    + [r["cost_new"] for r in host.iterations])
    rel = abs(float(cost) - host_cost) / abs(host_cost)
    eps_loop = ctx["n"] * n_it / st.loop_s
    eps_call = ctx["n"] * n_it / wall
    eps_host = host.events_per_second()["total"]
    print(f"fused: {n_it} iterations, accepts {''.join('A' if a else 'r' for a in fused_acc)}"
          f" (host loop {''.join('A' if a else 'r' for a in host_acc)}), cost "
          f"{float(cost):.6f} vs host {host_cost:.6f} (rel {rel:.2e}); the call that "
          f"reused the graphs equals the first bit for bit", flush=True)
    print(f"fused: first call {first[4]:.4f} s (set-up: warm-up + captures "
          f"{first[1].setup_s:.4f} s, loop {first[1].loop_s:.4f} s); second call "
          f"{wall:.4f} s (loop {st.loop_s:.4f} s) vs host loop {host.time_total_s:.4f} s; "
          f"events/s second call {eps_call:.4g}, its loop {eps_loop:.4g}, host loop "
          f"{eps_host:.4g}", flush=True)
    print(f"fused: replays {json.dumps(st.replays)}; forming passes {st.form_passes}, "
          f"a12_accumulate launches {launches} (first call: {first[1].form_passes} "
          f"forming passes with the warm-up's, {first[2]} launches); host loop forms "
          f"{host.count_form}; peak device memory first call {first[3]}, second {peak}",
          flush=True)
    _require(n_it == len(host.iterations),
             f"fused: {n_it} iterations != host loop {len(host.iterations)}")
    _require(fused_acc == host_acc, "fused: accept/reject sequence differs from the host loop")
    _require(rel <= FUSED_COST_REL_TOL,
             f"fused: final cost rel err {rel:.2e} > {FUSED_COST_REL_TOL:.0e}")
    for name, (passes, n_launch) in (("first", (first[1].form_passes, first[2])),
                                     ("second", (st.form_passes, launches))):
        _require(n_launch == passes,
                 f"fused {name} call: {n_launch} kernel launches != {passes} forming passes")
    _require(st.replays["form"] == host.count_form,
             f"fused: {st.replays['form']} form replays != host loop {host.count_form}")
    return launches


def phase_resume(ctx):
    """Host loop stopped at iteration 4 by its checkpoint callback, resumed
    from the payload: the bits of the uninterrupted run."""
    import torch

    from emba_tpu_torch import solver

    class Stop(Exception):
        pass

    captured = {}

    def checkpoint(state):
        captured.update(state)
        if state["it"] >= 4:
            raise Stop

    args = (*ctx["start"], ctx["dev"], ctx["cfg"], ctx["lm"])
    try:
        solver.solve_window(*args, fix_first=True, checkpoint_cb=checkpoint,
                            checkpoint_every=1)
        raise RuntimeError("chip_smoke: resume: the run was not stopped")
    except Stop:
        pass
    _require(captured["it"] == 4, f"resume: stopped at it={captured['it']}")
    k, gx, gy, st = solver.solve_window(*args, fix_first=True, resume_state=captured)
    k_ref, gx_ref, gy_ref, st_ref = ctx["host"]
    same = [torch.equal(a, b) for a, b in ((k, k_ref), (gx, gx_ref), (gy, gy_ref))]
    print(f"resume: stopped at it=4, resumed for {len(st.iterations)} iterations "
          f"(uninterrupted {len(st_ref.iterations)}); knots/Gx/Gy bit-equal {same}",
          flush=True)
    _require(len(st.iterations) == len(st_ref.iterations) - 4, "resume: iteration count")
    _require(all(same), "resume: the resumed state differs from the uninterrupted run")


def phase_cg(ctx):
    """The fused main window with the CG solve: cost falls, no NaN."""
    (k, gx, gy, cost, it, conv, trace), st, launches, peak, wall = _fused(
        ctx, use_cg=True)
    _finite("cg", (k, gx, gy))
    cost0 = float(trace[0, 1])
    print(f"cg: {int(it)} iterations, cost {cost0:.6f} -> {float(cost):.6f}; CG "
          f"iterations per solve {st.cg_iterations}; relative residuals "
          f"{[f'{e:.1e}' for e in st.cg_error]}; loop wall {st.loop_s:.4f} s, "
          f"peak device memory {peak}", flush=True)
    _require(float(cost) < cost0, f"cg: cost did not fall ({cost0} -> {float(cost)})")
    _require(launches == st.form_passes, "cg: kernel launches != forming passes")


def _cli_run(name, argv):
    """One ``cli.main(["run", ...])`` on the card
    (``probes.suite_run.measured_run``: graph and allocator caches emptied,
    peaks reset, A12 launches counted from 0). Prints the run's windows,
    iterations, events/s, wall, per-window set-up, peak memory and launches
    against forming passes; gates launches, costs and finiteness. Returns
    (RunResult, summary dict)."""
    from emba_tpu_torch.probes.suite_run import measured_run

    res, summary = measured_run(argv)
    print(f"pipeline {name}: " + json.dumps(summary), flush=True)
    launches, forms = summary["a12_launches"], summary["forming_passes"]
    stats = res.window_stats
    _require(launches == forms,
             f"pipeline {name}: {launches} A12 launches != {forms} forming passes")
    for st in stats:
        costs = [r["cost_min"] for r in st.iterations] + [r["cost_new"]
                                                          for r in st.iterations]
        _require(np.isfinite(costs).all(), f"pipeline {name}: non-finite cost")
        _require(min(costs) < st.iterations[0]["cost_min"],
                 f"pipeline {name}: the cost did not fall in a window")
    _require(np.isfinite(res.trajectory.knots).all() and np.isfinite(res.gx).all()
             and np.isfinite(res.gy).all(), f"pipeline {name}: NaN/Inf in the result")
    return res, summary


@contextlib.contextmanager
def _window_inputs(keep):
    """Within the scope, the pipeline's window solve records the inputs of
    the windows whose ids are in ``keep``: {win_id: {"dev", "cfg", "state"}},
    the device window as uploaded, the model configuration and the
    arguments from which the solve converts its start state (host arrays,
    so that the run's device memory stays as it was)."""
    from emba_tpu_torch import pipeline

    got = {}
    solve = pipeline.EmbaPipeline._solve

    def recording(self, win_id, num_events, seg_knots, dev, mcfg, *rest):
        if win_id in keep:
            got[win_id] = dict(dev=dev, cfg=mcfg, state=(
                np.array(seg_knots), self.gx.copy(), self.gy.copy(), self.dtype,
                self.device))
        return solve(self, win_id, num_events, seg_knots, dev, mcfg, *rest)

    pipeline.EmbaPipeline._solve = recording
    try:
        yield got
    finally:
        pipeline.EmbaPipeline._solve = solve


def _pipeline_window_kernel(name, windows):
    """The A12 kernel on the first forming pass of a pipeline window (the
    only window recorded in ``windows``), exact, against its plain version;
    the recorded inputs are freed after. Returns the case's numbers."""
    import torch

    from emba_tpu_torch import convert

    (ctx,) = windows.values()
    windows.clear()
    ctx["start"] = convert.state_from_numpy(*ctx.pop("state"))
    case = phase_window_kernel(ctx, name=name, graphed=False)
    del ctx
    torch.cuda.empty_cache()
    return case


def _accepts(stats):
    return "".join("A" if r["cost_new"] < r["cost_min"] else "r" for r in stats.iterations)


def phase_pipeline(device):
    """The port's CLI on the suite row (see the module docstring, phase 11).
    Returns ({run: A12 launches}, the largest absolute error of the A12
    kernel against its plain version on the recorded windows)."""
    import tempfile

    import torch

    from emba_tpu_torch import cli, recon, spline
    from emba_tpu_torch import io as eio
    from emba_tpu_torch.pipeline import CLASSIC_CAP_SMALL_ROWS
    from emba_tpu_torch.probes.suite_run import (CAP_MEMORY_SHARE, CARD_BYTES, cap_from,
                                                 suite_argv, write_suite_scene)

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        n_scene, n_kept, p = write_suite_scene(d)
        print(f"pipeline: suite row ecrot_bicycle_like, {n_scene} events rendered, "
              f"{n_kept} kept; scene files in {time.perf_counter() - t0:.1f} s",
              flush=True)
        argv = suite_argv(p)

        with _window_inputs({0}) as windows:
            fused, s1 = _cli_run("run 1 (fused, whole span)", argv)
        st1 = fused.window_stats[0]
        cases = [_pipeline_window_kernel("pipeline run 1 window 0", windows)]
        _require(s1["windows"] == 1 and st1.lm_mode == "fused",
                 f"run 1: {s1['windows']} windows, lm_mode {st1.lm_mode}")
        _require(st1.setup_s > 0, "run 1: the window did not capture its graphs")

        out = os.path.join(d, "rec")
        host, s2 = _cli_run("run 2 (recording, host loop)", argv + ["--out", out])
        st2 = host.window_stats[0]
        with open(os.path.join(out, "final_results", "runtime.json")) as f:
            rt = json.load(f)
        dk = float(np.max(np.abs(host.trajectory.knots - fused.trajectory.knots))
                   / np.max(np.abs(fused.trajectory.knots)))
        print(f"pipeline run 2 vs run 1: iterations {len(st2.iterations)} vs "
              f"{len(st1.iterations)}; accepts {_accepts(st2)} vs {_accepts(st1)}; "
              f"knots rel {dk:.3e}; runtime.json lm_mode {rt['lm_mode']}, total_s "
              f"{rt['total_s']:.4f}, phases_s {json.dumps(rt['phases_s'])}, "
              f"phase_counts {json.dumps(rt['phase_counts'])}, window_prep_s "
              f"{rt['window_prep_s']}", flush=True)
        _require(rt["lm_mode"] == ["host"], f"run 2: runtime.json lm_mode {rt['lm_mode']}")
        _require(len(st2.iterations) == len(st1.iterations),
                 "run 2: iteration count differs from run 1")
        _require(_accepts(st2) == _accepts(st1), "run 2: accept sequence differs from run 1")
        _require(dk <= PIPELINE_KNOTS_REL_TOL,
                 f"run 2: knots rel {dk:.3e} > {PIPELINE_KNOTS_REL_TOL:.0e}")
        per_ev = max(s1["bytes_per_event_reserved"], s2["bytes_per_event_reserved"])
        print(f"pipeline runs 1-2: classic-window cap estimate from these runs "
              f"{cap_from(per_ev)} events ({CAP_MEMORY_SHARE} x {CARD_BYTES:.0f} bytes / "
              f"{per_ev:.1f} bytes an event reserved, the larger of the fused and the "
              "recording run; it counts the map-sized buffers per event, so it errs "
              "low: probes/suite_run.py measures a window near the cap; the device "
              f"reports {torch.cuda.get_device_properties(0).total_memory} bytes); "
              f"pipeline.CLASSIC_CAP_SMALL_ROWS {CLASSIC_CAP_SMALL_ROWS}", flush=True)

        # run 3: eval of run 1's refined trajectory, and of the start the
        # pipeline fits to the front-end poses at the same knot times
        times, rots = eio.load_tum_trajectory(p["frontend.txt"])
        m = (times > 0.1) & (times < 4.7)
        start = spline.Trajectory.from_poses(times[m], rots[m], 0.1, 4.7, 0.05)
        rmse = {}
        for name, traj in (("initial", start), ("refined", fused.trajectory)):
            path = os.path.join(d, f"{name}.txt")
            traj.write_tum(path)
            rmse[name] = cli.main(["eval", "--traj", path, "--gt", p["traj_gt.txt"]])
        r0, r1 = (rmse[k]["rotation_rmse_deg"] for k in ("initial", "refined"))
        cost0, cost1 = st1.iterations[0]["cost_min"], min(
            [r["cost_min"] for r in st1.iterations] + [r["cost_new"]
                                                       for r in st1.iterations])
        print(f"pipeline run 3 (eval): rotation RMSE {r0:.4f} -> {r1:.4f} deg over "
              f"{rmse['refined']['num_poses']} knots; cost {cost0:.6g} -> {cost1:.6g}; "
              "the suite's row (reference formulation, emba_tpu on the same scene "
              "and 4M-event cut): 1.89 -> 0.26 deg", flush=True)
        _require(np.isfinite([r0, r1]).all() and r1 < 0.5 * r0,
                 f"run 3: refined RMSE {r1:.4f} not under half the initial {r0:.4f}")

        with _window_inputs({2}) as windows:
            slide, s4 = _cli_run("run 4 (sliding windows 2.0 s, stride 1.0 s, fused)",
                                 argv + ["--time-window-size", "2.0",
                                         "--sliding-window-stride", "1.0"])
        cases.append(_pipeline_window_kernel("pipeline run 4 window 2", windows))
        _require(s4["windows"] == 3, f"run 4: {s4['windows']} windows, expected 3")
        _require(all(m == "fused" for m in s4["lm_mode"]), f"run 4: {s4['lm_mode']}")
        _require(all(s > 0 for s in s4["setup_s"]),
                 f"run 4: a window did not capture its own graphs {s4['setup_s']}")

        gx, gy = (torch.as_tensor(a) for a in (fused.gx, fused.gy))
        want = recon.reconstruct_from_gradient(gx, gy)
        got = recon.reconstruct_from_gradient(gx.to(device, torch.float32),
                                              gy.to(device, torch.float32))
        torch.cuda.synchronize()
        rel = float((got.double().cpu() - want).abs().max() / want.abs().max())
        print(f"pipeline run 5 (recon): {tuple(got.shape)} f32 on the card vs f64 on the "
              f"CPU, rel {rel:.3e} (tolerance {RECON_REL_TOL:.0e})", flush=True)
        _require(torch.isfinite(got).all().item() and rel <= RECON_REL_TOL,
                 f"run 5: recon rel {rel:.3e} > {RECON_REL_TOL:.0e}")
    launches = {"run1": s1["a12_launches"], "run2": s2["a12_launches"],
                "run4": s4["a12_launches"]}
    return launches, max(c[0] for c in cases)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from emba_tpu_torch import kernels
    from emba_tpu_torch.device import card_name_and_power_limit, full_precision, require_cuda
    from emba_tpu_torch.kernels import _build

    device = require_cuda()
    full_precision()
    smi = card_name_and_power_limit()
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all(kernels.KERNELS)
    print(f"build: {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    syn = phase_kernels(device)
    (g_err, g_ms, g_plain_ms, g_bound, g_by, g_lib, g_rows, g_sector, g_graph,
     g_lib_graph) = phase_gather(device)
    g_launches = phase_probe()
    phase_reference(device)
    ctx = phase_main(device)
    win = phase_window_kernel(ctx)
    a12_launches = phase_fused(ctx)
    phase_resume(ctx)
    phase_cg(ctx)
    del ctx
    pipeline_launches, pipe_err = phase_pipeline(device)

    # the A12 "ms" is the eager wrapper call on the synthetic main-shape case,
    # as in every earlier report; beside it the same call replayed from a
    # CUDA graph (as the fused window runs it, without the host's dispatch of
    # the wrapper's index maps) and both times on the main window's own inputs
    report = {"kernels": [{
        "name": "a12_accumulate",
        "route": "cuda",
        "source": "emba_tpu_torch/kernels/csrc/a12_accum.cu",
        "replaces": "emba_tpu/kernels/a12_accum.py:79",
        "launches": a12_launches,
        "max_abs_err": max(syn[0], win[0], pipe_err),
        "ms": syn[1],
        "plain_ms": syn[2],
        "bound_ms": syn[3],
        "bound_by": syn[4],
        "library_ms": None,
        "graph_ms": syn[5],
        "window_ms": win[1],
        "window_graph_ms": win[5],
        "window_plain_ms": win[2],
        "window_bound_ms": win[3],
        "pipeline_launches": pipeline_launches,
    }, {
        "name": "gather_sum",
        "route": "cuda",
        "source": "emba_tpu_torch/kernels/csrc/gather_sum.cu",
        "replaces": "scripts/r5_dma_gather_probe.py:46",
        "launches": g_launches,
        "max_abs_err": g_err,
        "ms": g_ms,
        "plain_ms": g_plain_ms,
        "bound_ms": g_bound,
        "bound_by": g_by,
        "library_ms": g_lib,
        "rows_per_pass": g_rows,
        "sector_bound_ms": g_sector,
        "graph_ms": g_graph,
        "library_graph_ms": g_lib_graph,
    }]}
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
