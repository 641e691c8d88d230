#!/usr/bin/env python3
"""Smoke test of the emba_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own lines:

1. device: torch / CUDA versions and the card (``nvidia-smi``);
2. build: compiles the CUDA kernels from ``emba_tpu_torch/kernels/csrc``;
3. kernel check: the A12 accumulation kernel against its plain torch
   version on the same GPU tensors, at the main path's shapes and at edge
   cases; repeated runs must give the same bits;
4. reference check: a small window solved on the GPU in f32 against the
   plain CPU path in f64;
5. main path: one LM window of 2,000,000 events on a 1024x512 panorama with
   a 97-knot order-2 spline (the problem of ``bench.py``), with
   ``LMConfig(max_num_iter=8)`` as ``bench.py`` sets it (9 trial steps).

The line before the last is the kernel report ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before that line. There is no CPU path: without a CUDA
device the script exits with code 2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# Relative tolerance of the kernel against its plain version, as a fraction
# of each output's largest magnitude: both sum in f32, in different orders
# (sorted rows and per-block partials against chunked products and
# index_add_), which moves sums by a few ulps of their largest terms.
KERNEL_REL_TOL = 1e-5


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, reps=5):
    """Median milliseconds of ``reps`` runs after one warm-up, CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_inputs(rng, n, hw, knots, order, device, pix=None, zero_w=False):
    import torch

    d = 3 * order
    i_c = rng.integers(0, knots - order + 1, n)
    # prev segments at and before the curr one (as in an event stream),
    # with some far back
    i_p = np.clip(i_c - rng.integers(0, 3, n) * (rng.random(n) < 0.8)
                  - rng.integers(0, knots, n) * (rng.random(n) >= 0.8), 0, None)
    w = rng.uniform(0.0, 1.0, n)
    w[rng.random(n) < 0.3] = 0.0
    if zero_w:
        w[:] = 0.0
    host = [
        rng.integers(0, hw, n) if pix is None else pix,
        i_c, i_p,
        rng.normal(size=(d, n)), rng.normal(size=(d, n)),
        rng.normal(size=n), rng.normal(size=n), rng.normal(size=n), w,
    ]
    types = [torch.int32] * 3 + [torch.float32] * 6
    return [torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=t)
            for a, t in zip(host, types)]


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


def check_kernel_case(name, args, num_pix, knots, order, carry_args=None):
    """Kernel vs plain version on the same GPU tensors. Returns the
    case's (max_abs_err, kernel_ms, plain_ms)."""
    import torch

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
    max_abs = 0.0
    parts = []
    g, w = _outputs(got, num_pix, dim_pose), _outputs(want, num_pix, dim_pose)
    for key in g:
        err = float(torch.max(torch.abs(g[key] - w[key]))) if g[key].numel() else 0.0
        mag = float(torch.max(torch.abs(w[key]))) if w[key].numel() else 0.0
        rel = err / mag if mag > 0 else err
        _require(torch.isfinite(g[key]).all().item(), f"{name}: {key} not finite")
        _require(rel <= KERNEL_REL_TOL,
                 f"{name}: {key} rel err {rel:.3e} > {KERNEL_REL_TOL:.0e}")
        parts.append(f"{key} abs {err:.3e} rel {rel:.3e}")
        max_abs = max(max_abs, err)
    del got, again, want
    k_ms = _time_ms(kernel)
    p_ms = _time_ms(plain)
    torch.cuda.empty_cache()
    print(f"kernel {name}: bitwise-repeatable; " + "; ".join(parts)
          + f"; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms", flush=True)
    return max_abs, k_ms, p_ms


def phase_kernels(device):
    """Every listed case; returns the main-shape case's numbers."""
    rng = np.random.default_rng(1234)
    hw, knots = 1024 * 512, 97
    main = check_kernel_case(
        "main N=2000000 HW=524288 K=97 order=2",
        _kernel_inputs(rng, 2_000_000, hw, knots, 2, device), hw, knots, 2)
    check_kernel_case(
        "order4 N=500000", _kernel_inputs(rng, 500_000, hw, knots, 4, device),
        hw, knots, 4)
    check_kernel_case("N=1", _kernel_inputs(rng, 1, hw, knots, 2, device),
                      hw, knots, 2)
    check_kernel_case(
        "all-zero weights",
        _kernel_inputs(rng, 100_000, hw, knots, 2, device, zero_w=True),
        hw, knots, 2)
    pix = rng.integers(0, hw, 100_000)
    pix[rng.permutation(100_000)[:10_000]] = 77_777
    check_kernel_case(
        "one row with 10^4 measurements",
        _kernel_inputs(rng, 100_000, hw, knots, 2, device, pix=pix), hw, knots, 2)
    check_kernel_case(
        "carry chain (2 calls vs 1 concatenated)",
        _kernel_inputs(rng, 700_000, hw, knots, 2, device), hw, knots, 2,
        carry_args=_kernel_inputs(rng, 1_300_000, hw, knots, 2, device))
    return main


def _window(scene, traj, n, cfg_dtype, device, sensor):
    from emba_tpu.pairing import build_window  # numpy-only host module
    from emba_tpu_torch import model as M

    win = build_window(scene.t[:n], scene.x[:n], scene.y[:n], scene.pol[:n],
                       sensor.width, traj.locate, 100)
    return M.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                      cfg_dtype, device)


def _perturbed(traj, seed, sigma):
    from emba_tpu_torch import spline

    steps = np.random.default_rng(seed).normal(size=(traj.num_knots, 3)) * sigma
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    return dataclasses.replace(traj, knots=spline._np_exp(walk) @ traj.knots)


def phase_reference(device):
    """Small window: GPU f32 (kernel) against the CPU f64 plain path."""
    import torch

    from emba_tpu_torch import model as M
    from emba_tpu_torch import solver, synth

    sensor = synth.default_sensor(48, 48, f=44.0)
    scene = synth.generate(np.random.default_rng(11), sensor, pano_width=128,
                           pano_height=64, c_th=0.2, t_end=0.5, dt_knots=0.05,
                           num_steps=120, motion_amp=0.3)
    cfg = M.ModelConfig(c_th=0.2, pano_width=128, pano_height=64,
                        thres_valid_pixel=3, alpha=2.0)
    traj0 = _perturbed(scene.traj, 5, 0.01)
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
    """The bench problem through the port's entry points. Returns launches."""
    import torch

    from emba_tpu_torch import metrics, solver, synth
    from emba_tpu_torch import model as M
    from emba_tpu_torch.kernels import a12_accum as K

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    sensor = synth.default_sensor(128, 128, f=128 * 0.9)
    B = synth.smooth_random_map(512, 1024, rng, smooth=4, amp=3.0)
    scene = synth.generate(rng, sensor, pano_width=1024, pano_height=512,
                           c_th=0.1, t_end=4.8, dt_knots=0.05, num_steps=600,
                           motion_amp=0.22, brightness=B)
    n = min(len(scene.t), 2_000_000)
    traj0 = _perturbed(scene.traj, 1, 0.01)
    cfg = M.ModelConfig(c_th=0.1, pano_width=1024, pano_height=512,
                        thres_valid_pixel=3, alpha=0.5, outlier_dp_norm=3.0)
    dev = _window(scene, traj0, n, torch.float32, device, sensor)
    knots0, Gx0, Gy0 = (torch.as_tensor(a).to(device=device, dtype=torch.float32)
                        for a in (traj0.knots, scene.gx, scene.gy))
    print(f"main: scene {len(scene.t)} events, window {int(dev.pol_signed.shape[0])} "
          f"events, {traj0.num_knots} knots, set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    _require(traj0.num_knots == 97, f"expected 97 knots, got {traj0.num_knots}")

    lm = solver.LMConfig(max_num_iter=8)
    # warm-up (CUDA context, cuBLAS / cuSOLVER handles), not counted
    solver.solve_window(knots0, Gx0, Gy0, dev, cfg, solver.LMConfig(max_num_iter=1),
                        fix_first=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    K.launches = 0
    knots, Gx, Gy, st = solver.solve_window(knots0, Gx0, Gy0, dev, cfg, lm,
                                            fix_first=True)
    torch.cuda.synchronize()
    launches = K.launches
    peak = torch.cuda.max_memory_allocated(device)

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
    print(f"main: peak device memory {peak / 2**30:.3f} GiB", flush=True)
    print(f"main: a12_accumulate launches {launches} == count_form {st.count_form}",
          flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from emba_tpu_torch.device import full_precision, require_cuda
    from emba_tpu_torch.kernels import _build

    device = require_cuda()
    full_precision()
    smi = _nvidia_smi()
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    lib = _build.build("a12_accum")
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    max_abs, k_ms, p_ms = phase_kernels(device)
    phase_reference(device)
    launches = phase_main(device)

    report = {"kernels": [{
        "name": "a12_accumulate",
        "route": "cuda",
        "source": "emba_tpu_torch/kernels/csrc/a12_accum.cu",
        "replaces": "emba_tpu/kernels/a12_accum.py:79",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
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
