#!/usr/bin/env python3
"""Smoke test of the emba_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own lines:

1. device: torch / CUDA versions and the card (``nvidia-smi``);
2. build: compiles the CUDA kernels from ``emba_tpu_torch/kernels/csrc``,
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
   its plain version, with the window's row and key occupancy; then the
   active-row Schur kernels (``schur_rows``) on that window's own system
   and row list, and on 64 of its listed rows, against f64 sums over the
   same rows and beside two planted faults (a dropped stage of 8 rows,
   TF32 products) that must fail the same limit; the loop's schur_rows
   launches are gated at two a solve, the fused window's (8) likewise;
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
    ``pipeline.CLASSIC_CAP_SMALL_ROWS`` is set;
12. the accuracy path and 4K panoramas, each path with the A12 launches
    counted from 0 and gated against its forming passes: (a) ``cli run
    --multi-start`` (fused) on phase 11's scene, each variant's data cost
    and iterations printed, the selected one the lowest, ``eval`` RMSE under
    half the initial; (b) ``eval_suite.run_sequence`` with multi-start on
    ``ecrot_street_like`` at the suite's settings, its row beside the
    TPU's, the RMSE falling; in (a) and (b) the A12 kernel is held against
    its plain version (exact) on the first forming pass of a coarse stage
    (a 512x256 panorama) and of a ``sample_mode="mid"`` variant; (c) ``bench.py``'s problem at a 4096x2048
    panorama, its first 2M and 4M events compacted to the automatic caps
    2^20 and 2^21: the compacted forming pass through the kernel against
    the plain version (every NormalEq field, dropped = 0 in both), the A12
    kernel's occupancy, times and bound at the compacted R_pad, the window
    fused and through the host loop (same steps, final costs within 1e-5,
    the cost falls), peak bytes per event, and the classic-window cap
    above 2^20 rows (``pipeline.CLASSIC_CAP_LARGE_ROWS``) from the 4M
    window; (d) the 1024x512 bench window at a cap of 2^18 (the
    uncompacted host loop's steps; in f32 the final cost within 1e-4, and
    the same pair with the plain forming pass printed beside it, its steps
    the same and each within 1e-4 of the kernel's run at its row space;
    within 1e-8 in f64 with the plain forming pass) and at an
    undersized cap of 32,768 (kernel and plain version agree, with equal
    ``dropped``); (e) light-trial LM on that window, fused and host,
    against the classic runs (same steps, final cost within 1e-5), its loop
    seconds beside theirs;
13. streamed forming (``stream_chunk``), map-only and the super-resolution
    map, each path with the A12 launches counted from 0 and gated against
    forming passes times chunks: (a) the bench window padded to four
    chunks of 2^19, the FULL and the LIGHT tier each fused and through the
    host loop (the classic host loop's steps, final cost within 1e-4 of
    classic, fused within 1e-5 of host, the cost falls), the A12 kernel
    against its plain version over a whole streamed forming pass (every
    NormalEq field) and as a chain of calls through ``carry`` (timed,
    beside its bound, which counts the rows each chained call touches),
    and the map-only step in f32 on the card against f64 on the CPU; (b)
    the suite row rendered over 6.4 s with every event kept (35-45M events
    in its whole-span window, above ``pipeline.CLASSIC_CAP_SMALL_ROWS``):
    ``cli run`` fused with no streaming flag, the plan streaming it in the
    FULL tier at 2^21 by itself, the cost falling, the A12 kernel against
    its plain version on its first streamed forming pass, its events/s and
    peak bytes; (c) phase 12c's render, its first 12M events at a cap of
    2^21 rows, streamed by the plan, fused and host alike; (d) ``cli run
    --super-res-height 2048`` on phase 11's scene: the four map files and
    super_res.json, the data cost falls, a second map-only step is a fixed
    point, a second call gives the same map;
14. the sharded window (``emba_tpu_torch.dist``), every rank's A12
    launches gated against its forming passes: (a) NCCL at world size 1
    in this process on the bench window (9 steps): the fused sharded
    window, its CUDA graphs capturing the NCCL collectives, and the
    host-driven sharded window, against ``solve_window_fused`` and the
    host loop (same steps, final cost within 1e-5; the bits compared and
    printed); (b) two ranks on the one card over gloo (tensors staged
    through the host), the same window at full width and row space: each
    rank's A12 kernel on its own first forming pass against its plain
    version, the seconds of that pass's reduce-scatter, the host-driven
    and the ``lm_while`` window against the single-device host loop, 4
    steps each (same steps, final cost within 1e-4), each rank's peak
    memory; (c) the
    sharded map-only step on those ranks against ``model.solve_map_only``
    (within 3e-5 on the pixels whose counts agree; two calls equal in
    bits); (d) ``cli run --num-devices 2 --dist-backend gloo`` on phase
    11's scene, fused and recording, on ranks that count their launches,
    against the same run on one device, all held to 16 steps (the same
    steps, final cost within 1e-3, rotation RMSE within 0.01 deg), then the
    two-rank run's mid-window checkpoint resumed on one device; (e)
    ``dist.dryrun``'s variants on (b)'s ranks: finite, cost falling, the
    ranks agreeing.

The kernels are built before any rank starts; a rank's failure fails the
script.

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
import tempfile
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
# The active-row Schur kernels (schur_rows) on the main window's own system
# against float64 sums over the same listed rows, as a fraction of the f64
# result's largest magnitude (x2: of each row's |M| (|b2| + |a| . |x|)). The
# kernel sums each split's rows in sequence in f32 (a few 1e-7 to 1e-6 of the
# largest at the cells' shapes, probes.schur_probe). Each case also runs two
# planted faults through the plain version in f32, which must read above it:
# one stage of 8 listed rows dropped (8 of the window's ~40k rows move S by
# ~1e-4 of its largest), and a TF32 product (operands rounded to 10 mantissa
# bits, as the tensor cores take them: ~5e-4 a term, which averages down as
# 1/sqrt(rows) in S, so S is also checked over 64 of the listed rows, and
# x2's dots of 288 terms read it directly).
SCHUR_REL_TOL = 1e-5
SCHUR_SHORT_ROWS = 64
# Published peaks of one NVIDIA H100 SXM at its 700 W limit (data sheet):
# device memory rate and f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def _bound(nbytes, flops):
    """(least ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def a12_bound(n, num_pix, dim_pose, order, carry=False, rows=None):
    """Bound of one a12_accumulate call: 3 int32 + 2D + 4 f32 read per
    measurement; D multiply-adds per A12 plane and half, 5 px5 terms and the
    (2D+1)^2 / 2 cells of A11/b1 a measurement. Without ``carry`` the call
    writes all of A12, px5 and a11b once. Under ``carry`` it reads and
    writes a11b and only the rows its measurements touch (the kernel leaves
    the other rows alone): ``rows``, the rows with a measurement of weight
    > 0 (all R_pad rows when not given), so a chunk of a streamed pass is
    bounded by its own rows, not by all of A12."""
    from emba_tpu_torch.kernels.a12_accum import padded_dims

    d = 3 * order
    r_pad, dp_pad = padded_dims(num_pix, dim_pose)
    a11b = 4 * (dp_pad + 8) * dp_pad
    if carry:
        out = 2 * (4 * (r_pad if rows is None else rows) * (2 * dp_pad + 8) + a11b)
    else:
        out = 4 * r_pad * (2 * dp_pad + 8) + a11b
    inputs = 4 * n * (3 + 2 * d + 4)
    flops = n * (2 * 4 * d + 2 * 5 + (2 * d + 1) * (2 * d + 2))
    return _bound(out + inputs, flops)


def touched_rows(rows, wA):
    """Rows with a measurement of weight > 0: what a call under ``carry``
    reads and writes."""
    import torch

    return int(torch.unique(rows[wA > 0]).numel())


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
                           carry=carry_args is not None,
                           rows=None if carry_args is None else touched_rows(args[0], args[8]))
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
    schur_launches = kernels.launch_counts()["schur_rows"]
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
    _require(schur_launches == 2 * st.count_solve,
             f"main: {schur_launches} schur_rows launches != 2 x {st.count_solve} solves")

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
    print(f"main: a12_accumulate launches {launches} == count_form {st.count_form}; "
          f"schur_rows launches {schur_launches} == 2 x count_solve {st.count_solve}",
          flush=True)
    return dict(dev=dev, cfg=cfg, start=(knots0, Gx0, Gy0), lm=lm, n=n,
                host=(knots, Gx, Gy, st), win=w["win"], sensor=w["sensor"],
                schur_launches=schur_launches)


def phase_window_kernel(ctx, name="real window", graphed=True, exact=True):
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
                             r_pad, knots, order, exact=exact, graphed=graphed)


def _tf32(t):
    """``t`` (f32) rounded to nearest at TF32's 10 mantissa bits."""
    import torch

    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _schur_f32(a12, rows, count, vecs, lo, hi, x, tf32):
    """S_red, rhs_red and x2 on the listed rows in f32 over those rows
    only, with the products' operands rounded to TF32 when ``tf32``: the
    planted fault of a tensor-core product."""
    import torch

    rnd = _tf32 if tf32 else (lambda t: t)
    n = int(count)
    r = rows[:n].long()
    dp = a12.shape[1] // 2
    cols = torch.arange(dp, device=a12.device)
    cm = ((cols >= lo) & (cols < hi)).float()
    g = a12[r]
    a, o = g[:, :dp] * cm, g[:, dp:] * cm
    m00, m01, m11, bx, by = (v[r] for v in vecs)
    ze = a * m00[:, None] + o * m01[:, None]
    zo = a * m01[:, None] + o * m11[:, None]
    S = rnd(a).T @ rnd(ze) + rnd(o).T @ rnd(zo)
    rhs = (m00 * bx + m01 * by) @ a + (m01 * bx + m11 * by) @ o
    vx, vy = bx - rnd(g[:, :dp]) @ rnd(x), by - rnd(g[:, dp:]) @ rnd(x)
    return S, rhs, torch.stack([m00 * vx + m01 * vy, m01 * vx + m11 * vy])


def phase_schur(ctx):
    """The active-row Schur kernels on the main window's own system at its
    start state (the first solve's inputs, lambda at its start): the window's
    own row list, and 64 of its rows from the middle of the list, each
    against float64 sums over the same rows (``probes.schur_probe``), with
    two planted faults through f32 beside the kernel (one stage of 8 rows
    dropped, TF32 products), which must read above SCHUR_REL_TOL; the plain
    version on the same f32 inputs; x2 exactly zero on every other row; two
    calls equal in bits. Times: the eager call, the plain version, a graph
    replay, and the bound of that count (the upper triangle of S over the
    live columns: 2 n c (c + 1) f32 operations). Returns the report entry."""
    import torch

    from emba_tpu_torch import lm
    from emba_tpu_torch import model as M
    from emba_tpu_torch.device import cuda_time_ms, graph_time_ms
    from emba_tpu_torch.kernels import schur_rows as SR
    from emba_tpu_torch.probes.schur_probe import listed_f64

    knots, Gx, Gy = ctx["start"]
    cfg = ctx["cfg"]
    lin = M.linearize(knots, Gx, Gy, ctx["dev"], cfg)
    neq = M.form_normal_eq(lin, Gx, Gy, cfg, knots.shape[0])
    del lin
    lam = lm.LAMBDA_INIT
    x1, _ = M.solve_normal_eq(neq, lam, True)
    dim, dp = neq.b1.shape[0], neq.A12.shape[1] // 2
    lo = 3  # fix_first, as every window of the port is solved
    m00, m01, m11, live = M._damped_a22_inv(neq, lam)
    rows, count = SR.row_list(live)
    a12 = neq.A12.contiguous()
    vecs = (m00, m01, m11, neq.b2_x.contiguous(), neq.b2_y.contiguous())
    x = torch.zeros(dp, device=a12.device)
    x[lo:dim] = x1[lo:]
    n = int(count)
    _require(n > 2 * SCHUR_SHORT_ROWS, f"schur: {n} listed rows")
    mid = torch.roll(rows, -(n // 2))  # the list from its middle on
    short = torch.tensor(SCHUR_SHORT_ROWS, dtype=torch.int32, device=a12.device)
    stage = rows[n // 2:n // 2 + 8].long()
    dropped = tuple(v.clone() for v in vecs)
    for v in dropped[:3]:
        v[stage] = 0.0

    def errs(S, rhs, x2, want):
        Sd, rhsd, x2d, x2s = want
        return dict(S=float((S.double() - Sd).abs().max() / Sd.abs().max()),
                    rhs=float((rhs.double() - rhsd).abs().max() / rhsd.abs().max()),
                    x2=float(((x2.double() - x2d).abs() / x2s.clamp(min=1e-30)).max()))

    out = {}
    for case, rl, c in (("window", rows, count), ("64 rows", mid, short)):
        S, rhs = SR.schur_reduce(a12, rl, c, *vecs, lo, dim)
        S2, rhs2 = SR.schur_reduce(a12, rl, c, *vecs, lo, dim)
        x2 = SR.back_substitute(a12, rl, c, *vecs, x)
        x2b = SR.back_substitute(a12, rl, c, *vecs, x)
        Sp, rhsp = SR.schur_reduce_plain(a12, rl, c, *vecs, lo, dim)
        x2p = SR.back_substitute_plain(a12, rl, c, *vecs, x)
        torch.cuda.synchronize()
        Sd, rhsd, x2d, x2s, r = listed_f64(neq, rl, c, vecs, lo, dim, x)
        want = (Sd, rhsd, x2d, x2s)
        others = torch.ones(a12.shape[0], dtype=torch.bool, device=a12.device)
        others[r] = False
        got = errs(S, rhs, x2[:, r], want)
        plain = errs(Sp, rhsp, x2p[:, r], want)
        tf32 = errs(*_schur_f32(a12, rl, c, vecs, lo, dim, x, True), want)
        drop = errs(*_schur_f32(a12, rl, c, dropped, lo, dim, x, False), want)
        print(f"schur {case} ({int(c)} of {a12.shape[0]} rows, dp_pad {dp}, columns "
              f"[{lo}, {dim})) against f64: kernel {json.dumps(got)}; plain "
              f"{json.dumps(plain)}; planted TF32 {json.dumps(tf32)}; planted stage "
              f"dropped {json.dumps(drop)}", flush=True)
        _require(torch.equal(S, S2) and torch.equal(rhs, rhs2) and torch.equal(x2, x2b),
                 f"schur {case}: two calls differ")
        _require(torch.equal(S, S.T), f"schur {case}: S not exactly symmetric")
        _require(bool((x2[:, others] == 0).all()), f"schur {case}: x2 nonzero off the list")
        for k in ("S", "rhs", "x2"):
            _require(got[k] <= SCHUR_REL_TOL and plain[k] <= SCHUR_REL_TOL,
                     f"schur {case}: {k} kernel {got[k]:.2e}, plain {plain[k]:.2e} > "
                     f"{SCHUR_REL_TOL:.0e}")
        _require(drop["S"] > SCHUR_REL_TOL,
                 f"schur {case}: a dropped stage reads {drop['S']:.2e}, not above the limit")
        if case != "window":
            _require(tf32["S"] > SCHUR_REL_TOL,
                     f"schur {case}: TF32 products read {tf32['S']:.2e} in S, not above "
                     "the limit")
        _require(tf32["x2"] > SCHUR_REL_TOL,
                 f"schur {case}: TF32 products read {tf32['x2']:.2e} in x2, not above "
                 "the limit")
        out[case] = dict(kernel=got, plain=plain, tf32=tf32, dropped=drop)
        del Sd, rhsd, x2d, x2s, r, others

    c = dim - lo
    ms = cuda_time_ms(lambda: SR.schur_reduce(a12, rows, count, *vecs, lo, dim))
    graph_ms = graph_time_ms(lambda: SR.schur_reduce(a12, rows, count, *vecs, lo, dim))
    plain_ms = cuda_time_ms(lambda: SR.schur_reduce_plain(a12, rows, count, *vecs, lo, dim))
    back_ms = graph_time_ms(lambda: SR.back_substitute(a12, rows, count, *vecs, x))
    bound_ms = _bound(8 * n * dp, 2.0 * n * c * (c + 1))
    print(f"schur window: schur_reduce {ms:.3f} ms eager, graph {graph_ms:.3f}, plain "
          f"{plain_ms:.3f}; bound {bound_ms[0]:.3f} ms ({bound_ms[1]}; operations 2 n c (c + 1), n "
          f"{n}, c {c}), share of bound {bound_ms[0] / graph_ms:.3f} graph; "
          f"back_substitute graph {back_ms:.3f} ms", flush=True)
    return dict(max_rel_err=max(v for e in out.values() for k in ("kernel", "plain")
                                for v in e[k].values()),
                ms=ms, plain_ms=plain_ms, graph_ms=graph_ms, bound_ms=bound_ms[0],
                bound_by=bound_ms[1], back_graph_ms=back_ms, listed_rows=n,
                rows=a12.shape[0], errors=out)


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
    for bit. Returns the a12 kernel launches of the second call, its outputs
    and its schur_rows launches."""
    import torch

    from emba_tpu_torch import kernels, lm

    first = _fused(ctx)
    (k, gx, gy, cost, it, conv, trace), st, launches, peak, wall = _fused(ctx)
    schur_launches = kernels.launch_counts()["schur_rows"]  # counted from 0 in _fused
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
    print(f"fused: schur_rows launches {schur_launches} == 2 x {st.replays['solve']} "
          "solve replays", flush=True)
    _require(schur_launches == 2 * st.replays["solve"],
             f"fused: {schur_launches} schur_rows launches != 2 x "
             f"{st.replays['solve']} solve replays")
    return launches, (k, gx, gy, cost, it, conv, trace), schur_launches


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


def _cli_run(name, argv, chunks=1):
    """One ``cli.main(["run", ...])`` on the card
    (``probes.suite_run.measured_run``: graph and allocator caches emptied,
    peaks reset, A12 launches counted from 0). Prints the run's windows,
    iterations, events/s, wall, per-window set-up, peak memory and launches
    against forming passes (times ``chunks``, a streamed window's chunks a
    pass; None: the caller gates the launches); gates launches, costs and
    finiteness. Returns (RunResult, summary dict)."""
    from emba_tpu_torch.probes.suite_run import measured_run

    res, summary = measured_run(argv)
    print(f"pipeline {name}: " + json.dumps(summary), flush=True)
    launches, forms = summary["a12_launches"], summary["forming_passes"]
    stats = res.window_stats
    _require(chunks is None or launches == forms * chunks,
             f"pipeline {name}: {launches} A12 launches != {forms} forming passes x "
             f"{chunks}")
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
    every solve of the windows whose ids are in ``keep``, in call order (a
    coarse stage and each multi-start variant is a solve of its own):
    {win_id: [{"dev", "cfg", "state"}, ...]}, the device window as
    uploaded, the model configuration and the arguments from which the
    solve converts its start state (its maps, the pipeline's or a coarse
    stage's, as host arrays, so that the run's device memory stays as it
    was)."""
    from emba_tpu_torch import pipeline

    got = {}
    solve = pipeline.EmbaPipeline._solve

    def recording(self, win_id, num_events, seg_knots, dev, mcfg, *rest, **kw):
        if win_id in keep:
            gx, gy = kw.get("maps") or (self.gx, self.gy)
            got.setdefault(win_id, []).append(dict(dev=dev, cfg=mcfg, state=(
                np.array(seg_knots), np.array(gx), np.array(gy), self.dtype,
                self.device)))
        return solve(self, win_id, num_events, seg_knots, dev, mcfg, *rest, **kw)

    pipeline.EmbaPipeline._solve = recording
    try:
        yield got
    finally:
        pipeline.EmbaPipeline._solve = solve


def _pipeline_window_kernel(name, solve):
    """The A12 kernel on the first forming pass of a pipeline window's
    solve (one entry that :func:`_window_inputs` recorded), exact, against
    its plain version. Returns the case's numbers."""
    import torch

    from emba_tpu_torch import convert

    ctx = dict(solve, start=convert.state_from_numpy(*solve["state"]))
    case = phase_window_kernel(ctx, name=name, graphed=False)
    del ctx
    torch.cuda.empty_cache()
    return case


def _coarse_and_mid(solves):
    """Of a multi-start window's recorded solves (in the order of
    pipeline.MULTI_START), the first coarse stage (a half-resolution
    panorama) and the first ``sample_mode="mid"`` solve at full
    resolution."""
    full = max(c["cfg"].pano_height for c in solves)
    coarse = [c for c in solves if c["cfg"].pano_height < full]
    mid = [c for c in solves if c["cfg"].pano_height == full and c["cfg"].sample_mode == "mid"]
    _require(coarse and mid, "multi-start: no coarse stage or no mid variant was solved")
    return coarse[0], mid[0]


def _accepts(stats):
    return "".join("A" if r["cost_new"] < r["cost_min"] else "r" for r in stats.iterations)


def phase_pipeline(device, d):
    """The port's CLI on the suite row (see the module docstring, phase 11),
    its scene files written into ``d``. Returns ({run: A12 launches}, the
    largest absolute error of the A12 kernel against its plain version on
    the recorded windows, the scene's {file: path}, run 3's initial and
    refined RMSE)."""
    import torch

    from emba_tpu_torch import cli, recon, spline
    from emba_tpu_torch import io as eio
    from emba_tpu_torch.pipeline import CLASSIC_CAP_SMALL_ROWS
    from emba_tpu_torch.probes.suite_run import (CAP_MEMORY_SHARE, CARD_BYTES, cap_from,
                                                 suite_argv, write_suite_scene)

    t0 = time.perf_counter()
    n_scene, n_kept, p = write_suite_scene(d)
    print(f"pipeline: suite row ecrot_bicycle_like, {n_scene} events rendered, "
          f"{n_kept} kept; scene files in {time.perf_counter() - t0:.1f} s",
          flush=True)
    argv = suite_argv(p)

    with _window_inputs({0}) as windows:
        fused, s1 = _cli_run("run 1 (fused, whole span)", argv)
    st1 = fused.window_stats[0]
    cases = [_pipeline_window_kernel("pipeline run 1 window 0", windows.pop(0)[0])]
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
    cases.append(_pipeline_window_kernel("pipeline run 4 window 2", windows.pop(2)[0]))
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
    return launches, max(c[0] for c in cases), p, (r0, r1)


# ---------------------------------------------------------------------------
# Phase 12: the accuracy path and 4K panoramas.
# ---------------------------------------------------------------------------

# 12c: the 4096x2048 bench windows and their compaction caps
# (pipeline.auto_compact_cap(8_388_608, n, 3)).
PANO_4K_HEIGHT = 2048
WINDOWS_4K = (2_000_000, 4_000_000)
# 12d: caps of the 1024x512 bench window: above its ~41.6k active rows, and
# under them (the CPU tests hold caps that are not a multiple of 512)
CAP_ABOVE, CAP_UNDER = 1 << 18, 32_768
# 12d, f32 windows that sum in other orders: compacted against
# uncompacted (the Schur GEMMs run over 2^18 or 2^19 rows), the kernel
# against the plain forming pass. On an NVIDIA H100 80GB HBM3, 700 W, the
# final cost after 9 steps moved 2.53e-5 between the kernel's two row
# spaces, 5.73e-5 between the plain version's, and 3.96e-5 and 4.30e-5
# between kernel and plain at one row space: f32 rounding, which the LM
# steps carry into the cost, whatever sums. In f64 (the plain forming
# pass) that rounding is 2^29 times smaller; 1e-8 is the f64 window
# tolerance of the CPU parity tests.
COMPACT_F32_REL_TOL = 1e-4
COMPACT_F64_REL_TOL = 1e-8
# 12b: ecrot_street_like through eval_suite, as scripts/r5_suite.py ran it
SUITE_ROW_KW = dict(pano_height=512, sensor=240, sensor_h=180, c_th=0.2,
                    perturb=0.005, num_steps=1500, max_iter=50)
# that row's multi-start result on the TPU (docs/suite_table_ecrot_r5.md)
SUITE_ROW_TPU = "1.54 -> 0.27 deg, selected curr+c2f"


@contextlib.contextmanager
def _plain_forming():
    """Within the scope, the forming pass runs the A12 kernel's plain
    version on the same device tensors (no launch is counted)."""
    from emba_tpu_torch.kernels import a12_accum

    kernel = a12_accum.a12_accumulate
    a12_accum.a12_accumulate = a12_accum.a12_accumulate_plain
    try:
        yield
    finally:
        a12_accum.a12_accumulate = kernel


def check_forming(name, ctx):
    """The window's first forming pass at its start state through the A12
    kernel and through its plain version on the same inputs: every
    NormalEq field within KERNEL_REL_TOL of the plain one, the row space,
    the active count and ``dropped`` equal. The pass is the window's mode's
    (``model.window_mode``): a streamed window (``cfg.stream_chunk``)
    chains every chunk's call through ``carry`` in both. Returns (max abs
    err, dropped, active count, R_pad)."""
    import torch

    from emba_tpu_torch import model as M

    knots, Gx, Gy = ctx["start"]
    mode = M.window_mode(ctx["dev"], ctx["cfg"])
    aux = mode.objective(knots, Gx, Gy)[0]
    got = mode.form(aux, knots, Gx, Gy)
    with _plain_forming():
        want = mode.form(aux, knots, Gx, Gy)
    torch.cuda.synchronize()
    del aux, mode
    max_abs, parts = 0.0, []
    for f in ("A11", "b1", "a22_xx", "a22_xy", "a22_yy", "b2_x", "b2_y", "A12"):
        g, w = getattr(got, f), getattr(want, f)
        _require(torch.isfinite(g).all().item(), f"{name}: {f} not finite")
        rel = _rel(g, w)
        _require(rel <= KERNEL_REL_TOL, f"{name}: {f} rel err {rel:.3e} > {KERNEL_REL_TOL:.0e}")
        max_abs = max(max_abs, float(torch.max(torch.abs(g - w))))
        parts.append(f"{f} {rel:.2e}")
    for f in ("active", "pix2row", "active_pix"):
        _require(torch.equal(getattr(got, f), getattr(want, f)), f"{name}: {f} differs")
    dropped = (int(got.dropped), int(want.dropped))
    active = (int(got.active_count), int(want.active_count))
    r_pad = got.A12.shape[0]
    print(f"{name}: form_normal_eq through the kernel vs the plain version: rel "
          + ", ".join(parts) + f"; R_pad {r_pad}; active pixels {active[0]} "
          f"(plain {active[1]}); dropped {dropped[0]} (plain {dropped[1]})", flush=True)
    _require(dropped[0] == dropped[1] and active[0] == active[1],
             f"{name}: dropped or active counts differ {dropped} {active}")
    return max_abs, dropped[0], active[0], r_pad


def _peak_bytes():
    """Free the graph and allocator caches and reset the peaks; returns a
    function giving (peak allocated, peak reserved) bytes since."""
    import torch

    from emba_tpu_torch import solver

    solver._GRAPHED.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return lambda: (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())


def _final_cost(st):
    """The lowest cost a host loop's records reach."""
    return min([r["cost_min"] for r in st.iterations] + [r["cost_new"] for r in st.iterations])


def _loops_agree(name, fused_out, loop, launches_fused, host, launches_host, chunks=1):
    """Gates of a window run fused and through the host loop: the same
    iterations and accepts, final costs within FUSED_COST_REL_TOL, the cost
    falls, no NaN, no measurement dropped, A12 launches = forming passes
    times ``chunks`` (a streamed window's chunks a pass). Returns the fused
    final cost."""
    from emba_tpu_torch import lm

    k, gx, gy, cost, it, conv, trace = fused_out
    _finite(name, (k, gx, gy))
    recs = lm.trace_records(trace.cpu().double().numpy(), int(it))
    k_h, gx_h, gy_h, st = host
    _finite(f"{name} host", (k_h, gx_h, gy_h))
    host_cost = _final_cost(st)
    rel = abs(float(cost) - host_cost) / abs(host_cost)
    acc_f = "".join("A" if r["accepted"] else "r" for r in recs)
    acc_h = _accepts(st)
    cost0 = st.iterations[0]["cost_min"]
    dropped = [r["dropped"] for r in recs] + st.dropped_meas_per_form
    print(f"{name}: fused {int(it)} iterations {acc_f}, host {len(st.iterations)} "
          f"{acc_h}; cost {cost0:.6g} -> fused {float(cost):.6g}, host {host_cost:.6g} "
          f"(rel {rel:.2e}); A12 launches fused {launches_fused} = {loop.form_passes} "
          f"forming passes x {chunks}, host {launches_host} = {st.count_form} x "
          f"{chunks}; dropped {max(dropped)}", flush=True)
    _require(int(it) == len(st.iterations) and acc_f == acc_h,
             f"{name}: the fused and the host loop took other steps")
    _require(rel <= FUSED_COST_REL_TOL, f"{name}: final cost rel {rel:.2e}")
    _require(float(cost) < cost0, f"{name}: the cost did not fall")
    _require(max(dropped) == 0, f"{name}: measurements dropped past the cap")
    _require(launches_fused == loop.form_passes * chunks
             and launches_host == st.count_form * chunks,
             f"{name}: A12 launches != forming passes x {chunks}")
    return float(cost)


def _fused_and_host(name, ctx, iters=MAIN_ITERS, chunks=1):
    """A window run fused (from an empty graph cache) and then through the
    host loop, each with the A12 launches counted from 0 and the device's
    peaks reset; gated by :func:`_loops_agree` (``chunks``: the forming
    pass's A12 calls). Returns {"fused", "host"}: each (loop seconds,
    set-up seconds, peak allocated, peak reserved, A12 launches, final
    cost), and the host loop's LMStats under "host_stats"."""
    import torch

    from emba_tpu_torch import kernels, lm, solver

    out = {}
    peaks = _peak_bytes()
    kernels.reset_launch_counts()
    loop = lm.LoopStats()
    fused = solver.solve_window_fused(
        *ctx["start"], ctx["dev"], ctx["cfg"], 1.0, 0.0, fix_first=True,
        max_num_iter=iters, return_trace=True, stats=loop)
    torch.cuda.synchronize()
    launches_f = kernels.launch_counts()["a12_accum"]
    out["fused"] = (loop.loop_s, loop.setup_s, *peaks(), launches_f)
    peaks = _peak_bytes()
    kernels.reset_launch_counts()
    host = solver.solve_window(*ctx["start"], ctx["dev"], ctx["cfg"],
                               solver.LMConfig(max_num_iter=iters, tol_fun=0.0),
                               fix_first=True)
    torch.cuda.synchronize()
    launches_h = kernels.launch_counts()["a12_accum"]
    out["host"] = (host[3].time_total_s, 0.0, *peaks(), launches_h, _final_cost(host[3]))
    out["fused"] += (_loops_agree(name, fused, loop, launches_f, host, launches_h, chunks),)
    out["host_stats"] = host[3]
    del fused, host
    solver._GRAPHED.clear()
    torch.cuda.empty_cache()
    return out


def phase_multi_start(p, rmse_run3):
    """12a: ``cli run --multi-start`` (fused) on phase 11's suite row; the
    A12 kernel held against its plain version on the first forming pass of
    a coarse stage and of a ``mid`` variant. Returns (A12 launches, the
    kernel's largest absolute error)."""
    from emba_tpu_torch import cli
    from emba_tpu_torch.probes.suite_run import suite_argv

    with _window_inputs({0}) as windows:
        res, s = _cli_run("12a (multi-start, fused, whole span)",
                          suite_argv(p) + ["--multi-start"])
    solves = windows.pop(0)
    coarse, mid = _coarse_and_mid(solves)
    del solves
    err = max(_pipeline_window_kernel("12a coarse stage", coarse)[0],
              _pipeline_window_kernel("12a mid variant", mid)[0])
    del coarse, mid
    st = res.window_stats[0]
    sel = st.lm_mode.split("+multistart:")[-1]
    costs = {v["variant"]: v["data_cost"] for v in st.variants}
    for v in st.variants:
        print(f"12a variant {v['variant']}: data cost {v['data_cost']:.6g}, "
              f"{v['iterations']} iterations (+{v['coarse_iterations']} coarse), "
              f"solve {v['time_total_s']:.4f} s of which set-up {v['setup_s']:.4f} s",
              flush=True)
    path = os.path.join(os.path.dirname(p["events.npz"]), "multistart.txt")
    res.trajectory.write_tum(path)
    r = cli.main(["eval", "--traj", path, "--gt", p["traj_gt.txt"]])["rotation_rmse_deg"]
    r0, r1 = rmse_run3
    setup, total = sum(s["setup_s"]), sum(s["window_s"])
    print(f"12a: selected {sel} ({st.lm_mode}); set-up {setup:.4f} s, loop "
          f"{total - setup:.4f} s over {st.count_objective} objectives and "
          f"{st.count_form} forming passes of the four variants; CLI call "
          f"{s['wall_s']:.4f} s; rotation RMSE {r0:.4f} -> {r:.4f} deg (phase 11 run 1, "
          f"one variant: {r1:.4f})", flush=True)
    _require(len(costs) == 4 and sel in costs, f"12a: variants {list(costs)}, {sel}")
    _require(costs[sel] == min(costs.values()),
             f"12a: the selected {sel} has not the lowest data cost {costs}")
    _require(np.isfinite(r) and r < 0.5 * r0,
             f"12a: refined RMSE {r:.4f} not under half the initial {r0:.4f}")
    return s["a12_launches"], err


@contextlib.contextmanager
def _suite_solves():
    """Within the scope, every ``solver.solve_window`` call (each solve of
    an eval_suite row) records {"dev", "cfg", "start", "stats"}: its device
    window, model configuration, a copy of its start state and its
    LMStats, in call order."""
    from emba_tpu_torch import solver

    got = []
    solve = solver.solve_window

    def recording(knots, gx, gy, dev, cfg, *rest, **kw):
        start = tuple(t.clone() for t in (knots, gx, gy))
        out = solve(knots, gx, gy, dev, cfg, *rest, **kw)
        got.append(dict(dev=dev, cfg=cfg, start=start, stats=out[3]))
        return out

    solver.solve_window = recording
    try:
        yield got
    finally:
        solver.solve_window = solve


def phase_suite_row():
    """12b: eval_suite.run_sequence, multi-start, on ecrot_street_like; its
    A12 launches against the forming passes of all its solves, and the
    kernel against its plain version on the first forming pass of a coarse
    stage and of a ``mid`` variant. Returns (A12 launches, the kernel's
    largest absolute error)."""
    import torch

    from emba_tpu_torch import eval_suite, kernels

    name = "ecrot_street_like"
    kernels.reset_launch_counts()
    with _suite_solves() as solves:
        row = eval_suite.run_sequence(name, *eval_suite.ECROT_LIKE[name], **SUITE_ROW_KW,
                                      multi_start=True)
    launches = kernels.launch_counts()["a12_accum"]
    forms = sum(c.pop("stats").count_form for c in solves)
    coarse, mid = _coarse_and_mid(solves)
    del solves
    err = max(phase_window_kernel(coarse, name="12b coarse stage", graphed=False)[0],
              phase_window_kernel(mid, name="12b mid variant", graphed=False)[0])
    del coarse, mid
    torch.cuda.empty_cache()
    print(f"12b {name}: " + json.dumps(row), flush=True)
    print(f"12b {name}: rotation RMSE {row['rmse_init_deg']:.4f} -> "
          f"{row['rmse_refined_deg']:.4f} deg, selected {row['selected_variant']}, "
          f"{row['lm_iterations']} LM iterations in {row['wall_s']:.2f} s, A12 launches "
          f"{launches} = {forms} forming passes; the TPU's row (emba_tpu): "
          f"{SUITE_ROW_TPU}", flush=True)
    _require(np.isfinite(row["rmse_refined_deg"])
             and row["rmse_refined_deg"] < row["rmse_init_deg"],
             f"12b: RMSE did not fall ({row['rmse_init_deg']} -> {row['rmse_refined_deg']})")
    _require(row["selected_variant"] in ("curr", "mid", "curr+c2f", "mid+c2f"),
             f"12b: selected {row['selected_variant']}")
    _require(launches == forms > 0,
             f"12b: {launches} A12 launches != {forms} forming passes")
    return launches, err


def phase_4k(device):
    """12c: the 4096x2048 bench problem, two compacted windows. Returns
    (A12 launches {window: (fused, host)}, max abs err, the 4M window's
    kernel case, the cap from its bytes an event, (scene, start, sensor)
    for phase 13c)."""
    from emba_tpu_torch.pipeline import CLASSIC_CAP_LARGE_ROWS, auto_compact_cap
    from emba_tpu_torch.probes.profile_fused import bench_scene, bench_window
    from emba_tpu_torch.probes.suite_run import CAP_MEMORY_SHARE, CARD_BYTES, cap_from

    t0 = time.perf_counter()
    scene, traj0, sensor = bench_scene(PANO_4K_HEIGHT)
    hw = scene.gx.size
    print(f"12c: the bench scene at {scene.gx.shape[1]}x{scene.gx.shape[0]}: "
          f"{len(scene.t)} events rendered in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _require(len(scene.t) >= max(WINDOWS_4K),
             f"12c: the render holds {len(scene.t)} events, fewer than {max(WINDOWS_4K)}")
    launches, err, case, per_ev = {}, 0.0, None, {}
    for n in WINDOWS_4K:
        cap = auto_compact_cap(hw, n, 3)
        _require(cap is not None, f"12c: no compaction for {n} events")
        ctx = bench_window(scene, traj0, sensor, n, device, compact_cap=cap)
        name = f"12c {n} events cap {cap}"
        e, dropped, active, r_pad = check_forming(name, ctx)
        _require(dropped == 0, f"{name}: {dropped} measurements dropped")
        c = phase_window_kernel(ctx, name=f"{name} first forming pass", graphed=True,
                                exact=False)
        runs = _fused_and_host(name, ctx)
        for mode in ("fused", "host"):
            loop_s, setup_s, pa, pr, nl, _c = runs[mode]
            print(f"{name} {mode}: loop {loop_s:.4f} s, set-up {setup_s:.4f} s; peak "
                  f"{pa / 1e9:.3f} GB allocated, {pr / 1e9:.3f} GB reserved: {pa / n:.1f} / "
                  f"{pr / n:.1f} bytes an event; A12 launches {nl}", flush=True)
        launches[n] = (runs["fused"][4], runs["host"][4])
        per_ev[n] = max(runs["fused"][3], runs["host"][3]) / n
        err = max(err, e, c[0])
        case = c
        del ctx
    big = max(WINDOWS_4K)
    print(f"12c: classic-window cap above 2^20 rows from the {big}-event window: "
          f"{cap_from(per_ev[big])} events ({CAP_MEMORY_SHARE} x {CARD_BYTES:.0f} bytes / "
          f"{per_ev[big]:.1f} bytes an event reserved, the larger of fused and host); "
          f"pipeline.CLASSIC_CAP_LARGE_ROWS {CLASSIC_CAP_LARGE_ROWS}", flush=True)
    return launches, err, case, cap_from(per_ev[big]), (scene, traj0, sensor)


def _f64_window(ctx):
    """``ctx``'s window and start state in f64 on the same device."""
    import torch

    dev = ctx["dev"]
    dev64 = dataclasses.replace(dev, **{
        f.name: getattr(dev, f.name).double() for f in dataclasses.fields(dev)
        if getattr(dev, f.name) is not None and getattr(dev, f.name).is_floating_point()})
    return dict(ctx, dev=dev64, start=tuple(t.to(torch.float64) for t in ctx["start"]))


def phase_compact_1k(ctx):
    """12d: the 1024x512 bench window compacted. At a cap above its active
    pixels: in f32 through the kernel, the uncompacted host loop's steps
    (the final cost to COMPACT_F32_REL_TOL); the same two f32 windows with
    the plain forming pass, the same steps and each final cost to
    COMPACT_F32_REL_TOL of the kernel's at its row space; in f64 with the
    plain forming pass, compacted against uncompacted, the same steps and
    the final cost to COMPACT_F64_REL_TOL. At an undersized cap: the kernel
    and the plain version form alike and drop alike. Returns (A12
    launches, max abs err)."""
    import torch

    from emba_tpu_torch import kernels, solver

    cfg = dataclasses.replace(ctx["cfg"], compact_cap=CAP_ABOVE)
    kernels.reset_launch_counts()
    k, gx, gy, st = solver.solve_window(*ctx["start"], ctx["dev"], cfg, ctx["lm"],
                                        fix_first=True)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["a12_accum"]
    _finite("12d", (k, gx, gy))
    ref = ctx["host"][3]
    c_ref, c_got = _final_cost(ref), _final_cost(st)
    rel = abs(c_got - c_ref) / abs(c_ref)
    print(f"12d cap {CAP_ABOVE}, f32: {len(st.iterations)} iterations {_accepts(st)} vs "
          f"uncompacted {len(ref.iterations)} {_accepts(ref)}; final cost {c_got:.6f} vs "
          f"{c_ref:.6f} (rel {rel:.2e}); active pixels per form "
          f"{st.active_px_per_form}; dropped {st.dropped_meas_per_form}; loop "
          f"{st.time_total_s:.4f} s vs uncompacted {ref.time_total_s:.4f} s; A12 launches "
          f"{launches} = {st.count_form} forming passes", flush=True)
    _require(len(st.iterations) == len(ref.iterations) and _accepts(st) == _accepts(ref),
             "12d: the compacted window took other steps than the uncompacted one")
    _require(rel <= COMPACT_F32_REL_TOL, f"12d: f32 final cost rel {rel:.2e}")
    _require(launches == st.count_form, "12d: A12 launches != forming passes")
    _require(max(st.dropped_meas_per_form) == 0, "12d: dropped measurements")
    del k, gx, gy

    # the same two f32 windows with the plain forming pass: what the row
    # space moves without the kernel, and what the kernel moves at each row
    # space (f32 rounding either way: see COMPACT_F32_REL_TOL)
    with _plain_forming():
        plain = [solver.solve_window(*ctx["start"], ctx["dev"], c, ctx["lm"],
                                     fix_first=True)[3] for c in (ctx["cfg"], cfg)]
    torch.cuda.synchronize()
    p0, p1 = _final_cost(plain[0]), _final_cost(plain[1])
    rel_plain = abs(p1 - p0) / abs(p0)
    rel_k = (abs(c_ref - p0) / abs(p0), abs(c_got - p1) / abs(p1))
    print(f"12d cap {CAP_ABOVE}, f32 with the plain forming pass: {_accepts(plain[1])} vs "
          f"uncompacted {_accepts(plain[0])}; final cost {p1:.6f} vs {p0:.6f} (rel "
          f"{rel_plain:.2e}, the kernel's pair {rel:.2e}); kernel against plain at the "
          f"same row space: uncompacted rel {rel_k[0]:.2e}, compacted {rel_k[1]:.2e}",
          flush=True)
    _require(all(_accepts(r) == _accepts(ref) for r in plain),
             "12d: the plain f32 windows took other steps than the kernel's")
    _require(max(rel_k) <= COMPACT_F32_REL_TOL,
             f"12d: f32 final cost of the kernel against the plain forming pass at the "
             f"same row space rel {max(rel_k):.2e} > {COMPACT_F32_REL_TOL:.0e}")
    del plain

    w64 = _f64_window(ctx)
    with _plain_forming():
        runs = [solver.solve_window(*w64["start"], w64["dev"], c, ctx["lm"],
                                    fix_first=True)[3] for c in (ctx["cfg"], cfg)]
    torch.cuda.synchronize()
    c0, c1 = _final_cost(runs[0]), _final_cost(runs[1])
    rel64 = abs(c1 - c0) / abs(c0)
    print(f"12d cap {CAP_ABOVE}, f64 with the plain forming pass: {_accepts(runs[1])} vs "
          f"uncompacted {_accepts(runs[0])}; final cost {c1:.9f} vs {c0:.9f} (rel "
          f"{rel64:.2e}); the f32 runs' costs against these: uncompacted "
          f"{abs(c_ref - c0) / c0:.2e}, compacted {abs(c_got - c1) / c1:.2e}", flush=True)
    _require(_accepts(runs[0]) == _accepts(runs[1]) and rel64 <= COMPACT_F64_REL_TOL,
             f"12d: f64 compacted run differs from the uncompacted one (rel {rel64:.2e})")
    del w64, runs

    under = dict(ctx, cfg=dataclasses.replace(ctx["cfg"], compact_cap=CAP_UNDER))
    e, dropped, active, _r = check_forming(f"12d undersized cap {CAP_UNDER}", under)
    _require(dropped > 0 and active > CAP_UNDER,
             f"12d: the cap {CAP_UNDER} dropped nothing ({active} active)")
    c = phase_window_kernel(under, name=f"12d undersized cap {CAP_UNDER}", graphed=False,
                            exact=False)
    return launches, max(e, c[0])


def phase_light(ctx):
    """12e: light-trial LM on the 1024x512 bench window, fused and host,
    against the classic runs. Returns ({run: A12 launches}, loop seconds
    {classic, light})."""
    import torch

    from emba_tpu_torch import kernels, solver

    light = dict(ctx, cfg=dataclasses.replace(ctx["cfg"], light_trial=True))
    _fused(ctx)  # captures the classic graphs
    classic = _fused(ctx)
    _fused(light)  # captures the light graphs
    (k, gx, gy, cost, it, conv, trace), st, launches, peak, wall = _fused(light)
    _finite("12e fused", (k, gx, gy))
    kernels.reset_launch_counts()
    host = solver.solve_window(*ctx["start"], ctx["dev"], light["cfg"], ctx["lm"],
                               fix_first=True)
    torch.cuda.synchronize()
    launches_h = kernels.launch_counts()["a12_accum"]
    ref = ctx["host"][3]
    _loops_agree("12e light trial", (k, gx, gy, cost, it, conv, trace), st, launches,
                 host, launches_h)
    c_ref = _final_cost(ref)
    rel = abs(float(cost) - c_ref) / abs(c_ref)
    loops = {"classic": classic[1].loop_s, "light": st.loop_s}
    print(f"12e: light trial vs classic: {int(it)} vs {len(ref.iterations)} iterations, "
          f"{_accepts(host[3])} vs {_accepts(ref)}; final cost rel {rel:.2e}; fused loop "
          f"{st.loop_s:.4f} s vs classic {classic[1].loop_s:.4f} s; host loop "
          f"{host[3].time_total_s:.4f} s (objective {host[3].time_objective_s:.4f}, form "
          f"{host[3].time_form_s:.4f}) vs classic {ref.time_total_s:.4f} s (objective "
          f"{ref.time_objective_s:.4f}, form {ref.time_form_s:.4f}); peak {peak}",
          flush=True)
    _require(int(it) == len(ref.iterations) and _accepts(host[3]) == _accepts(ref),
             "12e: the light trial took other steps than the classic loop")
    _require(rel <= FUSED_COST_REL_TOL, f"12e: final cost rel {rel:.2e} against classic")
    return {"fused": launches, "host": launches_h}, loops



# ---------------------------------------------------------------------------
# Phase 13: streamed forming, map-only and the super-resolution map.
# ---------------------------------------------------------------------------

# 13a: the bench window in four chunks (2,000,000 events padded to 2^21)
STREAM_CHUNK_13A = 1 << 19
# A streamed window against the classic one in f32: the chunked forming
# pass sums in another order, which moves the final cost after 9 steps by
# f32 rounding (2.5-5.7e-5 for any change of summation order, 12d above).
STREAM_F32_REL_TOL = 1e-4
# The map-only map in f32 on the card against f64 on the CPU, as a fraction
# of the f64 map's largest magnitude, on the pixels whose inlier counts
# agree: a pixel whose measurement set differs (an event within f32
# rounding of a pixel edge or of the outlier cut) is a different
# per-pixel problem, so those pixels are counted and printed, not held to it.
MAP_ONLY_F32_REL_TOL = 1e-4
# 13b: the suite row rendered over 6.4 s, every event kept
DURATION_13B = 6.4
EVENTS_13B = (35_000_000, 45_000_000)
ITERS_13B = 8
# 13c: phase 12c's 4096x2048 render, its first 12M events at a cap of 2^21
EVENTS_13C, CAP_13C = 12_000_000, 1 << 21
# 13d: the super-resolution map of phase 11's scene
SUPER_RES_HEIGHT, ITERS_13D = 2048, 8
# One map-only step is the exact minimizer of the quadratic cost: a second
# step moves the data cost by f32 rounding only.
MAP_ONLY_EXACT_REL_TOL = 1e-5


def check_chain(name, chunks, num_pix, knots, order):
    """A streamed forming pass's A12 calls (``chunks``: each call's nine
    inputs) chained through ``carry`` by the kernel, twice (the same bits),
    against the plain version chained on the same GPU tensors. Times both
    chains; the bound is the first call's (all rows written) plus each
    later call's under ``carry`` (its touched rows read and written).
    Returns (max abs err, kernel ms, plain ms, bound ms, bound by)."""
    import torch

    from emba_tpu_torch.device import cuda_time_ms
    from emba_tpu_torch.kernels import a12_accum as K

    dim_pose = 3 * knots

    def chain(fn):
        out = None
        for args in chunks:
            out = fn(*args, num_pix, dim_pose, order, carry=out)
        return out

    got, again = chain(K.a12_accumulate), chain(K.a12_accumulate)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        _require(torch.equal(x, y), f"{name}: repeated kernel chains differ")
    want = chain(K.a12_accumulate_plain)
    torch.cuda.synchronize()
    g, w = _outputs(got, num_pix, dim_pose), _outputs(want, num_pix, dim_pose)
    max_abs, parts = 0.0, []
    for key in g:
        rel = _rel(g[key], w[key])
        _require(torch.isfinite(g[key]).all().item(), f"{name}: {key} not finite")
        _require(rel <= KERNEL_REL_TOL, f"{name}: {key} rel err {rel:.3e} > {KERNEL_REL_TOL:.0e}")
        max_abs = max(max_abs, float(torch.max(torch.abs(g[key] - w[key]))))
        parts.append(f"{key} rel {rel:.3e}")
    del got, again, want
    k_ms = cuda_time_ms(lambda: chain(K.a12_accumulate))
    p_ms = cuda_time_ms(lambda: chain(K.a12_accumulate_plain), reps=3)
    torch.cuda.empty_cache()
    b_ms, b_by = a12_bound(chunks[0][0].shape[0], num_pix, dim_pose, order)
    rows = [touched_rows(a[0], a[8]) for a in chunks]
    for args, r in zip(chunks[1:], rows[1:]):
        b_ms += a12_bound(args[0].shape[0], num_pix, dim_pose, order, carry=True, rows=r)[0]
    print(f"kernel {name}: {len(chunks)} calls chained through carry, bitwise-repeatable; "
          + "; ".join(parts) + f"; touched rows a call {rows} of {num_pix}; chain "
          f"{k_ms:.3f} ms eager, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
          f"share of bound {b_ms / k_ms:.3f}", flush=True)
    return max_abs, k_ms, p_ms, b_ms, b_by


def _window_f64_cpu(ctx, pad_multiple):
    """``ctx``'s window on the CPU in f64, padded to ``pad_multiple``."""
    import torch

    from emba_tpu_torch import model as M

    sensor = ctx["sensor"]
    return M.DeviceWindow.from_window(ctx["win"], sensor.bearing_lut(), sensor.width,
                                      torch.float64, "cpu", pad_multiple=pad_multiple)


def phase_map_only_1k(ctx, dev, cfg):
    """13a's map-only step: the map of the host loop's refined trajectory
    from zero maps, f32 on the card (twice) against the port's f64 map-only
    on the CPU. Returns the card's seconds."""
    import torch

    from emba_tpu_torch import model as M

    knots = ctx["host"][0]
    z = torch.zeros_like(ctx["start"][1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gx, gy, costs = M.solve_map_only(knots, z, z, dev, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    gx2, gy2, _costs2 = M.solve_map_only(knots, z, z, dev, cfg)
    dev64 = _window_f64_cpu(ctx, cfg.stream_chunk)
    k64, z64 = knots.double().cpu(), torch.zeros(z.shape, dtype=torch.float64)
    gx64, gy64, costs64 = M.solve_map_only(k64, z64, z64, dev64, cfg)
    nem = M.window_mode(dev, cfg).cost_and_activity(knots, gx, gy)[1].cpu()
    nem64 = M.window_mode(dev64, cfg).cost_and_activity(k64, gx64, gy64)[1]
    same = (nem == nem64).reshape(z.shape)
    mag = max(float(gx64.abs().max()), float(gy64.abs().max()))
    err_same = max(float((a.double().cpu() - b)[same].abs().max())
                   for a, b in ((gx, gx64), (gy, gy64))) / mag
    err_all = max(float((a.double().cpu() - b).abs().max())
                  for a, b in ((gx, gx64), (gy, gy64))) / mag
    rep = max(_rel(gx2, gx), _rel(gy2, gy))
    bits = torch.equal(gx2, gx) and torch.equal(gy2, gy)
    print(f"13a map-only: {cfg.pano_width}x{cfg.pano_height} from the refined trajectory, "
          f"data cost {costs[0]:.6g} -> {costs[1]:.6g} (f64 CPU {costs64[0]:.6g} -> "
          f"{costs64[1]:.6g}); f32 card vs f64 CPU: rel {err_same:.3e} on the "
          f"{int(same.sum())} pixels with equal inlier counts (tolerance "
          f"{MAP_ONLY_F32_REL_TOL:.0e}), {err_all:.3e} over all, {int((~same).sum())} "
          f"pixels' counts differ; two card runs: bit-equal {bits}, rel {rep:.3e} "
          f"(tolerance {M.MAP_ONLY_REPEAT_REL_TOL:.0e}); {secs:.4f} s on the card",
          flush=True)
    _require(costs[1] < costs[0], "13a map-only: the data cost did not fall")
    _require(err_same <= MAP_ONLY_F32_REL_TOL,
             f"13a map-only: f32 vs f64 rel {err_same:.3e} > {MAP_ONLY_F32_REL_TOL:.0e}")
    _require(rep <= M.MAP_ONLY_REPEAT_REL_TOL, f"13a map-only: two runs differ by {rep:.3e}")
    return secs


def phase_stream_1k(ctx, classic_fused_loop_s):
    """13a: the bench window padded to four chunks, the FULL and the LIGHT
    tier each fused and through the host loop, against the classic host
    loop; the A12 kernel chained through ``carry`` over a whole streamed
    forming pass against its plain version; the map-only step. Returns
    ({run: A12 launches}, the chain's numbers, {run: loop seconds}, max abs
    err)."""
    import torch

    from emba_tpu_torch import model as M
    from emba_tpu_torch import solver
    from emba_tpu_torch.probes.a12_parts import first_pass_inputs

    sensor = ctx["sensor"]
    dev = M.DeviceWindow.from_window(ctx["win"], sensor.bearing_lut(), sensor.width,
                                     torch.float32, ctx["start"][0].device,
                                     pad_multiple=STREAM_CHUNK_13A)
    n_chunks = len(M.stream_bounds(dev.pol_signed.shape[0], STREAM_CHUNK_13A))
    _require(n_chunks == 4, f"13a: {n_chunks} chunks")
    ref = ctx["host"][3]
    c_ref = _final_cost(ref)
    # the classic window in f64 (plain forming pass): where each f32 run's
    # rounding has taken its cost, printed beside the gates
    w64 = _f64_window(ctx)
    with _plain_forming():
        c64 = _final_cost(solver.solve_window(*w64["start"], w64["dev"], ctx["cfg"],
                                              ctx["lm"], fix_first=True)[3])
    del w64
    print(f"13a: classic f32 final cost {c_ref:.6f}, f64 {c64:.9f} (rel "
          f"{abs(c_ref - c64) / c64:.2e})", flush=True)
    launches, loops, err = {}, {"classic_host": ref.time_total_s,
                                "classic_fused": classic_fused_loop_s}, 0.0
    for tier in ("full", "light"):
        cfg = dataclasses.replace(ctx["cfg"], stream_chunk=STREAM_CHUNK_13A,
                                  stream_light=tier == "light")
        sctx = dict(ctx, dev=dev, cfg=cfg)
        name = f"13a {tier} tier, {n_chunks} chunks"
        runs = _fused_and_host(name, sctx, chunks=n_chunks)
        st = runs["host_stats"]
        rel = [abs(runs[m][5] - c_ref) / abs(c_ref) for m in ("fused", "host")]
        rel64 = [abs(runs[m][5] - c64) / c64 for m in ("fused", "host")]
        print(f"{name}: host accepts {_accepts(st)} vs classic {_accepts(ref)}; final cost "
              f"vs classic: fused rel {rel[0]:.2e}, host {rel[1]:.2e} (vs f64: "
              f"{rel64[0]:.2e}, {rel64[1]:.2e}); loop fused "
              f"{runs['fused'][0]:.4f} s (set-up {runs['fused'][1]:.4f}), host "
              f"{runs['host'][0]:.4f} s vs classic fused {classic_fused_loop_s:.4f} s, host "
              f"{ref.time_total_s:.4f} s; peak reserved fused "
              f"{runs['fused'][3] / 1e9:.3f} GB, host {runs['host'][3] / 1e9:.3f} GB",
              flush=True)
        _require(_accepts(st) == _accepts(ref),
                 f"{name}: other steps than the classic host loop")
        _require(max(rel) <= STREAM_F32_REL_TOL,
                 f"{name}: final cost rel {max(rel):.2e} > {STREAM_F32_REL_TOL:.0e}")
        launches[tier] = (runs["fused"][4], runs["host"][4])
        loops[f"{tier}_fused"], loops[f"{tier}_host"] = runs["fused"][0], runs["host"][0]
        err = max(err, check_forming(f"{name} first forming pass", sctx)[0])
        if tier == "full":
            chunks, num_pix, knots, order = first_pass_inputs(sctx)
            chain = check_chain(f"13a streamed pass N={dev.pol_signed.shape[0]}", chunks,
                                num_pix, knots, order)
            del chunks
            torch.cuda.empty_cache()
            err = max(err, chain[0])
            loops["map_only_s"] = phase_map_only_1k(ctx, dev, cfg)
    return launches, chain, loops, err


def phase_stream_above_cap(d):
    """13b: the suite row rendered over 6.4 s with every event kept, one
    whole-span window above the classic cap, ``cli run`` fused with no
    streaming flag: the plan streams it in the FULL tier by itself. The A12
    kernel against its plain version on the first streamed forming pass.
    Returns (A12 launches, the run's summary, max abs err)."""
    import torch

    from emba_tpu_torch import convert
    from emba_tpu_torch import model as M
    from emba_tpu_torch.pipeline import AUTO_STREAM_CHUNK, CLASSIC_CAP_SMALL_ROWS
    from emba_tpu_torch.probes.suite_run import suite_argv, write_suite_scene

    t0 = time.perf_counter()
    n_scene, _n_kept, p = write_suite_scene(d, max_events=None, duration=DURATION_13B)
    scene_s = time.perf_counter() - t0
    print(f"13b: the suite row over {DURATION_13B} s: {n_scene} events rendered and "
          f"written in {scene_s:.1f} s", flush=True)
    with _window_inputs({0}) as windows:
        res, s = _cli_run("13b (above the classic cap, fused)",
                          suite_argv(p, ITERS_13B, DURATION_13B),
                          chunks=None)
    mcfg = res.model_config
    n = s["events"][0]
    solve = windows.pop(0)[0]
    n_pad = solve["dev"].pol_signed.shape[0]
    chunks = len(M.stream_bounds(n_pad, mcfg.stream_chunk or n_pad))
    st = res.window_stats[0]
    print(f"13b: plan: stream_chunk {mcfg.stream_chunk}, stream_light {mcfg.stream_light} "
          f"(classic cap {CLASSIC_CAP_SMALL_ROWS}); window {n} events ({n_pad} padded), "
          f"{chunks} chunks, {res.trajectory.num_knots} knots, {len(st.iterations)} "
          f"steps {_accepts(st)}; loop {s['loop_s'][0]:.4f} s, set-up {s['setup_s'][0]:.4f} "
          f"s, events/s {s['events_per_s'][0]:.4g}; peak {s['peak_allocated_bytes'] / 1e9:.3f}"
          f" GB allocated, {s['peak_reserved_bytes'] / 1e9:.3f} GB reserved; A12 launches "
          f"{s['a12_launches']} = {s['forming_passes']} forming passes x {chunks}",
          flush=True)
    _require(EVENTS_13B[0] <= n <= EVENTS_13B[1] and n > CLASSIC_CAP_SMALL_ROWS,
             f"13b: {n} events, not in {EVENTS_13B} above the cap")
    _require(mcfg.stream_chunk == AUTO_STREAM_CHUNK and not mcfg.stream_light,
             f"13b: the plan chose stream_chunk {mcfg.stream_chunk}, light "
             f"{mcfg.stream_light}")
    _require(s["a12_launches"] == s["forming_passes"] * chunks,
             f"13b: {s['a12_launches']} A12 launches != {s['forming_passes']} x {chunks}")
    ctx = dict(solve, start=convert.state_from_numpy(*solve["state"]))
    e = check_forming(f"13b first streamed forming pass ({chunks} chunks)", ctx)[0]
    del ctx, solve, res
    torch.cuda.empty_cache()
    return s["a12_launches"], s, e


def phase_stream_4k(device, scene4k):
    """13c: phase 12c's 4096x2048 render, its first 12M events at a cap of
    2^21 rows: the plan streams (above CLASSIC_CAP_LARGE_ROWS), fused and
    host take the same steps, the A12 kernel against its plain version on
    the first streamed forming pass. Returns (A12 launches (fused, host),
    max abs err, {mode: peak reserved bytes})."""
    import torch

    from emba_tpu_torch import model as M
    from emba_tpu_torch.config import BAConfig
    from emba_tpu_torch.pipeline import AUTO_STREAM_CHUNK, CLASSIC_CAP_LARGE_ROWS, plan_model_config
    from emba_tpu_torch.probes.profile_fused import bench_window

    scene, traj0, sensor = scene4k
    n = EVENTS_13C
    _require(len(scene.t) >= n, f"13c: the render holds {len(scene.t)} events")
    t = scene.t[:n]
    span = float(t[-1] - t[0])
    H, W = scene.gx.shape
    mcfg = M.ModelConfig(c_th=0.1, pano_width=W, pano_height=H, thres_valid_pixel=3,
                         alpha=0.5, outlier_dp_norm=3.0, compact_cap=CAP_13C)
    mcfg, auto = plan_model_config(mcfg, BAConfig(), t, float(t[0]), float(t[-1]), span,
                                   span, 1)
    print(f"13c: {n} events at {W}x{H}, cap {CAP_13C}: plan stream_chunk "
          f"{mcfg.stream_chunk}, stream_light {mcfg.stream_light} (classic cap "
          f"{CLASSIC_CAP_LARGE_ROWS} above 2^20 rows)", flush=True)
    _require(mcfg.stream_chunk == AUTO_STREAM_CHUNK and not mcfg.stream_light
             and not auto, "13c: the plan did not stream in the FULL tier")
    ctx = bench_window(scene, traj0, sensor, n, device, compact_cap=CAP_13C,
                       pad_multiple=mcfg.stream_chunk)
    ctx["cfg"] = mcfg
    chunks = len(M.stream_bounds(ctx["dev"].pol_signed.shape[0], mcfg.stream_chunk))
    name = f"13c {n} events cap {CAP_13C}, {chunks} chunks"
    e, dropped, active, r_pad = check_forming(f"{name} first forming pass", ctx)
    runs = _fused_and_host(name, ctx, iters=MAIN_ITERS, chunks=chunks)
    for mode in ("fused", "host"):
        loop_s, setup_s, pa, pr, nl, _c = runs[mode]
        print(f"{name} {mode}: loop {loop_s:.4f} s, set-up {setup_s:.4f} s; peak "
              f"{pa / 1e9:.3f} GB allocated, {pr / 1e9:.3f} GB reserved ({pr / n:.1f} bytes "
              f"an event); A12 launches {nl}; dropped {dropped}, active {active} of R_pad "
              f"{r_pad}", flush=True)
    del ctx
    torch.cuda.empty_cache()
    return ((runs["fused"][4], runs["host"][4]), e,
            {m: runs[m][3] for m in ("fused", "host")})


@contextlib.contextmanager
def _super_res_calls():
    """Within the scope, ``EmbaPipeline.solve_super_res_map`` records its
    pipeline and each call's seconds: {"pipe", "seconds": [...]}."""
    import torch

    from emba_tpu_torch import pipeline

    got = {"seconds": []}
    solve = pipeline.EmbaPipeline.solve_super_res_map

    def recording(self, *a, **kw):
        got["pipe"] = self
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(self, *a, **kw)
        torch.cuda.synchronize()
        got["seconds"].append(time.perf_counter() - t0)
        return out

    pipeline.EmbaPipeline.solve_super_res_map = recording
    try:
        yield got
    finally:
        pipeline.EmbaPipeline.solve_super_res_map = solve


def phase_super_res(p, d):
    """13d: ``cli run --super-res-height 2048`` on phase 11's scene (the
    4096x2048 map of every kept event, chunks of 2^20): the four files and
    super_res.json, the data cost falls, a second step is a fixed point
    (the exact minimizer), and a second call gives the first one's map.
    Returns (seconds, peak reserved bytes)."""
    import torch

    from emba_tpu_torch import io as eio
    from emba_tpu_torch import model as M
    from emba_tpu_torch.probes.suite_run import suite_argv

    out = os.path.join(d, "sr")
    with _super_res_calls() as calls:
        res, s = _cli_run("13d (super-resolution, recording)",
                          suite_argv(p, ITERS_13D)
                          + ["--out", out, "--super-res-height", str(SUPER_RES_HEIGHT)])
    fr = os.path.join(out, "final_results")
    for f in ("Gx_sr.bin", "Gy_sr.bin", "G_hsv_sr.png", "poisson_sr.png", "super_res.json"):
        _require(os.path.exists(os.path.join(fr, f)), f"13d: {f} was not written")
    with open(os.path.join(fr, "super_res.json")) as f:
        sr = json.load(f)
    gx, gy = eio.load_map_bin(os.path.join(fr, "Gx_sr.bin"), os.path.join(fr, "Gy_sr.bin"))
    pipe = calls["pipe"]
    seconds = calls["seconds"]
    peaks = _peak_bytes()
    for iters in (2, 1):
        t0 = time.perf_counter()
        out = pipe.solve_super_res_map(SUPER_RES_HEIGHT, num_iters=iters)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if iters == 2:
            costs2 = out[2]
    gx3, gy3 = out[:2]
    peak = peaks()[1]
    fixed = abs(costs2[2] - costs2[1]) / abs(costs2[1])
    bits = np.array_equal(gx3, gx) and np.array_equal(gy3, gy)
    mag = max(np.abs(gx).max(), np.abs(gy).max())
    rep = max(np.abs(gx3 - gx).max(), np.abs(gy3 - gy).max()) / mag
    active = int(np.count_nonzero(gx) + np.count_nonzero(gy))
    print(f"13d: super_res.json {json.dumps(sr)}; map {gx.shape[1]}x{gx.shape[0]}, "
          f"{active} nonzero values of {2 * gx.size}; two steps: data costs {costs2} "
          f"(third vs second rel {fixed:.2e}, tolerance {MAP_ONLY_EXACT_REL_TOL:.0e}); "
          f"a second call: bit-equal {bits}, rel {rep:.3e} (tolerance "
          f"{M.MAP_ONLY_REPEAT_REL_TOL:.0e}); seconds a call {seconds} (the run's, then 2 "
          f"steps, then 1; each pairs its events on the host); peak of the last two "
          f"{peak / 1e9:.3f} GB reserved from an empty cache; the BA run's peak "
          f"{s['peak_reserved_bytes'] / 1e9:.3f} GB", flush=True)
    _require(gx.shape == (SUPER_RES_HEIGHT, 2 * SUPER_RES_HEIGHT), f"13d: map {gx.shape}")
    _require(np.isfinite(gx).all() and np.isfinite(gy).all(), "13d: NaN/Inf in the map")
    _require(sr["data_costs"][1] < sr["data_costs"][0], "13d: the data cost did not fall")
    _require(fixed <= MAP_ONLY_EXACT_REL_TOL, f"13d: a second step moved the cost {fixed:.2e}")
    _require(rep <= M.MAP_ONLY_REPEAT_REL_TOL, f"13d: two calls differ by {rep:.3e}")
    del res, pipe, calls, out
    return sr, peak



# ---------------------------------------------------------------------------
# Phase 14: the sharded window on torch.distributed.
# ---------------------------------------------------------------------------

# 14b: f32 windows whose sums run in another order than the single-device
# window's (the ranks' partial sums are added by the collectives): the
# final cost within COMPACT_F32_REL_TOL (any change of f32 summation order
# moved the 9-step cost by 2.5-5.7e-5, 12d); 14a at world size 1 adds
# nothing across ranks, so it is held to the fused window's 1e-5.
SHARDED_F32_REL_TOL = 1e-4
# 14c: the sharded map-only step against the single-device one, both f32 on
# the card, relative to the map's largest magnitude, on the pixels whose
# inlier counts agree (13a measured 3.0e-5 for f32 against f64)
SHARDED_MAP_REL_TOL = 3e-5
# 14d: a two-rank run of phase 11's row against one device, both f32 and
# held to the same SHARDED_CLI_MAX_NUM_ITER + 1 steps. Run to convergence the
# paths part: near step 23 the relative decrease sits at tol_fun's edge, and
# any change of f32 summation order (the ranks' partial sums, the Schur
# sums) moves the step at which tol_fun is met a second time, and with it a
# final cost by up to 0.4% (PERF.md, PR 17). 16 steps end before that edge,
# so every run takes the same steps and the costs compare step for step.
# The limit lies between the largest sound reading and the smallest reading
# of a fault planted in the sharded window (``python -m
# emba_tpu_torch.probes.sharded --max-num-iter 15``), see PERF.md, PR 17.
SHARDED_CLI_MAX_NUM_ITER = 15
SHARDED_CLI_COST_REL_TOL = 1e-3
SHARDED_RMSE_TOL_DEG = 0.01
SHARDED_RANKS = 2
RANK_THREADS = 2  # torch threads a rank: two ranks share the machine's cores
# The depth cut of phase 14 (widths stay): over gloo every forming pass
# stages A12 (1.34 GB a rank) through the host, most of a 1.6-1.9 s step
# on an NVIDIA H100 80GB HBM3 at 700 W (this phase's chip run), so 14b
# runs 4 steps, against the single-device host loop of the same depth.
SHARDED_WINDOW_ITERS = 3


def phase_sharded_nccl(ctx, fused_single):
    """14a: NCCL at world size 1 in this process. Returns ({path: A12
    launches}, {loop: seconds})."""
    import shutil

    import torch

    from emba_tpu_torch import dist, kernels, lm, solver

    d = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    comm = dist.init(1, 0, "nccl", f"file://{d}/store", device=ctx["dev"].pol_signed.device)
    try:
        place = dist.Sharded(comm, ctx["sensor"].width * ctx["sensor"].height)
        shard = dist.shard_window(ctx["dev"], comm)
        solver._GRAPHED.clear()
        torch.cuda.empty_cache()
        loop = lm.LoopStats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = solver.solve_window_fused(
            *ctx["start"], shard, ctx["cfg"], 1.0, 0.0, fix_first=True,
            max_num_iter=MAIN_ITERS, return_trace=True, stats=loop, placement=place)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_f = kernels.launch_counts()["a12_accum"]
        kernels.reset_launch_counts()
        host = solver.solve_window(*ctx["start"], shard, ctx["cfg"], ctx["lm"],
                                   fix_first=True, placement=place)
        torch.cuda.synchronize()
        launches_h = kernels.launch_counts()["a12_accum"]
    finally:
        dist.destroy()
        solver._GRAPHED.clear()
        torch.cuda.empty_cache()
        shutil.rmtree(d, ignore_errors=True)
    k, gx, gy, cost, it, conv, trace = out
    single = ctx["host"]
    same_fused = all(torch.equal(a, b) for a, b in zip(out, fused_single))
    same_host = all(torch.equal(a, b) for a, b in zip(host[:3], single[:3]))
    recs = lm.trace_records(trace.cpu().double().numpy(), int(it))
    acc_f = "".join("A" if r["accepted"] else "r" for r in recs)
    single_cost = _final_cost(single[3])
    rel_f = abs(float(cost) - float(fused_single[3])) / abs(float(fused_single[3]))
    rel_h = abs(_final_cost(host[3]) - single_cost) / abs(single_cost)
    print(f"sharded 14a (nccl, world 1, {ctx['n']} events): fused {int(it)} iterations "
          f"{acc_f}, its graphs capturing the NCCL collectives (set-up {loop.setup_s:.4f} "
          f"s, loop {loop.loop_s:.4f} s, call {wall:.4f} s), final cost {float(cost):.6f} vs "
          f"solve_window_fused {float(fused_single[3]):.6f} (rel {rel_f:.2e}), bits equal "
          f"{same_fused}; host {len(host[3].iterations)} iterations {_accepts(host[3])}, "
          f"{host[3].time_total_s:.4f} s (single-device host loop "
          f"{single[3].time_total_s:.4f} s), final cost rel {rel_h:.2e}, bits equal "
          f"{same_host}; A12 launches fused {launches_f} = {loop.form_passes} forming "
          f"passes, host {launches_h} = {host[3].count_form}", flush=True)
    _finite("14a fused", (k, gx, gy))
    _finite("14a host", host[:3])
    _require(loop.setup_s > 0, "14a: the fused sharded window did not capture its graphs")
    _require(int(it) == int(fused_single[4]) and acc_f == _accepts(single[3]),
             "14a: the fused sharded window took other steps than solve_window_fused")
    _require(_accepts(host[3]) == _accepts(single[3]),
             "14a: the host sharded window took other steps than the host loop")
    _require(rel_f <= FUSED_COST_REL_TOL and rel_h <= FUSED_COST_REL_TOL,
             f"14a: final cost rel {max(rel_f, rel_h):.2e} > {FUSED_COST_REL_TOL:.0e}")
    _require(launches_f == loop.form_passes and launches_h == host[3].count_form,
             "14a: A12 launches != forming passes")
    return ({"14a_fused": launches_f, "14a_host": launches_h},
            {"fused_loop_s": loop.loop_s, "host_s": host[3].time_total_s})


def phase_sharded_gloo(ctx, d):
    """14b, 14c, 14e: two ranks on the one card over gloo. Returns ({path:
    A12 launches of each rank}, the largest absolute error of the kernel
    against its plain version, {measure: value})."""
    import torch

    from emba_tpu_torch import dist, solver
    from emba_tpu_torch import model as M
    from emba_tpu_torch.probes import sharded

    sensor = ctx["sensor"]
    path = os.path.join(d, "window.pt")
    sharded.save_window(path, ctx["dev"], ctx["cfg"], ctx["start"],
                        sensor.width * sensor.height, ctx["host"][0])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dist.spawn(sharded.window_rank, SHARDED_RANKS, "gloo",
                       args=(path, SHARDED_WINDOW_ITERS), device="cuda",
                       threads=RANK_THREADS, timeout_s=900)
    wall = time.perf_counter() - t0
    single = solver.solve_window(*ctx["start"], ctx["dev"], ctx["cfg"],
                                 solver.LMConfig(max_num_iter=SHARDED_WINDOW_ITERS,
                                                 tol_fun=0.0), fix_first=True)[3]
    single_cost = _final_cost(single)
    launches, max_abs, numbers = {}, 0.0, {"wall_s": wall}
    for r, res in enumerate(ranks):
        kc, h, f = res["kernel"], res["host"], res["fused"]
        rel_h = abs(h["final_cost"] - single_cost) / abs(single_cost)
        rel_f = abs(f["final_cost"] - single_cost) / abs(single_cost)
        print(f"sharded 14b rank {r} (gloo, {res['events']} of the window's events): A12 "
              f"kernel on its first forming pass ({kc['measurements']} weighted "
              f"measurements) vs plain: " + "; ".join(
                  f"{k} rel {v:.3e}" for k, v in kc["rel"].items())
              + f"; the A12 reduce-scatter of that pass ({res['a12_bytes'] / 1e9:.3f} GB a "
              f"rank) {res['a12_reduce_scatter_s']:.4f} s; host {h['iterations']} iterations "
              f"{h['accepts']} in {h['seconds']:.4f} s (form {h['form_s']:.4f}, solve "
              f"{h['solve_s']:.4f}, objective {h['objective_s']:.4f}), final cost "
              f"{h['final_cost']:.6f} vs single host {single_cost:.6f} (rel {rel_h:.2e}); "
              f"lm_while {f['iterations']} iterations {f['accepts']} in {f['seconds']:.4f} s "
              f"(rel {rel_f:.2e}); A12 launches host {h['launches']} = {h['forms']}, "
              f"lm_while {f['launches']} = {f['forms']} forming passes; peak "
              f"{res['peak_reserved_bytes'] / 2**30:.3f} GiB reserved", flush=True)
        for key, v in kc["rel"].items():
            _require(v <= KERNEL_REL_TOL, f"14b rank {r}: A12 {key} rel {v:.3e} > "
                     f"{KERNEL_REL_TOL:.0e}")
        _require(kc["finite"] and kc["launches"] == 1,
                 f"14b rank {r}: the A12 kernel did not run, or not finite")
        for name, run, rel in (("host", h, rel_h), ("lm_while", f, rel_f)):
            _require(run["finite"], f"14b rank {r} {name}: NaN/Inf in the state")
            _require(run["accepts"] == _accepts(single),
                     f"14b rank {r} {name}: other steps than the single-device host loop")
            _require(rel <= SHARDED_F32_REL_TOL,
                     f"14b rank {r} {name}: final cost rel {rel:.2e} > "
                     f"{SHARDED_F32_REL_TOL:.0e}")
            _require(run["launches"] == run["forms"],
                     f"14b rank {r} {name}: A12 launches != forming passes")
        _require(h["final_cost"] == ranks[0]["host"]["final_cost"]
                 and f["final_cost"] == ranks[0]["fused"]["final_cost"],
                 "14b: the ranks' results differ")
        launches.update({f"14b_rank{r}_host": h["launches"],
                         f"14b_rank{r}_lm_while": f["launches"]})
        max_abs = max(max_abs, kc["max_abs_err"])
        numbers.update({f"rank{r}_a12_reduce_scatter_s": res["a12_reduce_scatter_s"],
                        f"rank{r}_host_s": h["seconds"], f"rank{r}_lm_while_s": f["seconds"],
                        f"rank{r}_peak_reserved_bytes": res["peak_reserved_bytes"]})

    # 14c: against the single-device map-only step on the card, both f32
    knots = ctx["host"][0]
    z = torch.zeros_like(ctx["start"][1])
    gx, gy, costs = M.solve_map_only(knots, z, z, ctx["dev"], ctx["cfg"])
    mo = ranks[0]["map_only"]
    sgx, sgy = (torch.as_tensor(a) for a in (mo["gx"], mo["gy"]))
    cfg = dataclasses.replace(ctx["cfg"], stream_chunk=1 << 20)
    mode = M.window_mode(ctx["dev"], cfg)
    nem = mode.cost_and_activity(knots, gx, gy)[1].cpu()
    nem_s = mode.cost_and_activity(knots, sgx.to(gx.device), sgy.to(gx.device))[1].cpu()
    same = (nem == nem_s).reshape(z.shape)
    mag = max(float(gx.abs().max()), float(gy.abs().max()))
    err = max(float((a.cpu().double() - b.double())[same].abs().max())
              for a, b in ((gx, sgx), (gy, sgy))) / mag
    print(f"sharded 14c map-only ({SHARDED_RANKS} ranks): data cost {mo['costs'][0]:.6g} -> "
          f"{mo['costs'][-1]:.6g} (single device {costs[0]:.6g} -> {costs[-1]:.6g}); rel "
          f"{err:.3e} on the {int(same.sum())} pixels whose counts agree ({int((~same).sum())} "
          f"differ); two calls bit-equal {[r['map_only']['repeat_equal'] for r in ranks]}; "
          f"{mo['seconds'][0]:.4f}, {mo['seconds'][1]:.4f} s a call", flush=True)
    _require(err <= SHARDED_MAP_REL_TOL,
             f"14c: sharded map-only rel {err:.3e} > {SHARDED_MAP_REL_TOL:.0e}")
    _require(all(r["map_only"]["repeat_equal"] for r in ranks),
             "14c: two sharded map-only calls differ in bits")
    _require(mo["costs"][-1] < mo["costs"][0], "14c: the data cost did not fall")
    numbers["map_only_s"] = mo["seconds"]

    # 14e: dist.dryrun's variants on these ranks
    dist.check_dryrun([r["dryrun"] for r in ranks], "gloo")
    print(f"sharded 14b-e: {SHARDED_RANKS} ranks over gloo, {wall:.1f} s from spawn to join",
          flush=True)
    return launches, max_abs, numbers


def _rmse(traj, p, d, name):
    from emba_tpu_torch import cli

    path = os.path.join(d, f"{name}.txt")
    traj.write_tum(path)
    return cli.main(["eval", "--traj", path, "--gt", p["traj_gt.txt"]])["rotation_rmse_deg"]


def phase_sharded_cli(p, d):
    """14d: ``cli run --num-devices 2 --dist-backend gloo`` on phase 11's
    scene against the same ``cli run`` on one device, every run held to
    SHARDED_CLI_MAX_NUM_ITER + 1 steps, on ranks that run the CLI's rank
    path and count their A12 launches (``probes.sharded.cli_rank``; the
    CLI's own spawn of them is held by the CPU tests): fused, then
    recording, whose first mid-window checkpoint one device then resumes.
    Returns ({path: A12 launches}, {run: seconds})."""
    from emba_tpu_torch import cli, dist
    from emba_tpu_torch.probes import sharded
    from emba_tpu_torch.probes.suite_run import suite_argv

    base = ["run"] + suite_argv(p, max_num_iter=SHARDED_CLI_MAX_NUM_ITER)
    argv = base + ["--num-devices", str(SHARDED_RANKS), "--dist-backend", "gloo"]
    out, snap = os.path.join(d, "sharded_rec"), os.path.join(d, "sharded_mid.npz")
    secs, runs, ranks = {}, {}, {}
    t0 = time.perf_counter()
    runs["one"] = cli.main(base)
    secs["one_s"] = time.perf_counter() - t0
    for name, extra, keep in (("fused", [], None), ("recording", ["--out", out], snap)):
        t0 = time.perf_counter()
        ranks[name] = dist.spawn(sharded.cli_rank, SHARDED_RANKS, "gloo",
                                 args=(argv + extra, keep), device="cuda",
                                 threads=RANK_THREADS, timeout_s=900)
        secs[name + "_s"] = time.perf_counter() - t0
        runs[name] = ranks[name][0][0]
    t0 = time.perf_counter()
    runs["resumed"] = cli.main(base + ["--resume", snap])
    secs["resumed_s"] = time.perf_counter() - t0
    launches = {f"14d_rank{r}_{name}": n for name in ranks
                for r, (_, n, _) in enumerate(ranks[name])}
    one = runs["one"].window_stats[0]
    cost1 = _final_cost(one)
    rmse1 = _rmse(runs["one"].trajectory, p, d, "sharded_one")
    steps = SHARDED_CLI_MAX_NUM_ITER + 1
    print(f"sharded 14d one device: {len(one.iterations)} iterations {_accepts(one)}; final "
          f"cost {cost1:.6f}; RMSE {rmse1:.4f} deg; {secs['one_s']:.1f} s", flush=True)
    _require(len(one.iterations) == steps,
             f"14d one device: {len(one.iterations)} iterations, expected {steps}")
    for name, mode in (("fused", "fused-sharded"), ("recording", "host-sharded"),
                       ("resumed", "host")):
        res = runs[name]
        st = res.window_stats[0]
        cost = _final_cost(st)
        rel = abs(cost - cost1) / abs(cost1)
        rmse = _rmse(res.trajectory, p, d, f"sharded_{name}")
        print(f"sharded 14d {name} ({len(res.window_stats)} window, lm_mode {st.lm_mode}): "
              f"{len(st.iterations)} iterations {_accepts(st)}; final cost {cost:.6f} vs one "
              f"device {cost1:.6f} (rel {rel:.2e}); RMSE {rmse:.4f} vs one device "
              f"{rmse1:.4f} deg; {secs[name + '_s']:.1f} s", flush=True)
        _require(st.lm_mode == mode, f"14d {name}: lm_mode {st.lm_mode}, expected {mode}")
        _require(np.isfinite(res.trajectory.knots).all() and np.isfinite(res.gx).all(),
                 f"14d {name}: NaN/Inf in the result")
        _require(rel <= SHARDED_CLI_COST_REL_TOL,
                 f"14d {name}: final cost rel {rel:.2e} > {SHARDED_CLI_COST_REL_TOL:.0e}")
        _require(abs(rmse - rmse1) <= SHARDED_RMSE_TOL_DEG,
                 f"14d {name}: RMSE {rmse:.4f} vs one device {rmse1:.4f} deg")
    for name in ranks:
        its = len(runs[name].window_stats[0].iterations)
        _require(its == steps, f"14d {name}: {its} iterations, expected {steps}")
        for r, (res, n, peak) in enumerate(ranks[name]):
            forms = sum(st.count_form for st in res.window_stats)
            print(f"sharded 14d {name} rank {r}: A12 launches {n} = {forms} forming "
                  f"passes; peak {peak / 2**30:.3f} GiB reserved", flush=True)
            _require(n == forms, f"14d {name} rank {r}: A12 launches {n} != forming "
                     f"passes {forms}")
    z = np.load(snap)
    _require(bool(z["mid_window"]) and len(runs["resumed"].window_stats[0].iterations)
             == len(runs["recording"].window_stats[0].iterations) - int(z["lm_it"]),
             "14d: the resumed run did not continue the checkpoint's window")
    return launches, secs


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
    ctx_schur_launches = ctx["schur_launches"]
    win = phase_window_kernel(ctx)
    schur = phase_schur(ctx)
    a12_launches, fused_single, schur_fused = phase_fused(ctx)
    phase_resume(ctx)
    phase_cg(ctx)
    p12, p13 = {}, {}
    with tempfile.TemporaryDirectory() as d:
        sharded_launches, sharded_s = phase_sharded_nccl(ctx, fused_single)
        del fused_single
        gloo_launches, err_14b, gloo_numbers = phase_sharded_gloo(ctx, d)
        sharded_launches.update(gloo_launches)
        sharded_s.update(gloo_numbers)
        pipeline_launches, pipe_err, scene_files, rmse_run3 = phase_pipeline(device, d)
        cli_launches, sharded_s["14d"] = phase_sharded_cli(scene_files, d)
        sharded_launches.update(cli_launches)
        p12["12a"], err_a = phase_multi_start(scene_files, rmse_run3)
        p12["12b"], err_b = phase_suite_row()
        p12["12d"], err_d = phase_compact_1k(ctx)
        p12["12e"], light_loops = phase_light(ctx)
        p13["13a"], chain, stream_loops, err_13a = phase_stream_1k(ctx, light_loops["classic"])
        del ctx
        p12["12c"], err_c, case_4k, cap_4k, scene_4k = phase_4k(device)
        p13["13c"], err_13c, peaks_13c = phase_stream_4k(device, scene_4k)
        del scene_4k
        super_res, super_res_peak = phase_super_res(scene_files, d)
        with tempfile.TemporaryDirectory(dir=d) as d13:
            p13["13b"], run_13b, err_13b = phase_stream_above_cap(d13)

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
        "max_abs_err": max(syn[0], win[0], pipe_err, err_a, err_b, err_c, err_d, err_13a,
                           err_13b, err_13c, err_14b),
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
        "phase12_launches": p12,
        "compact_4k_ms": case_4k[1],
        "compact_4k_graph_ms": case_4k[5],
        "compact_4k_plain_ms": case_4k[2],
        "compact_4k_bound_ms": case_4k[3],
        "classic_cap_large_rows_measured": cap_4k,
        "light_trial_loop_s": light_loops,
        "streamed_launches": p13,
        "stream_ms": chain[1],
        "stream_plain_ms": chain[2],
        "stream_bound_ms": chain[3],
        "stream_bound_by": chain[4],
        "stream_loop_s": stream_loops,
        "stream_13b": {k: run_13b[k] for k in (
            "events", "knots", "iterations", "loop_s", "setup_s", "events_per_s",
            "peak_allocated_bytes", "peak_reserved_bytes")},
        "stream_4k_peak_reserved_bytes": peaks_13c,
        "super_res_data_costs": super_res["data_costs"],
        "super_res_peak_reserved_bytes": super_res_peak,
        "sharded_launches": sharded_launches,
        "sharded_s": sharded_s,
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
    }, {
        "name": "schur_rows",
        "route": "cuda",
        "source": "emba_tpu_torch/kernels/csrc/schur_rows.cu",
        "replaces": None,
        "launches": {"main_host_loop": ctx_schur_launches, "fused": schur_fused},
        "library_ms": None,
        **schur,
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
