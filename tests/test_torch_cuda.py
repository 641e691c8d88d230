"""The port on the card: the CUDA kernels against their plain torch
versions, a kernel launch inside a CUDA graph, and the fused window on CUDA
graphs against the host loop. Every test here is marked ``cuda`` and skips
without a GPU.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: the A12 kernel to relative 1e-5 of each output's largest
magnitude and the gather kernel to 1e-6 of each row's sum of magnitudes,
because both sides sum in f32 in different orders; repeated kernel runs
must agree bit for bit. The fused window's final cost to relative 1e-5 of
the host loop's (lambda and the cost sum are f32 on the device, f64 on the
host).
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu_torch import kernels, lm, obs, solver, spline, synth
from emba_tpu_torch.pairing import build_window
from emba_tpu_torch import model as TM
from emba_tpu_torch.kernels import a12_accum as TK
from emba_tpu_torch.kernels import gather_sum as TG


def make_inputs(rng, n, hw, knots, order, device):
    d = 3 * order
    i_c = rng.integers(0, knots - order + 1, n)
    i_p = np.clip(i_c - rng.integers(0, 3, n), 0, None)
    w = rng.uniform(0.1, 1.0, n)
    w[rng.random(n) < 0.2] = 0.0
    arrs = [rng.integers(0, hw, n), i_c, i_p, rng.normal(size=(d, n)),
            rng.normal(size=(d, n)), rng.normal(size=n), rng.normal(size=n),
            rng.normal(size=n), w]
    types = [torch.int32] * 3 + [torch.float32] * 6
    return [torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=t)
            for a, t in zip(arrs, types)]


def unpadded(out, hw, dim):
    a12, px5, a11b = out
    dp = a12.shape[1] // 2
    return [a12[:hw, :dim], a12[:hw, dp:dp + dim], px5[:hw, :5], a11b[:dim, :dim],
            a11b[dp, :dim]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card with -m cuda)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4])
def test_cuda_kernel_matches_plain(cuda_device, order):
    rng = np.random.default_rng(10 + order)
    hw, knots = 4096, 20
    dim = 3 * knots
    args = make_inputs(rng, 50_000, hw, knots, order, cuda_device)
    before = TK.launches
    got = TK.a12_accumulate(*args, hw, dim, order)
    again = TK.a12_accumulate(*args, hw, dim, order)
    assert TK.launches == before + 2
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    want = TK.a12_accumulate_plain(*args, hw, dim, order)
    for g, w in zip(unpadded(got, hw, dim), unpadded(want, hw, dim)):
        assert torch.max(torch.abs(g - w)) <= 1e-5 * torch.max(torch.abs(w))


@pytest.mark.cuda
def test_cuda_kernel_carry_accumulates_in_place(cuda_device):
    rng = np.random.default_rng(3)
    hw, knots, dim = 4096, 20, 60
    a = make_inputs(rng, 30_000, hw, knots, 2, cuda_device)
    b = make_inputs(rng, 20_000, hw, knots, 2, cuda_device)
    out = TK.a12_accumulate(*a, hw, dim, 2)
    chained = TK.a12_accumulate(*b, hw, dim, 2, carry=out)
    assert all(x is y for x, y in zip(chained, out))
    cat = [torch.cat([x, y], dim=-1) for x, y in zip(a, b)]
    want = TK.a12_accumulate_plain(*cat, hw, dim, 2)
    for g, w in zip(unpadded(chained, hw, dim), unpadded(want, hw, dim)):
        assert torch.max(torch.abs(g - w)) <= 1e-5 * torch.max(torch.abs(w))


def check_kernel(args, hw, dim, order):
    """Kernel twice (same bits) against the plain version; returns the
    kernel's outputs."""
    got = TK.a12_accumulate(*args, hw, dim, order)
    again = TK.a12_accumulate(*args, hw, dim, order)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    want = TK.a12_accumulate_plain(*args, hw, dim, order)
    for g, w in zip(unpadded(got, hw, dim), unpadded(want, hw, dim)):
        assert torch.isfinite(g).all()
        assert torch.max(torch.abs(g - w)) <= 1e-5 * torch.max(torch.abs(w))
    return got


@pytest.mark.cuda
def test_cuda_kernel_heavy_rows(cuda_device):
    """Rows above the heavy-row threshold (cut into chunks reduced by their
    own warps), one just above it and one at it."""
    rng = np.random.default_rng(21)
    hw, knots = 4096, 20
    args = make_inputs(rng, 40_000, hw, knots, 2, cuda_device)
    pix = args[0].cpu().numpy()
    perm = rng.permutation(pix.shape[0])
    pix[perm[:5_000]] = 77
    pix[perm[5_000:5_000 + TK.HEAVY_ROW + 1]] = 1_000
    pix[perm[6_000:6_000 + TK.HEAVY_ROW]] = 2_000
    args[0] = torch.as_tensor(pix, device=cuda_device)
    check_kernel(args, hw, 3 * knots, 2)


@pytest.mark.cuda
def test_cuda_kernel_carry_keeps_empty_rows(cuda_device):
    """Under carry, the rows the second call does not touch keep the carry's
    bits; the touched ones hold the sum of both calls."""
    rng = np.random.default_rng(22)
    hw, knots, dim = 4096, 20, 60
    first = make_inputs(rng, 30_000, hw, knots, 2, cuda_device)
    second = make_inputs(rng, 2_000, hw, knots, 2, cuda_device)
    second[0] = torch.remainder(second[0], 64)  # rows 0..63 only
    out = TK.a12_accumulate(*first, hw, dim, 2)
    before = [t.clone() for t in out]
    chained = TK.a12_accumulate(*second, hw, dim, 2, carry=out)
    assert torch.equal(chained[0][64:], before[0][64:])
    assert torch.equal(chained[1][64:], before[1][64:])
    cat = [torch.cat([x, y], dim=-1) for x, y in zip(first, second)]
    want = TK.a12_accumulate_plain(*cat, hw, dim, 2)
    for g, w in zip(unpadded(chained, hw, dim), unpadded(want, hw, dim)):
        assert torch.max(torch.abs(g - w)) <= 1e-5 * torch.max(torch.abs(w))


@pytest.mark.cuda
def test_cuda_kernel_time_ordered_inputs(cuda_device):
    """As in a real window: i_c does not decrease in k and i_p is i_c or one
    before it, so the knot-pair sort is nearly the identity."""
    rng = np.random.default_rng(23)
    hw, knots, n = 8192, 30, 60_000
    args = make_inputs(rng, n, hw, knots, 2, cuda_device)
    i_c = np.sort(rng.integers(0, knots - 1, n))
    i_p = np.clip(i_c - (rng.random(n) < 0.3), 0, None)
    args[1] = torch.as_tensor(i_c.astype(np.int32), device=cuda_device)
    args[2] = torch.as_tensor(i_p.astype(np.int32), device=cuda_device)
    check_kernel(args, hw, 3 * knots, 2)


@pytest.mark.cuda
def test_cuda_kernel_random_pairs_order4(cuda_device):
    """i_c and i_p drawn independently (i_p may follow i_c) at order 4."""
    rng = np.random.default_rng(24)
    hw, knots, n = 4096, 16, 40_000
    args = make_inputs(rng, n, hw, knots, 4, cuda_device)
    for i in (1, 2):
        args[i] = torch.as_tensor(rng.integers(0, knots - 3, n).astype(np.int32),
                                  device=cuda_device)
    check_kernel(args, hw, 3 * knots, 4)


@pytest.mark.cuda
def test_cuda_kernel_many_knots(cuda_device):
    """K = 300: 90,000 knot pairs, far more than the chunks of the run, an
    A11 of 900 x 900 and 7.3 KB row buffers (6 warps a block)."""
    rng = np.random.default_rng(25)
    hw, knots = 2048, 300
    args = make_inputs(rng, 80_000, hw, knots, 2, cuda_device)
    far = rng.random(80_000) < 0.3
    i_p = args[2].cpu().numpy()
    i_p[far] = rng.integers(0, knots - 1, int(far.sum()))
    args[2] = torch.as_tensor(i_p, device=cuda_device)
    check_kernel(args, hw, 3 * knots, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 3, 4])
def test_cuda_scratch_sizes_hold_the_layout(cuda_device, order):
    """The library's scratch layout: a record holds 5 head words and 2D
    entries in whole 32-byte sectors, one word a lane of a warp; a chunk
    partial holds the (2D+1)(2D+2)/2 cells of the A11 vector, padded to a
    warp. Another order is refused."""
    d = 3 * order
    rw, ncp = TK.scratch_sizes(order)
    assert 5 + 2 * d <= rw <= 32 and rw % 8 == 0
    assert (2 * d + 1) * (2 * d + 2) // 2 <= ncp < (2 * d + 1) * (2 * d + 2) // 2 + 32
    assert ncp % 32 == 0
    with pytest.raises(ValueError):
        TK.scratch_sizes(5)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_cannot_take(cuda_device):
    rng = np.random.default_rng(0)
    args = make_inputs(rng, 10, 256, 5, 2, cuda_device)
    f64 = list(args)
    f64[3] = f64[3].double()
    with pytest.raises(ValueError, match="Jc"):
        TK.a12_accumulate(*f64, 256, 15, 2)
    strided = list(args)
    strided[3] = torch.empty((10, 6), device=cuda_device).T
    with pytest.raises(ValueError, match="contiguous"):
        TK.a12_accumulate(*strided, 256, 15, 2)


@pytest.mark.cuda
def test_cuda_row_offsets_match_bincount(cuda_device):
    rng = np.random.default_rng(4)
    r_pad = 1024
    pix = np.concatenate([rng.integers(0, 300, 5000), rng.integers(r_pad, 2 * r_pad, 50)])
    pm = torch.as_tensor(pix.astype(np.int32), device=cuda_device)
    order, off = TK.sorted_runs(pm, r_pad)
    counts = torch.bincount(pm.long(), minlength=2 * r_pad)[:r_pad]
    want = torch.zeros(r_pad + 1, dtype=torch.int64, device=cuda_device)
    want[1:] = torch.cumsum(counts, 0)
    assert off.dtype == torch.int32 and torch.equal(off.long(), want)
    assert torch.equal(order.long(), torch.sort(pm, stable=True).indices)


@pytest.mark.cuda
def test_cuda_kernel_launch_captured_in_a_graph(cuda_device):
    """The kernel's ctypes launch goes to the capture stream: a replay of the
    captured call gives the eager call's bits, and counts one launch."""
    rng = np.random.default_rng(8)
    hw, knots, dim = 4096, 20, 60
    args = make_inputs(rng, 40_000, hw, knots, 2, cuda_device)
    want = TK.a12_accumulate(*args, hw, dim, 2)
    torch.cuda.synchronize()
    phase = lm.CapturedPhase(lambda: TK.a12_accumulate(*args, hw, dim, 2))
    assert phase.launches == {"a12_accum": 1}
    before = TK.launches
    phase.replay()
    torch.cuda.synchronize()
    assert TK.launches == before + 1
    for x, y in zip(phase.out, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16])
def test_cuda_gather_kernel_matches_plain(cuda_device, rows):
    rng = np.random.default_rng(rows)
    n = 50_000
    payload = torch.as_tensor(rng.standard_normal((rows, n)), dtype=torch.float32,
                              device=cuda_device)
    perm = rng.permutation(n)[:n // TG.MC * TG.MC].reshape(-1, TG.MC)
    idx = torch.as_tensor(perm.astype(np.int32), device=cuda_device)
    cols = payload.double()[:, idx.reshape(-1).long()]
    want, scale = cols.sum(1, keepdim=True), cols.abs().sum(1, keepdim=True)
    for serial in (False, True):
        before = TG.launches
        got = TG.gather_sum(payload, idx, serial)
        again = TG.gather_sum(payload, idx, serial)
        assert TG.launches == before + 2
        assert got.shape == (rows, 1) and torch.equal(got, again)
        assert torch.max((got.double() - want).abs() / scale) <= 1e-6


def gather_reference(payload, idx):
    """(f64 sums of the named columns, their sums of magnitudes)."""
    cols = payload.double()[:, idx.reshape(-1).long()]
    return cols.sum(1, keepdim=True), cols.abs().sum(1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mc", [1, 100, 256, 1000])
@pytest.mark.parametrize("rows", [3, 17])
def test_cuda_gather_bits_do_not_depend_on_passes_or_grid(cuda_device, rows, mc):
    """The batched row sweep at N = 1M (R*N*4 = 12 or 68 MB: the rule sweeps
    R = 17 in several passes): passes of 1, 2 (which divides neither R), R
    and the rule's rows, and grids of 1, 3 and the card's blocks, give the
    same bits, within 1e-6 of the f64 sum's sum of magnitudes; so does the
    serial discipline. MC = 1000 takes the kernels' paths for chunks wider
    than a warp's 256 ids and a block's 256 threads."""
    rng = np.random.default_rng(100 * rows + mc)
    n = 1_000_000
    payload = torch.as_tensor(rng.standard_normal((rows, n)), dtype=torch.float32,
                              device=cuda_device)
    chunks = min(n // mc, 4096)
    ids = rng.permutation(n)[:chunks * mc].reshape(chunks, mc).astype(np.int32)
    idx = torch.as_tensor(ids, device=cuda_device)
    want, scale = gather_reference(payload, idx)
    rule = TG.device_pass_size(payload)
    if rows == 17:
        assert rule < rows
    got = TG.gather_sum(payload, idx, False)
    assert got.shape == (rows, 1)
    assert torch.max((got.double() - want).abs() / scale) <= 1e-6
    for p, blocks in [(1, None), (2, None), (rows, None), (rule, 3), (2, 1)]:
        again = TG.gather_sum(payload, idx, False, rows_per_pass=p, grid_blocks=blocks)
        assert torch.equal(again, got), (p, blocks)
    serial = TG.gather_sum(payload, idx, True)
    assert torch.max((serial.double() - want).abs() / scale) <= 1e-6


@pytest.mark.cuda
def test_cuda_gather_repeated_ids_and_a_bad_id(cuda_device):
    """Ids repeated many times in a chunk and across chunks sum each
    repeat; one id out of range among 10^5 is refused by the host check."""
    rng = np.random.default_rng(31)
    payload = torch.as_tensor(rng.standard_normal((5, 10_000)), dtype=torch.float32,
                              device=cuda_device)
    idx = torch.as_tensor(rng.integers(0, 40, (400, TG.MC)).astype(np.int32),
                          device=cuda_device)
    want, scale = gather_reference(payload, idx)
    for serial in (False, True):
        got = TG.gather_sum(payload, idx, serial, rows_per_pass=2)
        assert torch.max((got.double() - want).abs() / scale) <= 1e-6
    bad = idx.clone()
    bad[123, 45] = 10_000
    with pytest.raises(IndexError):
        TG.gather_sum(payload, bad, False)
    bad[123, 45] = -1
    with pytest.raises(IndexError):
        TG.gather_sum(payload, bad, True)


@pytest.mark.cuda
def test_cuda_gather_kernel_rejects_what_it_cannot_take(cuda_device):
    payload = torch.zeros((4, 100), device=cuda_device)
    idx = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        TG.gather_sum(payload.double(), idx, False)
    with pytest.raises(ValueError, match="int32"):
        TG.gather_sum(payload, idx.long(), False)
    with pytest.raises(IndexError):
        TG.gather_sum(payload, idx + 100, True)
    with pytest.raises(ValueError, match="device"):
        TG.gather_sum(payload, idx.cpu(), True)


@pytest.mark.cuda
def test_cuda_fused_window_follows_host_loop(cuda_device):
    """solve_window_fused on CUDA graphs against the host loop on the card:
    same iterations and accepts, final cost to 1e-5, one kernel launch per
    forming pass, the host loop's forming passes replayed; a second call
    reuses the graphs and gives the same bits."""
    sensor = synth.default_sensor(48, 48, f=44.0)
    rng = np.random.default_rng(42)
    B = synth.smooth_random_map(96, 192, rng, smooth=3, amp=3.0)
    scene = synth.generate(rng, sensor, pano_width=192, pano_height=96, c_th=0.1,
                           t_end=1.0, dt_knots=0.05, num_steps=600, motion_amp=0.25,
                           brightness=B)
    cfg = TM.ModelConfig(c_th=0.1, pano_width=192, pano_height=96,
                         thres_valid_pixel=3, alpha=0.5, outlier_dp_norm=3.0)
    steps = np.random.default_rng(7).normal(size=(scene.traj.num_knots, 3)) * 0.015
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    traj0 = dataclasses.replace(scene.traj, knots=spline._np_exp(walk) @ scene.traj.knots)
    win = build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width, traj0.locate,
                       100)
    dev = TM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                      torch.float32, cuda_device)
    start = [torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
             for a in (traj0.knots, scene.gx, scene.gy)]
    _k, _gx, _gy, st = solver.solve_window(
        *start, dev, cfg, solver.LMConfig(max_num_iter=8, tol_fun=0.0), fix_first=True)
    stats = lm.LoopStats()
    kernels.reset_launch_counts()
    k, gx, gy, cost, it, conv, trace = solver.solve_window_fused(
        *start, dev, cfg, 1.0, 0.0, fix_first=True, max_num_iter=8, return_trace=True,
        stats=stats)
    torch.cuda.synchronize()
    recs = lm.trace_records(trace.double().cpu().numpy(), int(it))
    assert int(it) == len(st.iterations)
    assert [r["accepted"] for r in recs] == [
        r["cost_new"] < r["cost_min"] for r in st.iterations]
    host_cost = min([r["cost_min"] for r in st.iterations]
                    + [r["cost_new"] for r in st.iterations])
    assert abs(float(cost) - host_cost) <= 1e-5 * abs(host_cost)
    assert kernels.launch_counts()["a12_accum"] == stats.form_passes
    assert stats.replays["form"] == st.count_form
    assert all(torch.isfinite(t).all() for t in (k, gx, gy))
    # a second call reuses the captured graphs: no set-up, the same bits
    again = lm.LoopStats()
    kernels.reset_launch_counts()
    out = solver.solve_window_fused(
        *start, dev, cfg, 1.0, 0.0, fix_first=True, max_num_iter=8, return_trace=True,
        stats=again)
    torch.cuda.synchronize()
    assert again.setup_s == 0.0 and again.form_passes == stats.form_passes - 1
    assert kernels.launch_counts()["a12_accum"] == again.form_passes
    assert all(torch.equal(a, b) for a, b in zip(out, (k, gx, gy, cost, it, conv, trace)))


@pytest.mark.cuda
def test_cuda_graph_cache_counters(cuda_device, monkeypatch):
    """The graphed window's cache in the run record on the card: a second
    window of the same shapes is a hit, a window of other shapes a capture
    and an evict; each build is an lm.capture span and each step's host
    read of the status an lm.status_wait."""
    monkeypatch.setattr(solver, "_GRAPHED", {})
    sensor = synth.default_sensor(48, 48, f=44.0)
    scene = synth.generate(np.random.default_rng(11), sensor, pano_width=128,
                           pano_height=64, c_th=0.2, t_end=0.5, dt_knots=0.05,
                           num_steps=120, motion_amp=0.3)
    cfg = TM.ModelConfig(c_th=0.2, pano_width=128, pano_height=64,
                         thres_valid_pixel=3, alpha=2.0)
    start = [torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
             for a in (scene.traj.knots, scene.gx, scene.gy)]

    def window(n):
        win = build_window(scene.t[:n], scene.x[:n], scene.y[:n], scene.pol[:n],
                           sensor.width, scene.traj.locate, 100)
        return TM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                           torch.float32, cuda_device)

    full, half = window(len(scene.t)), window(len(scene.t) // 2)
    rec = obs.Record()
    steps = 0
    with obs.recording(rec):
        for win in (full, full, half):
            out = solver.solve_window_fused(*start, win, cfg, 1.0, 1e-3, fix_first=True,
                                            max_num_iter=4)
            steps += int(out[4])
    rec.finish()
    assert {k: v for k, v in rec.counters.items() if k.startswith("lm.graph")} == {
        "lm.graph_capture": 2, "lm.graph_hit": 1, "lm.graph_evict": 1}
    assert [s.name for s in rec.spans] == ["lm.capture", "lm.capture"]
    assert rec.repeats["lm.status_wait"][1] == rec.counters["lm.replays.solve"] == steps


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_cuda_pipeline_two_windows_matches_cpu_f64(cuda_device, tmp_path, fused):
    """A tiny two-window pipeline (40x40 sensor, 128x64 panorama, 0.6 s) on
    the card in f32 against the same pipeline on the CPU in f64: the same
    windows and knot count, knots within 1e-4 (f32 against f64 through each
    window's Cholesky solves, as chip_smoke.py's reference check), finite
    maps; on the card the A12 launches equal the forming passes."""
    from emba_tpu_torch import cli, config, pipeline
    from emba_tpu_torch import io as eio
    from emba_tpu_torch.camera import load_camera_yaml

    cli.main(["synth", "--out", str(tmp_path), "--sensor", "40", "--pano-height", "64",
              "--duration", "0.6", "--steps", "300", "--motion", "0.2", "--c-th", "0.1"])
    events = eio.load_events_npz(str(tmp_path / "events.npz"))[:4]
    poses = eio.load_tum_trajectory(str(tmp_path / "traj_gt.txt"))
    gx, gy = eio.load_map_bin(str(tmp_path / "Gx.bin"), str(tmp_path / "Gy.bin"))
    kw = dict(start_time=0.0, stop_time=0.6, c_th=0.1, alpha=0.5, max_num_iter=3,
              dt_knots=0.05, time_window_size=0.3, sliding_window_stride=0.3,
              fused_lm=fused)

    def run(device, dtype):
        return pipeline.EmbaPipeline(
            config.BAConfig(**kw, dtype=dtype), load_camera_yaml(str(tmp_path / "calib.yaml")),
            events, *poses, init_gx=gx.copy(), init_gy=gy.copy(), device=device).run()

    ref = run("cpu", "float64")
    kernels.reset_launch_counts()
    res = run(cuda_device, "float32")
    torch.cuda.synchronize()
    assert len(res.window_stats) == len(ref.window_stats) == 2
    assert res.trajectory.num_knots == ref.trajectory.num_knots
    assert [st.lm_mode for st in res.window_stats] == ["fused" if fused else "host"] * 2
    assert kernels.launch_counts()["a12_accum"] == sum(
        st.count_form for st in res.window_stats)
    if fused:  # each window's own event count: graphs captured anew
        assert all(st.setup_s > 0 for st in res.window_stats)
    assert np.max(np.abs(res.trajectory.knots - ref.trajectory.knots)) <= 1e-4
    assert np.isfinite(res.gx).all() and np.isfinite(res.gy).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_cuda_two_rank_gloo_pipeline_matches_cpu_f64(cuda_device, tmp_path, fused):
    """The tiny two-window pipeline with num_devices=2: two ranks on the one
    card over gloo (tensors staged through the host), f32, against one
    device on the CPU in f64: the same windows, the sharded LM mode, knots
    within 1e-3; each rank's A12 launches equal its forming passes."""
    import _torch_dist_worker as W
    from emba_tpu_torch import cli, config, dist, pipeline
    from emba_tpu_torch import io as eio
    from emba_tpu_torch.camera import load_camera_yaml

    cli.main(["synth", "--out", str(tmp_path), "--sensor", "40", "--pano-height", "64",
              "--duration", "0.6", "--steps", "300", "--motion", "0.2", "--c-th", "0.1"])
    kw = dict(start_time=0.0, stop_time=0.6, c_th=0.1, alpha=0.5, max_num_iter=3,
              dt_knots=0.05, time_window_size=0.3, sliding_window_stride=0.3,
              fused_lm=fused)
    gx, gy = eio.load_map_bin(str(tmp_path / "Gx.bin"), str(tmp_path / "Gy.bin"))
    ref = pipeline.EmbaPipeline(
        config.BAConfig(**kw, dtype="float64"), load_camera_yaml(str(tmp_path / "calib.yaml")),
        eio.load_events_npz(str(tmp_path / "events.npz"))[:4],
        *eio.load_tum_trajectory(str(tmp_path / "traj_gt.txt")), init_gx=gx.copy(),
        init_gy=gy.copy(), device="cpu").run()
    ranks = dist.spawn(W.pipeline_rank, 2, "gloo", device="cuda", timeout_s=600, args=(
        str(tmp_path), [("run", {**kw, "dtype": "float32"}, {}, None)], "cuda"))
    res = ranks[0]["run"]
    assert len(res.window_stats) == len(ref.window_stats) == 2
    mode = ("fused" if fused else "host") + "-sharded"
    assert [st.lm_mode for st in res.window_stats] == [mode] * 2
    for r in ranks:
        assert r["a12_launches"]["run"] == sum(st.count_form for st in r["run"].window_stats)
        np.testing.assert_array_equal(r["run"].trajectory.knots, res.trajectory.knots)
    assert np.max(np.abs(res.trajectory.knots - ref.trajectory.knots)) <= 1e-3
    assert np.isfinite(res.gx).all() and np.isfinite(res.gy).all()


@pytest.mark.cuda
@pytest.mark.parametrize("light", [False, True])
def test_cuda_streamed_window_follows_host_loop(cuda_device, light):
    """A streamed window (chunks of 2^16 events on a window padded to a
    multiple) on the card, fused and through the host loop, and the
    classic window on the card, against the classic window in f64 on the
    CPU: the same steps, each final cost within 1e-3 of the f64 one (f32
    against f64, as chip_smoke.py's reference check; the chunked and the
    one-pass f32 sums round in other orders, which the LM steps carry into
    the cost), the two streamed loops within 1e-5 of each other, A12
    launches = forming passes x chunks; the map-only step twice within
    model.MAP_ONLY_REPEAT_REL_TOL."""
    sensor = synth.default_sensor(48, 48, f=44.0)
    rng = np.random.default_rng(42)
    B = synth.smooth_random_map(96, 192, rng, smooth=3, amp=3.0)
    scene = synth.generate(rng, sensor, pano_width=192, pano_height=96, c_th=0.1,
                           t_end=1.0, dt_knots=0.05, num_steps=600, motion_amp=0.25,
                           brightness=B)
    cfg = TM.ModelConfig(c_th=0.1, pano_width=192, pano_height=96,
                         thres_valid_pixel=3, alpha=0.5, outlier_dp_norm=3.0)
    chunk = 1 << 16
    scfg = dataclasses.replace(cfg, stream_chunk=chunk, stream_light=light)
    steps = np.random.default_rng(7).normal(size=(scene.traj.num_knots, 3)) * 0.015
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    traj0 = dataclasses.replace(scene.traj, knots=spline._np_exp(walk) @ scene.traj.knots)
    win = build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width, traj0.locate,
                       100)
    dev = TM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                      torch.float32, cuda_device, pad_multiple=chunk)
    chunks = len(TM.stream_bounds(dev.pol_signed.shape[0], chunk))
    assert chunks > 1
    start = [torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
             for a in (traj0.knots, scene.gx, scene.gy)]
    lmc = solver.LMConfig(max_num_iter=8, tol_fun=0.0)
    dev64 = TM.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                        torch.float64, "cpu")
    ref = solver.solve_window(*[torch.as_tensor(a, dtype=torch.float64) for a in (
        traj0.knots, scene.gx, scene.gy)], dev64, cfg, lmc, fix_first=True)[3]
    classic = solver.solve_window(*start, dev, cfg, lmc, fix_first=True)[3]
    kernels.reset_launch_counts()
    _k, _gx, _gy, st = solver.solve_window(*start, dev, scfg, lmc, fix_first=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["a12_accum"] == st.count_form * chunks

    def accepts(s):
        return [r["cost_new"] < r["cost_min"] for r in s.iterations]

    def final(s):
        return min([r["cost_min"] for r in s.iterations]
                   + [r["cost_new"] for r in s.iterations])

    assert accepts(st) == accepts(classic) == accepts(ref)
    for run in (st, classic):
        assert abs(final(run) - final(ref)) <= 1e-3 * abs(final(ref))
    stats = lm.LoopStats()
    kernels.reset_launch_counts()
    k, gx, gy, cost, it, conv, trace = solver.solve_window_fused(
        *start, dev, scfg, 1.0, 0.0, fix_first=True, max_num_iter=8, return_trace=True,
        stats=stats)
    torch.cuda.synchronize()
    recs = lm.trace_records(trace.double().cpu().numpy(), int(it))
    assert [r["accepted"] for r in recs] == accepts(st)
    assert abs(float(cost) - final(st)) <= 1e-5 * abs(final(st))
    assert kernels.launch_counts()["a12_accum"] == stats.form_passes * chunks
    assert stats.replays["form"] == st.count_form
    assert all(torch.isfinite(t).all() for t in (k, gx, gy))

    z = torch.zeros_like(start[1])
    a = TM.solve_map_only(start[0], z, z, dev, scfg)
    b = TM.solve_map_only(start[0], z, z, dev, scfg)
    assert a[2][1] < a[2][0]
    for x, y in zip(a[:2], b[:2]):
        assert float((x - y).abs().max()) <= TM.MAP_ONLY_REPEAT_REL_TOL * float(
            y.abs().max())


@pytest.mark.cuda
def test_cuda_deferred_cap_streamed_window_follows_host_loop(cuda_device):
    """A window whose event bound overshoots ``pipeline.ROWS_LARGE`` (a
    128x96 sensor onto a 4096x2048 map, ~2.4M events at
    ``thres_valid_pixel`` 1: the bound leaves the 2^23-pixel map
    uncompacted) defers its compaction cap and sizes it from the active
    pixels counted at its start; streamed in chunks of 2^19 events, fused
    on the card and through the host loop, against the same pipeline in
    f64 on the CPU: the same cap on all three, no pixel past it; the same
    steps and accepts, final costs within 1e-5 of each other on the card
    and within 1e-3 of the f64 one (as the streamed window above); A12
    launches = forming passes x chunks."""
    from emba_tpu_torch import config, pipeline

    sensor = synth.default_sensor(128, 96, f=106.0)
    rng = np.random.default_rng(3)
    B = synth.smooth_random_map(2048, 4096, rng, smooth=31, amp=3.0)
    scene = synth.generate(rng, sensor, pano_width=4096, pano_height=2048, c_th=0.05,
                           t_end=1.0, dt_knots=0.05, num_steps=400, motion_amp=0.25,
                           brightness=B)
    steps = np.random.default_rng(7).normal(size=(scene.traj.num_knots, 3)) * 0.01
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    traj0 = dataclasses.replace(scene.traj, knots=spline._np_exp(walk) @ scene.traj.knots)
    pose_t = np.arange(0.0, 1.0, 1.0 / 200)
    pose_R = traj0.evaluate(pose_t)
    chunk = 1 << 19
    kw = dict(start_time=0.05, stop_time=0.95, c_th=0.05, alpha=0.5, max_num_iter=6,
              dt_knots=0.05, thres_valid_pixel=1, outlier_dp_norm=3.0, stream_chunk=chunk)
    events = (scene.t, scene.x, scene.y, scene.pol)

    def run(device, dtype, fused):
        pipe = pipeline.EmbaPipeline(
            config.BAConfig(**kw, dtype=dtype, fused_lm=fused), sensor, events, pose_t,
            pose_R, init_gx=scene.gx, init_gy=scene.gy, device=device)
        return pipe.run(), pipe.record.counters

    assert pipeline.auto_compact_cap(4096 * 2048, len(scene.t), 1) is None
    ref, ref_cnt = run("cpu", "float64", False)
    host, host_cnt = run(cuda_device, "float32", False)
    kernels.reset_launch_counts()
    fused, fused_cnt = run(cuda_device, "float32", True)
    torch.cuda.synchronize()
    st = fused.window_stats[0]
    chunks = -(-st.num_events // chunk)
    assert chunks > 1
    assert kernels.launch_counts()["a12_accum"] == st.count_form * chunks
    assert fused_cnt["plan.active_px"] == host_cnt["plan.active_px"]
    for res, cnt in ((ref, ref_cnt), (host, host_cnt), (fused, fused_cnt)):
        cap = res.model_config.compact_cap
        assert cap == fused.model_config.compact_cap <= pipeline.ROWS_LARGE
        assert cap == pipeline.retune_compact_cap(cnt["plan.active_px"], 4096 * 2048)
        assert res.model_config.stream_chunk == chunk
        assert cnt["plan.rows"] == cap and cnt["plan.overflow_px"] == 0

    def accepts(r):
        return [it["cost_new"] < it["cost_min"] for it in r.window_stats[0].iterations]

    def final(r):
        its = r.window_stats[0].iterations
        return min([it["cost_min"] for it in its] + [it["cost_new"] for it in its])

    assert accepts(fused) == accepts(host) == accepts(ref)
    assert abs(final(fused) - final(host)) <= 1e-5 * abs(final(host))
    for r in (fused, host):
        assert abs(final(r) - final(ref)) <= 1e-3 * abs(final(ref))
    assert np.isfinite(fused.gx).all() and np.isfinite(fused.trajectory.knots).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pad", [(torch.float32, 1), (torch.float64, 1 << 19)])
def test_cuda_device_window_equals_host_build(cuda_device, dtype, pad):
    """``DeviceWindow.from_window`` paired on the card at the bicycle cell's
    size (3.5M events, 240x180) against the host build of the same fields
    (``compute_prev_index``, the LUT gathered in f64 on the host, then
    cast): every field equal in dtype, shape and bits, a padded window
    too; the upload copies at most 9 bytes an event besides the batch
    arrays and the LUT."""
    import _host_window as HW

    rng = np.random.default_rng(15)
    w, h, n = 240, 180, 3_494_000
    sensor = synth.default_sensor(w, h, f=200.0)
    lut = sensor.bearing_lut()
    x = rng.integers(0, w, n).astype(np.int32)
    y = rng.integers(0, h, n).astype(np.int32)
    t = np.sort(rng.uniform(0.0, 4.8, n))
    pol = rng.integers(0, 2, n).astype(np.int8)

    def locate(tq):
        return np.floor(tq / 0.05).astype(np.int32), tq / 0.05 - np.floor(tq / 0.05)

    win = build_window(t, x, y, pol, w, locate, 100)
    rec = obs.Record()
    with obs.recording(rec):
        dev = TM.DeviceWindow.from_window(win, lut, w, dtype, cuda_device,
                                          pad_multiple=pad)
    rec.finish()
    assert "prev_idx" not in vars(win)
    assert dev.bearings.device.type == "cuda"
    HW.assert_same_window(dev, HW.host_window(win, lut, w, dtype, pad))
    nb, item = len(win.batch_s), dtype.itemsize
    assert rec.counters["window.upload_bytes"] <= (9 * win.num_events + (4 + item) * nb
                                                   + lut.size * item)


SCHUR_CELLS = [  # the benchmark cells' row spaces, columns and listed rows
    pytest.param(1 << 19, 320, 291, 42_000, id="bicycle"),
    pytest.param(1 << 19, 608, 603, 52_000, id="boxes"),
    pytest.param(1 << 21, 320, 291, 600_000, id="dvx_4k"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("r_pad,dp,dim,n", SCHUR_CELLS)
def test_cuda_schur_rows_matches_f64_at_cell_shapes(cuda_device, r_pad, dp, dim, n):
    """The active-row Schur kernel at the cells' shapes against float64 sums
    over the listed rows: S_red (exactly symmetric) and rhs_red to 1e-4 of
    their largest magnitude, because each f32 partial sums up to 2n/splits
    terms in sequence (about 2e4 at the 4K shape; sqrt(L) u is 1e-5, L u
    1e-3); x2 to 1e-4 of its largest, and exactly zero on every other row.
    Two calls give the same bits, and each call is one launch."""
    from emba_tpu_torch.probes import schur_probe as SP
    from emba_tpu_torch.kernels import schur_rows as SR

    neq = SP.synthetic_system(r_pad, dp, dim, n, cuda_device)
    m00, m01, m11, live = TM._damped_a22_inv(neq, torch.tensor(1e-3, device=cuda_device))
    rows, count = SR.row_list(live)
    assert int(count) == n
    vecs = (m00, m01, m11, neq.b2_x, neq.b2_y)
    x = torch.zeros(dp, device=cuda_device)
    x[3:dim] = 1e-2 * torch.randn(dim - 3, device=cuda_device)
    before = SR.launches
    got = SR.schur_reduce(neq.A12, rows, count, *vecs, 3, dim)
    again = SR.schur_reduce(neq.A12, rows, count, *vecs, 3, dim)
    x2 = SR.back_substitute(neq.A12, rows, count, *vecs, x)
    assert SR.launches == before + 3
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(x2, SR.back_substitute(neq.A12, rows, count, *vecs, x))
    S_d, rhs_d, x2_d, _scale, r = SP.listed_f64(neq, rows, count, vecs, 3, dim, x)
    S, rhs = got
    assert torch.equal(S, S.T)
    assert (S.double() - S_d).abs().max() <= 1e-4 * S_d.abs().max()
    assert (rhs.double() - rhs_d).abs().max() <= 1e-4 * rhs_d.abs().max()
    assert (x2[:, r].double() - x2_d).abs().max() <= 1e-4 * x2_d.abs().max()
    others = torch.ones(r_pad, dtype=torch.bool, device=cuda_device)
    others[r] = False
    assert bool((x2[:, others] == 0).all())


@pytest.mark.cuda
def test_cuda_schur_graph_reads_the_count_on_the_device(cuda_device):
    """One CUDA graph of the whole Schur solve, captured once, replayed over
    three activity patterns of other counts (5%, 30%, 0.1% of 2^17 rows,
    bicycle's columns) loaded into its input buffers: each replay gives
    the bits of an eager solve of that pattern, so the kernels read the
    row list and its length on the device."""
    from emba_tpu_torch.probes import schur_probe as SP

    r_pad, dp, dim = 1 << 17, 320, 291
    neq = SP.synthetic_system(r_pad, dp, dim, r_pad // 2, cuda_device)
    lam = torch.tensor(1e-3, device=cuda_device)
    TM.solve_normal_eq(neq, lam, True)  # builds the library, makes the solver handles
    torch.cuda.synchronize()
    phase = lm.CapturedPhase(lambda: TM.solve_normal_eq(neq, lam, True))
    assert phase.launches == {"schur_rows": 2}
    g = torch.Generator(device=cuda_device).manual_seed(5)
    for share in (0.05, 0.30, 0.001):
        pattern = torch.rand(r_pad, generator=g, device=cuda_device) < share
        neq.active.copy_(pattern)
        want = TM.solve_normal_eq(neq, lam, True)
        phase.replay()
        torch.cuda.synchronize()
        for x, y in zip(phase.out, want):
            assert torch.equal(x, y)
        assert bool((phase.out[1][:, ~pattern] == 0).all())


@pytest.mark.cuda
def test_cuda_f64_solve_takes_the_plain_path(cuda_device):
    """A float64 system on the card is solved by the plain active-row
    version (no launch of the kernel) and matches the same solve on the
    CPU to 1e-12."""
    from emba_tpu_torch.kernels import schur_rows as SR
    from emba_tpu_torch.probes import schur_probe as SP

    neq32 = SP.synthetic_system(1 << 14, 64, 60, 3000, cuda_device)
    neq = TM.NormalEq(**{f.name: (getattr(neq32, f.name).double()
                                  if getattr(neq32, f.name).is_floating_point()
                                  else getattr(neq32, f.name))
                         for f in dataclasses.fields(neq32)})
    before = SR.launches
    x1, x2 = TM.solve_normal_eq(neq, 1e-3, True)
    assert SR.launches == before
    cpu = TM.NormalEq(**{f.name: getattr(neq, f.name).cpu() for f in dataclasses.fields(neq)})
    x1c, x2c = TM.solve_normal_eq(cpu, 1e-3, True)
    assert (x1.cpu() - x1c).abs().max() <= 1e-12 * x1c.abs().max()
    assert (x2.cpu() - x2c).abs().max() <= 1e-12 * x2c.abs().max()
