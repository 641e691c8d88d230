"""The port's sliding-window pipeline and CLI against the JAX package's on
the CPU in f64, on the tiny scene of ``tests/test_pipeline.py`` (40x40
sensor, 128x64 panorama, 0.6 s, made by the CLI's ``synth`` from seed 0):
one whole-span window and two sliding windows, each fused and through the
host loop; checkpoints and resume within the port and across packages;
the CLI end to end; the streamed tiers, a window streamed by the plan
above the classic cap and the super-resolution map; the option that is
not ported yet; the fused-cap fallback.

Tolerances: against JAX the same window count, knot count, iterations per
window, active pixels per forming pass and LM mode, and knots and maps to
relative 1e-8 of their largest magnitude (rounding differences grow through
each Cholesky solve and state update, as in ``test_torch_solver.py``);
within the port a resumed run equals the uninterrupted one bit for bit.
Each JAX run is made once per module.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

import emba_tpu.config as JC
import emba_tpu.pipeline as JP
from emba_tpu import cli as jcli
from emba_tpu.camera import load_camera_yaml as j_load_camera_yaml
from emba_tpu_torch import cli as tcli
from emba_tpu_torch import config as TC
from emba_tpu_torch import io as tio
from emba_tpu_torch import kernels
from emba_tpu_torch import pipeline as TP
from emba_tpu_torch.camera import load_camera_yaml

REL = 1e-8
ONE = dict(start_time=0.02, stop_time=0.58, c_th=0.1, alpha=0.5, max_num_iter=6,
           dt_knots=0.05, dtype="float64", outlier_dp_norm=3.0, thres_valid_pixel=3)
TWO = dict(start_time=0.0, stop_time=0.6, c_th=0.1, alpha=0.5, max_num_iter=4,
           dt_knots=0.05, dtype="float64", time_window_size=0.3,
           sliding_window_stride=0.3)
CASES = {"one": ONE, "two": TWO}
PLAN = TP.plan_model_config


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("tsynth")
    tcli.main(["synth", "--out", str(out), "--sensor", "40", "--pano-height", "64",
               "--duration", "0.6", "--steps", "300", "--motion", "0.2", "--c-th", "0.1"])
    t, x, y, pol, _ = tio.load_events_npz(str(out / "events.npz"))
    times, rots = tio.load_tum_trajectory(str(out / "traj_gt.txt"))
    gx, gy = tio.load_map_bin(str(out / "Gx.bin"), str(out / "Gy.bin"))
    return dict(dir=out, events=(t, x, y, pol), poses=(times, rots), maps=(gx, gy))


def port_pipe(ds, cfg, device="cpu", **kw):
    gx, gy = ds["maps"]
    return TP.EmbaPipeline(cfg, load_camera_yaml(str(ds["dir"] / "calib.yaml")),
                           ds["events"], *ds["poses"], init_gx=gx.copy(),
                           init_gy=gy.copy(), device=device, **kw)


def jax_pipe(ds, cfg, **kw):
    gx, gy = ds["maps"]
    return JP.EmbaPipeline(cfg, j_load_camera_yaml(str(ds["dir"] / "calib.yaml")),
                           ds["events"], *ds["poses"], init_gx=gx.copy(),
                           init_gy=gy.copy(), **kw)


@pytest.fixture(scope="module")
def jax_runs(dataset):
    """JAX's pipeline for each (case, mode), run once."""
    return {(case, mode): jax_pipe(dataset, JC.BAConfig(**kw, fused_lm=mode == "fused"))
            .run()
            for case, kw in CASES.items() for mode in ("fused", "host")}


def assert_runs_match(t, j, padded=False):
    """``padded``: a streamed host-loop window, whose event count JAX takes
    from its padded length; the port counts the window's events."""
    assert len(t.window_stats) == len(j.window_stats)
    assert t.trajectory.num_knots == j.trajectory.num_knots
    for ts, js in zip(t.window_stats, j.window_stats):
        assert len(ts.iterations) == len(js.iterations)
        assert ts.active_px_per_form == js.active_px_per_form
        assert ts.dropped_meas_per_form == js.dropped_meas_per_form
        assert ts.lm_mode == js.lm_mode
        if padded:
            chunk = t.model_config.stream_chunk
            assert js.num_events == -(-ts.num_events // chunk) * chunk
        else:
            assert ts.num_events == js.num_events
        assert [r["cost_new"] < r["cost_min"] for r in ts.iterations] == [
            r["cost_new"] < r["cost_min"] for r in js.iterations]
    assert rel_err(t.trajectory.knots, j.trajectory.knots) <= REL
    assert rel_err(t.gx, j.gx) <= REL and rel_err(t.gy, j.gy) <= REL


@pytest.mark.parametrize("mode", ["fused", "host"])
@pytest.mark.parametrize("case", ["one", "two"])
def test_pipeline_matches_jax(dataset, jax_runs, case, mode):
    kernels.reset_launch_counts()
    res = port_pipe(dataset, TC.BAConfig(**CASES[case], fused_lm=mode == "fused")).run()
    assert_runs_match(res, jax_runs[case, mode])
    assert len(res.window_stats) == (1 if case == "one" else 2)
    for st in res.window_stats:
        # the CPU runs the kernel's plain version: no launch; one forming
        # pass per entry of the per-form lists
        assert st.count_form == len(st.active_px_per_form) and st.setup_s == 0.0
    assert kernels.launch_counts()["a12_accum"] == 0


def test_cli_end_to_end_matches_jax(dataset, tmp_path, capsys):
    """synth -> run -> eval through both CLIs on the same files: the port's
    runtime.json has JAX's keys plus setup_s and the run record's spans_s
    and counters, and its eval RMSE equals JAX's."""
    d = dataset["dir"]
    args = ["run", "--events", str(d / "events.npz"), "--poses", str(d / "traj_gt.txt"),
            "--map-gx", str(d / "Gx.bin"), "--map-gy", str(d / "Gy.bin"), "--calib",
            str(d / "calib.yaml"), "--start-time", "0.02", "--stop-time", "0.58",
            "--c-th", "0.1", "--alpha", "0.5", "--max-num-iter", "6", "--dtype",
            "float64", "--outlier-dp", "3.0", "--thres-valid-pixel", "3"]
    res = tcli.main(args + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    tout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(args + ["--out", str(tmp_path / "j")])
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tout["windows"] == jout["windows"] == len(res.window_stats) == 1
    assert tout["num_knots"] == jout["num_knots"]
    fr = {k: tmp_path / k / "final_results" for k in "tj"}
    for name in ("trajectory_refined.txt", "Gx.bin", "Gy.bin", "runtime.json",
                 "iterations.txt", "checkpoint.npz"):
        assert (fr["t"] / name).exists(), name
    assert (tmp_path / "t" / "params.txt").exists()
    rt_t = json.loads((fr["t"] / "runtime.json").read_text())
    rt_j = json.loads((fr["j"] / "runtime.json").read_text())
    assert set(rt_t) == set(rt_j) | {"setup_s", "spans_s", "counters"}
    assert rt_t["lm_mode"] == rt_j["lm_mode"] == ["host"]
    assert rt_t["num_active_pixels"] == rt_j["num_active_pixels"]
    assert rt_t["phase_counts"] == rt_j["phase_counts"]
    assert rt_t["setup_s"] == [0.0]

    rmse = {}
    for k, cli in (("t", tcli), ("j", jcli)):
        cli.main(["eval", "--traj", str(fr[k] / "trajectory_refined.txt"), "--gt",
                  str(d / "traj_gt.txt")])
        rmse[k] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rmse["t"]["num_poses"] == rmse["j"]["num_poses"]
    assert rmse["t"]["rotation_rmse_deg"] == pytest.approx(
        rmse["j"]["rotation_rmse_deg"], rel=REL, abs=REL)
    assert rmse["t"]["rotation_rmse_deg"] < 2.0

    # no silent CPU path: the default device is the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(args)
        with pytest.raises(RuntimeError, match="CUDA"):
            port_pipe(dataset, TC.BAConfig(**ONE), device=None)
    with pytest.raises(SystemExit):
        tcli.main(args + ["--device", "gpu"])
    # the suite is ported: like run, it needs the card unless asked for the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["suite", "--out", str(tmp_path / "suite.json")])


def test_cli_reference_layout_and_clamp(dataset, tmp_path, capsys):
    """The reference's directory layout resolves the inputs (events from a
    bag), and a BA interval left at the preset's is clamped to the data,
    in both CLIs alike."""
    import shutil

    from emba_tpu_torch import rosbag

    d = dataset["dir"]
    seq = tmp_path / "datasets" / "ECRot_dataset" / "playroom"
    seq.mkdir(parents=True)
    rosbag.write_rosbag(str(seq / "events.bag"), "/dvs/events", *dataset["events"],
                        width=40, height=40)
    base = tmp_path / "inputs" / "ECRot_dataset" / "playroom"
    (base / "traj" / "interpolation").mkdir(parents=True)
    shutil.copy(d / "traj_gt.txt", base / "traj" / "interpolation" / "cmaxw_traj_interp.txt")
    maps = base / "map" / "frontend" / "cmaxw_traj_interp" / "bin"
    maps.mkdir(parents=True)
    for name in ("Gx.bin", "Gy.bin"):
        shutil.copy(d / name, maps / name)
    args = ["run", "--preset", "playroom", "--dataset-root-dir", str(tmp_path / "datasets"),
            "--input-data-dir", str(tmp_path / "inputs"), "--calib", str(d / "calib.yaml"),
            "--c-th", "0.1", "--alpha", "0.5", "--max-num-iter", "2", "--dtype", "float64"]
    res = tcli.main(args + ["--device", "cpu"])
    err = capsys.readouterr().err
    assert "clamping stop_time 2.4 -> 0.6" in err
    jcli.main(args)
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(res.window_stats) == jout["windows"] == 1
    assert res.trajectory.num_knots == jout["num_knots"]


def _killed_run(make, window, writes):
    """Run ``make()`` until its ``writes``-th mid-window checkpoint inside
    ``window``; returns the checkpoint path."""
    pipe = make()
    orig = pipe.save_checkpoint
    calls = []

    class Killed(Exception):
        pass

    def save_and_die(path, window_idx, lm_state=None):
        orig(path, window_idx, lm_state=lm_state)
        if lm_state is not None and window_idx == window:
            calls.append(path)
            if len(calls) >= writes:
                raise Killed

    pipe.save_checkpoint = save_and_die
    with pytest.raises(Killed):
        pipe.run()
    return calls[-1]


def test_resume_bitwise_within_port(dataset, tmp_path):
    """Window-boundary and mid-window checkpoints of a recording run resume
    to the bits of the uninterrupted run."""
    cfg = TC.BAConfig(**{**TWO, "max_num_iter": 6}, lm_checkpoint_every=1)

    def make(name):
        return port_pipe(dataset, cfg, result_dir=str(tmp_path / name), record_data=True)

    full = make("full").run()
    assert [st.lm_mode for st in full.window_stats] == ["host", "host"]

    part = make("part")
    part.t_ba_end = 0.3 + 1e-6  # only window 0 fits
    assert len(part.run().window_stats) == 1
    boundary = tmp_path / "part" / "final_results" / "checkpoint.npz"
    z = np.load(boundary)
    assert int(z["window_idx"]) == 1 and "mid_window" not in z

    mid = _killed_run(lambda: make("killed"), window=1, writes=3)
    z = np.load(mid)
    assert bool(z["mid_window"]) and int(z["window_idx"]) == 1 and int(z["lm_it"]) == 3

    for ckpt, skipped in ((boundary, 0), (mid, 3)):
        res = make(f"resumed{skipped}").run(resume_from=str(ckpt))
        assert len(res.window_stats) == 1
        assert (len(res.window_stats[0].iterations)
                == len(full.window_stats[1].iterations) - skipped)
        np.testing.assert_array_equal(res.trajectory.knots, full.trajectory.knots)
        np.testing.assert_array_equal(res.gx, full.gx)
        np.testing.assert_array_equal(res.gy, full.gy)


def test_resume_from_jax_checkpoint(dataset, tmp_path):
    """A mid-window checkpoint written by the JAX pipeline, resumed by the
    port, matches JAX's own resumed run."""
    kw = dict(**{**TWO, "max_num_iter": 6}, lm_checkpoint_every=1)
    cfg = JC.BAConfig(**kw)
    ckpt = _killed_run(lambda: jax_pipe(dataset, cfg, result_dir=str(tmp_path / "jk"),
                                        record_data=True), window=1, writes=2)
    j = jax_pipe(dataset, cfg, result_dir=str(tmp_path / "jr"),
                 record_data=True).run(resume_from=ckpt)
    t = port_pipe(dataset, TC.BAConfig(**kw), result_dir=str(tmp_path / "tr"),
                  record_data=True).run(resume_from=ckpt)
    assert_runs_match(t, j)
    assert len(t.window_stats[0].iterations) == len(j.window_stats[0].iterations) >= 1


@pytest.fixture(scope="module")
def sharded_runs(dataset):
    """The port's pipeline with num_devices=2 on two gloo CPU ranks, each
    case fused and host, run once (``_torch_dist_worker.pipeline_rank``)."""
    from emba_tpu_torch import dist

    import _torch_dist_worker as W

    runs = [(f"{case}-{mode}", {**CASES[case], "fused_lm": mode == "fused"}, {}, None)
            for case in CASES for mode in ("fused", "host")]
    return dist.spawn(W.pipeline_rank, 2, "gloo", args=(str(dataset["dir"]), runs),
                      device="cpu", timeout_s=300)


@pytest.mark.parametrize("mode", ["fused", "host"])
@pytest.mark.parametrize("case", ["one", "two"])
def test_sharded_pipeline_matches_jax(dataset, sharded_runs, case, mode):
    """num_devices=2: every window solved sharded over two ranks, against
    JAX's pipeline with num_devices=2 (a (2, 1) mesh of the virtual CPU
    devices); both ranks return the same result. Without a process group
    of two ranks the pipeline raises rather than run on one device."""
    cfg = {**CASES[case], "fused_lm": mode == "fused"}
    j = jax_pipe(dataset, JC.BAConfig(**cfg, num_devices=2)).run()
    t, t1 = (r[f"{case}-{mode}"] for r in sharded_runs)
    assert_runs_match(t, j)
    assert [st.lm_mode for st in t.window_stats] == [f"{mode}-sharded"] * len(j.window_stats)
    np.testing.assert_array_equal(t1.trajectory.knots, t.trajectory.knots)
    np.testing.assert_array_equal(t1.gx, t.gx)
    with pytest.raises(RuntimeError, match="process group"):
        port_pipe(dataset, TC.BAConfig(**cfg, num_devices=2))


STREAMED = {
    "stream_chunk": (dict(stream_chunk=4096), "fused"),
    "stream_light": (dict(stream_chunk=4096, stream_light=True), "host"),
    "super_res_height": (dict(super_res_height=128), "host"),
}


@pytest.mark.parametrize("option", list(STREAMED))
def test_streaming_options_match_jax(dataset, tmp_path, option):
    """The streamed tiers (FULL fused, LIGHT through the host loop) and the
    super-resolution map run and give JAX's run; the super-resolution run
    writes JAX's files, its maps and costs to relative 1e-8."""
    kw, mode = STREAMED[option]
    runs = []
    for C, make in ((TC, port_pipe), (JC, jax_pipe)):
        out = tmp_path / C.__name__.split(".")[0]
        rec = dict(result_dir=str(out), record_data=True) if mode == "host" else {}
        runs.append(make(dataset, C.BAConfig(**ONE, **kw, fused_lm=mode == "fused"),
                         **rec).run())
    assert_runs_match(*runs, padded="stream_chunk" in kw and mode == "host")
    mcfg = runs[0].model_config
    assert mcfg.stream_chunk == kw.get("stream_chunk")
    assert mcfg.stream_light == bool(kw.get("stream_light"))
    if option == "super_res_height":
        fr = {k: tmp_path / k / "final_results" for k in ("emba_tpu_torch", "emba_tpu")}
        t, j = ({n: tio.load_map_bin(str(f / "Gx_sr.bin"), str(f / "Gy_sr.bin"))[i]
                 for i, n in enumerate("xy")} for f in fr.values())
        assert t["x"].shape == (128, 256)
        assert rel_err(t["x"], j["x"]) <= REL and rel_err(t["y"], j["y"]) <= REL
        for name in ("G_hsv_sr.png", "poisson_sr.png"):
            assert (fr["emba_tpu_torch"] / name).exists(), name
        st, sj = (json.loads((f / "super_res.json").read_text()) for f in fr.values())
        assert set(st) == set(sj) and st["width"] == sj["width"] == 256
        assert rel_err(st["data_costs"], sj["data_costs"]) <= REL
        assert st["data_costs"][-1] < st["data_costs"][0]


def test_window_above_classic_cap_streams_like_jax(dataset, monkeypatch):
    """A window above the classic-window cap streams by the pipeline's own
    decision (the FULL tier, :data:`pipeline.AUTO_STREAM_CHUNK`, here set
    to 4096 events) and gives the run of JAX's pipeline streaming at that
    chunk, fused."""
    plan = TP.plan_model_config

    def small_caps(*a, **kw):
        return plan(*a, **kw, classic_cap_small=1000, classic_cap_large=1000)

    monkeypatch.setattr(TP, "plan_model_config", small_caps)
    monkeypatch.setattr(TP, "AUTO_STREAM_CHUNK", 4096)
    res = port_pipe(dataset, TC.BAConfig(**ONE, fused_lm=True)).run()
    assert res.model_config.stream_chunk == 4096 and not res.model_config.stream_light
    assert res.window_stats[0].num_events > 1000
    want = jax_pipe(dataset, JC.BAConfig(**ONE, fused_lm=True, stream_chunk=4096)).run()
    assert_runs_match(res, want)


def test_cli_streaming_flags(dataset, tmp_path, capsys):
    """``cli run --stream-chunk --stream-light --super-res-height --device
    cpu`` gives JAX's CLI run on the same files: the same windows, knots
    and super-resolution map."""
    d = dataset["dir"]
    args = ["run", "--events", str(d / "events.npz"), "--poses", str(d / "traj_gt.txt"),
            "--map-gx", str(d / "Gx.bin"), "--map-gy", str(d / "Gy.bin"), "--calib",
            str(d / "calib.yaml"), "--start-time", "0.02", "--stop-time", "0.58",
            "--c-th", "0.1", "--alpha", "0.5", "--max-num-iter", "3", "--dtype",
            "float64", "--outlier-dp", "3.0", "--thres-valid-pixel", "3",
            "--stream-chunk", "3000", "--stream-light", "1", "--super-res-height", "96"]
    res = tcli.main(args + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert res.model_config.stream_chunk == 3000 and res.model_config.stream_light
    jcli.main(args + ["--out", str(tmp_path / "j")])
    capsys.readouterr()
    fr = {k: tmp_path / k / "final_results" for k in "tj"}
    kt, kj = (np.loadtxt(f / "trajectory_refined.txt") for f in fr.values())
    assert rel_err(kt, kj) <= REL
    (tx, ty), (jx, jy) = (tio.load_map_bin(str(f / "Gx_sr.bin"), str(f / "Gy_sr.bin"))
                          for f in fr.values())
    assert tx.shape == (96, 192)
    assert rel_err(tx, jx) <= REL and rel_err(ty, jy) <= REL


@pytest.mark.parametrize("option,value", [
    ("compact_cap", 4096),
    ("light_trial", True),
    ("coarse_to_fine", True),
    ("multi_start", True),
])
def test_ported_options_match_jax(dataset, option, value):
    """Compaction, light trial, coarse-to-fine and multi-start run, fused,
    and give JAX's run: the same window stats (iterations, accepts, active pixels and dropped
    measurements per forming pass, LM mode with the multi-start winner)
    and knots and maps to relative 1e-8."""
    cfgs = []
    for C in (TC, JC):
        cfg = C.BAConfig(**ONE, fused_lm=True)
        setattr(cfg, option, value)
        cfgs.append(cfg)
    res = port_pipe(dataset, cfgs[0]).run()
    assert_runs_match(res, jax_pipe(dataset, cfgs[1]).run())
    if option == "multi_start":
        st = res.window_stats[0]
        assert st.lm_mode.startswith("fused+multistart:")
        assert [v["variant"] for v in st.variants] == [
            "curr", "curr+c2f", "mid", "mid+c2f"]
        # the winner has the lowest data cost; the counts cover every run
        sel = st.lm_mode.split(":")[1]
        costs = {v["variant"]: v["data_cost"] for v in st.variants}
        assert costs[sel] == min(costs.values())
        assert st.count_objective == sum(
            v["iterations"] + v["coarse_iterations"] for v in st.variants)


def test_auto_compaction_and_auto_stream_match_jax(dataset):
    """Where the reference turns on compaction by itself (a 2048x1024
    panorama), the port does too, with the same cap, and two windows run
    like the reference's, the cap retuned between them from the device's
    active-pixel count; where the reference would stream (a window above
    the classic cap), the port streams, at the reference's chunk: its
    decisions equal the reference's at the same inputs (mirror of
    tests/test_pipeline.py:585), an explicit stream_chunk and tier too."""
    z = np.zeros((1024, 2048))
    kw = dict(TWO, max_num_iter=2, fused_lm=True, thres_valid_pixel=1,
              outlier_dp_norm=30.0)
    runs = [P.EmbaPipeline(C.BAConfig(**kw), load(str(dataset["dir"] / "calib.yaml")),
                           dataset["events"], *dataset["poses"], init_gx=z.copy(),
                           init_gy=z.copy(), **dev).run()
            for P, C, load, dev in ((TP, TC, load_camera_yaml, dict(device="cpu")),
                                    (JP, JC, j_load_camera_yaml, {}))]
    assert_runs_match(*runs)
    for ts, js in zip(runs[0].window_stats, runs[1].window_stats):
        assert ts.overflow_active_pixels == js.overflow_active_pixels
        assert ts.active_px_per_form[0] > 0
    assert TP.auto_compact_cap(2048 * 1024, 10_000, 3) == JP.auto_compact_cap(
        2048 * 1024, 10_000, 3) == 4096
    assert TP.auto_compact_cap(1024 * 512, 2_000_000, 3) is None

    cfg_t, cfg_j = TC.BAConfig(), JC.BAConfig()
    t = np.concatenate([np.linspace(0.0, 0.5, 100, endpoint=False),
                        np.linspace(0.5, 1.0, 900)])
    mcfg = TC.BAConfig(pano_width=128, pano_height=64).model_config()
    jm = JC.BAConfig(pano_width=128, pano_height=64, use_pallas=False).model_config()
    for beg, end, cap in ((0.0, 1.0, 700), (0.0, 1.0, 500), (0.0, 0.1, 900),
                          (0.0, 0.1, 2000)):
        args = (t, beg, end, 0.8, 0.5, 1)
        want = JP.plan_model_config(jm, cfg_j, *args, classic_cap_small=cap,
                                    classic_cap_large=cap)[0]
        got, auto = TP.plan_model_config(mcfg, cfg_t, *args, classic_cap_small=cap,
                                         classic_cap_large=cap)
        assert (got.stream_chunk, got.stream_light, auto) == (
            want.stream_chunk, want.stream_light, False)
        assert got.stream_chunk in (None, TP.AUTO_STREAM_CHUNK)
    for kw in (dict(stream_chunk=1 << 10), dict(stream_chunk=1 << 10, stream_light=True),
               dict(stream_light=True), dict(stream_chunk=0)):
        ct, cj = TC.BAConfig(**kw), JC.BAConfig(**kw, use_pallas=False)
        args = (t, 0.0, 1.0, 0.8, 0.5, 1)
        got = TP.plan_model_config(ct.model_config(), ct, *args, classic_cap_small=500,
                                   classic_cap_large=500)[0]
        want = JP.plan_model_config(cj.model_config(), cj, *args, classic_cap_small=500,
                                    classic_cap_large=500)[0]
        assert (got.stream_chunk, got.stream_light) == (want.stream_chunk,
                                                        want.stream_light), kw
    assert TP.CLASSIC_CAP_LARGE_ROWS <= TP.CLASSIC_CAP_SMALL_ROWS


def test_fused_event_cap_fallback(dataset, tmp_path):
    """A window above fused_event_cap runs the host loop and records it
    (runtime.json lm_mode), as in the reference; the result is the host
    loop's."""
    kw = dict(start_time=0.02, stop_time=0.4, c_th=0.1, alpha=0.5, max_num_iter=3,
              dt_knots=0.05, dtype="float64")
    res = port_pipe(dataset, TC.BAConfig(**kw, fused_lm=True, fused_event_cap=100),
                    result_dir=str(tmp_path / "cap"), record_data=True).run()
    assert res.window_stats[0].lm_mode == "host(fused-cap-fallback)"
    rt = json.loads((tmp_path / "cap" / "final_results" / "runtime.json").read_text())
    assert rt["lm_mode"] == ["host(fused-cap-fallback)"]
    assert rt["phases_s"]["form"] > 0
    host = port_pipe(dataset, TC.BAConfig(**kw, fused_lm=False)).run()
    np.testing.assert_array_equal(res.trajectory.knots, host.trajectory.knots)
    big = port_pipe(dataset, TC.BAConfig(**kw, fused_lm=True, fused_event_cap=10**9)).run()
    assert big.window_stats[0].lm_mode == "fused"


# a span's end is its time.time_ns() start plus its perf_counter_ns()
# duration: ends compare within this
CLOCK_NS = 100_000
PIPELINE_SPANS = ("pipeline.init", "init.sort_cut", "init.map_filter", "init.bearing_lut",
                  "pipeline.run", "window.prep_wait", "window.prepare", "prepare.cut",
                  "prepare.pose_fit", "prepare.batches", "window.upload", "upload.copy",
                  "upload.pair", "window.solve", "window.result")


def assert_counters_match(rec, res):
    c = rec.counters
    assert c["windows"] == len(res.window_stats)
    assert c["window.events"] == sum(st.num_events for st in res.window_stats)
    assert c["lm.steps"] == sum(len(st.iterations) for st in res.window_stats)


def test_run_record_holds_the_pipeline_spans_in_causal_order(dataset):
    """One window, fused: the pipeline's run record (obs) holds every span of
    the constructor, the run and the window, each stage after the one it
    waits for, the preparation on the worker thread, the upload's copy and
    device pairing inside it on the run's thread; its counters equal the
    LMStats; pipeline.init and pipeline.run cover the job."""
    from emba_tpu_torch import obs

    pipe = port_pipe(dataset, TC.BAConfig(**ONE, fused_lm=True))
    res = pipe.run()
    rec = obs.runs()[-1]
    assert rec is pipe.record and rec.end_ns is not None
    assert [s.name for s in rec.spans if s.name in PIPELINE_SPANS] == [
        "init.sort_cut", "init.map_filter", "init.bearing_lut", "pipeline.init",
        "prepare.cut", "prepare.pose_fit", "prepare.batches", "window.prepare",
        "window.prep_wait", "upload.copy", "upload.pair", "window.upload", "window.solve",
        "window.result", "pipeline.run"]
    s = {sp.name: sp for sp in rec.spans}
    init, run, prep = s["pipeline.init"], s["pipeline.run"], s["window.prepare"]
    for name in ("init.sort_cut", "init.map_filter", "init.bearing_lut"):
        assert s[name].parent == init.id
    for name in ("prepare.cut", "prepare.pose_fit", "prepare.batches"):
        assert s[name].parent == prep.id and s[name].thread == prep.thread
    for name in ("upload.copy", "upload.pair"):
        assert s[name].parent == s["window.upload"].id and s[name].thread == run.thread
    assert s["upload.copy"].end_ns <= s["upload.pair"].start_ns + CLOCK_NS
    for name in ("window.prepare", "window.prep_wait", "window.upload", "window.solve",
                 "window.result"):
        assert s[name].parent == run.id
    assert init.parent is None and run.parent is None
    assert prep.thread != rec.thread == run.thread == init.thread
    order = ["pipeline.init", "window.prep_wait", "window.upload", "window.solve",
             "window.result"]
    for a, b in zip(order, order[1:]):
        assert s[a].end_ns <= s[b].start_ns + CLOCK_NS, (a, b)
    assert init.end_ns <= run.start_ns + CLOCK_NS <= prep.start_ns + 2 * CLOCK_NS
    assert prep.end_ns <= s["window.prep_wait"].end_ns + CLOCK_NS
    for a, b in (("prepare.cut", "prepare.pose_fit"), ("prepare.pose_fit",
                                                      "prepare.batches")):
        assert s[a].end_ns <= s[b].start_ns + CLOCK_NS
    assert rec.start_ns <= init.start_ns and run.end_ns <= rec.end_ns + CLOCK_NS
    assert_counters_match(rec, res)
    assert rec.counters["launches.a12_accum"] == 0  # the CPU runs the plain version
    tot = rec.totals()
    assert 0 <= tot["pipeline.run"]["self_s"] < tot["pipeline.run"]["total_s"]
    assert tot["window.prepare"]["total_s"] > 0 and tot["window.prep_wait"]["count"] == 1


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_run_record_counts_the_rows_each_solve_listed(dataset, monkeypatch, mode):
    """Two windows: the run record's counter solve.rows is the sum, over the
    windows' Schur solves (one an LM step), of the rows each solve listed;
    the loops read nothing more on the host (no lm.status_wait on the
    CPU, whose loops read their decision each step as before)."""
    from emba_tpu_torch.kernels import schur_rows as SR

    listed = []
    row_list = SR.row_list

    def counting(mask):
        rows, count = row_list(mask)
        listed.append(int(count))
        return rows, count

    monkeypatch.setattr(SR, "row_list", counting)
    pipe = port_pipe(dataset, TC.BAConfig(**TWO, fused_lm=mode == "fused"))
    res = pipe.run()
    c = pipe.record.counters
    assert len(listed) == c["lm.steps"] == sum(len(st.iterations) for st in res.window_stats)
    assert c["solve.rows"] == sum(listed) > 0
    assert "lm.status_wait" not in pipe.record.repeats


def test_fused_run_leaves_the_callers_events_untouched(dataset):
    """The constructor keeps read-only views of time-ordered events: a whole
    fused run leaves the caller's four arrays bit for bit as they were (and
    writeable), the pipeline's columns are not writeable, and the run gives
    the bits of a run on the same events shuffled, which the constructor
    sorts into copies of its own."""
    before = [a.copy() for a in dataset["events"]]
    pipe = port_pipe(dataset, TC.BAConfig(**ONE, fused_lm=True))
    got = pipe.run()
    assert pipe.record.counters["init.presorted"] == 1
    for col, a, b in zip((pipe.t, pipe.x, pipe.y, pipe.pol), dataset["events"], before):
        assert not col.flags.writeable and np.shares_memory(col, a)
        assert a.flags.writeable and a.dtype == b.dtype and a.tobytes() == b.tobytes()

    perm = np.random.default_rng(0).permutation(len(before[0]))
    shuffled = dict(dataset, events=tuple(a[perm] for a in before))
    other = port_pipe(shuffled, TC.BAConfig(**ONE, fused_lm=True))
    want = other.run()
    assert other.record.counters["init.presorted"] == 0
    assert np.array_equal(got.trajectory.knots, want.trajectory.knots)
    assert np.array_equal(got.gx, want.gx) and np.array_equal(got.gy, want.gy)


def test_pipeline_pairs_on_the_device_only(dataset, monkeypatch):
    """A one-window job never pairs on the host: with
    ``pairing.compute_prev_index`` raising, the job runs and gives the same
    bits as the job that may call it, and its upload hands over the raw
    columns (9 bytes an event), the batch arrays and the LUT."""
    from emba_tpu_torch import pairing

    want = port_pipe(dataset, TC.BAConfig(**ONE, fused_lm=True)).run()

    def host_pairing(*a, **k):
        raise AssertionError("the pipeline paired on the host")

    monkeypatch.setattr(pairing, "compute_prev_index", host_pairing)
    pipe = port_pipe(dataset, TC.BAConfig(**ONE, fused_lm=True))
    got = pipe.run()
    assert np.array_equal(got.trajectory.knots, want.trajectory.knots)
    assert np.array_equal(got.gx, want.gx) and np.array_equal(got.gy, want.gy)
    c = pipe.record.counters
    item = 8 if pipe.dtype == torch.float64 else 4
    nb = c["window.events"] // pipe.cfg.event_batch_size
    assert c["window.upload_bytes"] == (9 * c["window.events"] + (4 + item) * nb
                                        + pipe.bearing_lut.size * item)


def test_recording_run_writes_prep_times_from_its_spans(dataset, tmp_path):
    """Two windows through the host loop, recording: runtime.json's
    window_prep_s and window_prep_wait_s are the run record's spans, one a
    window, with spans_s and counters beside them; a second run of the
    same pipeline gets a record of its own."""
    from emba_tpu_torch import obs

    pipe = port_pipe(dataset, TC.BAConfig(**TWO, fused_lm=False),
                     result_dir=str(tmp_path / "rec"), record_data=True)
    res = pipe.run()
    rec = obs.runs()[-1]
    assert rec is pipe.record
    rt = json.loads((tmp_path / "rec" / "final_results" / "runtime.json").read_text())
    assert rt["window_prep_s"] == [sp.dur_ns * 1e-9 for sp in rec.named("window.prepare")]
    assert rt["window_prep_wait_s"] == [sp.dur_ns * 1e-9
                                        for sp in rec.named("window.prep_wait")]
    assert len(rt["window_prep_s"]) == len(rt["window_prep_wait_s"]) == 2
    assert all(p > 0 for p in rt["window_prep_s"])
    assert {"pipeline.init", "window.prepare", "window.solve", "pipeline.write"} <= set(
        rt["spans_s"])
    assert rt["spans_s"]["window.solve"]["count"] == 2
    for t in rt["spans_s"].values():
        assert 0 <= t["self_s"] <= t["total_s"] + CLOCK_NS * 1e-9
    assert_counters_match(rec, res)
    assert {k: v for k, v in rec.counters.items()
            if not k.startswith("launches.")} == rt["counters"]
    again = pipe.run(resume_from=str(tmp_path / "rec" / "final_results" / "checkpoint.npz"))
    assert obs.runs()[-1] is pipe.record is not rec
    assert pipe.record.counters.get("windows", 0) == len(again.window_stats) == 0
    assert [sp.name for sp in pipe.record.spans][-1] == "pipeline.run"


def test_nan_debug_names_the_window(dataset):
    """--debug-nans: a non-finite map after a window raises
    FloatingPointError naming the window; off, the run completes."""
    gx, gy = dataset["maps"]
    bad = gx.copy()
    bad[10:13, 20:23] = np.nan  # survives the 3x3 median blur
    cfg = TC.BAConfig(**{**ONE, "max_num_iter": 1})
    from emba_tpu_torch.obs import nan_debug

    def make():
        return TP.EmbaPipeline(cfg, load_camera_yaml(str(dataset["dir"] / "calib.yaml")),
                               dataset["events"], *dataset["poses"], init_gx=bad,
                               init_gy=gy.copy(), device="cpu")

    with nan_debug(True), pytest.raises(FloatingPointError, match="window 0"):
        make().run()
    assert len(make().run().window_stats) == 1


def test_record_maps_and_median_blur(dataset, tmp_path):
    """--record-maps fills the per-iteration evolution folders and the
    per-window map set; the median blur and the subsample equal the
    reference's."""
    cfg = TC.BAConfig(**{**ONE, "max_num_iter": 2})
    res = port_pipe(dataset, cfg, result_dir=str(tmp_path / "evo"), record_data=True,
                    record_maps=True).run()
    n_iter = len(res.window_stats[0].iterations)
    for d in ("Gx_evo", "Gy_evo", "G_hsv_evo", "map_poisson_evo"):
        assert len(os.listdir(tmp_path / "evo" / d)) >= n_iter, d
    assert len(os.listdir(tmp_path / "evo" / "map_opt")) == 4
    img = np.random.default_rng(3).normal(size=(9, 14))
    np.testing.assert_array_equal(TP.median_blur_3x3(img), JP.median_blur_3x3(img))
    ev = dataset["events"]
    for a, b in zip(TP.systematic_subsample(*ev, 8), JP.systematic_subsample(*ev, 8)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw,events,thres", [
    (1024 * 512, 2_000_000, 3), (4096 * 2048, 2_000_000, 3),
    (4096 * 2048, 4_000_000, 3), (4096 * 2048, 100_000_000, 3),
    (4096 * 2048, 1_000, 3), (2048 * 1024, 10_000, 1), (2048 * 1024, 3_000_000, 5),
])
def test_auto_compact_cap_matches_jax(hw, events, thres):
    """Mirror of tests/test_pipeline.py:489: small panoramas never compact,
    a 4K one gets the next power of two over events / thres, dense
    coverage gets none, the floor is 4096 rows."""
    assert TP.auto_compact_cap(hw, events, thres) == JP.auto_compact_cap(hw, events, thres)
    assert TP.auto_compact_cap(4096 * 2048, 2_000_000, 3) == 1 << 20
    assert TP.auto_compact_cap(4096 * 2048, 4_000_000, 3) == 1 << 21


@pytest.mark.parametrize("cap,observed", [
    (1 << 20, 300_000), (1 << 20, 1 << 19), (1 << 20, (1 << 19) + 1),
    (1 << 20, 1 << 18), (1 << 20, 10), (1 << 20, 4096 * 2048), (4096, 0),
])
def test_retune_compact_cap_matches_jax(cap, observed):
    """Mirror of tests/test_pipeline.py:502: the (cap/4, cap/2] band keeps
    the cap, it grows with 2x headroom past it and shrinks below it, the
    floor is 4096 rows and the ceiling next_pow2(HW)."""
    hw = 4096 * 2048
    assert TP.retune_compact_cap(observed, hw) == JP.retune_compact_cap(
        cap, observed, hw)


@pytest.mark.parametrize("n_events,compact_cap,rows", [
    (4_000_000, None, 1 << 21), (1_000, 1 << 21, 1 << 21),
    (6_500_000, None, None), (1_000, 1 << 22, None),
])
def test_plan_model_config_row_ceiling(n_events, compact_cap, rows):
    """A 4096x2048 panorama plans a window in a row space up to
    pipeline.ROWS_LARGE (2^21, the automatic cap of 4M events, or a cap
    set there). A cap set above it (2^22) raises, naming A12's memory,
    which streaming does not shrink, and the map-only super-resolution
    path. Where the automatic row space is above it (the 2^23 rows that
    6.5M events leave uncompacted) the plan defers the cap, streamed as
    2^21 rows would be, and sizes it from an active-pixel count: within
    the ceiling, or raising on a count above it, naming the count."""
    mcfg = TC.BAConfig(pano_width=4096, pano_height=2048,
                       thres_valid_pixel=3).model_config()
    mcfg = dataclasses.replace(mcfg, compact_cap=compact_cap)
    args = (mcfg, TC.BAConfig(), np.linspace(0.0, 1.0, n_events), 0.0, 1.0, 0.8, 0.5, 1)
    if rows is None and compact_cap is None:
        got, auto = TP.plan_model_config(*args)
        assert got.compact_cap is None and auto and got.stream_chunk is None
        for active, cap in ((700_000, 1 << 21), (300_000, 1 << 20), (1 << 21, 1 << 21)):
            sized, auto = TP.plan_model_config(*args, active_px=active)
            assert sized.compact_cap == cap and auto
        with pytest.raises(NotImplementedError, match="has 2097153 active pixels"):
            TP.plan_model_config(*args, active_px=(1 << 21) + 1)
    elif rows is None:
        with pytest.raises(NotImplementedError, match="super_res_height"):
            TP.plan_model_config(*args)
        streamed = TC.BAConfig(stream_chunk=1 << 20)
        with pytest.raises(NotImplementedError, match="does not shrink"):
            TP.plan_model_config(args[0], streamed, *args[2:])
    else:
        assert TP.plan_model_config(*args)[0].compact_cap == rows


def small_rows(monkeypatch, rows_large, **caps):
    """``pipeline.plan_model_config`` with a row ceiling of ``rows_large``
    (and the classic caps ``caps``), so that a tiny panorama defers its
    cap (over the module's own function, however often it is patched)."""
    def planned(*a, **kw):
        return PLAN(*a, **kw, rows_large=rows_large, **caps)

    monkeypatch.setattr(TP, "plan_model_config", planned)


@pytest.mark.parametrize("case", ["classic", "streamed", "uploaded_again"])
def test_deferred_cap_is_the_cap_set_at_its_count(dataset, monkeypatch, case):
    """A panorama above the row ceiling (here 4096 or 6144 rows under the
    8192 pixels of 128x64) defers its compaction cap: the pipeline counts
    the active pixels at the window's start (``plan.active_px``, in the
    span ``window.plan_rows``), sizes the cap from them, and the window
    runs bit for bit as with that cap set in its configuration, classic or
    streamed, the same chunk and tier; ``plan.rows`` is its R_pad and
    ``plan.overflow_px`` 0. Where the ceiling is above ROWS_SMALL but the
    sized cap is not (``uploaded_again``), the window that streamed for the
    count runs classic, as the set cap plans it, and is uploaded again."""
    kw = dict(ONE, fused_lm=True)
    rows_large, caps = 4096, {}
    if case == "streamed":
        kw["stream_chunk"] = 4096
    if case == "uploaded_again":
        rows_large, caps = 6144, dict(classic_cap_small=10**9, classic_cap_large=1000)
        monkeypatch.setattr(TP, "ROWS_SMALL", 4096)
        monkeypatch.setattr(TP, "AUTO_STREAM_CHUNK", 4096)
    small_rows(monkeypatch, rows_large, **caps)
    pipe = port_pipe(dataset, TC.BAConfig(**kw))
    res = pipe.run()
    cnt = pipe.record.counters
    cap = res.model_config.compact_cap
    assert cnt["plan.active_px"] == res.window_stats[0].active_px_per_form[0] > 0
    assert cap == TP.retune_compact_cap(cnt["plan.active_px"], 128 * 64) == 4096
    assert cnt["plan.rows"] == cap and cnt["plan.overflow_px"] == 0
    (plan_rows,) = pipe.record.named("window.plan_rows")
    assert plan_rows.thread == pipe.record.thread
    assert len(pipe.record.named("window.upload")) == (2 if case == "uploaded_again" else 1)
    assert res.model_config.stream_chunk == (4096 if case == "streamed" else None)
    fixed = port_pipe(dataset, TC.BAConfig(**kw, compact_cap=cap))
    want = fixed.run()
    assert want.model_config == res.model_config
    assert "plan.active_px" not in fixed.record.counters
    assert fixed.record.counters["plan.rows"] == cap
    assert not fixed.record.named("window.plan_rows")
    assert res.window_stats[0].iterations == want.window_stats[0].iterations
    for a, b in ((res.trajectory.knots, want.trajectory.knots), (res.gx, want.gx),
                 (res.gy, want.gy)):
        np.testing.assert_array_equal(a, b)


def test_deferred_cap_raises_on_a_count_above_the_ceiling(dataset, monkeypatch):
    """A start state whose active pixels exceed the row ceiling raises
    before the solve, naming the count; under the ceiling the same window
    runs, and a panorama that fits the ceiling counts nothing."""
    small_rows(monkeypatch, 4096)
    pipe = port_pipe(dataset, TC.BAConfig(**ONE, fused_lm=True))
    pipe.run()
    active = pipe.record.counters["plan.active_px"]
    small_rows(monkeypatch, active - 1)
    with pytest.raises(NotImplementedError, match=f"has {active} active pixels"):
        port_pipe(dataset, TC.BAConfig(**ONE, fused_lm=True)).run()
    small_rows(monkeypatch, 128 * 64)
    plain = port_pipe(dataset, TC.BAConfig(**ONE, fused_lm=True))
    plain.run()
    assert "plan.active_px" not in plain.record.counters
    assert "plan.overflow_px" not in plain.record.counters
    assert plain.record.counters["plan.rows"] == 128 * 64


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_pipeline_coarse_to_fine_matches_jax(dataset, tmp_path, mode):
    """Mirror of tests/test_pipeline.py:866 on two windows: each window's
    half-resolution pose pre-solve, on the window's own fused-or-host path
    (JAX's coarse stage always runs fused), then the full solve: JAX's
    result, and no worse than the direct run's final cost by 2x. The
    recording run logs each coarse stage."""
    kw = dict(TWO, max_num_iter=3, fused_lm=mode == "fused")
    extra = dict(result_dir=str(tmp_path / "c2f"), record_data=True) if mode == "host" else {}
    res = port_pipe(dataset, TC.BAConfig(**kw, coarse_to_fine=True), **extra).run()
    assert_runs_match(res, jax_pipe(dataset, JC.BAConfig(**kw, coarse_to_fine=True)).run())
    direct = jax_pipe(dataset, JC.BAConfig(**kw)).run()
    cd = direct.window_stats[-1].iterations[-1]["cost_min"]
    assert res.window_stats[-1].iterations[-1]["cost_min"] <= 2.0 * cd
    for st in res.window_stats:
        assert st.count_objective > len(st.iterations)  # the coarse stage's too
    if mode == "host":
        log = (tmp_path / "c2f" / "final_results" / "iterations.txt").read_text()
        assert log.count("coarse presolve:") == 2 and "at 64x32" in log


def test_pipeline_coarse_to_fine_odd_panorama(dataset, capsys):
    """A panorama of odd size has no 2x2 pooling: the coarse stage is
    skipped with a log line, and the run equals the direct run."""
    gx, gy = (m[:63, :126].copy() for m in dataset["maps"])
    kw = dict(ONE, max_num_iter=2)

    def run(**over):
        return TP.EmbaPipeline(TC.BAConfig(**kw, **over), load_camera_yaml(
            str(dataset["dir"] / "calib.yaml")), dataset["events"], *dataset["poses"],
            init_gx=gx, init_gy=gy, device="cpu").run()

    res = run(coarse_to_fine=True)
    assert "coarse presolve skipped: odd panorama 126x63" in capsys.readouterr().err
    np.testing.assert_array_equal(res.trajectory.knots, run().trajectory.knots)


def test_pipeline_multi_start_matches_jax(dataset, tmp_path):
    """Mirror of tests/test_pipeline.py:896 on two windows, recording (host
    loops): every window solved with the four variants, the winner by the
    data cost under the reference model, as in JAX's; lm_mode records it
    and iterations.txt logs each variant's cost."""
    kw = dict(TWO, max_num_iter=3, multi_start=True)
    res = port_pipe(dataset, TC.BAConfig(**kw), result_dir=str(tmp_path / "t"),
                    record_data=True).run()
    jres = jax_pipe(dataset, JC.BAConfig(**kw), result_dir=str(tmp_path / "j"),
                    record_data=True).run()
    assert_runs_match(res, jres)
    for st in res.window_stats:
        sel = st.lm_mode.split("+multistart:")[1]
        assert st.lm_mode.startswith("host+multistart:")
        assert sel in ("curr", "mid", "curr+c2f", "mid+c2f")
    log = (tmp_path / "t" / "final_results" / "iterations.txt").read_text()
    assert log.count("multi-start") == 8
    rt = json.loads((tmp_path / "t" / "final_results" / "runtime.json").read_text())
    assert rt["lm_mode"] == [st.lm_mode for st in jres.window_stats]
