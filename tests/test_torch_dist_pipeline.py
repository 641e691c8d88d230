"""The port's sharded pipeline and CLI over two gloo CPU ranks in f64,
against JAX's pipeline and CLI with ``num_devices=2`` (a (2, 1) mesh of the
conftest's virtual CPU devices), on the tiny scene of
``tests/test_torch_pipeline.py``: multi-start and coarse-to-fine windows, a
recording run (host loop, mid-window checkpoints, the super-resolution map
solved sharded) written by rank 0 alone, ``cli run --num-devices 2
--dist-backend gloo``, and resume across world sizes: a single-device
checkpoint resumed on two ranks and a two-rank checkpoint on one device.

Tolerances: against JAX, and across world sizes, the same iterations,
accepts and forming stats, knots and maps to 1e-8 relative to their
largest magnitude (``tests/test_torch_pipeline.py``'s ``REL``); a rank's
result equals rank 0's bit for bit.
"""

import json

import numpy as np
import pytest
import torch

import _torch_dist_worker as W
import _torch_threads  # noqa: F401  (one torch thread)
import emba_tpu.config as JC
import emba_tpu.pipeline as JP
from emba_tpu import cli as jcli
from emba_tpu.camera import load_camera_yaml as j_load_camera_yaml
from emba_tpu_torch import cli as tcli
from emba_tpu_torch import config as TC
from emba_tpu_torch import dist
from emba_tpu_torch import io as tio
from emba_tpu_torch import pipeline as TP
from emba_tpu_torch.camera import load_camera_yaml

REL = 1e-8
ONE = dict(start_time=0.02, stop_time=0.58, c_th=0.1, alpha=0.5, max_num_iter=4,
           dt_knots=0.05, dtype="float64", outlier_dp_norm=3.0, thres_valid_pixel=3)
TWO = dict(start_time=0.0, stop_time=0.6, c_th=0.1, alpha=0.5, max_num_iter=4,
           dt_knots=0.05, dtype="float64", time_window_size=0.3,
           sliding_window_stride=0.3)
RECORD = {**TWO, "lm_checkpoint_every": 1, "super_res_height": 96}


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("dsynth")
    tcli.main(["synth", "--out", str(out), "--sensor", "40", "--pano-height", "64",
               "--duration", "0.6", "--steps", "300", "--motion", "0.2", "--c-th", "0.1"])
    t, x, y, pol, _ = tio.load_events_npz(str(out / "events.npz"))
    times, rots = tio.load_tum_trajectory(str(out / "traj_gt.txt"))
    gx, gy = tio.load_map_bin(str(out / "Gx.bin"), str(out / "Gy.bin"))
    return dict(dir=out, events=(t, x, y, pol), poses=(times, rots), maps=(gx, gy))


def port_pipe(ds, cfg, **kw):
    gx, gy = ds["maps"]
    return TP.EmbaPipeline(cfg, load_camera_yaml(str(ds["dir"] / "calib.yaml")),
                           ds["events"], *ds["poses"], init_gx=gx.copy(),
                           init_gy=gy.copy(), device="cpu", **kw)


def jax_pipe(ds, cfg, **kw):
    gx, gy = ds["maps"]
    return JP.EmbaPipeline(cfg, j_load_camera_yaml(str(ds["dir"] / "calib.yaml")),
                           ds["events"], *ds["poses"], init_gx=gx.copy(),
                           init_gy=gy.copy(), **kw)


def assert_match(t, j):
    assert len(t.window_stats) == len(j.window_stats)
    for ts, js in zip(t.window_stats, j.window_stats):
        assert len(ts.iterations) == len(js.iterations)
        assert [r["cost_new"] < r["cost_min"] for r in ts.iterations] == [
            r["cost_new"] < r["cost_min"] for r in js.iterations]
        assert ts.active_px_per_form == js.active_px_per_form
    assert rel_err(t.trajectory.knots, j.trajectory.knots) <= REL
    assert rel_err(t.gx, j.gx) <= REL and rel_err(t.gy, j.gy) <= REL


@pytest.fixture(scope="module")
def single_ckpt(dataset, tmp_path_factory):
    """A mid-window checkpoint of a single-device recording run: window 1,
    after its second iteration."""
    d = tmp_path_factory.mktemp("single")
    pipe = port_pipe(dataset, TC.BAConfig(**RECORD), result_dir=str(d / "run"),
                     record_data=True)
    pipe.save_checkpoint = W._snapshotting(pipe.save_checkpoint, 1, 2, str(d / "mid.npz"))
    return pipe.run(), str(d / "mid.npz")


@pytest.fixture(scope="module")
def ranks(dataset, single_ckpt, tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    runs = [
        ("multi_start", {**ONE, "multi_start": True, "fused_lm": True}, {}, None),
        ("coarse_to_fine", {**ONE, "coarse_to_fine": True, "fused_lm": False}, {}, None),
        ("record", RECORD, dict(result_dir=str(d / "rec"), record_data=True,
                                snapshot=(1, 2, str(d / "mid2.npz"))), None),
        ("resumed", RECORD, dict(result_dir=str(d / "res"), record_data=True),
         single_ckpt[1]),
    ]
    out = dist.spawn(W.pipeline_rank, 2, "gloo", args=(str(dataset["dir"]), runs),
                     device="cpu", timeout_s=300)
    return out, d


@pytest.mark.parametrize("name", ["multi_start", "coarse_to_fine", "record"])
def test_sharded_variants_match_jax(dataset, ranks, name, tmp_path):
    out, d = ranks
    cfg = {"multi_start": {**ONE, "multi_start": True, "fused_lm": True},
           "coarse_to_fine": {**ONE, "coarse_to_fine": True, "fused_lm": False},
           "record": RECORD}[name]
    kw = dict(result_dir=str(tmp_path / "j"), record_data=True) if name == "record" else {}
    j = jax_pipe(dataset, JC.BAConfig(**cfg, num_devices=2), **kw).run()
    t = out[0][name]
    assert_match(t, j)
    mode = "fused" if cfg.get("fused_lm") else "host"
    assert all(st.lm_mode.startswith(f"{mode}-sharded") for st in t.window_stats)
    np.testing.assert_array_equal(out[1][name].trajectory.knots, t.trajectory.knots)
    if name == "multi_start":
        assert [v["variant"] for v in t.window_stats[0].variants] == [
            "curr", "curr+c2f", "mid", "mid+c2f"]
    if name == "record":
        fr = d / "rec" / "final_results"
        for f in ("trajectory_refined.txt", "Gx.bin", "Gx_sr.bin", "super_res.json",
                  "runtime.json", "checkpoint.npz", "iterations.txt"):
            assert (fr / f).exists(), f
        rt = json.loads((fr / "runtime.json").read_text())
        assert rt["lm_mode"] == ["host-sharded"] * 2
        # one writer: each iteration's line once
        lines = (fr / "iterations.txt").read_text().splitlines()
        assert len(lines) == len(set(lines)) > 0
        jsr = json.loads((tmp_path / "j" / "final_results" / "super_res.json").read_text())
        tsr = json.loads((fr / "super_res.json").read_text())
        assert rel_err(tsr["data_costs"], jsr["data_costs"]) <= REL
        gsr = tio.load_map_bin(str(fr / "Gx_sr.bin"), str(fr / "Gy_sr.bin"))
        jgsr = tio.load_map_bin(str(tmp_path / "j" / "final_results" / "Gx_sr.bin"),
                                str(tmp_path / "j" / "final_results" / "Gy_sr.bin"))
        for g, w in zip(gsr, jgsr):
            assert rel_err(g, w) <= 1e-6  # the .bin files hold f32


@pytest.mark.parametrize("direction", ["1to2", "2to1"])
def test_resume_across_world_sizes(dataset, ranks, single_ckpt, direction, tmp_path):
    """A mid-window checkpoint of window 1 taken on one device resumes on two
    ranks, and one taken on two ranks resumes on one device, each landing on
    the uninterrupted run of the other world size."""
    out, d = ranks
    single, _ = single_ckpt
    two = out[0]["record"]
    if direction == "1to2":
        got, want = out[0]["resumed"], two
    else:
        got = port_pipe(dataset, TC.BAConfig(**RECORD), result_dir=str(tmp_path / "r"),
                        record_data=True).run(resume_from=str(d / "mid2.npz"))
        want = single
    z = np.load(str(d / "mid2.npz"))
    assert bool(z["mid_window"]) and int(z["window_idx"]) == 1 and int(z["lm_it"]) == 2
    assert len(got.window_stats) == 1
    assert len(got.window_stats[0].iterations) == len(want.window_stats[1].iterations) - 2
    assert rel_err(got.trajectory.knots, want.trajectory.knots) <= REL
    assert rel_err(got.gx, want.gx) <= REL and rel_err(got.gy, want.gy) <= REL


def test_cli_num_devices_matches_jax(dataset, tmp_path, capsys):
    """``cli run --num-devices 2 --dist-backend gloo`` spawns its ranks and
    matches JAX's ``--num-devices 2``; nccl on the CPU raises."""
    d = dataset["dir"]
    args = ["run", "--events", str(d / "events.npz"), "--poses", str(d / "traj_gt.txt"),
            "--map-gx", str(d / "Gx.bin"), "--map-gy", str(d / "Gy.bin"), "--calib",
            str(d / "calib.yaml"), "--start-time", "0.02", "--stop-time", "0.58",
            "--c-th", "0.1", "--alpha", "0.5", "--max-num-iter", "4", "--dtype",
            "float64", "--outlier-dp", "3.0", "--thres-valid-pixel", "3",
            "--num-devices", "2"]
    res = tcli.main(args + ["--out", str(tmp_path / "t"), "--device", "cpu",
                            "--dist-backend", "gloo"])
    jcli.main(args + ["--out", str(tmp_path / "j")])
    capsys.readouterr()
    fr = {k: tmp_path / k / "final_results" for k in "tj"}
    rt = {k: json.loads((fr[k] / "runtime.json").read_text()) for k in "tj"}
    assert rt["t"]["lm_mode"] == rt["j"]["lm_mode"] == ["host-sharded"]
    assert rt["t"]["num_active_pixels"] == rt["j"]["num_active_pixels"]
    knots = {k: np.loadtxt(fr[k] / "trajectory_refined.txt") for k in "tj"}
    assert rel_err(knots["t"], knots["j"]) <= REL
    assert [st.lm_mode for st in res.window_stats] == ["host-sharded"]
    with pytest.raises(Exception, match="nccl"):
        tcli.main(args + ["--device", "cpu", "--dist-backend", "nccl"])
