"""The port's accuracy suite, ``cli suite``, ``poses`` and ``viz`` against
the JAX package's on the CPU in f64, at a tiny size (16x16 sensor, 64x32
panorama, 0.3 s, up to 3 LM iterations).

JAX's ``run_sequence`` pads its window to 131,072 events with masked
events (``dist.pad_window``); the port's does not, and the masked events
add nothing, so the two agree to rounding. Tolerances: the same event
count, LM iterations and selected variant; RMSE and photometric errors
to relative 1e-8 (rounding grows through each Cholesky solve, as in
``test_torch_solver.py``); the numpy-only ``poses`` and ``viz`` equal
JAX's exactly.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu import cli as jcli
from emba_tpu import eval_suite as JE
from emba_tpu import io as jio
from emba_tpu import lie as jlie
from emba_tpu import poses as jposes
from emba_tpu import viz as jviz
from emba_tpu.camera import EquirectangularCamera as JEquirect
from emba_tpu.camera import load_camera_yaml as j_load_camera_yaml
from emba_tpu.spline import Trajectory as JTrajectory
from emba_tpu_torch import cli as tcli
from emba_tpu_torch import eval_suite as TE
from emba_tpu_torch import io as tio
from emba_tpu_torch import metrics as TMet
from emba_tpu_torch import poses as tposes
from emba_tpu_torch import viz as tviz
from emba_tpu_torch.camera import EquirectangularCamera, load_camera_yaml
from emba_tpu_torch.spline import Trajectory

TINY = dict(sensor=16, pano_height=32, max_iter=3)
ROW = ("tiny", 3, 0.25, 2, 3.0, 0.3)  # name, seed, motion, smooth, amp, duration
REL = 1e-8


def assert_rows_match(t, j):
    assert set(t) == set(j)
    for k in ("sequence", "num_events", "lm_iterations", "converged"):
        assert t[k] == j[k], k
    assert t.get("selected_variant") == j.get("selected_variant")
    for k in ("rmse_init_deg", "rmse_refined_deg", "photometric_init",
              "photometric_refined"):
        assert t[k] == pytest.approx(j[k], rel=REL, abs=1e-12), k


@pytest.mark.parametrize("multi_start", [False, True])
def test_run_sequence_matches_jax(multi_start):
    """One row, single variant and multi-start (the winner by photometric
    error under the reference model, as JAX's). At this size the window
    is too small to recover the pose: the test holds parity only."""
    t = TE.run_sequence(*ROW, **TINY, multi_start=multi_start, dtype=torch.float64,
                        device="cpu")
    j = JE.run_sequence(*ROW, **TINY, multi_start=multi_start, dtype=jnp.float64)
    assert_rows_match(t, j)
    assert t["events_per_s"] > 0 and t["wall_s"] > 0
    if multi_start:
        assert t["selected_variant"] in ("curr", "mid", "curr+c2f", "mid+c2f")


def test_run_sequence_options_and_limits(capsys):
    """An odd panorama skips the coarse stage with a log line (the run then
    equals the direct run); light-trial gives the classic row; a window
    above ``stream_over``, or with ``stream=True`` (in either tier),
    streams and gives the unstreamed row to relative 1e-8; without a GPU
    the default device raises."""
    kw = dict(TINY, pano_height=33, dtype=torch.float64, device="cpu")
    c2f = TE.run_sequence(*ROW, **kw, coarse_to_fine=True)
    assert "coarse presolve skipped: odd panorama 66x33" in capsys.readouterr().err
    direct = TE.run_sequence(*ROW, **kw)
    for k in ("rmse_refined_deg", "photometric_refined", "lm_iterations"):
        assert c2f[k] == direct[k]
    light = TE.run_sequence(*ROW, **kw, light_trial=True)
    for k in ("rmse_refined_deg", "photometric_refined", "lm_iterations"):
        assert light[k] == direct[k]
    assert direct["num_events"] > 1000
    for over in (dict(stream_over=1000), dict(stream=True),
                 dict(stream=True, stream_light=True)):
        streamed = TE.run_sequence(*ROW, **kw, **over)
        assert streamed["num_events"] == direct["num_events"]
        assert streamed["lm_iterations"] == direct["lm_iterations"]
        for k in ("rmse_refined_deg", "photometric_refined"):
            assert streamed[k] == pytest.approx(direct[k], rel=REL, abs=1e-12), (over, k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TE.run_sequence(*ROW, **TINY)


def test_cli_suite_matches_jax(monkeypatch, tmp_path):
    """``cli suite --device cpu`` on one tiny monkeypatched sequence writes
    JAX's CLI's rows."""
    rows = {"tiny": ROW[1:]}
    for mod, dtype in ((TE, torch.float64), (JE, jnp.float64)):
        def tiny(*a, _run=mod.run_sequence, _dtype=dtype, **k):
            return _run(*a, **k, **TINY, dtype=_dtype)

        monkeypatch.setattr(mod, "SEQUENCES", rows)
        monkeypatch.setattr(mod, "run_sequence", tiny)
    got = tcli.main(["suite", "--out", str(tmp_path / "t.json"), "--device", "cpu"])
    jcli.main(["suite", "--out", str(tmp_path / "j.json")])
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    assert len(t) == len(j) == len(got) == 1
    assert_rows_match(t[0], j[0])


def test_photometric_error_matches_jax():
    e = np.random.default_rng(0).normal(size=1000)
    want = JE.metrics.photometric_error(e)
    assert TMet.photometric_error(torch.from_numpy(e)) == pytest.approx(want, rel=1e-14)
    assert TMet.photometric_error(e) == want


def test_pose_manager_matches_jax(tmp_path):
    """Mirror of tests/test_pipeline.py:332: loading, endpoint and clamped
    queries, geodesic interpolation, strict subsets, midpoints."""
    rng = np.random.default_rng(4)
    times = np.linspace(0.0, 1.0, 11)
    R = np.asarray(jlie.exp(jnp.asarray(rng.normal(size=(11, 3)) * 0.2)))
    jio.save_tum_trajectory(str(tmp_path / "p.txt"), times, R)
    pm = tposes.PoseManager.from_tum(str(tmp_path / "p.txt"))
    jpm = jposes.PoseManager.from_tum(str(tmp_path / "p.txt"))
    assert len(pm) == len(jpm) == 11
    np.testing.assert_allclose(pm.pose_at(0.0), R[0], atol=1e-9)
    np.testing.assert_allclose(pm.pose_at(1.0), R[-1], atol=1e-9)
    np.testing.assert_allclose(pm.pose_at(0.3), R[3], atol=1e-9)
    for q in (-5.0, 0.0, 0.3, 0.35, 0.77, 1.0, 7.0):
        np.testing.assert_array_equal(pm.pose_at(q), jpm.pose_at(q))
    sub, jsub = pm.subset(0.05, 0.55), jpm.subset(0.05, 0.55)
    assert len(sub) == len(jsub) == 5
    np.testing.assert_array_equal(sub.times, jsub.times)
    t_mid, r_mid = pm.interp_mid(3, 4)
    jt_mid, jr_mid = jpm.interp_mid(3, 4)
    assert t_mid == jt_mid
    np.testing.assert_array_equal(r_mid, jr_mid)


def test_viz_matches_jax(tmp_path):
    """Mirror of tests/test_pipeline.py:360: warped events drawn on the
    map and the sensor's field of view marked, as JAX draws them."""
    tcli.main(["synth", "--out", str(tmp_path), "--sensor", "40", "--pano-height",
               "64", "--duration", "0.6", "--steps", "300", "--c-th", "0.1"])
    t, x, y, pol, _ = tio.load_events_npz(str(tmp_path / "events.npz"))
    times, rots = tio.load_tum_trajectory(str(tmp_path / "traj_gt.txt"))
    gx, _gy = tio.load_map_bin(str(tmp_path / "Gx.bin"), str(tmp_path / "Gy.bin"))
    cam = load_camera_yaml(str(tmp_path / "calib.yaml"))
    jcam = j_load_camera_yaml(str(tmp_path / "calib.yaml"))
    traj = Trajectory.from_poses(times, rots, 0.0, 0.6, 0.05)
    jtraj = JTrajectory.from_poses(times, rots, 0.0, 0.6, 0.05)
    pano, jpano = (E(gx.shape[1], gx.shape[0]) for E in (EquirectangularCamera, JEquirect))
    ev = (t[:5000], x[:5000], y[:5000], pol[:5000])
    canvas = tviz.render_warped_events(gx, traj, cam, pano, *ev)
    jcanvas = jviz.render_warped_events(gx, jtraj, jcam, jpano, *ev)
    assert canvas.shape == gx.shape + (3,)
    assert (canvas == (255, 0, 0)).all(axis=-1).any()
    np.testing.assert_array_equal(canvas, jcanvas)
    R0 = traj.evaluate(0.3).numpy()[0]
    marked = tviz.draw_sensor_fov(canvas, R0, cam, pano)
    assert (marked == (0, 255, 0)).all(axis=-1).any()
    np.testing.assert_array_equal(marked, jviz.draw_sensor_fov(canvas, R0, jcam, jpano))
