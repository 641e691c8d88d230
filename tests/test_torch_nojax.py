"""The port runs without JAX: a fresh interpreter imports emba_tpu_torch
and its kernel, probe and application modules and ``chip_smoke.py``,
solves a tiny window on the CPU through the host loop and the fused loop,
classic and in both streamed tiers, runs the map-only solve, the CLI's
``synth`` and ``run --device cpu`` on a tiny scene (streamed, with the
super-resolution map) and one streamed multi-start row of the accuracy
suite (``eval_suite``, with ``poses`` and ``viz`` imported), and must have
loaded neither ``jax`` nor the JAX package ``emba_tpu``. A second fresh
interpreter runs ``dist.dryrun`` (every sharded configuration on two gloo
CPU ranks, spawned processes of their own) and imports the sharded tests'
rank module ``tests/_torch_dist_worker.py``; neither it nor a spawned rank
may load them either."""

import os
import subprocess
import sys

import _torch_threads  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import numpy as np
import torch
import emba_tpu_torch
from emba_tpu_torch.pairing import build_window
from emba_tpu_torch import model as M, solver, synth

sensor = synth.default_sensor(24, 24, f=22.0)
scene = synth.generate(np.random.default_rng(0), sensor, pano_width=64,
                       pano_height=32, c_th=0.2, t_end=0.3, num_steps=40)
win = build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                   scene.traj.locate, 100)
dev = M.DeviceWindow.from_window(win, sensor.bearing_lut(), sensor.width,
                                 torch.float64, "cpu")
cfg = M.ModelConfig(c_th=0.2, pano_width=64, pano_height=32, thres_valid_pixel=2)
knots, gx, gy, st = solver.solve_window(
    torch.from_numpy(scene.traj.knots), torch.from_numpy(scene.gx),
    torch.from_numpy(scene.gy), dev, cfg, solver.LMConfig(max_num_iter=1))
assert torch.isfinite(knots).all() and st.count_form >= 1
out = solver.solve_window_fused(
    torch.from_numpy(scene.traj.knots), torch.from_numpy(scene.gx),
    torch.from_numpy(scene.gy), dev, cfg, 1.0, 1e-3, use_cg=True, max_num_iter=1)
assert torch.isfinite(out[0]).all()
for light in (False, True):
    scfg = M.ModelConfig(c_th=0.2, pano_width=64, pano_height=32, thres_valid_pixel=2,
                         stream_chunk=500, stream_light=light)
    out = solver.solve_window_fused(
        torch.from_numpy(scene.traj.knots), torch.from_numpy(scene.gx),
        torch.from_numpy(scene.gy), dev, scfg, 1.0, 1e-3, max_num_iter=1)
    assert torch.isfinite(out[0]).all()
z = torch.zeros_like(torch.from_numpy(scene.gx))
gx_m, gy_m, costs = M.solve_map_only(torch.from_numpy(scene.traj.knots), z, z, dev, scfg)
assert torch.isfinite(gx_m).all() and costs[-1] < costs[0]
from emba_tpu_torch import convert, lm
from emba_tpu_torch.kernels import gather_sum
from emba_tpu_torch.probes import gather_probe, profile_fused, suite_run
import chip_smoke
payload = torch.ones((2, 300))
idx = torch.zeros((2, gather_sum.MC), dtype=torch.int32)
assert gather_sum.gather_sum(payload, idx, True).tolist() == [[512.0], [512.0]]
import os, tempfile
from emba_tpu_torch import cli, config, io, obs, pipeline, recon, rosbag
with tempfile.TemporaryDirectory() as d:
    cli.main(["synth", "--out", d, "--sensor", "24", "--pano-height", "32",
              "--duration", "0.3", "--steps", "60", "--c-th", "0.2"])
    res = cli.main(["run", "--events", os.path.join(d, "events.npz"),
                    "--poses", os.path.join(d, "traj_gt.txt"),
                    "--calib", os.path.join(d, "calib.yaml"),
                    "--map-gx", os.path.join(d, "Gx.bin"),
                    "--map-gy", os.path.join(d, "Gy.bin"), "--out", os.path.join(d, "r"),
                    "--start-time", "0.02", "--stop-time", "0.28", "--c-th", "0.2",
                    "--max-num-iter", "1", "--thres-valid-pixel", "2", "--device", "cpu",
                    "--stream-chunk", "1000", "--super-res-height", "48"])
    assert len(res.window_stats) == 1 and np.isfinite(res.trajectory.knots).all()
    assert res.model_config.stream_chunk == 1000
    for f in ("runtime.json", "Gx_sr.bin", "super_res.json"):
        assert os.path.exists(os.path.join(d, "r", "final_results", f)), f
from emba_tpu_torch import eval_suite, poses, viz
row = eval_suite.run_sequence("tiny", 3, 0.25, 2, 3.0, 0.3, sensor=16, pano_height=32,
                              max_iter=1, multi_start=True, stream=True, device="cpu")
assert row["selected_variant"] in ("curr", "mid", "curr+c2f", "mid+c2f")
loaded = sorted(m for m in sys.modules
                if m in ("jax", "emba_tpu") or m.startswith(("jax.", "jaxlib", "emba_tpu.")))
print("JAX_MODULES", loaded)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX_MODULES []" in res.stdout, res.stdout


DIST_SCRIPT = r"""
import os, sys
import torch
torch.set_num_threads(1)
from emba_tpu_torch import dist
dist.dryrun(2, "gloo", device="cpu")
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import _torch_dist_worker as W
assert dist.spawn(W.jax_modules_rank, 2, "gloo", device="cpu") == [[], []]
loaded = sorted(m for m in sys.modules
                if m in ("jax", "emba_tpu") or m.startswith(("jax.", "jaxlib", "emba_tpu.")))
print("JAX_MODULES", loaded)
"""


def test_dist_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", DIST_SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX_MODULES []" in res.stdout, res.stdout
