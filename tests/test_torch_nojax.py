"""The port runs without JAX: a fresh interpreter imports emba_tpu_torch,
solves a tiny window on the CPU, and must not have loaded ``jax``."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import numpy as np
import torch
import emba_tpu_torch
from emba_tpu.pairing import build_window
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
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", loaded)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX_MODULES []" in res.stdout, res.stdout
