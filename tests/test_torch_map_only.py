"""The port's map-only solve (a fixed trajectory: the super-resolution
path) against the JAX package's on the CPU in f64, mirroring
``tests/test_map_only.py``: one step equals the joint normal equations'
map blocks solved at lambda = 0, it is the exact minimizer of the
quadratic cost, and ``solve_map_only`` gives JAX's maps and costs.

Tolerances, relative to each output's largest magnitude: 1e-12 against the
port's own joint blocks (the same per-pixel sums), 1e-10 against JAX; the
cost's gradient on the active pixels below 1e-8 after one step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu import model as JM
from emba_tpu import pairing, spline, synth
from emba_tpu_torch import model as TM

CFG = dict(c_th=0.1, pano_width=192, pano_height=96, thres_valid_pixel=3, alpha=0.5,
           outlier_dp_norm=3.0, stream_chunk=1 << 12)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.fixture(scope="module")
def problem():
    """tests/test_map_only.py's problem: a textured scene (seed 7, 48x48
    sensor, 192x96 panorama, 1 s), a trajectory perturbed by a 0.005 rad
    random walk and then held fixed, both packages' f64 windows."""
    rng = np.random.default_rng(7)
    cam = synth.default_sensor(48, 48, f=44.0)
    B = synth.smooth_random_map(96, 192, rng, smooth=3, amp=3.0)
    scene = synth.generate(rng, cam, pano_width=192, pano_height=96, c_th=0.1,
                           t_end=1.0, dt_knots=0.05, num_steps=400, motion_amp=0.25,
                           brightness=B)
    steps = rng.normal(size=(scene.traj.num_knots, 3)) * 0.005
    walk = np.cumsum(steps, axis=0)
    walk -= walk[0]
    traj = dataclasses.replace(scene.traj, knots=spline._np_exp(walk) @ scene.traj.knots)
    win = pairing.build_window(scene.t, scene.x, scene.y, scene.pol, cam.width,
                               traj.locate, 100)
    assert win.num_events % CFG["stream_chunk"]
    lut = cam.bearing_lut()
    return dict(
        jdev=JM.DeviceWindow.from_window(win, lut, cam.width, jnp.float64),
        tdev=TM.DeviceWindow.from_window(win, lut, cam.width, torch.float64, "cpu"),
        j=tuple(jnp.asarray(a) for a in (traj.knots, scene.gx, scene.gy)),
        t=tuple(torch.from_numpy(np.array(a)) for a in (traj.knots, scene.gx, scene.gy)),
        gt=(scene.gx, scene.gy))


def test_map_only_matches_joint_map_blocks_and_jax(problem):
    """Mirror of tests/test_map_only.py:47: one step equals the classic
    normal equations' map blocks solved at lambda = 0 with the update_map
    rule, and JAX's step."""
    cfg = TM.ModelConfig(**CFG)
    knots, gx, gy = problem["t"]
    classic = dataclasses.replace(cfg, stream_chunk=None)
    lin = TM.linearize(knots, gx, gy, problem["tdev"], classic)
    neq = TM.form_normal_eq(lin, gx, gy, classic, knots.shape[0])
    a, b, d = neq.a22_xx, neq.a22_xy, neq.a22_yy
    det = a * d - b * b
    ok = neq.active & (torch.abs(det) >= 1e-30)
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    x2 = torch.stack([(d * neq.b2_x - b * neq.b2_y) * inv, (a * neq.b2_y - b * neq.b2_x) * inv])
    gx_exp, gy_exp = TM.update_map(gx, gy, x2, 1.0, neq)

    gx1, gy1, cost0, nem = TM.map_only_step(knots, gx, gy, problem["tdev"], cfg)
    assert rel_err(gx1, gx_exp) <= 1e-12 and rel_err(gy1, gy_exp) <= 1e-12
    assert torch.equal(nem, lin.num_ev_map)

    jgx, jgy, jcost, jnem = JM.map_only_step(*problem["j"], problem["jdev"],
                                             JM.ModelConfig(**CFG))
    assert rel_err(gx1, jgx) <= 1e-10 and rel_err(gy1, jgy) <= 1e-10
    assert rel_err(cost0, jcost) <= 1e-12
    np.testing.assert_array_equal(nem.numpy(), np.asarray(jnem))


def test_map_only_is_exact_quadratic_minimizer(problem):
    """Mirror of tests/test_map_only.py:78: after one step from zero maps
    the regularized data cost has zero gradient on the active pixels, and
    a second step is a fixed point."""
    cfg = TM.ModelConfig(**CFG)
    knots, gx_gt, _ = problem["t"]
    z = torch.zeros_like(gx_gt)
    gx1, gy1, cost0, nem = TM.map_only_step(knots, z, z, problem["tdev"], cfg)
    act = (nem >= cfg.thres_valid_pixel).reshape(z.shape)

    g = [gx1.clone().requires_grad_(True), gy1.clone().requires_grad_(True)]
    gxa, gya = (torch.where(act, v, torch.zeros_like(v)) for v in g)
    cost, _ = TM.window_mode(problem["tdev"], cfg).cost_and_activity(knots, gxa, gya)
    ggx, ggy = torch.autograd.grad(cost + TM.reg_cost(gxa, gya, cfg.alpha), g)
    assert float(ggx[act].abs().max()) < 1e-8 and float(ggy[act].abs().max()) < 1e-8

    gx2, gy2, cost1, _ = TM.map_only_step(knots, gx1, gy1, problem["tdev"], cfg)
    assert float(cost1) < float(cost0)
    assert float((gx2 - gx1).abs().max()) < 1e-9 and float((gy2 - gy1).abs().max()) < 1e-9


@pytest.mark.parametrize("irls", [False, True])
def test_solve_map_only_matches_jax(problem, irls):
    """Mirror of tests/test_map_only.py:109: from zero maps the cost falls
    and the map follows the ground truth on the active pixels; maps and
    costs equal JAX's, with IRLS (three weight refreshes) too."""
    kw = dict(use_irls=True, cost_type="cauchy", eta=0.5) if irls else {}
    iters = 3 if irls else 1
    cfg, jcfg = TM.ModelConfig(**CFG, **kw), JM.ModelConfig(**CFG, **kw)
    knots = problem["t"][0]
    z = torch.zeros_like(problem["t"][1])
    gx, gy, costs = TM.solve_map_only(knots, z, z, problem["tdev"], cfg, num_iters=iters)
    jz = jnp.zeros_like(problem["j"][1])
    jgx, jgy, jcosts = JM.solve_map_only(problem["j"][0], jz, jz, problem["jdev"], jcfg,
                                         num_iters=iters)
    assert len(costs) == iters + 1 and costs[-1] < costs[0]
    assert rel_err(costs, jcosts) <= 1e-12
    assert rel_err(gx, jgx) <= 1e-10 and rel_err(gy, jgy) <= 1e-10
    if not irls:
        _, _, _, nem = TM.map_only_step(knots, z, z, problem["tdev"], cfg)
        act = (nem >= cfg.thres_valid_pixel).reshape(gx.shape).numpy()
        c = np.corrcoef(gx.numpy()[act], problem["gt"][0][act])[0, 1]
        assert c > 0.85, c
