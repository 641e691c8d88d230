"""Parity of the port's Lie-group core and spline against the JAX package
on the CPU in f64.

Tolerance: relative 1e-12 of each output's largest magnitude. Both sides
evaluate the same closed forms; they differ only in the rounding of a few
batched 3x3 products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu import lie as jlie
from emba_tpu import spline as jspline
from emba_tpu_torch import lie as tlie
from emba_tpu_torch import spline as tspline

REL = 1e-12


def assert_rel(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert float(np.max(np.abs(got - want))) <= rel * scale


def _vectors(seed):
    """Rotation vectors across the small-angle branch and up to ~2.5 rad."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(64, 3))
    scales = np.concatenate([np.full(16, 1e-8), np.full(16, 1e-3),
                             np.full(16, 0.3), np.full(16, 1.4)])
    return v * scales[:, None]


@pytest.mark.parametrize(
    "name", ["exp", "left_jacobian", "left_jacobian_inv", "right_jacobian",
             "right_jacobian_inv", "hat"]
)
def test_vector_functions_match(name):
    v = _vectors(0)
    got = getattr(tlie, name)(torch.from_numpy(v))
    want = getattr(jlie, name)(jnp.asarray(v))
    assert_rel(got, want)


def test_log_vee_quat_slerp_match():
    v = _vectors(1)
    R = np.array(jlie.exp(jnp.asarray(v)))
    Rt = torch.from_numpy(R)
    assert_rel(tlie.log(Rt), jlie.log(jnp.asarray(R)))
    assert_rel(tlie.vee(Rt), jlie.vee(jnp.asarray(R)))
    q = tlie.matrix_to_quat(Rt)
    assert_rel(q, jlie.matrix_to_quat(jnp.asarray(R)))
    assert_rel(tlie.quat_to_matrix(q), jlie.quat_to_matrix(jnp.asarray(q.numpy())))
    alpha = np.linspace(0.0, 1.0, 64)
    assert_rel(tlie.slerp(Rt, Rt.flip(0), torch.from_numpy(alpha)),
               jlie.slerp(jnp.asarray(R), jnp.asarray(R[::-1]), jnp.asarray(alpha)))


def _knots(k, seed):
    """A smooth trajectory: increments well below pi."""
    inc = jspline._np_exp(np.random.default_rng(seed).normal(size=(k, 3)) * 0.3)
    R = [inc[0]]
    for i in range(1, k):
        R.append(R[-1] @ inc[i])
    return np.stack(R)


@pytest.mark.parametrize("order", [2, 4])
def test_evaluate_values_and_jacobians_match(order):
    knots = _knots(12, order)
    rng = np.random.default_rng(10 + order)
    s = rng.integers(0, 12 - order + 1, 200).astype(np.int32)
    u = rng.random(200)
    u[:3] = [0.0, 1e-9, 1.0 - 1e-12]
    R_t, J_t = tspline.evaluate(torch.from_numpy(knots), torch.from_numpy(s),
                                torch.from_numpy(u), order, True)
    R_j, J_j = jspline.evaluate(jnp.asarray(knots), jnp.asarray(s), jnp.asarray(u),
                                order, True)
    assert_rel(R_t, R_j)
    assert_rel(J_t, J_j)
    R_only = tspline.evaluate(torch.from_numpy(knots), torch.from_numpy(s),
                              torch.from_numpy(u), order, False)
    assert torch.equal(R_only, R_t)


@pytest.mark.parametrize("order", [2, 4])
def test_host_half_matches(order):
    """Blending matrices, locate, fitting and Trajectory are the same numpy
    code in both packages: equal to the last bit."""
    np.testing.assert_array_equal(tspline.blending_matrix(order, True),
                                  jspline.blending_matrix(order, True))
    rng = np.random.default_rng(order)
    tt = np.linspace(0.0, 1.0, 200)
    rotvec = np.stack([0.2 * np.sin(3 * tt + p) for p in rng.uniform(0, 6, 3)], -1)
    R = jspline._np_exp(rotvec)
    tj = jspline.Trajectory.from_poses(tt, R, 0.0, 1.0, 0.05, order)
    tp = tspline.Trajectory.from_poses(tt, R, 0.0, 1.0, 0.05, order)
    np.testing.assert_array_equal(tp.knots, tj.knots)
    np.testing.assert_array_equal(tp.locate(tt)[0], tj.locate(tt)[0])
    np.testing.assert_array_equal(tp.locate(tt)[1], tj.locate(tt)[1])
    assert_rel(tp.evaluate(tt), tj.evaluate(tt))
    np.testing.assert_array_equal(tspline._np_log(R), jspline._np_log(R))


def test_trajectory_methods_match(tmp_path):
    """The host Trajectory's bookkeeping and TUM writer agree with the
    reference's."""
    knots = _knots(8, 3)
    tj = jspline.Trajectory(t_beg=0.5, dt=0.1, knots=knots.copy())
    tp = tspline.Trajectory(t_beg=0.5, dt=0.1, knots=knots.copy())
    assert (tp.num_knots, tp.t_end, tp.knot_time(3)) == (tj.num_knots, tj.t_end,
                                                          tj.knot_time(3))
    drot = np.random.default_rng(4).normal(size=(5, 3)) * 0.01
    np.testing.assert_array_equal(tp.incremental_update(drot, 3).knots,
                                  tj.incremental_update(drot, 3).knots)
    np.testing.assert_array_equal(tp.segment(2, 6).knots, tj.segment(2, 6).knots)
    assert tp.segment(2, 6).t_beg == tj.segment(2, 6).t_beg
    c = tp.clone()
    c.replace_with(tp.segment(0, 2), 2, 0, 5)
    c.pushback(knots[:1])
    np.testing.assert_array_equal(c.knots[5:7], knots[:2])
    assert c.num_knots == 9
    tp.write_tum(str(tmp_path / "p.txt"), time_offset=0.5)
    tj.write_tum(str(tmp_path / "j.txt"), time_offset=0.5)
    got = np.loadtxt(tmp_path / "p.txt")
    want = np.loadtxt(tmp_path / "j.txt")
    assert np.max(np.abs(got - want)) <= 1e-12


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("order", [2, 3, 4])
def test_evaluate_derivatives_matches_jax(order, degree):
    """Body-frame angular velocity, acceleration and jerk against JAX's
    recursion, to 1e-12 of each output's largest magnitude; ``_binom``
    against JAX's."""
    rng = np.random.default_rng(10 * order + degree)
    knots = tspline._np_exp(rng.normal(size=(order + 5, 3)) * 0.5)
    s = rng.integers(0, 6, size=9).astype(np.int32)
    u = rng.random(9)
    want = jspline.evaluate_derivatives(knots, s, u, 0.2, order, degree)
    got = tspline.evaluate_derivatives(torch.from_numpy(knots), s, u, 0.2, order, degree)
    assert len(got) == len(want) == degree + 1
    for g, w in zip(got, want):
        assert_rel(g.numpy(), np.asarray(w))
    assert all(tspline._binom(n, k) == jspline._binom(n, k)
               for n in range(7) for k in range(n + 1))
