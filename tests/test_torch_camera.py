"""Parity of the port's camera models against the JAX package (CPU, f64),
and the calibration loader on a playroom-like fixture.

Tolerance: relative 1e-12 of each output's largest magnitude (same closed
forms on both sides)."""

import os

import jax.numpy as jnp
import numpy as np
import torch

from emba_tpu import camera as jcam
from emba_tpu_torch import camera as tcam

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "dvs_playroom_like.yaml")


def assert_rel(got, want, rel=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rel * max(np.max(np.abs(want)), 1e-300)


def test_project_and_lift_match():
    rng = np.random.default_rng(0)
    P = rng.normal(size=(500, 3))
    P[:4] = [[0, 0, 1], [0, 1, 0], [0, -1e-9, 1e-9], [1e-7, 2, 0]]  # axis, poles
    pj, Jj = jcam.EquirectangularCamera(256, 128).project(jnp.asarray(P))
    pano = tcam.EquirectangularCamera(256, 128)
    pt, Jt = pano.project(torch.from_numpy(P))
    assert_rel(pt, pj)
    assert_rel(Jt, Jj)
    assert torch.equal(pano.project(torch.from_numpy(P), need_jacobian=False), pt)
    assert_rel(pano.lift_to_unit_sphere(pt),
               jcam.EquirectangularCamera(256, 128).lift_to_unit_sphere(pj))


def test_pinhole_bearing_lut_matches():
    K = [[50.0, 0, 31.5], [0, 52.0, 30.0], [0, 0, 1]]
    D = [-0.2, 0.05, 1e-3, -2e-3, 0.0]
    a = tcam.PinholeCamera.from_calib(64, 48, K, D)
    b = jcam.PinholeCamera.from_calib(64, 48, K, D)
    np.testing.assert_array_equal(a.bearing_lut(), b.bearing_lut())


def test_load_camera_yaml_fixture():
    cam = tcam.load_camera_yaml(FIXTURE)
    assert cam.width == 128 and cam.height == 128
    np.testing.assert_allclose(cam.K[0, 0], 91.4014729896821)
    np.testing.assert_allclose(cam.K[0, 2], 64.0)
    assert np.all(cam.D == 0)
    ref = jcam.load_camera_yaml(FIXTURE)
    for f in ("K", "D", "R", "P"):
        np.testing.assert_array_equal(getattr(cam, f), getattr(ref, f))
