"""The renderer gives the same events for the same seed and other events
for another seed (a tiny scene on the CPU)."""

import torch

from benchmark import scene

CAM = dict(fx=20.0, fy=20.0, cx=12.5, cy=9.5, dist=[-0.37, 0.15, -3e-4, -8e-4, 0.0])
SC = dict(sensor_width=24, sensor_height=18, camera=CAM, pano_width=96, pano_height=48,
          duration_s=0.5, steps_per_s=312.5, texture_smooth=3, texture_amp=3.0,
          motion_amp=0.22, dt_knots=0.05, c_th=0.2)


def test_same_seed_same_events_other_seed_other_events():
    a, b = scene.render(SC, 2**31 + 5, "cpu"), scene.render(SC, 2**31 + 5, "cpu")
    c = scene.render(SC, 2**31 + 6, "cpu")
    assert a.rendered > 1000
    for f in ("t", "x", "y", "pol", "gx", "knots"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(a.gx, c.gx)
    assert a.t.shape != c.t.shape or not torch.equal(a.t, c.t)
    assert torch.all(a.t[1:] >= a.t[:-1])
    assert int(a.x.max()) < 24 and int(a.y.max()) < 18 and set(a.pol.tolist()) <= {0, 1}


def test_perturbation_is_seeded():
    a = scene.render(SC, 7, "cpu")
    p1 = scene.perturbed_knots(a.knots, 0.005, scene.generator(3, "cpu"))
    p2 = scene.perturbed_knots(a.knots, 0.005, scene.generator(3, "cpu"))
    p3 = scene.perturbed_knots(a.knots, 0.005, scene.generator(4, "cpu"))
    assert torch.equal(p1, p2) and not torch.equal(p1, p3)
    assert torch.allclose(p1[0], a.knots[0])
