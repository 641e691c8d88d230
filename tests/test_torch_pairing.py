"""The port's host pairing (``emba_tpu_torch.pairing``) against
``emba_tpu.pairing`` on the same events: every field equal, exactly (the
same integer pairing and the same f64 batch arithmetic)."""

import numpy as np
import pytest

from emba_tpu import pairing as JP
from emba_tpu import synth as jsynth
from emba_tpu_torch import pairing as TP


@pytest.mark.parametrize("batch_size", [1, 100, 333])
def test_build_window_matches_jax_package(batch_size):
    sensor = jsynth.default_sensor(32, 24, f=30.0)
    scene = jsynth.generate(np.random.default_rng(3), sensor, pano_width=96,
                            pano_height=48, c_th=0.2, t_end=0.4, dt_knots=0.05,
                            num_steps=80, motion_amp=0.3)
    args = (scene.t, scene.x, scene.y, scene.pol, sensor.width, scene.traj.locate,
            batch_size)
    want, got = JP.build_window(*args), TP.build_window(*args)
    assert got.num_events == want.num_events > 0
    for name in ("t", "x", "y", "pol", "prev_idx", "batch_s", "batch_u"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got.batch_ids(), want.batch_ids())
    np.testing.assert_array_equal(got.sensor_flat_idx(sensor.width),
                                  want.sensor_flat_idx(sensor.width))


def test_prev_index_matches_jax_package_with_repeats():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, 5000).astype(np.int32)
    y = rng.integers(0, 3, 5000).astype(np.int32)
    got = TP.compute_prev_index(x, y, 4)
    np.testing.assert_array_equal(got, JP.compute_prev_index(x, y, 4))
    assert got[0] == -1 and (got < np.arange(5000)).all()


def test_time_and_count_maps_match_jax_package():
    """``time_map`` and ``event_count_map`` against JAX's on a window with
    repeated pixels: the same arrays, exactly."""
    sensor = jsynth.default_sensor(32, 24, f=30.0)
    scene = jsynth.generate(np.random.default_rng(3), sensor, pano_width=96,
                            pano_height=48, c_th=0.2, t_end=0.4, dt_knots=0.05,
                            num_steps=80, motion_amp=0.3)
    win = TP.build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                          scene.traj.locate, 50)
    jwin = JP.build_window(scene.t, scene.x, scene.y, scene.pol, sensor.width,
                           scene.traj.locate, 50)
    t0 = float(scene.t[0])
    got = TP.time_map(win, 32, 24, t0)
    assert np.array_equal(got, JP.time_map(jwin, 32, 24, t0))
    counts = TP.event_count_map(win, 32, 24)
    assert counts.dtype == np.int32
    assert np.array_equal(counts, JP.event_count_map(jwin, 32, 24))
    assert counts.sum() == win.num_events and counts.max() > 1
