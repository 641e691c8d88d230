"""The port's host pairing (``emba_tpu_torch.pairing``) against
``emba_tpu.pairing`` on the same events: every field equal, exactly (the
same integer pairing and the same f64 batch arithmetic). The device window
(``model.DeviceWindow.from_window``, which pairs on the device) against the
host build of the same fields (``_host_window``), bit for bit."""

import numpy as np
import pytest
import torch

import _host_window as HW
from emba_tpu import pairing as JP
from emba_tpu import synth as jsynth
from emba_tpu_torch import model as TM
from emba_tpu_torch import obs
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


def _events(case, rng):
    """(x, y) of a case's events, in arrival order."""
    w, h, n = case["sensor"] + (case["n"],)
    if case["pixels"] == "one":
        return np.full(n, w - 1, np.int32), np.full(n, h - 1, np.int32)
    if case["pixels"] == "distinct":
        flat = rng.permutation(w * h)[:n]
        return (flat % w).astype(np.int32), (flat // w).astype(np.int32)
    # repeats: a few clusters of pixels over the whole sensor
    cx, cy = rng.integers(0, w, 8), rng.integers(0, h, 8)
    k = rng.integers(0, 8, n)
    x = np.clip(cx[k] + rng.integers(-6, 7, n), 0, w - 1)
    y = np.clip(cy[k] + rng.integers(-6, 7, n), 0, h - 1)
    return x.astype(np.int32), y.astype(np.int32)


DEVICE_WINDOW_CASES = {
    "240x180-f32": dict(sensor=(240, 180), n=20_003, pixels="repeats", dtype="float32",
                        pad=1),
    "240x180-f64-padded-chunked": dict(sensor=(240, 180), n=20_003, pixels="repeats",
                                       dtype="float64", pad=4096, chunk=4096),
    "640x480-f32-padded-chunked": dict(sensor=(640, 480), n=30_000, pixels="repeats",
                                       dtype="float32", pad=1000, chunk=777),
    "640x480-f64": dict(sensor=(640, 480), n=30_000, pixels="repeats", dtype="float64",
                        pad=1),
    "one-pixel-f32-padded-chunked": dict(sensor=(240, 180), n=5_000, pixels="one",
                                         dtype="float32", pad=4096, chunk=1000),
    "one-pixel-f64": dict(sensor=(240, 180), n=5_000, pixels="one", dtype="float64",
                          pad=1),
    "distinct-f32": dict(sensor=(640, 480), n=40_000, pixels="distinct",
                         dtype="float32", pad=1),
    "distinct-f64-padded-chunked": dict(sensor=(240, 180), n=20_000, pixels="distinct",
                                        dtype="float64", pad=3000, chunk=1024),
    "partial-batch-f32-padded": dict(sensor=(240, 180), n=1_234, pixels="repeats",
                                     dtype="float32", pad=1000, whole_batches=False),
    "partial-batch-f64": dict(sensor=(640, 480), n=1_234, pixels="repeats",
                              dtype="float64", pad=1, whole_batches=False),
}


@pytest.mark.parametrize("case", DEVICE_WINDOW_CASES.values(), ids=DEVICE_WINDOW_CASES)
def test_device_window_equals_host_build(case, monkeypatch):
    """``DeviceWindow.from_window`` on the CPU against the host build of the
    same fields (``compute_prev_index``, the LUT gathered in f64 on the host,
    then cast): every field equal in dtype, shape and bits, padding
    included; only the raw columns, the batch arrays and the LUT are handed
    over (``window.upload_bytes``), and the window's ``prev_idx`` is not
    read. Cases: f32 and f64; padded or not; paired in one sort or in
    chunks (``model.PAIR_CHUNK``); 240x180 and 640x480 (above 65,536
    pixels); every event on one pixel, no pixel repeated; a window cut to
    whole batches from 20,003 events and one whose last batch is partial."""
    if "chunk" in case:
        monkeypatch.setattr(TM, "PAIR_CHUNK", case["chunk"])
    rng = np.random.default_rng(len(case) + case["n"])
    (w, h), n = case["sensor"], case["n"]
    dtype = getattr(torch, case["dtype"])
    x, y = _events(case, rng)
    t = np.sort(rng.uniform(0.0, 1.0, n))
    pol = rng.integers(0, 2, n).astype(np.int8)
    lut = rng.normal(size=(w * h, 3))
    lut /= np.linalg.norm(lut, axis=1, keepdims=True)

    def locate(tq):
        return np.floor(tq * 10).astype(np.int32), tq * 10 - np.floor(tq * 10)

    if case.get("whole_batches", True):
        win = TP.build_window(t, x, y, pol, w, locate, 100)
        assert win.num_events == n // 100 * 100
    else:
        nb = -(-n // 100)
        s, u = locate(t[::100])
        win = TP.EventWindow(t=t, x=x, y=y, pol=pol, batch_s=s, batch_u=u,
                             batch_size=100, sensor_width=w)
        assert win.num_events % 100 and len(win.batch_s) == nb
    rec = obs.Record()
    with obs.recording(rec):
        dev = TM.DeviceWindow.from_window(win, lut, w, dtype, "cpu",
                                          pad_multiple=case["pad"])
    rec.finish()
    assert "prev_idx" not in vars(win)  # never paired on the host
    want = HW.host_window(win, lut, w, dtype, case["pad"])
    HW.assert_same_window(dev, want)
    m, nb, item = win.num_events, len(win.batch_s), dtype.itemsize
    assert rec.counters["window.upload_bytes"] == 9 * m + (4 + item) * nb + 3 * w * h * item
    assert [sp.name for sp in rec.spans] == ["upload.copy", "upload.pair"]
    if case["pixels"] == "one":
        assert int(dev.has_prev.sum()) == m - 1
    if case["pixels"] == "distinct":
        assert not bool(dev.has_prev.any())
