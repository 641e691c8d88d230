"""The port's support modules against the JAX package's on the CPU: the
presets (``config``), the artifact files (``io``), the rosbag reader and
writer (``rosbag``), the Poisson reconstruction (``recon``) and the
observability helpers (``obs``).

Tolerances: map, event and rosbag files written by either package are
read by the other with the same bits, and both packages write the same
bytes; the PNG bytes and the HSV image are equal. TUM files: times equal,
rotations and written quaternions within 1e-15 (the two packages' quaternion
conversions round differently). ``recon`` in f64: relative 1e-10 of the largest
magnitude against JAX (both use an FFT, in different libraries), and the
reference's dense-Dirichlet check at the tolerance of
``tests/test_recon.py``.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu import config as JC
from emba_tpu import io as jio
from emba_tpu import lie as jlie
from emba_tpu import recon as jrecon
from emba_tpu import rosbag as jrb
from emba_tpu_torch import config as TC
from emba_tpu_torch import io as tio
from emba_tpu_torch import obs
from emba_tpu_torch import recon as trecon
from emba_tpu_torch import rosbag as trb

RNG = np.random.default_rng(21)
RECON_REL = 1e-10


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float64))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sequence", [None, *sorted(JC._SEQUENCES)])
def test_presets_match(sequence):
    """Every preset (and the defaults) has the reference's fields and values,
    apart from ``use_pallas`` (kept, ignored by the port) and
    ``fused_event_cap``, whose reference default fences a failure of the
    reference's accelerator and has no counterpart on the card."""
    j = JC.preset(sequence) if sequence else JC.BAConfig()
    t = TC.preset(sequence) if sequence else TC.BAConfig()
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert list(jd) == list(td)
    for k in ("use_pallas", "fused_event_cap"):
        jd.pop(k), td.pop(k)
    assert td == jd
    assert t.fused_event_cap is None
    assert t.window_size == j.window_size
    assert dataclasses.asdict(t.lm_config()) == dataclasses.asdict(j.lm_config())
    mt = dataclasses.asdict(t.model_config())
    mj = dataclasses.asdict(dataclasses.replace(j, use_pallas=False).model_config())
    mj.pop("use_pallas")
    assert mt == mj
    with pytest.raises(KeyError):
        TC.preset("nope")


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------


def test_map_bin_cross(tmp_path):
    gx, gy = RNG.normal(size=(64, 128)), RNG.normal(size=(64, 128))
    jio.save_map_bin(str(tmp_path / "jx.bin"), str(tmp_path / "jy.bin"), gx, gy)
    tio.save_map_bin(str(tmp_path / "tx.bin"), str(tmp_path / "ty.bin"), gx, gy)
    assert (tmp_path / "jx.bin").read_bytes() == (tmp_path / "tx.bin").read_bytes()
    for a, b in ((tio.load_map_bin(str(tmp_path / "jx.bin"), str(tmp_path / "jy.bin"))),
                 (jio.load_map_bin(str(tmp_path / "tx.bin"), str(tmp_path / "ty.bin")))):
        np.testing.assert_array_equal(a, gx)
        np.testing.assert_array_equal(b, gy)
    np.fromfile(tmp_path / "jx.bin")[:-1].tofile(tmp_path / "bad.bin")
    with pytest.raises(ValueError):
        tio.load_map_bin(str(tmp_path / "bad.bin"), str(tmp_path / "jy.bin"))


def test_tum_cross(tmp_path):
    times = np.sort(RNG.uniform(0, 1, 20))
    R = np.asarray(jlie.exp(jnp.asarray(RNG.normal(size=(20, 3)) * 0.5)))
    jio.save_tum_trajectory(str(tmp_path / "j.txt"), times, R, time_offset=0.5)
    tio.save_tum_trajectory(str(tmp_path / "t.txt"), times, R, time_offset=0.5)
    # the quaternions of the two packages' matrix_to_quat differ by rounding
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.txt"),
                               np.loadtxt(tmp_path / "j.txt"), rtol=0, atol=1e-15)
    for path in ("t.txt", "j.txt"):
        tj, Rj = jio.load_tum_trajectory(str(tmp_path / path), time_offset=0.5)
        tt, Rt = tio.load_tum_trajectory(str(tmp_path / path), time_offset=0.5)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-15)
        np.testing.assert_allclose(Rt, R, atol=1e-9)


def test_events_npz_cross(tmp_path):
    n = 1000
    t = np.sort(RNG.uniform(0, 1, n))
    x, y = RNG.integers(0, 240, n), RNG.integers(0, 180, n)
    pol = RNG.integers(0, 2, n)
    jio.save_events_npz(str(tmp_path / "j.npz"), t, x, y, pol, sensor=240)
    tio.save_events_npz(str(tmp_path / "t.npz"), t, x, y, pol, sensor=240)
    for a, b in ((tio.load_events_npz(str(tmp_path / "j.npz")),
                  jio.load_events_npz(str(tmp_path / "j.npz"))),
                 (jio.load_events_npz(str(tmp_path / "t.npz")),
                  tio.load_events_npz(str(tmp_path / "t.npz")))):
        for u, v in zip(a[:4], b[:4]):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
        assert int(a[4]["sensor"]) == int(b[4]["sensor"]) == 240
    np.testing.assert_array_equal(tio.load_events_npz(str(tmp_path / "t.npz"))[0], t)


def test_images_equal(tmp_path):
    img = RNG.normal(size=(32, 48))
    gx, gy = img, img[::-1].copy()
    hsv = tio.gradient_hsv_image(gx, gy)
    np.testing.assert_array_equal(hsv, jio.gradient_hsv_image(gx, gy))
    np.testing.assert_array_equal(tio.normalize_robust(img), jio.normalize_robust(img))
    for name, a in (("gray", img), ("rgb", hsv)):
        tio.save_png(str(tmp_path / f"t_{name}.png"), a)
        jio.save_png(str(tmp_path / f"j_{name}.png"), a)
        data = (tmp_path / f"t_{name}.png").read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert data == (tmp_path / f"j_{name}.png").read_bytes()
        u8 = tio.normalize_robust(a) if a.dtype != np.uint8 else a
        tio._write_png_minimal(str(tmp_path / f"tm_{name}.png"), u8)
        jio._write_png_minimal(str(tmp_path / f"jm_{name}.png"), u8)
        assert ((tmp_path / f"tm_{name}.png").read_bytes()
                == (tmp_path / f"jm_{name}.png").read_bytes())
    tio.save_img_bin(str(tmp_path / "i.bin"), img)
    np.testing.assert_array_equal(np.fromfile(tmp_path / "i.bin").reshape(img.shape), img)


# ---------------------------------------------------------------------------
# rosbag
# ---------------------------------------------------------------------------


def _events(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return (np.sort(rng.uniform(10.0, 11.0, n)), rng.integers(0, 64, n).astype(np.int32),
            rng.integers(0, 48, n).astype(np.int32), rng.integers(0, 2, n).astype(np.int8))


CAM = dict(width=240, height=180, distortion_model="plumb_bob",
           D=np.array([-0.3, 0.1, 1e-4, -1e-4, 0.02]),
           K=np.array([200.0, 0, 120, 0, 201.0, 90, 0, 0, 1]), R=np.eye(3).ravel(),
           P=np.array([199.0, 0, 119, 0, 0, 200.5, 89, 0, 0, 0, 1, 0]))


@pytest.mark.parametrize("layout", ["plain", "indexed_bz2_multiconn", "unindexed"])
def test_rosbag_cross(tmp_path, layout):
    """A bag written by either package is parsed by the other, and both
    write the same bytes (the layouts of ``tests/test_pipeline.py``'s bag
    tests: plain, bz2 chunks with index records, a camera-info connection
    and an unknown topic, and the unindexed layout of a crashed recorder)."""
    t, x, y, pol = _events(seed=len(layout))
    kw = dict(chunk_events=1234)
    if layout == "indexed_bz2_multiconn":
        kw.update(width=240, height=180, compression="bz2",
                  camera_info_topic="/dvs/camera_info", extra_topic="/rosout")
    if layout == "unindexed":
        kw.update(chunk_events=999, write_index=False)
    for mod, name in ((jrb, "j.bag"), (trb, "t.bag")):
        if "camera_info_topic" in kw:
            kw["camera_info"] = mod.CameraInfo(**CAM)
        mod.write_rosbag(str(tmp_path / name), "/dvs/events", t, x, y, pol, **kw)
    assert (tmp_path / "j.bag").read_bytes() == (tmp_path / "t.bag").read_bytes()
    for reader, name in ((trb, "j.bag"), (jrb, "t.bag")):
        (t2, x2, y2, pol2), cam = reader.parse_rosbag(
            str(tmp_path / name), "/dvs/events", camera_info_topic="/dvs/camera_info")
        np.testing.assert_array_equal(t2, jrb.parse_rosbag(str(tmp_path / name),
                                                           "/dvs/events")[0][0])
        np.testing.assert_allclose(t2, t, atol=1e-9)
        np.testing.assert_array_equal(x2, x)
        np.testing.assert_array_equal(y2, y)
        np.testing.assert_array_equal(pol2, pol)
        if layout == "indexed_bz2_multiconn":
            assert cam.width == 240 and cam.distortion_model == "plumb_bob"
            np.testing.assert_array_equal(cam.K, CAM["K"])
        else:
            assert cam is None
    (t3, *_), _ = trb.parse_rosbag(str(tmp_path / "j.bag"), "/dvs/events",
                                   tmin=10.5, tmax=10.8)
    assert t3.min() > 10.5 and t3.max() <= 10.8


def test_convert_bag_cli_matches_jax(tmp_path):
    """``convert-bag`` of both CLIs on a bag with camera info: the same
    events file contents and the same calibration file."""
    from emba_tpu import cli as jcli
    from emba_tpu_torch import cli as tcli

    t, x, y, pol = _events(seed=7)
    bag = tmp_path / "in.bag"
    jrb.write_rosbag(str(bag), "/dvs/events", t, x, y, pol, width=240, height=180,
                     camera_info=jrb.CameraInfo(**CAM), camera_info_topic="/dvs/camera_info")
    for cli, k in ((tcli, "t"), (jcli, "j")):
        cli.main(["convert-bag", "--bag", str(bag), "--out", str(tmp_path / f"{k}.npz"),
                  "--calib-out", str(tmp_path / f"{k}.yaml")])
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    for a, b in zip(tio.load_events_npz(str(tmp_path / "t.npz"))[:4],
                    jio.load_events_npz(str(tmp_path / "j.npz"))[:4]):
        np.testing.assert_array_equal(a, b)
    from emba_tpu_torch.camera import load_camera_yaml

    cam = load_camera_yaml(str(tmp_path / "t.yaml"))
    assert (cam.width, cam.height) == (240, 180)
    np.testing.assert_array_equal(cam.K.ravel(), CAM["K"])


@pytest.mark.parametrize("full", [False, True], ids=["K only", "K D R P"])
def test_save_calib_yaml_read_by_both(tmp_path, full):
    """``io.save_calib_yaml`` (of ``cli synth``, ``cli convert-bag`` and the
    chip smoke's scene) is read back with the same camera by the port's and
    the JAX package's loaders."""
    from emba_tpu.camera import load_camera_yaml as jload
    from emba_tpu_torch.camera import load_camera_yaml as tload

    K = np.array([[216.0, 0.0, 120.5], [0.0, 215.25, 90.0], [0.0, 0.0, 1.0]])
    extra = dict(D=[-0.25, 0.0625, 1e-3, -2e-3, 0.0], R=np.eye(3),
                 P=np.hstack([K, np.zeros((3, 1))])) if full else {}
    path = str(tmp_path / "calib.yaml")
    tio.save_calib_yaml(path, 240, 180, K, **extra)
    t, j = tload(path), jload(path)
    assert (t.width, t.height) == (j.width, j.height) == (240, 180)
    for name in ("K", "D", "R", "P"):
        np.testing.assert_array_equal(getattr(t, name), np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t.K, K)
    if full:
        np.testing.assert_array_equal(t.D, extra["D"])


def test_rosbag_lz4_gated(tmp_path):
    """lz4 chunks: round trip where the lz4 module imports; otherwise the
    writer raises ImportError and the reader a RuntimeError naming lz4, as
    in the reference module."""
    t, x, y, pol = _events(n=100, seed=2)
    bag = tmp_path / "l.bag"
    try:
        import lz4.frame  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            trb.write_rosbag(str(bag), "/e", t, x, y, pol, compression="lz4")
        import struct as st

        chunk = trb._record({"op": b"\x05", "compression": b"lz4",
                             "size": st.pack("<I", 4)}, b"\x00\x00\x00\x00")
        hdr = trb._record({"op": b"\x03", "index_pos": st.pack("<Q", 0),
                           "conn_count": st.pack("<I", 0),
                           "chunk_count": st.pack("<I", 1)}, b" " * 64)
        bag.write_bytes(b"#ROSBAG V2.0\n" + hdr + chunk)
        with pytest.raises(RuntimeError, match="lz4"):
            trb.parse_rosbag(str(bag), "/e")
    else:
        trb.write_rosbag(str(bag), "/e", t, x, y, pol, compression="lz4")
        (t2, *_), _ = jrb.parse_rosbag(str(bag), "/e")
        np.testing.assert_allclose(t2, t, atol=1e-9)


# ---------------------------------------------------------------------------
# recon
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(17,), (5, 17), (12, 18)])
@pytest.mark.parametrize("name", ["dst1", "dct1"])
def test_transforms_match(name, shape):
    x = RNG.normal(size=shape)
    for axis in range(len(shape)):
        got = getattr(trecon, name)(t64(x), axis=axis).numpy()
        want = np.asarray(getattr(jrecon, name)(jnp.asarray(x), axis=axis))
        assert rel_err(got, want) <= RECON_REL


@pytest.mark.parametrize("boundary,bound_value", [("dirichlet", 0.0), ("dirichlet", 0.3),
                                                  ("neumann", 0.0), ("neumann", -0.2)])
def test_poisson_solve_matches(boundary, bound_value):
    F = RNG.normal(size=(16, 24))
    got = trecon.poisson_solve(t64(F), boundary, bound_value).numpy()
    # the reference's jit traces bound_value; its plain function takes a float
    want = np.asarray(jrecon.poisson_solve.__wrapped__(jnp.asarray(F), boundary,
                                                       bound_value))
    assert rel_err(got, want) <= RECON_REL
    with pytest.raises(ValueError):
        trecon.poisson_solve(t64(F), "periodic")


@pytest.mark.parametrize("bound_value", [0.0, 0.7])
def test_poisson_dirichlet_matches_dense(bound_value):
    """The port's solve against a dense solve of the 5-point system (the
    check of ``tests/test_recon.py``); a boundary value b moves to the right
    side as b times each point's neighbours outside the grid."""
    F = RNG.normal(size=(12, 18))
    n1, n2 = F.shape
    ghosts = np.zeros_like(F)
    ghosts[[0, -1], :] += 1
    ghosts[:, [0, -1]] += 1
    A = np.zeros((n1 * n2, n1 * n2))
    for i in range(n1):
        for j in range(n2):
            k = i * n2 + j
            A[k, k] = -4.0
            for di, dj in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
                if 0 <= i + di < n1 and 0 <= j + dj < n2:
                    A[k, (i + di) * n2 + j + dj] = 1.0
    U_ref = np.linalg.solve(A, (F - bound_value * ghosts).reshape(-1)).reshape(n1, n2)
    np.testing.assert_allclose(trecon.poisson_solve(t64(F), "dirichlet", bound_value)
                               .numpy(), U_ref, atol=1e-8)


def test_reconstruct_and_operators_match():
    gx, gy = RNG.normal(size=(32, 64)), RNG.normal(size=(32, 64))
    for boundary in ("dirichlet", "neumann"):
        got = trecon.reconstruct_from_gradient(t64(gx), t64(gy), boundary).numpy()
        want = np.asarray(jrecon.reconstruct_from_gradient(jnp.asarray(gx),
                                                           jnp.asarray(gy), boundary))
        assert rel_err(got, want) <= RECON_REL
    np.testing.assert_array_equal(trecon.divergence(t64(gx), t64(gy)).numpy(),
                                  np.asarray(jrecon.divergence(jnp.asarray(gx),
                                                               jnp.asarray(gy))))
    u = RNG.normal(size=(9, 13))
    for a, b in zip(trecon.grad_central(t64(u), 0.5, 2.0),
                    jrecon.grad_central(jnp.asarray(u), 0.5, 2.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0)
    np.testing.assert_allclose(trecon.laplacian_5pt(t64(u), 1.5, 0.7, 0.25).numpy(),
                               np.asarray(jrecon.laplacian_5pt(jnp.asarray(u), 1.5,
                                                               0.7, 0.25)),
                               rtol=1e-14, atol=1e-14)


# ---------------------------------------------------------------------------
# obs
# ---------------------------------------------------------------------------


def test_obs_helpers(tmp_path):
    assert not obs.nan_checks_enabled()
    with obs.nan_debug(True):
        assert obs.nan_checks_enabled()
        with obs.nan_debug(False):
            assert not obs.nan_checks_enabled()
        assert obs.nan_checks_enabled()
    assert not obs.nan_checks_enabled()
    obs.check_finite("window 0", knots=torch.ones(3), cost=1.0)
    with pytest.raises(FloatingPointError, match="window 3: non-finite gx"):
        obs.check_finite("window 3", knots=torch.ones(3), gx=torch.tensor([0.0, np.nan]))
    with pytest.raises(FloatingPointError, match="cost"):
        obs.check_finite("window 1", cost=float("inf"))

    with obs.profiler_trace(str(tmp_path / "prof"), "cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    with obs.profiler_trace(None):
        pass
    assert os.path.isdir(tmp_path / "prof")
