"""Artifact IO: events, trajectories, gradient maps, images (counterpart of
``emba_tpu/io.py``, the same on-disk formats):

* ``Gx.bin``/``Gy.bin`` — raw little-endian float64, row-major, pano size
  inferred from the byte count as H = sqrt(N/2), W = 2H (reference
  ``EMBA::loadMap``, src/emba/emba.cpp:535-578),
* TUM trajectory txt ``t tx ty tz qx qy qz qw`` (reference
  ``PoseManager::loadPoses`` src/utils/pose_manager.cpp:7-39 and
  ``LinearTrajectory::write`` src/utils/trajectory.cpp:98-114),
* events as ``.npz`` SoA (t float64 [s], x/y int16, pol int8), the
  replacement for rosbag streams (converter in :mod:`emba_tpu_torch.rosbag`),
* raw image dump (reference ``image_util::saveImgBin``
  src/utils/image_utils.cpp:43-61) and robust-normalized PNG export
  (``normalizeRobust`` image_utils.cpp:30-38).

Quaternion conversions go through the port's :mod:`lie` on the CPU in f64.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import lie

# ---------------------------------------------------------------------------
# Gradient maps.
# ---------------------------------------------------------------------------


def load_map_bin(path_gx: str, path_gy: str):
    """Load Gx/Gy with the reference's size-inference convention."""
    gx_raw = np.fromfile(path_gx, dtype="<f8")
    gy_raw = np.fromfile(path_gy, dtype="<f8")
    if gx_raw.size != gy_raw.size:
        raise ValueError("Gx/Gy byte sizes differ")
    h = int(np.sqrt(gx_raw.size / 2))
    w = 2 * h
    if h * w != gx_raw.size:
        raise ValueError(f"map size {gx_raw.size} is not 2*H^2 for integer H")
    return gx_raw.reshape(h, w), gy_raw.reshape(h, w)


def save_map_bin(path_gx: str, path_gy: str, gx: np.ndarray, gy: np.ndarray):
    np.asarray(gx, dtype="<f8").tofile(path_gx)
    np.asarray(gy, dtype="<f8").tofile(path_gy)


# ---------------------------------------------------------------------------
# Trajectories (TUM format).
# ---------------------------------------------------------------------------


def load_tum_trajectory(path: str, time_offset: float = 0.0):
    """Read a TUM trajectory txt -> (times (M,), rotations (M, 3, 3)).

    Applies ``time_offset`` to the timestamps (reference
    pose_manager.cpp:27).
    """
    data = np.loadtxt(path)
    data = np.atleast_2d(data)
    times = data[:, 0] + time_offset
    quats = data[:, 4:8]  # qx qy qz qw
    R = lie.quat_to_matrix(torch.from_numpy(np.ascontiguousarray(quats))).numpy()
    order = np.argsort(times, kind="stable")
    return times[order], R[order]


def save_tum_trajectory(path: str, times, rotations, time_offset: float = 0.0):
    rot = torch.from_numpy(np.array(rotations, np.float64))
    quats = lie.matrix_to_quat(rot).numpy()
    with open(path, "w") as f:
        for t, q in zip(np.asarray(times), quats):
            f.write(f"{t - time_offset} 0.0 0.0 0.0 {q[0]} {q[1]} {q[2]} {q[3]}\n")


# ---------------------------------------------------------------------------
# Events.
# ---------------------------------------------------------------------------


def save_events_npz(path: str, t, x, y, pol, **meta):
    np.savez_compressed(
        path,
        t=np.asarray(t, np.float64),
        x=np.asarray(x, np.int16),
        y=np.asarray(y, np.int16),
        pol=np.asarray(pol, np.int8),
        **{f"meta_{k}": np.asarray(v) for k, v in meta.items()},
    )


def load_events_npz(path: str):
    z = np.load(path)
    meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return (
        z["t"].astype(np.float64),
        z["x"].astype(np.int32),
        z["y"].astype(np.int32),
        z["pol"].astype(np.int8),
        meta,
    )


# ---------------------------------------------------------------------------
# Camera calibration (the ROS YAML that ``camera.load_camera_yaml`` reads).
# ---------------------------------------------------------------------------


def save_calib_yaml(path: str, width: int, height: int, K, D=None, R=None, P=None,
                    distortion_model: str = "plumb_bob"):
    """Write a ROS-style calibration YAML; D defaults to no distortion, and
    the rectification and projection matrices are written only when given."""

    def data(a):
        return ", ".join(map(str, np.asarray(a).ravel()))

    with open(path, "w") as f:
        f.write(f"image_width: {width}\nimage_height: {height}\n")
        f.write(f"camera_matrix:\n  rows: 3\n  cols: 3\n  data: [{data(K)}]\n")
        f.write(f"distortion_model: {distortion_model}\n")
        f.write("distortion_coefficients:\n  rows: 1\n  cols: 5\n"
                f"  data: [{'0, 0, 0, 0, 0' if D is None else data(D)}]\n")
        if R is not None:
            f.write(f"rectification_matrix:\n  rows: 3\n  cols: 3\n  data: [{data(R)}]\n")
        if P is not None:
            f.write(f"projection_matrix:\n  rows: 3\n  cols: 4\n  data: [{data(P)}]\n")


# ---------------------------------------------------------------------------
# Images.
# ---------------------------------------------------------------------------


def minmax_robust(img: np.ndarray, percent: float = 0.1):
    """Percentile-clipped min/max (reference ``minMaxLocRobust``,
    image_utils.cpp:13-24)."""
    lo = np.percentile(img, percent)
    hi = np.percentile(img, 100.0 - percent)
    return lo, hi


def normalize_robust(img: np.ndarray, percent: float = 0.1) -> np.ndarray:
    """Robust 0..255 normalization (reference ``normalizeRobust``,
    image_utils.cpp:30-38)."""
    lo, hi = minmax_robust(img, percent)
    scale = 255.0 / (hi - lo + 1e-12)
    return np.clip((img - lo) * scale, 0, 255).astype(np.uint8)


def save_img_bin(path: str, img: np.ndarray):
    """Raw float64 dump (reference ``saveImgBin``, image_utils.cpp:43-61)."""
    np.asarray(img, dtype="<f8").tofile(path)


def save_png(path: str, img: np.ndarray):
    """Write a PNG (uint8 grayscale or HxWx3): PIL if present, else a
    minimal PNG encoder (stdlib zlib)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = normalize_robust(img)
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
        return
    except ImportError:
        pass
    _write_png_minimal(path, img)


def _write_png_minimal(path: str, img: np.ndarray):
    import struct
    import zlib

    if img.ndim == 2:
        color_type = 0
        raw = img[:, :, None]
    else:
        color_type = 2
        raw = img
    h, w = raw.shape[:2]
    lines = b"".join(b"\x00" + raw[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", hdr))
        f.write(chunk(b"IDAT", zlib.compress(lines, 6)))
        f.write(chunk(b"IEND", b""))


def gradient_hsv_image(gx: np.ndarray, gy: np.ndarray) -> np.ndarray:
    """Orientation-hue / magnitude-value visualization of the gradient map
    (reference ``saveEvoData``, src/emba/solver.cpp:386-408): H = gradient
    orientation, S = 1, V = normalized magnitude."""
    mag = np.hypot(gx, gy)
    ang = np.degrees(np.arctan2(gy, gx)) % 360.0
    hch = ang / 360.0
    vch = mag / (mag.max() + 1e-12)
    # HSV -> RGB (S = 1)
    i = np.floor(hch * 6.0).astype(int) % 6
    f = hch * 6.0 - np.floor(hch * 6.0)
    p = np.zeros_like(vch)
    q = vch * (1.0 - f)
    t = vch * f
    rgb = np.zeros(gx.shape + (3,))
    lut = [
        (vch, t, p),
        (q, vch, p),
        (p, vch, t),
        (p, q, vch),
        (t, p, vch),
        (vch, p, q),
    ]
    for k in range(6):
        m = i == k
        for c in range(3):
            rgb[..., c][m] = lut[k][c][m]
    return (rgb * 255).astype(np.uint8)


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
