"""Camera models: pinhole + plumb_bob rectification (numpy, host) and the
equirectangular panorama (torch).

Counterpart of ``emba_tpu/camera.py``. The bearing LUT is computed once on
the host in f64; projection and its Jacobian are torch ops on any device,
safe at the z-axis and at the poles.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Pinhole intrinsics with plumb_bob distortion and rectification
    (the fields of a ROS CameraInfo message)."""

    width: int
    height: int
    K: np.ndarray  # (3, 3) camera matrix
    D: np.ndarray  # (5,) plumb_bob: k1 k2 p1 p2 k3
    R: np.ndarray  # (3, 3) rectification matrix
    P: np.ndarray  # (3, 4) projection matrix

    @classmethod
    def from_calib(cls, width: int, height: int, K, D=None, R=None, P=None
                   ) -> "PinholeCamera":
        K = np.asarray(K, dtype=np.float64).reshape(3, 3)
        D = (
            np.zeros(5)
            if D is None
            else np.pad(np.asarray(D, dtype=np.float64).ravel(), (0, 5))[:5]
        )
        R = np.eye(3) if R is None else np.asarray(R, dtype=np.float64).reshape(3, 3)
        if P is None:
            P = np.zeros((3, 4))
            P[:, :3] = K
        else:
            P = np.asarray(P, dtype=np.float64).reshape(3, 4)
        return cls(width=width, height=height, K=K, D=D, R=R, P=P)

    def undistort_normalized(self, u, v, iters: int = 8):
        """Raw pixel -> undistorted normalized coordinates (x, y) on z=1
        (fixed-point inversion of the plumb_bob model)."""
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        x0 = (np.asarray(u, dtype=np.float64) - cx) / fx
        y0 = (np.asarray(v, dtype=np.float64) - cy) / fy
        k1, k2, p1, p2, k3 = self.D
        x, y = x0, y0
        if np.any(self.D != 0):
            for _ in range(iters):
                r2 = x * x + y * y
                icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
                dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
                dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
                x = (x0 - dx) * icdist
                y = (y0 - dy) * icdist
        return x, y

    def bearing_lut(self) -> np.ndarray:
        """Per-pixel unit bearing vectors, row-major (H*W, 3) f64."""
        xs, ys = np.meshgrid(np.arange(self.width), np.arange(self.height))
        x, y = self.undistort_normalized(xs.ravel(), ys.ravel())
        rays = np.stack([x, y, np.ones_like(x)], axis=-1)
        rays = rays @ self.R.T
        return rays / np.linalg.norm(rays, axis=-1, keepdims=True)


@dataclasses.dataclass(frozen=True)
class EquirectangularCamera:
    """Equirectangular panorama projection (360 x 180 deg FOV):
    fx = W/(2 pi), fy = H/pi, principal point at the image center."""

    width: int
    height: int

    @property
    def fx(self) -> float:
        return self.width / (2.0 * np.pi)

    @property
    def fy(self) -> float:
        return self.height / np.pi

    def project(self, P, need_jacobian: bool = True):
        """Project 3D points (..., 3) -> pano pixels (..., 2) [+ the 2x3
        Jacobian], phi = atan2(x, z), theta = asin(y / ||P||)."""
        x, y, z = P[..., 0], P[..., 1], P[..., 2]
        rho2 = x * x + y * y + z * z
        rho = torch.sqrt(rho2)
        phi = torch.atan2(x, z)
        y_div_rho = torch.clamp(y / rho, -1.0, 1.0)
        theta = torch.asin(y_div_rho)
        fx, fy = self.fx, self.fy
        pm = torch.stack(
            [self.width / 2.0 + phi * fx, self.height / 2.0 + theta * fy], dim=-1
        )
        if not need_jacobian:
            return pm
        xz2 = x * x + z * z
        xz2_safe = torch.where(xz2 < 1e-24, torch.ones_like(xz2), xz2)
        j00 = fx * z / xz2_safe
        j02 = -fx * x / xz2_safe
        one_m_w2 = torch.clamp(1.0 - y_div_rho * y_div_rho, min=1e-12)
        inv_sq = 1.0 / torch.sqrt(one_m_w2)
        tmp3 = y_div_rho / rho2
        j10 = fy * inv_sq * (-tmp3 * x)
        j11 = fy * inv_sq * (1.0 / rho - tmp3 * y)
        j12 = fy * inv_sq * (-tmp3 * z)
        zero = torch.zeros_like(j00)
        jac = torch.stack(
            [torch.stack([j00, zero, j02], dim=-1),
             torch.stack([j10, j11, j12], dim=-1)],
            dim=-2,
        )
        return pm, jac

    def lift_to_unit_sphere(self, pm):
        """Pano pixel (..., 2) -> unit bearing (..., 3); inverse of
        :meth:`project`."""
        phi = (pm[..., 0] - self.width / 2.0) / self.fx
        theta = (pm[..., 1] - self.height / 2.0) / self.fy
        ct = torch.cos(theta)
        return torch.stack(
            [torch.sin(phi) * ct, torch.sin(theta), torch.cos(phi) * ct], dim=-1
        )


def load_camera_yaml(path: str) -> PinholeCamera:
    """Load a ROS-style camera calibration YAML (minimal parser, no yaml
    dependency)."""
    with open(path) as f:
        text = f.read()

    def grab(name, default=None):
        m = re.search(rf"^{name}:\s*(.*)$", text, re.M)
        return m.group(1).strip() if m else default

    width = int(grab("image_width"))
    height = int(grab("image_height"))

    def grab_matrix(name):
        i = text.find(name + ":")
        if i < 0:
            return None
        m = re.search(r"data:\s*\[([^\]]*)\]", text[i:])
        if not m:
            return None
        return np.array([float(v) for v in m.group(1).replace("\n", " ").split(",")])

    return PinholeCamera.from_calib(
        width, height,
        K=grab_matrix("camera_matrix"),
        D=grab_matrix("distortion_coefficients"),
        R=grab_matrix("rectification_matrix"),
        P=grab_matrix("projection_matrix"),
    )
