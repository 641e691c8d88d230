"""SO(3) Lie-group core in torch: exp/log, hat/vee, left and right
Jacobians, quaternion interop.

Counterpart of ``emba_tpu/lie.py``, function for function. Rotations are
3x3 matrices, every function is batched over leading axes, and each
small-angle branch keeps the reference's Taylor expansion and its
``where``-guarded division so that no branch ever evaluates 0/0.
"""

from __future__ import annotations

import torch

# Angle below which Taylor expansions are used (same as the reference).
_SMALL_ANGLE = 1e-5


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def hat(v):
    """Skew-symmetric (hat) operator. v: (..., 3) -> (..., 3, 3), with
    ``hat(v) @ w == cross(v, w)``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m):
    """Inverse of :func:`hat` (symmetrized extraction)."""
    return 0.5 * torch.stack(
        [
            m[..., 2, 1] - m[..., 1, 2],
            m[..., 0, 2] - m[..., 2, 0],
            m[..., 1, 0] - m[..., 0, 1],
        ],
        dim=-1,
    )


def _theta(v):
    """(theta2, theta_safe, is_small): ``theta_safe`` is 1 where
    ``is_small`` so the non-Taylor branch never divides by zero."""
    theta2 = torch.sum(v * v, dim=-1)
    is_small = theta2 < _SMALL_ANGLE**2
    theta2_safe = torch.where(is_small, torch.ones_like(theta2), theta2)
    return theta2, torch.sqrt(theta2_safe), is_small


def exp(v):
    """SO(3) exponential map (Rodrigues). v: (..., 3) -> (..., 3, 3)."""
    theta2, theta_safe, is_small = _theta(v)
    K = hat(v)
    K2 = K @ K
    st = torch.sin(theta_safe)
    ct = torch.cos(theta_safe)
    a = torch.where(is_small, 1.0 - theta2 / 6.0, st / theta_safe)
    b = torch.where(is_small, 0.5 - theta2 / 24.0, (1.0 - ct) / theta_safe**2)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * K2


def log(R):
    """SO(3) logarithm. R: (..., 3, 3) -> (..., 3); finite up to just
    below pi (knot increments are always far below it)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    is_small = cos_theta > 1.0 - 1e-7
    wn2 = torch.sum(w * w, dim=-1)
    cos_safe = torch.where(is_small, torch.zeros_like(cos_theta), cos_theta)
    theta = torch.arccos(cos_safe)
    sin_safe = torch.sqrt(torch.clamp(1.0 - cos_safe * cos_safe, min=1e-24))
    k = torch.where(is_small, 0.5 + wn2 / 48.0, theta / (2.0 * sin_safe))
    return k[..., None] * w


def left_jacobian(v):
    """Jl = I + (1-cos t)/t^2 hat(v) + (t - sin t)/t^3 hat(v)^2."""
    theta2, theta_safe, is_small = _theta(v)
    K = hat(v)
    K2 = K @ K
    st, ct = torch.sin(theta_safe), torch.cos(theta_safe)
    a = torch.where(is_small, 0.5 - theta2 / 24.0, (1.0 - ct) / theta_safe**2)
    b = torch.where(
        is_small, 1.0 / 6.0 - theta2 / 120.0, (theta_safe - st) / theta_safe**3
    )
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * K2


def left_jacobian_inv(v):
    """Jl^-1 = I - hat(v)/2 + (1/t^2 - (1+cos t)/(2 t sin t)) hat(v)^2."""
    theta2, theta_safe, is_small = _theta(v)
    K = hat(v)
    K2 = K @ K
    st, ct = torch.sin(theta_safe), torch.cos(theta_safe)
    st_safe = torch.where(torch.abs(st) < 1e-30, torch.ones_like(st), st)
    c = torch.where(
        is_small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / theta_safe**2 - (1.0 + ct) / (2.0 * theta_safe * st_safe),
    )
    return _eye_like(K) - 0.5 * K + c[..., None, None] * K2


def right_jacobian(v):
    """Jr(v) = Jl(-v)."""
    return left_jacobian(-v)


def right_jacobian_inv(v):
    """Jr^-1(v) = Jl^-1(-v)."""
    return left_jacobian_inv(-v)


def quat_to_matrix(q):
    """Unit quaternion (..., 4) in (x, y, z, w) order -> rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R):
    """Rotation matrix -> unit quaternion (x, y, z, w), w >= 0
    (Shepperd-style: the candidate with the largest pivot wins)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, wxyz)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q_wxyz = torch.gather(cands, -2, idx)[..., 0, :]
    q_wxyz = q_wxyz / torch.linalg.norm(q_wxyz, dim=-1, keepdim=True)
    q_wxyz = torch.where(q_wxyz[..., :1] < 0, -q_wxyz, q_wxyz)
    return torch.cat([q_wxyz[..., 1:], q_wxyz[..., :1]], dim=-1)


def slerp(R1, R2, alpha):
    """Geodesic interpolation R1 * exp(alpha * log(R1^T R2))."""
    alpha = torch.as_tensor(alpha, dtype=R1.dtype, device=R1.device)
    rel = R1.transpose(-1, -2) @ R2
    return R1 @ exp(alpha[..., None] * log(rel))
