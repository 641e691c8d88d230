"""Poisson brightness reconstruction: gradient map -> panorama
(counterpart of ``emba_tpu/recon.py``).

* divergence of (Gx, Gy) by forward differences
  (reference ``poisson_reconstruction.cpp:21-29``),
* solve ``u_xx + u_yy = F`` with Dirichlet (DST-I) or Neumann (DCT-I)
  boundaries by eigen-decomposition of the 5-point Laplacian:
  transform -> divide by ``lambda_i + lambda_j`` -> inverse transform
  (``laplace.cpp:641-776``; eigenvalues ``laplace.cpp:697-709``),
* DST-I/DCT-I built from ``torch.fft.rfft`` over odd/even extensions, on
  the device and in the dtype of the maps.

Also the finite-difference gradient and Laplacian operators (the
reference's ``laplace.h:92-209`` utility surface).
"""

from __future__ import annotations

import math

import torch


def dst1(x, axis: int = -1):
    """Type-I discrete sine transform along ``axis`` (orthogonal up to a
    factor: DST1(DST1(x)) = (n+1)/2 * x). Matches FFTW's RODFT00 up to its
    factor of 2 (FFTW computes 2*DST1)."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    z = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    ext = torch.cat([z, x, z, -torch.flip(x, (-1,))], dim=-1)  # length 2(n+1)
    X = torch.fft.rfft(ext, dim=-1)
    out = -X.imag[..., 1 : n + 1] / 2.0
    return torch.movedim(out.to(x.dtype), -1, axis)


def dct1(x, axis: int = -1):
    """Type-I discrete cosine transform along ``axis``
    (DCT1(DCT1(x)) = (n-1)/2 * x for the interior). Matches FFTW's REDFT00
    up to its factor of 2."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    ext = torch.cat([x, torch.flip(x[..., 1 : n - 1], (-1,))], dim=-1)  # 2(n-1)
    X = torch.fft.rfft(ext, dim=-1)
    out = X.real[..., :n] / 2.0
    return torch.movedim(out.to(x.dtype), -1, axis)


def _eigenvalues(n: int, shift: int, denom: int, like):
    k = torch.arange(n, dtype=torch.float64, device=like.device) + shift
    return (-4.0 * torch.sin(math.pi * k / (2.0 * denom)) ** 2).to(like.dtype)


def poisson_solve(F, boundary: str = "dirichlet", bound_value: float = 0.0):
    """Solve ``u_xx + u_yy = F`` on the unit grid (a1=a2=h1=h2=1, the
    parameters EMBA uses, ``poisson_reconstruction.cpp:36-38``).

    Dirichlet: u = bound_value on the (virtual) boundary just outside the
    grid; Neumann: du/dn = bound_value.

    Reference math: ``laplace.cpp:587-796``.
    """
    F = torch.as_tensor(F)
    n1, n2 = F.shape

    def adjust(F, v):
        # boundary rhs adjustment (laplace.cpp:610-631)
        F = F.clone()
        F[0, :] -= v
        F[-1, :] -= v
        F[:, 0] -= v
        F[:, -1] -= v
        return F

    if boundary == "dirichlet":
        if bound_value != 0.0:
            F = adjust(F, bound_value)
        lam1 = _eigenvalues(n1, 1, n1 + 1, F)
        lam2 = _eigenvalues(n2, 1, n2 + 1, F)
        # forward: DST-I both axes; normalization such that applying the
        # transform twice is identity: DST1^2 = ((n1+1)/2)((n2+1)/2).
        Fh = dst1(dst1(F, axis=0), axis=1)
        div = lam1[:, None] + lam2[None, :]
        Uh = Fh / div  # div < 0 strictly for Dirichlet: no zero mode
        return dst1(dst1(Uh, axis=0), axis=1) * (4.0 / ((n1 + 1) * (n2 + 1)))
    if boundary == "neumann":
        if bound_value != 0.0:
            F = adjust(F, 2.0 * bound_value)
        lam1 = _eigenvalues(n1, 0, n1 - 1, F)
        lam2 = _eigenvalues(n2, 0, n2 - 1, F)
        # Eigen basis is DCT-I with half-weighted first/last coefficients
        # (laplace.cpp:654-673): forward = w . DCT1(F); inverse = DCT1(U/w).
        w1 = torch.ones(n1, dtype=F.dtype, device=F.device)
        w2 = torch.ones(n2, dtype=F.dtype, device=F.device)
        w1[0] = w1[-1] = w2[0] = w2[-1] = 0.5
        wgrid = w1[:, None] * w2[None, :]
        Fh = dct1(dct1(F, axis=0), axis=1) * wgrid / ((n1 - 1) * (n2 - 1))
        div = lam1[:, None] + lam2[None, :]
        div_safe = torch.where(div == 0.0, torch.ones_like(div), div)
        # project out the zero mode
        Uh = torch.where(div == 0.0, torch.zeros_like(Fh), Fh / div_safe)
        return 4.0 * dct1(dct1(Uh / wgrid, axis=0), axis=1)
    raise ValueError(f"unknown boundary {boundary!r}")


def divergence(gx, gy):
    """Forward-difference divergence with zeroed last row/column
    (reference ``poisson_reconstruction.cpp:21-29``)."""
    F = torch.zeros_like(gx)
    F[:-1, :-1] = gx[:-1, 1:] - gx[:-1, :-1] + gy[1:, :-1] - gy[:-1, :-1]
    return F


def reconstruct_from_gradient(gx, gy, boundary: str = "dirichlet"):
    """Gradient maps -> brightness panorama (reference
    ``reconstructFromGradient``, poisson_reconstruction.cpp:9-50)."""
    return poisson_solve(divergence(gx, gy), boundary=boundary)


# ---------------------------------------------------------------------------
# Finite-difference operators (reference laplace.h:92-209 surface).
# ---------------------------------------------------------------------------


def grad_central(u, h1: float = 1.0, h2: float = 1.0):
    """Central-difference gradient (interior), one-sided at borders."""
    gy = (torch.roll(u, -1, 0) - torch.roll(u, 1, 0)) / (2 * h1)
    gy[0, :] = (u[1, :] - u[0, :]) / h1
    gy[-1, :] = (u[-1, :] - u[-2, :]) / h1
    gx = (torch.roll(u, -1, 1) - torch.roll(u, 1, 1)) / (2 * h2)
    gx[:, 0] = (u[:, 1] - u[:, 0]) / h2
    gx[:, -1] = (u[:, -1] - u[:, -2]) / h2
    return gx, gy


def laplacian_5pt(u, h1: float = 1.0, h2: float = 1.0, boundary_value: float = 0.0):
    """5-point Laplacian with constant Dirichlet padding."""
    p = torch.nn.functional.pad(u, (1, 1, 1, 1), value=boundary_value)
    return (p[:-2, 1:-1] - 2 * u + p[2:, 1:-1]) / h1**2 + (
        p[1:-1, :-2] - 2 * u + p[1:-1, 2:]
    ) / h2**2
