"""Accumulation of the LEGM normal equations: the pose-map coupling block
A12, the per-pixel A22 / b2 sums and the pose block A11 / b1.

Counterpart of ``emba_tpu/kernels/a12_accum.py`` with the same contract.
On a CUDA tensor :func:`a12_accumulate` launches the hand-written kernel in
``csrc/a12_accum.cu`` (its note says what bounds it and how it is built);
on a CPU tensor it runs :func:`a12_accumulate_plain`, the plain torch
version (counterpart of ``emba_tpu.model._xla_accumulate``). There is no
fallback: a CUDA input the kernel cannot take raises.

Layout: A12 is (R_pad, 2*dp_pad), columns [0:dp_pad) the Gx plane and
[dp_pad:2*dp_pad) the Gy plane; px5 is (R_pad, 8) with columns 0..4 =
a22_xx, a22_xy, a22_yy, b2_x, b2_y; a11b is (dp_pad + 8, dp_pad) with rows
[0:dp_pad) = A11 and row dp_pad = b1. Padding is zero.
"""

from __future__ import annotations

import ctypes

import torch

ROW_ALIGN = 128  # R_pad = round_up(num_pix, ROW_ALIGN)
DP_ALIGN = 32  # dp_pad = round_up(dim_pose, DP_ALIGN): 128-byte row segments
CHUNK = 1 << 16  # measurements per step of the plain version
A11_BLOCKS = 1024  # most private A11 partials of the kernel
A11_MIN_PER_BLOCK = 256  # fewest measurements a partial covers

# Launches of the CUDA kernel in this process; a caller may reset it.
launches = 0


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_dims(num_pix: int, dim_pose: int) -> tuple[int, int]:
    """(R_pad, dp_pad) of the outputs."""
    return round_up(num_pix, ROW_ALIGN), round_up(dim_pose, DP_ALIGN)


def _zeros_out(r_pad, dp_pad, dtype, device):
    return (
        torch.zeros((r_pad, 2 * dp_pad), dtype=dtype, device=device),
        torch.zeros((r_pad, 8), dtype=dtype, device=device),
        torch.zeros((dp_pad + 8, dp_pad), dtype=dtype, device=device),
    )


def a12_accumulate(pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA, num_pix: int,
                   dim_pose: int, order: int, carry=None):
    """Accumulate A12, px5 and A11/b1 over a measurement set.

    Args:
      pm_pix: (N,) int32 row per measurement; rows >= R_pad are dropped from
        the row outputs and must carry zero weight.
      i_c, i_p: (N,) int32 first knot of the curr / prev half.
      Jc, Jp: (3*order, N) half-Jacobians.
      dx, dy, e: (N,) map Jacobians and residuals.
      wA: (N,) weights >= 0; 0 disables a measurement.
      num_pix: rows of the map domain; dim_pose: 3K; order: spline order.
      carry: optional (a12, px5, a11b) of an earlier call. The sums are
        added INTO these tensors in place (no second 1.3 GB A12 buffer),
        and the same tensors are returned.

    Returns (a12, px5, a11b) in the layout of the module doc.
    """
    if Jc.device.type == "cpu":
        return a12_accumulate_plain(pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA,
                                    num_pix, dim_pose, order, carry)
    if Jc.device.type != "cuda":
        raise ValueError(f"a12_accumulate: unsupported device {Jc.device}")
    return _launch(pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA, num_pix, dim_pose,
                   order, carry)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"a12_accumulate: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"a12_accumulate: {name} must be contiguous")


def check_inputs(pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA, num_pix: int,
                 dim_pose: int, order: int, carry=None):
    """Raise ValueError unless the inputs meet the CUDA kernel's contract
    (types, shapes, one device, contiguity). Returns (n, R_pad, dp_pad)."""
    if order not in (2, 3, 4):
        raise ValueError(f"a12_accumulate: order {order} not in (2, 3, 4)")
    device = Jc.device
    n = pm_pix.shape[0]
    d = 3 * order
    r_pad, dp_pad = padded_dims(num_pix, dim_pose)
    for name, t in (("pm_pix", pm_pix), ("i_c", i_c), ("i_p", i_p)):
        _check(name, t, torch.int32, (n,), device)
    for name, t in (("Jc", Jc), ("Jp", Jp)):
        _check(name, t, torch.float32, (d, n), device)
    for name, t in (("dx", dx), ("dy", dy), ("e", e), ("wA", wA)):
        _check(name, t, torch.float32, (n,), device)
    if carry is not None:
        for name, t, shape in zip(("a12", "px5", "a11b"), carry,
                                  ((r_pad, 2 * dp_pad), (r_pad, 8),
                                   (dp_pad + 8, dp_pad))):
            _check(f"carry {name}", t, torch.float32, shape, device)
    return n, r_pad, dp_pad


def _launch(pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA, num_pix, dim_pose, order,
            carry):
    global launches
    from . import _build

    n, r_pad, dp_pad = check_inputs(pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA,
                                    num_pix, dim_pose, order, carry)
    device = Jc.device
    if carry is None:
        a12 = torch.empty((r_pad, 2 * dp_pad), dtype=torch.float32, device=device)
        px5 = torch.empty((r_pad, 8), dtype=torch.float32, device=device)
        a11b = torch.empty((dp_pad + 8, dp_pad), dtype=torch.float32, device=device)
    else:
        a12, px5, a11b = carry

    # prepass: measurement ids sorted by row (stable), per-row offsets
    order_ids = torch.sort(pm_pix, stable=True).indices.to(torch.int32)
    counts = torch.bincount(pm_pix.long(), minlength=r_pad)[:r_pad]
    row_off = torch.zeros(r_pad + 1, dtype=torch.int32, device=device)
    row_off[1:] = torch.cumsum(counts, 0)

    nblk = max(1, min(A11_BLOCKS, -(-n // A11_MIN_PER_BLOCK)))
    per_block = -(-n // nblk)
    partial = torch.empty((nblk, dim_pose + 1, dim_pose), dtype=torch.float32,
                          device=device)

    lib = _build.load("a12_accum")
    fn = lib.emba_a12_accumulate
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp] * 10 + [cll, ci, ci, ci, ci, ci, ci, cll] + [vp] * 5
    fn.restype = ci
    lib.emba_cuda_error_string.argtypes = [ci]
    lib.emba_cuda_error_string.restype = ctypes.c_char_p
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(
            order_ids.data_ptr(), row_off.data_ptr(), i_c.data_ptr(),
            i_p.data_ptr(), Jc.data_ptr(), Jp.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), e.data_ptr(), wA.data_ptr(), n, order, dim_pose,
            dp_pad, r_pad, int(carry is not None), nblk, per_block,
            a12.data_ptr(), px5.data_ptr(), a11b.data_ptr(), partial.data_ptr(),
            stream,
        )
    if err != 0:
        msg = lib.emba_cuda_error_string(err).decode()
        raise RuntimeError(f"a12_accumulate: CUDA launch failed: {msg} ({err})")
    launches += 1
    return a12, px5, a11b


def a12_accumulate_plain(pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA, num_pix: int,
                         dim_pose: int, order: int, carry=None):
    """Plain torch version with the contract of :func:`a12_accumulate`, in
    the dtype of ``Jc``: one-hot row expansion and a product for A11/b1,
    ``index_add_`` for A22, b2 and A12, CHUNK measurements at a time."""
    dt, device = Jc.dtype, Jc.device
    d = 3 * order
    r_pad, dp_pad = padded_dims(num_pix, dim_pose)
    a12, px5, a11b = carry if carry is not None else _zeros_out(r_pad, dp_pad, dt, device)
    a12_flat = a12.view(-1)
    col = torch.arange(dim_pose, device=device)
    for lo in range(0, pm_pix.shape[0], CHUNK):
        sl = slice(lo, lo + CHUNK)
        w, ick, ipk = wA[sl], i_c[sl].long(), i_p[sl].long()
        Jck, Jpk, dxk, dyk = Jc[:, sl], Jp[:, sl], dx[sl], dy[sl]
        pix = pm_pix[sl].long()
        valid = pix < r_pad
        pix = torch.where(valid, pix, 0)
        w = torch.where(valid, w, 0.0)
        we = w * e[sl]

        rows = torch.zeros((w.shape[0], dim_pose), dtype=dt, device=device)
        for j in range(d):
            rows += (col[None, :] == (3 * ick + j)[:, None]).to(dt) * Jck[j][:, None]
            rows += (col[None, :] == (3 * ipk + j)[:, None]).to(dt) * Jpk[j][:, None]
        a11b[:dim_pose, :dim_pose] += rows.T @ (rows * w[:, None])
        a11b[dp_pad, :dim_pose] += rows.T @ we

        px5[:, 0].index_add_(0, pix, w * dxk * dxk)
        px5[:, 1].index_add_(0, pix, w * dxk * dyk)
        px5[:, 2].index_add_(0, pix, w * dyk * dyk)
        px5[:, 3].index_add_(0, pix, we * dxk)
        px5[:, 4].index_add_(0, pix, we * dyk)

        rowbase = pix * (2 * dp_pad)
        for seg, Jh in ((ick, Jck), (ipk, Jpk)):
            colbase = rowbase + 3 * seg
            for j in range(d):
                wJ = w * Jh[j]
                a12_flat.index_add_(0, colbase + j, wJ * dxk)
                a12_flat.index_add_(0, colbase + dp_pad + j, wJ * dyk)
    return a12, px5, a11b
