"""The Schur complement of the normal equations over the map rows that take
part in it, and the back substitution of the map step over the same rows.

Only the rows whose damped 2x2 inverse M_r is nonzero add to S, to the
reduced right-hand side and to x2 (``model.solve_normal_eq``). The solve
lists them on the device (:func:`row_list`: the ascending list in a buffer
of the row space's length, and the list's length as a 0-d tensor), and
both functions here read the list and its length from device memory. So a
CUDA graph captured once does, in every replay, the work of that replay's
count: no size is read on the host, no row is capped or dropped.

On a CUDA float32 tensor :func:`schur_reduce` and :func:`back_substitute`
launch the hand-written kernels of ``csrc/schur_rows.cu`` (its note says
what bounds them and what the design does about it); on a CPU tensor and
on a float64 one they run :func:`schur_reduce_plain` and
:func:`back_substitute_plain`, the plain torch versions with the same
contract. There is no fallback: a CUDA float32 input the kernels cannot
take raises.

Contract: A12 is (R, 2*dp) (the Gx plane in columns [0:dp), the Gy plane in
[dp:2*dp)); ``rows`` is :func:`row_list`'s (R,) int32 permutation whose
first ``count`` entries are the listed rows; m00, m01, m11, b2x, b2y are
(R,) vectors; columns outside [col_lo, col_hi) of both planes count as
zero.
"""

from __future__ import annotations

import ctypes

import torch

TILE = 64  # the kernel's tile side: S is formed in 64 x 64 tiles

# Launches of the CUDA kernels in this process (one a call of either
# function); a caller may reset it. A CUDA graph that holds the launch adds
# one per replay (``lm.CapturedPhase``).
launches = 0


def row_list(mask):
    """(rows, count) of a (R,) bool mask: ``rows`` (R,) int32 holds the
    rows where ``mask`` holds in ascending order, then the others in
    ascending order (a permutation of [0, R)); ``count`` is a 0-d int32
    tensor, the number of the first. A prefix sum and a scatter at fixed
    shapes: nothing is read on the host."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int32)  # listed rows up to r, r included
    count = pos[-1]
    r = torch.arange(n, dtype=torch.int32, device=mask.device)
    dest = torch.where(mask, pos - 1, count + r - pos)
    rows = torch.empty(n, dtype=torch.int32, device=mask.device)
    return rows.scatter_(0, dest.long(), r), count


def _check(name, a12, rows, count, vecs, x=None):
    """Raise unless the inputs meet the contract. Returns (R, dp)."""
    if a12.dim() != 2 or a12.shape[1] % 2:
        raise ValueError(f"{name}: A12 must be (R, 2*dp), got {tuple(a12.shape)}")
    r_pad, dp = a12.shape[0], a12.shape[1] // 2
    if rows.dtype != torch.int32 or tuple(rows.shape) != (r_pad,):
        raise ValueError(f"{name}: rows must be ({r_pad},) int32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if count.dtype != torch.int32 or count.dim() != 0:
        raise ValueError(f"{name}: count must be a 0-d int32 tensor, got {count.dtype} "
                         f"{tuple(count.shape)}")
    for v in vecs:
        if tuple(v.shape) != (r_pad,) or v.dtype != a12.dtype:
            raise ValueError(f"{name}: the row vectors must be ({r_pad},) {a12.dtype}, "
                             f"got {v.dtype} {tuple(v.shape)}")
    if x is not None and (tuple(x.shape) != (dp,) or x.dtype != a12.dtype):
        raise ValueError(f"{name}: x must be ({dp},) {a12.dtype}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    ts = [a12, rows, count, *vecs] + ([x] if x is not None else [])
    if any(t.device != a12.device for t in ts):
        raise ValueError(f"{name}: all inputs must be on {a12.device}")
    if a12.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: A12 must be float32 or float64, got {a12.dtype}")
    if _kernel(a12):
        if dp % 4:
            raise ValueError(f"{name}: dp must be a multiple of 4, got {dp}")
        if not all(t.is_contiguous() for t in ts) or a12.data_ptr() % 16 or (
                x is not None and x.data_ptr() % 16):
            raise ValueError(f"{name}: inputs must be contiguous, A12 and x 16-byte "
                             "aligned")
        if a12.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: tensors on {a12.device}, but the current device "
                             f"is cuda:{torch.cuda.current_device()}")
    elif a12.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {a12.device}")
    return r_pad, dp


def _kernel(a12):
    """Whether the CUDA kernels take this call (else the plain version)."""
    return a12.device.type == "cuda" and a12.dtype == torch.float32


def schur_reduce(a12, rows, count, m00, m01, m11, b2x, b2y, col_lo: int, col_hi: int):
    """(S_red (dp, dp), rhs_red (dp,)) over the listed rows: S_red = sum_r
    a (m00 a + m01 o)^T + o (m01 a + m11 o)^T and rhs_red = sum_r (m00 b2x
    + m01 b2y) a + (m01 b2x + m11 b2y) o, with a and o row r of the two
    planes, masked to the columns [col_lo, col_hi). S_red is exactly
    symmetric on CUDA."""
    r_pad, dp = _check("schur_reduce", a12, rows, count, (m00, m01, m11, b2x, b2y))
    if not 0 <= col_lo <= col_hi <= dp:
        raise ValueError(f"schur_reduce: columns [{col_lo}, {col_hi}) not inside [0, {dp})")
    if not _kernel(a12):
        return schur_reduce_plain(a12, rows, count, m00, m01, m11, b2x, b2y, col_lo,
                                  col_hi)
    global launches
    device = a12.device
    lib = _library()
    splits = _splits(device.index, dp)
    nt = -(-dp // TILE)
    ntri = nt * (nt + 1) // 2
    f32 = torch.float32
    part = torch.empty((splits, ntri, TILE, TILE), dtype=f32, device=device)
    rpart = torch.empty((splits, nt * TILE), dtype=f32, device=device)
    S = torch.empty((dp, dp), dtype=f32, device=device)
    rhs = torch.empty(dp, dtype=f32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise(lib, lib.emba_schur_reduce(
        device.index, a12.data_ptr(), rows.data_ptr(), count.data_ptr(), m00.data_ptr(),
        m01.data_ptr(), m11.data_ptr(), b2x.data_ptr(), b2y.data_ptr(), dp, col_lo, col_hi,
        splits, part.data_ptr(), rpart.data_ptr(), S.data_ptr(), rhs.data_ptr(), stream),
        "schur_reduce")
    launches += 1
    return S, rhs


def back_substitute(a12, rows, count, m00, m01, m11, b2x, b2y, x):
    """x2 (2, R): on each listed row r, M_r (b2[r] - [a . x, o . x]) with
    a and o row r of the two planes; exact zero on every other row. ``x``
    (dp,) is the pose step, zero outside the columns the solve keeps."""
    r_pad, dp = _check("back_substitute", a12, rows, count, (m00, m01, m11, b2x, b2y), x)
    if not _kernel(a12):
        return back_substitute_plain(a12, rows, count, m00, m01, m11, b2x, b2y, x)
    global launches
    device = a12.device
    lib = _library()
    x2 = torch.zeros((2, r_pad), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise(lib, lib.emba_schur_back(
        device.index, a12.data_ptr(), rows.data_ptr(), count.data_ptr(), m00.data_ptr(),
        m01.data_ptr(), m11.data_ptr(), b2x.data_ptr(), b2y.data_ptr(), x.data_ptr(), dp,
        r_pad, x2.data_ptr(), stream), "back_substitute")
    launches += 1
    return x2


def _listed(a12, rows, count, vecs):
    """The plain versions' view of the listed rows at fixed shapes: every
    row in list order (rows past ``count`` weigh nothing), the (R,) bool of
    those inside the count, and each vector in list order."""
    r = rows.long()
    live = torch.arange(r.shape[0], device=a12.device) < count
    return a12.index_select(0, r), live, [v.index_select(0, r) for v in vecs]


def schur_reduce_plain(a12, rows, count, m00, m01, m11, b2x, b2y, col_lo: int,
                       col_hi: int):
    """Plain torch version of :func:`schur_reduce`, at fixed shapes (a CUDA
    graph can hold it): the rows past ``count`` take zero weight."""
    dp = a12.shape[1] // 2
    dt = a12.dtype
    g, live, (p00, p01, p11, bx, by) = _listed(a12, rows, count, (m00, m01, m11, b2x, b2y))
    cols = torch.arange(dp, device=a12.device)
    colmask = ((cols >= col_lo) & (cols < col_hi)).to(dt)
    w = live.to(dt)
    p00, p01, p11 = p00 * w, p01 * w, p11 * w
    a = g[:, :dp] * colmask
    o = g[:, dp:] * colmask
    ze = a * p00[:, None] + o * p01[:, None]
    zo = a * p01[:, None] + o * p11[:, None]
    S = a.T @ ze + o.T @ zo
    rhs = (p00 * bx + p01 * by) @ a + (p01 * bx + p11 * by) @ o
    return S, rhs


def back_substitute_plain(a12, rows, count, m00, m01, m11, b2x, b2y, x):
    """Plain torch version of :func:`back_substitute`, at fixed shapes."""
    dp = a12.shape[1] // 2
    g, live, (p00, p01, p11, bx, by) = _listed(a12, rows, count, (m00, m01, m11, b2x, b2y))
    vx = bx - g[:, :dp] @ x
    vy = by - g[:, dp:] @ x
    zero = torch.zeros((), dtype=a12.dtype, device=a12.device)
    x2 = torch.stack([torch.where(live, p00 * vx + p01 * vy, zero),
                      torch.where(live, p01 * vx + p11 * vy, zero)])
    return torch.zeros_like(x2).index_copy_(1, rows.long(), x2)


_LIB = None


def _library():
    """The kernel library, built at first use, with its C signatures set."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("schur_rows")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.emba_schur_splits.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.emba_schur_splits.restype = ci
        lib.emba_schur_reduce.argtypes = [ci] + [vp] * 8 + [ci] * 4 + [vp] * 5
        lib.emba_schur_reduce.restype = ci
        lib.emba_schur_back.argtypes = [ci] + [vp] * 9 + [ci, cll, vp, vp]
        lib.emba_schur_back.restype = ci
        lib.emba_schur_error_string.argtypes = [ci]
        lib.emba_schur_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise(lib, err, name):
    if err != 0:
        msg = lib.emba_schur_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")


def _splits(device_index: int, dp: int) -> int:
    """The row list's splits for ``dp`` columns on a device: as many as
    fill the card with tile blocks once (the library asks the card)."""
    lib = _library()
    out = ctypes.c_int()
    _raise(lib, lib.emba_schur_splits(device_index, dp, ctypes.byref(out)), "schur_reduce")
    return out.value
