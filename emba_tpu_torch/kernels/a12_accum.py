"""Accumulation of the LEGM normal equations: the pose-map coupling block
A12, the per-pixel A22 / b2 sums and the pose block A11 / b1.

Counterpart of ``emba_tpu/kernels/a12_accum.py`` with the same contract.
On a CUDA tensor :func:`a12_accumulate` launches the hand-written kernel in
``csrc/a12_accum.cu`` (its note says what bounds it and how it is built);
on a CPU tensor it runs :func:`a12_accumulate_plain`, the plain torch
version (counterpart of ``emba_tpu.model._xla_accumulate``). There is no
fallback: a CUDA input the kernel cannot take raises.

Around the CUDA kernels the wrapper builds the index maps in torch, with no
size read on the host, so that a CUDA graph can capture the call: the stable
sorts of the row and knot-pair keys with their run offsets
(:func:`sorted_runs`), the inverse permutations that give each measurement
its record slots (:func:`inverse_permutation`), and the chunk maps of heavy
rows and knot-pair runs (:func:`chunk_map`, sized by :func:`chunk_bounds`).

Layout: A12 is (R_pad, 2*dp_pad), columns [0:dp_pad) the Gx plane and
[dp_pad:2*dp_pad) the Gy plane; px5 is (R_pad, 8) with columns 0..4 =
a22_xx, a22_xy, a22_yy, b2_x, b2_y; a11b is (dp_pad + 8, dp_pad) with rows
[0:dp_pad) = A11 and row dp_pad = b1. Padding is zero.
"""

from __future__ import annotations

import ctypes
import functools

import torch

ROW_ALIGN = 128  # R_pad = round_up(num_pix, ROW_ALIGN)
DP_ALIGN = 32  # dp_pad = round_up(dim_pose, DP_ALIGN): 128-byte row segments
CHUNK = 1 << 16  # measurements per step of the plain version
HEAVY_ROW = 512  # a row with more measurements is cut into chunks this long
PAIR_CHUNK = 512  # measurements of a knot-pair run one warp reduces for A11

# Launches of the CUDA kernel in this process; a caller may reset it. A
# CUDA graph that holds the launch adds one per replay (``lm.CapturedPhase``).
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


def sorted_runs(keys, num_keys: int):
    """Ids of ``keys`` sorted stably (int64) and the (num_keys + 1,) int32
    offsets of each key's run in that order; keys >= num_keys fall past
    ``off[num_keys]``. The offsets come from a binary search over the sorted
    keys, not from ``bincount``, which reads its length on the host: no host
    synchronization, so it can be captured in a CUDA graph, and integer, so
    deterministic."""
    sorted_keys, ids = torch.sort(keys, stable=True)
    bounds = torch.arange(num_keys + 1, dtype=keys.dtype, device=keys.device)
    return ids, torch.searchsorted(sorted_keys, bounds, out_int32=True)


def inverse_permutation(ids):
    """pos (int32) with pos[ids[s]] = s: one ``scatter_`` of ``arange``."""
    n = ids.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=ids.device)
    return pos.scatter_(0, ids, torch.arange(n, dtype=torch.int32, device=ids.device))


def chunk_map(off, chunk: int, max_chunks: int, heavy_only: bool = False):
    """Cut each run of ``off`` ((num_keys + 1,) run offsets) into chunks of
    ``chunk``; with ``heavy_only`` only runs longer than ``chunk`` are cut
    and the others get none. Returns ``start`` ((num_keys + 1,) int32, the
    first chunk of each key; key q owns chunks [start[q], start[q + 1])) and
    ``key`` ((max_chunks,) int32, the key of each chunk; num_keys for the
    chunks past the last). ``max_chunks`` is a bound from the sizes alone
    (:func:`chunk_bounds`), so no size is read on the host."""
    counts = off[1:] - off[:-1]
    per = torch.div(counts + (chunk - 1), chunk, rounding_mode="floor")
    if heavy_only:
        per = per * (counts > chunk)
    start = torch.zeros(off.shape[0], dtype=torch.int32, device=off.device)
    torch.cumsum(per, 0, dtype=torch.int32, out=start[1:])
    ids = torch.arange(max_chunks, dtype=torch.int32, device=off.device)
    key = torch.searchsorted(start, ids, right=True, out_int32=True) - 1
    return start, key


def chunk_bounds(n: int, num_keys: int, heavy: int = HEAVY_ROW,
                 chunk: int = PAIR_CHUNK) -> tuple[int, int]:
    """(most heavy-row chunks, most knot-pair chunks) of n measurements: a
    row of c > heavy measurements gives ceil(c / heavy) < 2 c / heavy
    chunks; the pair runs give at most n / chunk plus one a non-empty key."""
    return 2 * n // heavy + 1, n // chunk + min(n, num_keys) + 1


_LIB = None


def _lib():
    """The kernel library, built at first use, with its C signatures set."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("a12_accum")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.emba_a12_keys.argtypes = [vp] * 4 + [cll, ci, ci, ci, ci] + [vp] * 3
        lib.emba_a12_keys.restype = ci
        lib.emba_a12_form.argtypes = [vp] * 16 + [cll] + [ci] * 10 + [vp] * 8
        lib.emba_a12_form.restype = ci
        lib.emba_a12_sizes.argtypes = [ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
        lib.emba_a12_sizes.restype = ci
        lib.emba_cuda_error_string.argtypes = [ci]
        lib.emba_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@functools.cache
def scratch_sizes(order: int) -> tuple[int, int]:
    """(record words, padded A11 cells a chunk partial) of the kernels'
    scratch at a spline order, as the library lays them out (the layout has
    no second copy here); builds the library at first use."""
    lib = _lib()
    rw, ncp = ctypes.c_int(), ctypes.c_int()
    err = lib.emba_a12_sizes(order, ctypes.byref(rw), ctypes.byref(ncp))
    if err != 0:
        raise ValueError(f"a12_accumulate: order {order} not in (2, 3, 4)")
    return rw.value, ncp.value


def _launch(pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA, num_pix, dim_pose, order,
            carry):
    global launches

    n, r_pad, dp_pad = check_inputs(pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA,
                                    num_pix, dim_pose, order, carry)
    knots = -(-dim_pose // 3)
    num_keys = knots * knots
    if num_keys >= 2**31 - 1 or n >= 2**31 - 1:
        raise ValueError(f"a12_accumulate: {n} measurements of {knots} knots "
                         "overflow the kernel's int32 keys")
    device = Jc.device
    # the library launches on the calling thread's current device
    if device.index != torch.cuda.current_device():
        raise ValueError(f"a12_accumulate: tensors on {device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()} (torch.cuda.set_device)")
    f32, i32 = torch.float32, torch.int32
    if carry is None:
        a12 = torch.empty((r_pad, 2 * dp_pad), dtype=f32, device=device)
        px5 = torch.empty((r_pad, 8), dtype=f32, device=device)
        a11b = torch.empty((dp_pad + 8, dp_pad), dtype=f32, device=device)
    else:
        a12, px5, a11b = carry

    lib = _lib()

    def check(err):
        if err != 0:
            msg = lib.emba_cuda_error_string(err).decode()
            raise RuntimeError(f"a12_accumulate: CUDA launch failed: {msg} ({err})")

    rw, ncp = scratch_sizes(order)
    max_heavy, max_chunks = chunk_bounds(n, num_keys)
    stream = torch.cuda.current_stream(device).cuda_stream
    row_key = torch.empty(n, dtype=i32, device=device)
    pair_key = torch.empty(n, dtype=i32, device=device)
    check(lib.emba_a12_keys(pm_pix.data_ptr(), i_c.data_ptr(), i_p.data_ptr(),
                            wA.data_ptr(), n, order, dim_pose, r_pad, knots,
                            row_key.data_ptr(), pair_key.data_ptr(), stream))
    row_ids, row_off = sorted_runs(row_key, r_pad)
    pair_ids, key_off = sorted_runs(pair_key, num_keys)
    # records lie in pair order; the rows reach theirs through slot
    pos = inverse_permutation(pair_ids)
    slot = torch.gather(pos, 0, row_ids)
    del row_ids, pair_ids, row_key, pair_key
    hc_start, hc_row = chunk_map(row_off, HEAVY_ROW, max_heavy, heavy_only=True)
    ck_start, ck_key = chunk_map(key_off, PAIR_CHUNK, max_chunks)
    rec = torch.empty((n, rw), dtype=f32, device=device)
    heavy_part = torch.empty((max_heavy, 2 * dp_pad + 8), dtype=f32, device=device)
    a11_part = torch.empty((max_chunks, ncp), dtype=f32, device=device)
    marg = torch.empty((2, knots, ncp), dtype=f32, device=device)
    check(lib.emba_a12_form(
        pos.data_ptr(), slot.data_ptr(), row_off.data_ptr(),
        hc_start.data_ptr(), hc_row.data_ptr(), key_off.data_ptr(),
        ck_start.data_ptr(), ck_key.data_ptr(), i_c.data_ptr(), i_p.data_ptr(),
        Jc.data_ptr(), Jp.data_ptr(), dx.data_ptr(), dy.data_ptr(), e.data_ptr(),
        wA.data_ptr(), n, order, dim_pose, dp_pad, r_pad, knots,
        int(carry is not None), max_heavy, HEAVY_ROW, max_chunks, PAIR_CHUNK,
        rec.data_ptr(), heavy_part.data_ptr(),
        a11_part.data_ptr(), marg.data_ptr(), a12.data_ptr(), px5.data_ptr(),
        a11b.data_ptr(), stream))
    launches += 1
    return a12, px5, a11b


def a12_accumulate_plain(pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA, num_pix: int,
                         dim_pose: int, order: int, carry=None):
    """Plain torch version with the contract of :func:`a12_accumulate`, in
    the dtype of ``Jc``: one-hot row expansion and a product for A11/b1,
    indexed adds in a fixed order (``device.add_at``) for A22, b2 and A12,
    CHUNK measurements at a time; a run repeats bit for bit on either
    device. f32 inputs are summed in f64 and each output rounded once into
    f32 (added into ``carry`` with one rounding): the version the kernel is
    held to is exact to f32 rounding, not a second f32 order of summation,
    whose rounding an LM window carries into its cost as far as the
    kernel's own."""
    from ..device import add_at

    if Jc.dtype == torch.float32:
        wide = [t.double() if t.is_floating_point() else t
                for t in (pm_pix, i_c, i_p, Jc, Jp, dx, dy, e, wA)]
        sums = a12_accumulate_plain(*wide, num_pix, dim_pose, order)
        if carry is None:
            return tuple(t.float() for t in sums)
        for c, t in zip(carry, sums):
            c.copy_(t.add_(c))
        return carry
    dt, device = Jc.dtype, Jc.device
    d = 3 * order
    r_pad, dp_pad = padded_dims(num_pix, dim_pose)
    a12, px5, a11b = carry if carry is not None else _zeros_out(r_pad, dp_pad, dt, device)
    a12_flat, px5_flat = a12.view(-1), px5.view(-1)
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

        for k, v in enumerate((w * dxk * dxk, w * dxk * dyk, w * dyk * dyk, we * dxk,
                               we * dyk)):
            add_at(px5_flat, pix * 8 + k, v)

        rowbase = pix * (2 * dp_pad)
        for seg, Jh in ((ick, Jck), (ipk, Jpk)):
            colbase = rowbase + 3 * seg
            for j in range(d):
                wJ = w * Jh[j]
                add_at(a12_flat, colbase + j, wJ * dxk)
                add_at(a12_flat, colbase + dp_pad + j, wJ * dyk)
    return a12, px5, a11b
