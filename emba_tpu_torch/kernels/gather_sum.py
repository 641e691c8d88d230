"""Gather-and-sum of indexed payload columns: the port's counterpart of the
probe kernel ``scripts/r5_dma_gather_probe.py::dma_gather_sum``.

For each chunk of MC column ids, gather those columns of an (R, N) f32
payload, and sum all of them into (R, 1). It is the access pattern of the
A12 kernel's reads through the sorted permutation, alone: the probe in
``probes/gather_probe.py`` measures its floor on the card.

On a CUDA tensor :func:`gather_sum` launches the hand-written kernel in
``csrc/gather_sum.cu`` in one of the reference's two disciplines
(``serial``: one column fetch in flight per block; batched: a row sweep in
passes of ``rows_per_pass`` rows sized to the card's L2, many loads in
flight per lane); on a CPU tensor it runs :func:`gather_sum_plain`, where
neither the discipline nor the passes change the result. There is no
fallback: a CUDA input the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MC = 256  # columns per chunk, as in the reference
# Share of the card's L2 that one pass's payload rows may fill. A sector's 8
# columns are read by different chunks of the pass; the share leaves room
# for the pass after it (the grid works on two passes at its seam), the ids
# streaming through and the L2's split into two partitions. Set from the
# probe's sweep on an H100 (PERF.md): one row a pass at N = 2M was the
# fastest, and this share gives it.
L2_SHARE = 0.25

# Launches of the CUDA kernel in this process; a caller may reset it.
launches = 0


def pass_size(rows: int, n: int, l2_bytes: int) -> int:
    """P, the rows of one pass of the batched kernel's row sweep: as many
    payload rows of N f32 as fit in ``L2_SHARE`` of an L2 of ``l2_bytes``,
    at least 1 and at most R."""
    fit = int(L2_SHARE * l2_bytes) // (4 * max(n, 1))
    return max(1, min(rows, fit))


def row_passes(rows: int, p: int) -> list[tuple[int, int]]:
    """The passes of the row sweep, as the kernel walks them: rows
    [r0, r1) of each, in order, P rows each but the last."""
    return [(r0, min(rows, r0 + p)) for r0 in range(0, rows, p)]


@functools.lru_cache(maxsize=None)
def _l2_bytes(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).L2_cache_size


def device_pass_size(payload) -> int:
    """The rule's P for ``payload`` (R, N) on its CUDA device, from the
    card's L2 size."""
    rows, n = payload.shape
    return pass_size(rows, n, _l2_bytes(payload.device))


def check_inputs(payload, idx, check_ids: bool = True):
    """Raise unless (payload, idx) meet the contract: payload (R, N) f32
    contiguous, idx (n_chunks, MC) int32 contiguous on the same device and,
    with ``check_ids``, every id in [0, N) (one read of the id range on the
    host). Returns (R, N, n_chunks, MC)."""
    if payload.dtype != torch.float32 or payload.dim() != 2:
        raise ValueError(f"gather_sum: payload must be 2-D float32, got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"gather_sum: idx must be 2-D int32, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.device != payload.device:
        raise ValueError(f"gather_sum: idx and payload must be on one device, got "
                         f"{idx.device} and {payload.device}")
    if not (payload.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_sum: payload and idx must be contiguous")
    rows, n = payload.shape
    n_chunks, mc = idx.shape
    if rows < 1 or mc < 1:
        raise ValueError(f"gather_sum: needs R >= 1 and MC >= 1, got R={rows}, MC={mc}")
    if check_ids and idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= n:
            raise IndexError(f"gather_sum: column ids in [{lo}, {hi}], payload has {n}")
    return rows, n, n_chunks, mc


def gather_sum(payload, idx, serial: bool, check_ids: bool = True,
               rows_per_pass: int | None = None, grid_blocks: int | None = None):
    """(R, 1) sums of the payload columns named by ``idx``. A caller that
    has checked its ids once (``check_inputs``) may pass ``check_ids=False``
    to keep the host read of their range out of a timed call; an id out of
    range then faults on the card.

    ``rows_per_pass`` (batched only) sets P for the probe's sweep and the
    tests, and ``grid_blocks`` the batched grid for the tests; None takes
    the rule (:func:`device_pass_size`) and a grid of the blocks the
    card holds at once. Neither changes the result's bits."""
    rows, n, n_chunks, mc = check_inputs(payload, idx, check_ids)
    for name, v in (("rows_per_pass", rows_per_pass), ("grid_blocks", grid_blocks)):
        if v is not None and not 1 <= v <= 2**31 - 1:
            raise ValueError(f"gather_sum: {name} must be a positive int32, got {v}")
    if payload.device.type == "cpu":
        return gather_sum_plain(payload, idx, serial)
    if payload.device.type != "cuda":
        raise ValueError(f"gather_sum: unsupported device {payload.device}")
    p = device_pass_size(payload) if rows_per_pass is None else min(rows_per_pass, rows)
    return _launch(payload, idx, serial, rows, n, n_chunks, mc, p, grid_blocks or 0)


_lib = None  # the loaded library, its argument types set


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("gather_sum")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.emba_gather_sum.argtypes = [ci, vp, vp, cll, ci, cll, ci, ci, ci, ci, vp, vp,
                                        vp]
        lib.emba_gather_sum.restype = ci
        lib.emba_gather_error_string.argtypes = [ci]
        lib.emba_gather_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(payload, idx, serial, rows, n, n_chunks, mc, p, blocks):
    global launches
    device = payload.device
    partial = torch.empty((rows, n_chunks), dtype=torch.float32, device=device)
    out = torch.empty((rows, 1), dtype=torch.float32, device=device)
    lib = _library()
    # the host's dispatch of this call is part of its eager time: the raw
    # stream handle and the library's own device switch cost a fraction of
    # torch.cuda.current_stream() and a torch.cuda.device guard
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = lib.emba_gather_sum(device.index, payload.data_ptr(), idx.data_ptr(), n, rows,
                              n_chunks, mc, int(bool(serial)), p, blocks,
                              partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        msg = lib.emba_gather_error_string(err).decode()
        raise RuntimeError(f"gather_sum: CUDA launch failed: {msg} ({err})")
    launches += 1
    return out


def gather_sum_plain(payload, idx, serial: bool = False):
    """Plain torch version: ``index_select`` of the named columns, then
    their sum. Both disciplines give this result."""
    del serial
    cols = payload.index_select(1, idx.reshape(-1).long())
    return cols.sum(dim=1, keepdim=True)
