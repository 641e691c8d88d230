"""Gather-and-sum of indexed payload columns: the port's counterpart of the
probe kernel ``scripts/r5_dma_gather_probe.py::dma_gather_sum``.

For each chunk of MC column ids, gather those columns of an (R, N) f32
payload, and sum all of them into (R, 1). It is the access pattern of the
A12 kernel's reads through the sorted permutation, alone: the probe in
``probes/gather_probe.py`` measures its floor on the card.

On a CUDA tensor :func:`gather_sum` launches the hand-written kernel in
``csrc/gather_sum.cu`` in one of the reference's two disciplines
(``serial``: one column fetch in flight per block; batched: all of a
chunk's fetches in flight, then one wait); on a CPU tensor it runs
:func:`gather_sum_plain`, where the discipline does not change the result.
There is no fallback: a CUDA input the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

MC = 256  # columns per chunk, as in the reference
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper

# Launches of the CUDA kernel in this process; a caller may reset it.
launches = 0


def check_inputs(payload, idx, check_ids: bool = True):
    """Raise unless (payload, idx) meet the contract: payload (R, N) f32
    contiguous, idx (n_chunks, MC) int32 contiguous on the same device, a
    chunk's (R, MC) staging buffer within one block's shared memory and,
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
    if (rows * mc + mc) * 4 > SMEM_LIMIT:
        raise ValueError(f"gather_sum: R={rows} x MC={mc} does not fit one block's "
                         f"shared memory ({SMEM_LIMIT} bytes)")
    if check_ids and idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= n:
            raise IndexError(f"gather_sum: column ids in [{lo}, {hi}], payload has {n}")
    return rows, n, n_chunks, mc


def gather_sum(payload, idx, serial: bool, check_ids: bool = True):
    """(R, 1) sums of the payload columns named by ``idx``. A caller that
    has checked its ids once (``check_inputs``) may pass ``check_ids=False``
    to keep the host read of their range out of a timed call; an id out of
    range then faults on the card."""
    rows, n, n_chunks, mc = check_inputs(payload, idx, check_ids)
    if payload.device.type == "cpu":
        return gather_sum_plain(payload, idx, serial)
    if payload.device.type != "cuda":
        raise ValueError(f"gather_sum: unsupported device {payload.device}")
    return _launch(payload, idx, serial, rows, n, n_chunks, mc)


def _launch(payload, idx, serial, rows, n, n_chunks, mc):
    global launches
    from . import _build

    device = payload.device
    partial = torch.empty((rows, n_chunks), dtype=torch.float32, device=device)
    out = torch.empty((rows, 1), dtype=torch.float32, device=device)
    lib = _build.load("gather_sum")
    fn = lib.emba_gather_sum
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, cll, ci, cll, ci, ci, vp, vp, vp]
    fn.restype = ci
    lib.emba_gather_error_string.argtypes = [ci]
    lib.emba_gather_error_string.restype = ctypes.c_char_p
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(payload.data_ptr(), idx.data_ptr(), n, rows, n_chunks, mc,
                 int(bool(serial)), partial.data_ptr(), out.data_ptr(), stream)
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
