"""Where the time of one A12 accumulation call goes on the card.

    python -m emba_tpu_torch.probes.a12_parts [--out PATH]

Synthetic measurement sets (:func:`synthetic_inputs`, seed 1234) on the
main shapes (1024x512 panorama, 97 knots, order 2) at N = 2,000,000, N = 1
and N = 100,000, then the bench window's first forming pass
(:func:`forming_inputs` of ``profile_fused.main_window``). Every case is
timed before any is profiled. For each case:

* ``device_ms``: the sum of the device activities ``torch.profiler``
  records in one call (after an unprofiled one);
* ``eager_ms``: the call timed with CUDA events (median of 5), host
  dispatch of the wrapper's torch index maps included;
* ``host_ms``: the host's time in the eager call, from an idle device to
  its return (median of 5): the dispatch of its torch ops and launches;
* ``graph_ms``: the call captured in a CUDA graph and replayed, as the
  fused window runs it;
* ``parts``: the device activities by total time (name, count, ms).

It prints one JSON line, with ``device`` naming the card and its power
limit, and writes it to PATH only when ``--out`` is given. It needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import model as M
from ..device import (card_name_and_power_limit, cuda_time_ms, full_precision,
                      graph_time_ms, host_time_ms, require_cuda)
from ..kernels import a12_accum
from .profile_fused import _profiled, _top, main_window

HW, KNOTS, ORDER = 1024 * 512, 97, 2
SIZES = (2_000_000, 1, 100_000)


def synthetic_inputs(rng, n, hw, knots, order, device, pix=None, zero_w=False):
    """The nine inputs of ``a12_accumulate`` for n measurements: uniform rows
    (or ``pix``), curr segments uniform, prev segments at or a little before
    them (80%) or anywhere before (20%), 30% zero weights (all with
    ``zero_w``), normal Jacobians and residuals."""
    d = 3 * order
    i_c = rng.integers(0, knots - order + 1, n)
    i_p = np.clip(i_c - rng.integers(0, 3, n) * (rng.random(n) < 0.8)
                  - rng.integers(0, knots, n) * (rng.random(n) >= 0.8), 0, None)
    w = rng.uniform(0.0, 1.0, n)
    w[rng.random(n) < 0.3] = 0.0
    if zero_w:
        w[:] = 0.0
    host = [
        rng.integers(0, hw, n) if pix is None else pix,
        i_c, i_p,
        rng.normal(size=(d, n)), rng.normal(size=(d, n)),
        rng.normal(size=n), rng.normal(size=n), rng.normal(size=n), w,
    ]
    types = [torch.int32] * 3 + [torch.float32] * 6
    return [torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=t)
            for a, t in zip(host, types)]


def pass_inputs(mode, aux, knots, Gx, Gy, cfg):
    """The inputs of each ``a12_accumulate`` call of a forming pass of the
    window's ``mode`` (``model.window_mode``, or a placement's) from its
    forming input ``aux`` at (knots, Gx, Gy): one list of nine a slice, the
    rows and weights the pass gives the kernel, which chains the calls
    through ``carry``. Returns (calls, R_pad)."""
    bounds, pieces = mode.chunks(aux, knots, Gx, Gy)
    active, r_pad, pix2row, _ = M._row_space(aux.num_ev_map, cfg)
    calls = []
    for lo, hi in bounds:
        e, inl, pmp, ic, ip, dx, dy, Jc, Jp = pieces(lo, hi)
        rows, wA, _ = M._rows_and_weights(e, inl, pmp, active, pix2row, r_pad, cfg, e.dtype)
        calls.append([rows, ic, ip, Jc, Jp, dx, dy, e, wA])
    return calls, r_pad


def first_pass_inputs(w):
    """The inputs of each ``a12_accumulate`` call of the first forming pass
    of a window of :func:`main_window` (or any window given as ``dev``,
    ``cfg`` and ``start``) at its start state, through its mode: one call
    for a classic window, one a chunk for a streamed one (FULL or LIGHT
    tier). Returns (calls, num_pix, knots, order); ``num_pix`` is the row
    space's R_pad (compacted under ``cfg.compact_cap``)."""
    knots, Gx, Gy = w["start"]
    cfg = w["cfg"]
    mode = M.window_mode(w["dev"], cfg)
    calls, r_pad = pass_inputs(mode, mode.objective(knots, Gx, Gy)[0], knots, Gx, Gy, cfg)
    return calls, r_pad, knots.shape[0], cfg.spline_order


def forming_inputs(w):
    """(inputs, num_pix, knots, order) of the one ``a12_accumulate`` call of
    a classic window's first forming pass (:func:`first_pass_inputs`)."""
    calls, r_pad, k, order = first_pass_inputs(w)
    return calls[0], r_pad, k, order


def run(device) -> list[dict]:
    """Every case timed first, then every case profiled: no clock runs
    after the profiler has been started in the process."""
    rng = np.random.default_rng(1234)
    cases = [(f"synthetic N={n}", synthetic_inputs(rng, n, HW, KNOTS, ORDER, device),
              HW, KNOTS, ORDER) for n in SIZES]
    cases.append(("window", *forming_inputs(main_window(device))))
    calls = [(name, lambda a=args, p=num_pix, k=knots, o=order:
              a12_accum.a12_accumulate(*a, p, 3 * k, o))
             for name, args, num_pix, knots, order in cases]
    res = []
    for name, call in calls:
        res.append({"case": name, "eager_ms": cuda_time_ms(call),
                    "host_ms": host_time_ms(call), "graph_ms": graph_time_ms(call)})
        torch.cuda.empty_cache()
    for r, (_, call) in zip(res, calls):
        call()
        _, r["device_ms"], acts = _profiled(call)
        r["parts"] = _top(acts, k=None)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    device = require_cuda()
    full_precision()
    line = json.dumps({"device": card_name_and_power_limit(), "cases": run(device)})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
