"""The gather floor on the card: the port's counterpart of
``scripts/r5_dma_gather_probe.py``.

    python -m emba_tpu_torch.probes.gather_probe [--out PATH]

The A12 kernel reads each measurement's fields through the row-sorted
permutation: 16 f32 rows gathered column by column at order 2. This probe
times that access pattern alone. For R in (8, 16) rows of an (R, 2,000,000)
f32 payload and a random permutation of its columns (both from
``np.random.default_rng(5)``, in the reference's order), with CUDA events,
median of 5 after a warm-up:

* ``index_select_rows{R}``: torch's gather of all N columns and their sum,
  the counterpart of the reference's ``jnp.take`` point;
* ``kernel_batched_rows{R}``, ``kernel_serial_rows{R}``: the ``gather_sum``
  kernel over N // 256 chunks of 256 columns in each discipline, the
  batched one with the rule's rows per pass;
* ``kernel_batched_rows16_p{P}``: the batched kernel at R = 16 with P rows
  per pass, for P in (1, 2, 3, 4, 16): the sweep that sets the rule.

Each of those entries holds ``s`` (seconds a call), ``cols_per_s`` and
``per_col_ns``, and ``graph_s``: seconds a call replayed from a CUDA graph,
the device's time without the host's dispatch of the call, which the eager
``s`` includes; ``rows_per_pass_rows{R}`` is the P the rule chose,
``l2_bytes`` the card's L2 it read, and ``device`` names the card and its
power limit. Calls follow each other with no flush between them, so the
last pass's rows may still be in L2 when the next call starts; that holds
for ``index_select`` as well. It prints one JSON line and writes it to
PATH only when ``--out`` is given. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..device import card_name_and_power_limit, cuda_time_ms, graph_time_ms, require_cuda
from ..kernels.gather_sum import MC, check_inputs, device_pass_size, gather_sum

N = 2_000_000
ROWS = (8, 16)
SWEEP = (1, 2, 3, 4, 16)  # rows per pass at R = 16


def _entry(fn, cols: int, reps: int) -> dict:
    seconds = cuda_time_ms(fn, reps) / 1e3
    return {"s": seconds, "cols_per_s": cols / seconds,
            "per_col_ns": seconds / cols * 1e9, "graph_s": graph_time_ms(fn, reps) / 1e3}


def run(device) -> dict:
    """The probe's measurements on ``device``, keyed as the module doc says."""
    rng = np.random.default_rng(5)
    n, reps = N, 5
    res = {"l2_bytes": torch.cuda.get_device_properties(device).L2_cache_size}
    for r in ROWS:
        payload = torch.as_tensor(rng.standard_normal((r, n)),
                                  dtype=torch.float32).to(device)
        perm = rng.permutation(n).astype(np.int32)
        n_chunks = n // MC
        idx = torch.as_tensor(perm[:n_chunks * MC].reshape(n_chunks, MC)).to(device)
        src = torch.as_tensor(perm).to(device=device, dtype=torch.long)
        res[f"index_select_rows{r}"] = _entry(lambda: payload.index_select(1, src).sum(),
                                              n, reps)
        check_inputs(payload, idx)  # once; the timed calls skip the host read
        for serial in (False, True):
            tag = "serial" if serial else "batched"
            res[f"kernel_{tag}_rows{r}"] = _entry(
                lambda: gather_sum(payload, idx, serial, check_ids=False),
                n_chunks * MC, reps)
        res[f"rows_per_pass_rows{r}"] = device_pass_size(payload)
        for p in SWEEP if r == 16 else ():
            res[f"kernel_batched_rows{r}_p{p}"] = _entry(
                lambda: gather_sum(payload, idx, False, check_ids=False, rows_per_pass=p),
                n_chunks * MC, reps)
        del payload, idx, src
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    device = require_cuda()
    res = {"device": card_name_and_power_limit(), **run(device)}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
