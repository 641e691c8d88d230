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
  kernel over N // 256 chunks of 256 columns in each discipline.

Each entry holds ``s`` (seconds a call), ``cols_per_s`` and ``per_col_ns``;
``device`` names the card and its power limit. It prints one JSON line and
writes it to PATH only when ``--out`` is given. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..device import card_name_and_power_limit, cuda_time_ms, require_cuda
from ..kernels.gather_sum import MC, check_inputs, gather_sum

N = 2_000_000
ROWS = (8, 16)


def _entry(seconds: float, cols: int) -> dict:
    return {"s": seconds, "cols_per_s": cols / seconds,
            "per_col_ns": seconds / cols * 1e9}


def run(device) -> dict:
    """The probe's measurements on ``device``, keyed as the module doc says."""
    rng = np.random.default_rng(5)
    n, reps, res = N, 5, {}
    for r in ROWS:
        payload = torch.as_tensor(rng.standard_normal((r, n)),
                                  dtype=torch.float32).to(device)
        perm = rng.permutation(n).astype(np.int32)
        n_chunks = n // MC
        idx = torch.as_tensor(perm[:n_chunks * MC].reshape(n_chunks, MC)).to(device)
        src = torch.as_tensor(perm).to(device=device, dtype=torch.long)
        ms = cuda_time_ms(lambda: payload.index_select(1, src).sum(), reps)
        res[f"index_select_rows{r}"] = _entry(ms / 1e3, n)
        check_inputs(payload, idx)  # once; the timed calls skip the host read
        for serial in (False, True):
            tag = "serial" if serial else "batched"
            ms = cuda_time_ms(lambda: gather_sum(payload, idx, serial, check_ids=False),
                              reps)
            res[f"kernel_{tag}_rows{r}"] = _entry(ms / 1e3, n_chunks * MC)
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
