"""Carry state across from the JAX package: numpy arrays in, the port's
tensors out. Both packages then compute from the same inputs.

The LM checkpoint payload (``solver.lm_state_dict``, and
``emba_tpu.solver.lm_state_dict``) is numpy arrays and Python scalars, so
it goes both ways: :func:`lm_state_to_numpy` brings a payload of either
package (arrays of any kind, scalars of any kind) to that neutral form, and
each package's ``solve_window(resume_state=...)`` takes it.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import DeviceWindow

LM_STATE_ARRAYS = ("knots", "gx", "gy")
LM_STATE_SCALARS = {"lam": float, "cost_min": float, "count_tol_sat": int,
                    "it": int, "cost_decreased": bool}


def state_from_numpy(knots, Gx, Gy, dtype, device):
    """(knots (K,3,3), Gx (H,W), Gy (H,W)) numpy arrays -> tensors."""
    return tuple(
        torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
        for a in (knots, Gx, Gy)
    )


def _to_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.array(a)  # a copy: arrays of JAX are read-only


def lm_state_to_numpy(payload: dict) -> dict:
    """An LM checkpoint payload of either package -> numpy arrays (knots,
    gx, gy) and Python scalars (lam, cost_min, count_tol_sat, it,
    cost_decreased). Raises KeyError if a key is missing."""
    out = {k: _to_numpy(payload[k]) for k in LM_STATE_ARRAYS}
    for k, kind in LM_STATE_SCALARS.items():
        v = payload[k]
        out[k] = kind(v.item() if hasattr(v, "item") else v)
    return out


def device_window_from_jax(dev, dtype=None, *, device) -> DeviceWindow:
    """An ``emba_tpu.model.DeviceWindow`` -> the port's DeviceWindow on
    ``device``, which the caller names (no default: neither the card nor
    the CPU is assumed). Floating fields keep their dtype unless ``dtype``
    is given; integer and bool fields keep theirs."""
    fields = {}
    for name in DeviceWindow.__dataclass_fields__:
        a = getattr(dev, name)
        if a is None:
            fields[name] = None
            continue
        t = torch.as_tensor(np.array(a))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        fields[name] = t.to(device)
    return DeviceWindow(**fields)
