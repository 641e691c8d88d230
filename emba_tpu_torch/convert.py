"""Carry state across from the JAX package: numpy arrays in, the port's
tensors out. Both packages then compute from the same inputs."""

from __future__ import annotations

import numpy as np
import torch

from .model import DeviceWindow


def state_from_numpy(knots, Gx, Gy, dtype, device):
    """(knots (K,3,3), Gx (H,W), Gy (H,W)) numpy arrays -> tensors."""
    return tuple(
        torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
        for a in (knots, Gx, Gy)
    )


def device_window_from_jax(dev, dtype=None, device="cpu") -> DeviceWindow:
    """An ``emba_tpu.model.DeviceWindow`` -> the port's DeviceWindow.
    Floating fields keep their dtype unless ``dtype`` is given; integer and
    bool fields keep theirs."""
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
