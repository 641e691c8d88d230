"""The device window's fields built on the host with numpy, as the port
built them before it paired on the device: ``pairing.compute_prev_index``
for the pairing and the bearing LUT gathered in float64 on the host, then
cast. ``model.DeviceWindow.from_window`` must equal it bit for bit. Imports
no JAX, so the card's tests use it too."""

import numpy as np
import torch

from emba_tpu_torch import pairing

FIELDS = ("bearings", "pol_signed", "prev_idx", "has_prev", "batch_ids", "batch_s",
          "batch_u", "sensor_pix")


def host_window(win, bearing_lut, sensor_width, dtype, pad_multiple=1):
    """{field: CPU tensor} of the window, padded as ``from_window`` pads."""
    spix = win.sensor_flat_idx(sensor_width)
    prev = pairing.compute_prev_index(win.x, win.y, sensor_width)
    n = len(spix)
    pad = -(-n // pad_multiple) * pad_multiple - n

    def t(a, dt, v=0):
        if pad:
            a = np.concatenate([a, np.full(pad, v, a.dtype)])
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype=dt)

    b = bearing_lut[spix].T
    if pad:
        b = np.concatenate([b, np.tile(np.array([[0.0], [0.0], [1.0]], b.dtype), pad)],
                           axis=1)
    return dict(
        bearings=torch.as_tensor(np.ascontiguousarray(b)).to(dtype=dtype),
        pol_signed=t(2.0 * (win.pol.astype(np.float64) - 0.5), dtype),
        prev_idx=t(np.maximum(prev, 0).astype(np.int32), torch.int32),
        has_prev=t(prev >= 0, torch.bool, False),
        batch_ids=t((np.arange(n) // win.batch_size).astype(np.int32), torch.int32),
        batch_s=torch.as_tensor(win.batch_s.astype(np.int32)),
        batch_u=torch.as_tensor(np.asarray(win.batch_u)).to(dtype=dtype),
        sensor_pix=t(spix.astype(np.int32), torch.int32),
    )


def bits(a):
    """``a`` with floats viewed as integers of their width, so that equality
    is equality of bits."""
    if a.is_floating_point():
        return a.view({4: torch.int32, 8: torch.int64}[a.element_size()])
    return a


def assert_same_window(dev, want):
    for name in FIELDS:
        got, w = getattr(dev, name).cpu(), want[name]
        assert got.dtype == w.dtype and got.shape == w.shape, name
        assert getattr(dev, name).is_contiguous(), name
        assert torch.equal(bits(got), bits(w)), name
