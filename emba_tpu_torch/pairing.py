"""Per-sensor-pixel event pairing on the host (counterpart of
``emba_tpu/pairing.py``): the static structures of one window, in numpy.

Consecutive-event pairing at each sensor pixel depends only on (x, y,
arrival order), so ``prev_idx`` is computed once per window; every LM
iteration then gathers through it on the device. The device window
(``model.DeviceWindow.from_window``) pairs the events itself, on the
device, from the raw columns: :attr:`EventWindow.prev_idx` is computed here
only when something reads it, and :func:`compute_prev_index` is the numpy
counterpart the device pairing is held against.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass
class EventWindow:
    """Static per-window event data, host-resident (numpy), SoA layout."""

    t: np.ndarray  # (N,) f64 absolute timestamps [s]
    x: np.ndarray  # (N,) int32 sensor column
    y: np.ndarray  # (N,) int32 sensor row
    pol: np.ndarray  # (N,) int8 polarity in {0, 1}
    batch_s: np.ndarray  # (NB,) int32 spline segment per batch
    batch_u: np.ndarray  # (NB,) f64 normalized offset per batch
    batch_size: int
    sensor_width: int

    @property
    def num_events(self) -> int:
        return len(self.t)

    @functools.cached_property
    def prev_idx(self) -> np.ndarray:
        """(N,) int32 index of the previous event at the same pixel, -1 if
        none (:func:`compute_prev_index`, on first read)."""
        return compute_prev_index(self.x, self.y, self.sensor_width)

    def batch_ids(self) -> np.ndarray:
        return (np.arange(self.num_events) // self.batch_size).astype(np.int32)

    def sensor_flat_idx(self, sensor_width: int) -> np.ndarray:
        return (self.y.astype(np.int64) * sensor_width + self.x).astype(np.int32)


def compute_prev_index(x: np.ndarray, y: np.ndarray, sensor_width: int) -> np.ndarray:
    """For each event, the index of the previous event at the same sensor
    pixel (or -1), from a stable sort by pixel (time order kept per pixel)."""
    n = len(x)
    pix = y.astype(np.int64) * sensor_width + x.astype(np.int64)
    order = np.argsort(pix, kind="stable")
    sorted_pix = pix[order]
    prev_sorted = np.full(n, -1, dtype=np.int64)
    same = sorted_pix[1:] == sorted_pix[:-1]
    prev_sorted[1:][same] = order[:-1][same]
    prev = np.full(n, -1, dtype=np.int64)
    prev[order] = prev_sorted
    return prev.astype(np.int32)


def build_window(t, x, y, pol, sensor_width: int, traj_locate,
                 batch_size: int = 100) -> EventWindow:
    """Assemble the static per-window structures (the pairing itself is
    left to :attr:`EventWindow.prev_idx` or to the device window).

    Truncates the event tail to a multiple of ``batch_size``, as the
    reference's integer-division batch count does. ``traj_locate`` maps
    batch mid-times (first + last) / 2 to (segment s, offset u), normally
    ``spline.Trajectory.locate``.
    """
    n = (len(t) // batch_size) * batch_size
    t, x, y, pol = t[:n], x[:n], y[:n], pol[:n]
    nb = n // batch_size
    t_first = t[0::batch_size]
    t_last = t[batch_size - 1::batch_size]
    s, u = traj_locate(t_first + 0.5 * (t_last - t_first))
    return EventWindow(
        t=np.asarray(t, np.float64),
        x=np.asarray(x, np.int32),
        y=np.asarray(y, np.int32),
        pol=np.asarray(pol, np.int8),
        batch_s=np.asarray(s, np.int32).reshape(nb),
        batch_u=np.asarray(u, np.float64).reshape(nb),
        batch_size=batch_size,
        sensor_width=sensor_width,
    )


def time_map(win: EventWindow, sensor_width: int, sensor_height: int, t0: float):
    """Last-event timestamp per sensor pixel, relative to ``t0`` (0 where no
    event fell; reference ``getTimeMap``)."""
    out = np.zeros((sensor_height, sensor_width))
    np.maximum.at(out, (win.y, win.x), win.t - t0)
    return out


def event_count_map(win: EventWindow, sensor_width: int, sensor_height: int):
    """Events per sensor pixel, int32 (reference ``getEventNumMap``)."""
    out = np.zeros((sensor_height, sensor_width), dtype=np.int32)
    np.add.at(out, (win.y, win.x), 1)
    return out
