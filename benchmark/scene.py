"""The benchmark's scene, rendered on the device from a seed: a brightness
panorama, a ground-truth rotation spline, and the event stream a rotating
event camera sees, by threshold crossing of the warped brightness.

The arithmetic is that of the program's synthetic renderer (``synth.
generate``) and of the accuracy suite's texture, rewritten in torch so that
it runs on the card in a few seconds instead of a minute of host numpy:

* texture: normal noise, three passes of a box filter of width ``smooth``
  (wrapping in x, mirrored in y), scaled to a peak of ``amp``; the gradient
  maps are its Sobel derivatives over 8;
* motion: rotation vectors ``a_i sin(2 pi f_i t + phi_i)`` less their value
  at t = 0, with ``f ~ U(0.5, 1.5)``, ``phi ~ U(0, 2 pi)``, ``a ~ motion
  U(0.5, 1)``, sampled at the knots of a spline of spacing ``dt_knots``;
* events: at each of ``steps`` evenly spaced times every sensor pixel
  samples the panorama bilinearly along its rotated bearing; a pixel fires
  once for each whole ``c_th`` its value moved from its reference since the
  last step, the reference moving by ``c_th`` each time, and each event is
  timed by linear interpolation inside the step. Events are sorted by time.

Everything runs in float64 on the given device; a ``torch.Generator`` on
that device, seeded from ``seed``, draws every random number.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .reference import geometry as geo


@dataclasses.dataclass
class Scene:
    gx: torch.Tensor  # (H, W) ground-truth gradient maps
    gy: torch.Tensor
    knots: torch.Tensor  # (K, 3, 3) ground-truth spline, knots at i * dt_knots
    dt_knots: float
    t: torch.Tensor  # (N,) f64 event times, sorted
    x: torch.Tensor  # (N,) int32
    y: torch.Tensor  # (N,) int32
    pol: torch.Tensor  # (N,) int8, 1 = brighter
    rendered: int  # events before any were dropped


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def texture(height: int, width: int, smooth: int, amp: float, gen, device):
    """The suite's brightness panorama: box-filtered normal noise."""
    if smooth % 2 == 0:
        raise ValueError("texture: the box filter width must be odd")
    B = torch.randn((height, width), generator=gen, dtype=torch.float64, device=device)
    k = torch.full((1, 1, smooth), 1.0 / smooth, dtype=torch.float64, device=device)
    h = smooth // 2
    for _ in range(3):
        B = torch.nn.functional.conv1d(
            torch.nn.functional.pad(B[:, None, :], (h, h), mode="circular"), k)[:, 0, :]
        Bt = B.T.contiguous()[:, None, :]
        B = torch.nn.functional.conv1d(
            torch.nn.functional.pad(Bt, (h, h), mode="reflect"), k)[:, 0, :].T
    return B / (torch.max(torch.abs(B)) + 1e-12) * amp


def motion_knots(duration: float, dt_knots: float, motion: float, gen, device):
    """Ground-truth knots at times i * dt_knots covering [0, duration]."""
    u = torch.rand(9, generator=gen, dtype=torch.float64, device=device)
    f = 0.5 + u[0:3]
    ph = 2.0 * math.pi * u[3:6]
    amp = motion * (0.5 + 0.5 * u[6:9])
    count = int(math.ceil(duration / dt_knots)) + 2
    tk = torch.arange(count, dtype=torch.float64, device=device) * dt_knots
    rv = amp * torch.sin(2.0 * math.pi * f * tk[:, None] + ph)
    return geo.exp_so3(rv - amp * torch.sin(ph))


def rotations(knots, dt_knots: float, times):
    """The spline's rotations at ``times`` (numpy or tensor, seconds)."""
    t = np.asarray(times.cpu() if isinstance(times, torch.Tensor) else times, np.float64)
    s, u = geo.locate(t, 0.0, dt_knots, knots.shape[0])
    return geo.spline_eval(knots, s, u)


def bilinear(img, px, py):
    h, w = img.shape
    x0 = torch.clamp(torch.floor(px).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(py).long(), 0, h - 2)
    fx = torch.clamp(px - x0, 0.0, 1.0)
    fy = torch.clamp(py - y0, 0.0, 1.0)
    flat = img.reshape(-1)
    i = y0 * w + x0
    return (flat[i] * (1 - fx) * (1 - fy) + flat[i + 1] * fx * (1 - fy)
            + flat[i + w] * (1 - fx) * fy + flat[i + w + 1] * fx * fy)


def render(sc: dict, seed: int, device, step_block: int = 256) -> Scene:
    """Render the scene of the configuration's ``scene`` dict ``sc`` from
    ``seed`` on ``device``."""
    gen = generator(seed, device)
    H, W = sc["pano_height"], sc["pano_width"]
    B = texture(H, W, sc["texture_smooth"], sc["texture_amp"], gen, device)
    gx, gy = geo.sobel(B)
    duration, dtk = sc["duration_s"], sc["dt_knots"]
    knots = motion_knots(duration, dtk, sc["motion_amp"], gen, device)

    sw, sh = sc["sensor_width"], sc["sensor_height"]
    bear = geo.bearings(sw, sh, sc["camera"], device=device)  # (P, 3)
    steps = int(round(sc["steps_per_s"] * duration))
    ts = torch.linspace(0.0, duration - 1e-9, steps, dtype=torch.float64, device=device)
    Rk = rotations(knots, dtk, ts)
    vals = torch.empty((steps, bear.shape[0]), dtype=torch.float64, device=device)
    for lo in range(0, steps, step_block):
        rb = torch.einsum("pj,kij->kpi", bear, Rk[lo:lo + step_block])
        px, py = geo.project(rb.reshape(-1, 3), W, H)
        vals[lo:lo + step_block] = bilinear(B, px, py).reshape(rb.shape[0], -1)

    # threshold crossing: the count of whole c_th each pixel moved at each
    # step, and its reference before the step
    c_th = sc["c_th"]
    ref = vals[0].clone()
    fired = torch.zeros((steps, bear.shape[0]), dtype=torch.int32, device=device)
    ref_before = torch.empty_like(vals)
    for k in range(1, steps):
        diff = vals[k] - ref
        n = torch.floor(torch.abs(diff) / c_th) * torch.sign(diff)
        ref_before[k] = ref
        ref = ref + n * c_th
        fired[k] = n.to(torch.int32)

    k_idx, p_idx = torch.nonzero(fired, as_tuple=True)
    count = torch.abs(fired[k_idx, p_idx]).long()
    sign = torch.sign(fired[k_idx, p_idx]).to(torch.float64)
    k_ev = torch.repeat_interleave(k_idx, count)
    p_ev = torch.repeat_interleave(p_idx, count)
    s_ev = torch.repeat_interleave(sign, count)
    start = torch.repeat_interleave(torch.cumsum(count, 0) - count, count)
    j = (torch.arange(k_ev.shape[0], device=device) - start + 1).to(torch.float64)
    new_ref = ref_before[k_ev, p_ev] + s_ev * j * c_th
    prev = vals[k_ev - 1, p_ev]
    denom = vals[k_ev, p_ev] - prev
    denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    frac = torch.clamp((new_ref - prev) / denom, 0.0, 1.0)
    step = ts[1] - ts[0]
    t = ts[k_ev] - step + frac * step
    t, order = torch.sort(t, stable=True)
    p_ev = p_ev[order]
    return Scene(gx=gx, gy=gy, knots=knots, dt_knots=dtk, t=t,
                 x=(p_ev % sw).to(torch.int32), y=(p_ev // sw).to(torch.int32),
                 pol=(s_ev[order] > 0).to(torch.int8), rendered=int(t.shape[0]))


def perturbed_knots(knots, sigma: float, gen):
    """``knots`` moved by a random walk of ``sigma`` rad a knot (normal
    steps), the first knot kept."""
    steps = torch.randn(knots.shape[:1] + (3,), generator=gen, dtype=knots.dtype,
                        device=knots.device) * sigma
    walk = torch.cumsum(steps, 0)
    return geo.exp_so3(walk - walk[0]) @ knots
