"""The port's A12 accumulation module against the JAX package's Pallas
kernel, and the CUDA kernel against its plain version.

On the CPU the port's wrapper runs its plain torch version; it is held
against ``emba_tpu.kernels.a12_accum.a12_accumulate``, which runs in
interpret mode off the TPU, at f32. Tolerance: relative 1e-4 of each
output's largest magnitude, because the Pallas kernel splits its products
into hi/lo bf16 halves and keeps about 16 mantissa bits.

The CUDA kernel itself is tested on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emba_tpu.kernels.a12_accum as JK
from emba_tpu_torch.kernels import a12_accum as TK


def make_inputs(rng, n, hw, knots, order, pix=None):
    d = 3 * order
    i_c = rng.integers(0, knots - order + 1, n)
    i_p = np.clip(i_c - rng.integers(0, 3, n), 0, None)
    w = rng.uniform(0.1, 1.0, n)
    w[rng.random(n) < 0.2] = 0.0
    arrs = [rng.integers(0, hw, n) if pix is None else pix, i_c, i_p,
            rng.normal(size=(d, n)), rng.normal(size=(d, n)), rng.normal(size=n),
            rng.normal(size=n), rng.normal(size=n), w]
    types = [np.int32] * 3 + [np.float32] * 6
    return [np.ascontiguousarray(a, t) for a, t in zip(arrs, types)]


def unpadded(out, hw, dim):
    a12, px5, a11b = (np.asarray(x, np.float64) for x in out)
    dp = a12.shape[1] // 2
    return [a12[:hw, :dim], a12[:hw, dp:dp + dim], px5[:hw, :5], a11b[:dim, :dim],
            a11b[dp, :dim]]


def assert_rel(got, want, rel):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= rel * max(np.max(np.abs(w)), 1e-30)


def port(args, hw, dim, order, carry=None):
    return TK.a12_accumulate(*[torch.from_numpy(a) for a in args], hw, dim, order, carry)


def jax_ref(args, hw, dim, order, carry=None):
    return JK.a12_accumulate(*[jnp.asarray(a) for a in args], num_pix=hw,
                             dim_pose=dim, order=order, carry=carry)


@pytest.mark.parametrize("order", [2, 4])
def test_plain_matches_pallas_kernel(order):
    rng = np.random.default_rng(order)
    hw, knots = 2048, 10
    args = make_inputs(rng, 2000, hw, knots, order)
    before = TK.launches
    got = port(args, hw, 3 * knots, order)
    assert TK.launches == before  # CPU tensors never reach the CUDA kernel
    assert_rel(unpadded(got, hw, 3 * knots),
               unpadded(jax_ref(args, hw, 3 * knots, order), hw, 3 * knots), 1e-4)


def test_plain_carry_chain_matches_pallas_kernel():
    rng = np.random.default_rng(5)
    hw, knots, dim = 2048, 10, 30
    a = make_inputs(rng, 1500, hw, knots, 2)
    b = make_inputs(rng, 700, hw, knots, 2, pix=np.where(rng.random(700) < 0.5, 0,
                                                         hw - 1))
    out = port(a, hw, dim, 2)
    chained = port(b, hw, dim, 2, carry=out)
    assert all(x is y for x, y in zip(chained, out))  # accumulated in place
    want = jax_ref(b, hw, dim, 2, carry=jax_ref(a, hw, dim, 2))
    assert_rel(unpadded(chained, hw, dim), unpadded(want, hw, dim), 1e-4)


@pytest.mark.parametrize("case", ["spread", "empty rows and rows past r_pad", "none"])
def test_row_offsets_match_bincount(case):
    """The kernel's prepass offsets (binary search over the sorted rows) are
    the offsets of bincount + cumsum, exactly; rows >= r_pad fall past the
    last offset and rows with no measurement give empty runs."""
    rng = np.random.default_rng(6)
    r_pad = 512
    pix = {"spread": rng.integers(0, r_pad, 3000),
           "empty rows and rows past r_pad": np.concatenate([
               rng.integers(100, 140, 2000), rng.integers(r_pad, 3 * r_pad, 300),
               np.full(50, r_pad - 1)]),
           "none": np.zeros(0, np.int64)}[case]
    pm = torch.as_tensor(rng.permutation(pix).astype(np.int32))
    order, off = TK.row_offsets(pm, r_pad)
    counts = np.bincount(pm.numpy(), minlength=r_pad)[:r_pad]
    want = np.concatenate([[0], np.cumsum(counts)])
    assert off.dtype == torch.int32 and order.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), want)
    np.testing.assert_array_equal(order.numpy(), np.argsort(pm.numpy(), kind="stable"))
    if case != "spread":
        assert (np.diff(want) == 0).any()


def test_plain_matches_loop_reference_f64():
    """Tiny N, a zero-weight measurement and a repeated pixel against the
    definition, summed measurement by measurement in f64."""
    rng = np.random.default_rng(3)
    hw, knots, order, dim = 200, 6, 2, 18
    args = make_inputs(rng, 5, hw, knots, order, pix=np.array([7, 7, 3, 199, 7]))
    args[8][1] = 0.0
    args = [a.astype(np.float64) if a.dtype == np.float32 else a for a in args]
    pm, ic, ip, Jc, Jp, dx, dy, e, w = args
    a12 = np.zeros((hw, 2, dim))
    px5 = np.zeros((hw, 5))
    A11 = np.zeros((dim, dim))
    b1 = np.zeros(dim)
    for k in range(5):
        u = np.zeros(dim)
        u[3 * ic[k]:3 * ic[k] + 6] += Jc[:, k]
        u[3 * ip[k]:3 * ip[k] + 6] += Jp[:, k]
        a12[pm[k], 0] += w[k] * u * dx[k]
        a12[pm[k], 1] += w[k] * u * dy[k]
        px5[pm[k]] += w[k] * np.array([dx[k] ** 2, dx[k] * dy[k], dy[k] ** 2,
                                       e[k] * dx[k], e[k] * dy[k]])
        A11 += w[k] * np.outer(u, u)
        b1 += w[k] * e[k] * u
    got = unpadded(port(args, hw, dim, order), hw, dim)
    assert_rel(got, [a12[:, 0], a12[:, 1], px5, A11, b1], 1e-14)
