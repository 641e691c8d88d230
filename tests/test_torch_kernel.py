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

import _torch_threads  # noqa: F401  (one torch thread)

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
    order, off = TK.sorted_runs(pm, r_pad)
    counts = np.bincount(pm.numpy(), minlength=r_pad)[:r_pad]
    want = np.concatenate([[0], np.cumsum(counts)])
    assert off.dtype == torch.int32 and order.dtype == torch.int64
    np.testing.assert_array_equal(off.numpy(), want)
    np.testing.assert_array_equal(order.numpy(), np.argsort(pm.numpy(), kind="stable"))
    if case != "spread":
        assert (np.diff(want) == 0).any()


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_inverse_permutation_matches_numpy(n):
    """pos[ids[s]] = s for the stable sort's ids, as the pack kernel's slots."""
    rng = np.random.default_rng(n)
    keys = torch.as_tensor(rng.integers(0, 40, n).astype(np.int32))
    ids, _ = TK.sorted_runs(keys, 40)
    pos = TK.inverse_permutation(ids)
    want = np.empty(n, np.int64)
    want[np.argsort(keys.numpy(), kind="stable")] = np.arange(n)
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), want)


def test_pair_key_offsets_match_bincount():
    """Knot-pair keys i_c * K + i_p (K^2 for a dropped measurement): the run
    offsets over the K^2 keys equal bincount + cumsum, with empty keys, and
    the dropped measurements fall past the last offset."""
    rng = np.random.default_rng(9)
    knots, n = 30, 4000
    i_c = rng.integers(0, knots - 1, n)
    i_p = np.clip(i_c - rng.integers(0, 2, n), 0, None)
    keys = np.where(rng.random(n) < 0.1, knots * knots, i_c * knots + i_p)
    ids, off = TK.sorted_runs(torch.as_tensor(keys.astype(np.int32)), knots * knots)
    counts = np.bincount(keys, minlength=knots * knots + 1)[:knots * knots]
    np.testing.assert_array_equal(off.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    assert (counts == 0).sum() > knots * knots // 2
    np.testing.assert_array_equal(ids.numpy(), np.argsort(keys, kind="stable"))


def _chunks_numpy(counts, chunk, heavy_only):
    """Loop reference: (first chunk of each key, key of each chunk)."""
    start, key = [0], []
    for q, c in enumerate(counts):
        m = -(-c // chunk) if (c > chunk or not heavy_only) else 0
        key += [q] * m
        start.append(start[-1] + m)
    return np.array(start), np.array(key, np.int64)


@pytest.mark.parametrize("heavy_only", [False, True])
@pytest.mark.parametrize("case", ["mixed", "none", "exactly one chunk", "bound"])
def test_chunk_map_matches_numpy(case, heavy_only):
    """chunk -> key maps against a loop, with empty keys, runs of exactly one
    chunk and runs beyond one; the chunks past the last get key num_keys,
    and the chunks of each key cover its run exactly once. The "bound" case
    is the worst case of ``chunk_bounds`` (every run one past a chunk)."""
    rng = np.random.default_rng(12)
    chunk = 8
    counts = {"mixed": rng.choice([0, 0, 1, 7, 8, 9, 16, 17, 40], 300),
              "none": np.zeros(50, np.int64),
              "exactly one chunk": np.full(20, chunk),
              "bound": np.full(60, chunk + 1)}[case]
    num_keys, n = counts.shape[0], int(counts.sum())
    off = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    max_heavy, max_pair = TK.chunk_bounds(n, num_keys, chunk, chunk)
    max_chunks = max_heavy if heavy_only else max_pair
    start, key = TK.chunk_map(off, chunk, max_chunks, heavy_only)
    want_start, want_key = _chunks_numpy(counts, chunk, heavy_only)
    assert start.dtype == torch.int32 and key.dtype == torch.int32
    assert want_key.shape[0] <= max_chunks
    np.testing.assert_array_equal(start.numpy(), want_start)
    total = want_key.shape[0]
    np.testing.assert_array_equal(key.numpy()[:total], want_key)
    assert (key.numpy()[total:] == num_keys).all()
    # the kernel's ranges: chunk c of key q covers [off[q] + (c - start[q]) *
    # chunk, min(.. + chunk, off[q + 1]))
    covered = np.zeros(n, np.int64)
    o, s = off.numpy(), start.numpy()
    for c in range(total):
        q = key.numpy()[c]
        s0 = o[q] + (c - s[q]) * chunk
        covered[s0:min(s0 + chunk, o[q + 1])] += 1
    heavy_rows = np.repeat(counts > chunk, counts) if heavy_only else np.ones(n, bool)
    np.testing.assert_array_equal(covered, heavy_rows.astype(np.int64))


@pytest.mark.parametrize("case", ["valid", "order 5", "pm_pix int64",
                                  "Jc not contiguous", "Jc of another order",
                                  "carry of another shape"])
def test_check_inputs_holds_the_kernel_contract(case):
    """The CUDA wrapper's input check: int32 ids, f32 (3*order, N)
    half-Jacobians, contiguous, carry of the output shapes; anything else
    raises ValueError before a launch."""
    rng = np.random.default_rng(8)
    hw, knots, order, n = 300, 6, 2, 50
    args = [torch.from_numpy(a) for a in make_inputs(rng, n, hw, knots, order)]
    carry = TK._zeros_out(*TK.padded_dims(hw, 3 * knots), torch.float32, "cpu")
    if case == "order 5":
        order = 5
    elif case == "pm_pix int64":
        args[0] = args[0].long()
    elif case == "Jc not contiguous":
        args[3] = args[3].T.contiguous().T
    elif case == "Jc of another order":
        order = 3
    elif case == "carry of another shape":
        carry = TK._zeros_out(*TK.padded_dims(2 * hw, 3 * knots), torch.float32, "cpu")
    if case == "valid":
        assert TK.check_inputs(*args, hw, 3 * knots, order, carry) == (n, 384, 32)
    else:
        with pytest.raises(ValueError):
            TK.check_inputs(*args, hw, 3 * knots, order, carry)


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
