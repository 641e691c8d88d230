"""The CUDA A12 accumulation kernel against its plain torch version, on
the card. Every test here is marked ``cuda`` and skips without a GPU.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: relative 1e-5 of each output's largest magnitude, because both
sides sum in f32 in different orders; repeated kernel runs must agree bit
for bit.
"""

import numpy as np
import pytest
import torch

from emba_tpu_torch.kernels import a12_accum as TK


def make_inputs(rng, n, hw, knots, order, device):
    d = 3 * order
    i_c = rng.integers(0, knots - order + 1, n)
    i_p = np.clip(i_c - rng.integers(0, 3, n), 0, None)
    w = rng.uniform(0.1, 1.0, n)
    w[rng.random(n) < 0.2] = 0.0
    arrs = [rng.integers(0, hw, n), i_c, i_p, rng.normal(size=(d, n)),
            rng.normal(size=(d, n)), rng.normal(size=n), rng.normal(size=n),
            rng.normal(size=n), w]
    types = [torch.int32] * 3 + [torch.float32] * 6
    return [torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=t)
            for a, t in zip(arrs, types)]


def unpadded(out, hw, dim):
    a12, px5, a11b = out
    dp = a12.shape[1] // 2
    return [a12[:hw, :dim], a12[:hw, dp:dp + dim], px5[:hw, :5], a11b[:dim, :dim],
            a11b[dp, :dim]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card with -m cuda)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4])
def test_cuda_kernel_matches_plain(cuda_device, order):
    rng = np.random.default_rng(10 + order)
    hw, knots = 4096, 20
    dim = 3 * knots
    args = make_inputs(rng, 50_000, hw, knots, order, cuda_device)
    before = TK.launches
    got = TK.a12_accumulate(*args, hw, dim, order)
    again = TK.a12_accumulate(*args, hw, dim, order)
    assert TK.launches == before + 2
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    want = TK.a12_accumulate_plain(*args, hw, dim, order)
    for g, w in zip(unpadded(got, hw, dim), unpadded(want, hw, dim)):
        assert torch.max(torch.abs(g - w)) <= 1e-5 * torch.max(torch.abs(w))


@pytest.mark.cuda
def test_cuda_kernel_carry_accumulates_in_place(cuda_device):
    rng = np.random.default_rng(3)
    hw, knots, dim = 4096, 20, 60
    a = make_inputs(rng, 30_000, hw, knots, 2, cuda_device)
    b = make_inputs(rng, 20_000, hw, knots, 2, cuda_device)
    out = TK.a12_accumulate(*a, hw, dim, 2)
    chained = TK.a12_accumulate(*b, hw, dim, 2, carry=out)
    assert all(x is y for x, y in zip(chained, out))
    cat = [torch.cat([x, y], dim=-1) for x, y in zip(a, b)]
    want = TK.a12_accumulate_plain(*cat, hw, dim, 2)
    for g, w in zip(unpadded(chained, hw, dim), unpadded(want, hw, dim)):
        assert torch.max(torch.abs(g - w)) <= 1e-5 * torch.max(torch.abs(w))


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_cannot_take(cuda_device):
    rng = np.random.default_rng(0)
    args = make_inputs(rng, 10, 256, 5, 2, cuda_device)
    f64 = list(args)
    f64[3] = f64[3].double()
    with pytest.raises(ValueError, match="Jc"):
        TK.a12_accumulate(*f64, 256, 15, 2)
    strided = list(args)
    strided[3] = torch.empty((10, 6), device=cuda_device).T
    with pytest.raises(ValueError, match="contiguous"):
        TK.a12_accumulate(*strided, 256, 15, 2)
