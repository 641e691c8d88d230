"""The port's gather-sum module against the JAX probe kernel it replaces,
``scripts/r5_dma_gather_probe.py::dma_gather_sum``, loaded with importlib
and run in interpret mode on the CPU, on the same numpy inputs.

On the CPU the port's wrapper runs its plain torch version. Tolerance:
3e-5 absolute on sums of 1,024 standard normal f32 values (|sum| ~ 30):
both sides sum in f32, in different orders, so they differ by a few ulps
of the running sums. The CUDA kernel itself is tested on the card by
``tests/test_torch_cuda.py``.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu_torch.kernels import gather_sum as TG
from emba_tpu_torch.probes import gather_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "r5_dma_gather_probe", os.path.join(ROOT, "scripts", "r5_dma_gather_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(rng, rows, n=4096, n_chunks=4):
    payload = rng.standard_normal((rows, n)).astype(np.float32)
    idx = rng.permutation(n)[:n_chunks * TG.MC].reshape(n_chunks, TG.MC)
    return payload, idx.astype(np.int32)


@pytest.mark.parametrize("serial", [False, True], ids=["batched", "serial"])
@pytest.mark.parametrize("rows", [8, 16])
def test_plain_matches_pallas_probe_kernel(probe, rows, serial):
    payload, idx = make_inputs(np.random.default_rng(rows), rows)
    want = np.asarray(probe.dma_gather_sum(jnp.asarray(payload), jnp.asarray(idx),
                                           rows, serial))
    before = TG.launches
    got = TG.gather_sum(torch.from_numpy(payload), torch.from_numpy(idx), serial)
    assert TG.launches == before  # CPU tensors never reach the CUDA kernel
    assert got.shape == want.shape == (rows, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)


def test_plain_matches_f64_sum_with_repeats_and_one_chunk():
    rng = np.random.default_rng(3)
    payload = rng.standard_normal((5, 300)).astype(np.float32)
    for idx in (rng.integers(0, 7, (6, TG.MC)), np.full((1, 1), 299)):
        got = TG.gather_sum(torch.from_numpy(payload),
                            torch.from_numpy(idx.astype(np.int32)), True)
        cols = payload.astype(np.float64)[:, idx.reshape(-1)]
        err = np.abs(got.numpy() - cols.sum(1, keepdims=True))
        # f32 sums of up to 1,536 terms: within 1e-6 of the sum of magnitudes
        assert np.all(err <= 1e-6 * np.abs(cols).sum(1, keepdims=True))


def test_wrapper_contract_errors():
    payload = torch.zeros((4, 100))
    idx = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        TG.gather_sum(payload.double(), idx, False)
    with pytest.raises(ValueError, match="float32"):
        TG.gather_sum(payload[0], idx, False)
    with pytest.raises(ValueError, match="int32"):
        TG.gather_sum(payload, idx.long(), False)
    with pytest.raises(ValueError, match="contiguous"):
        TG.gather_sum(torch.zeros((100, 4)).T, idx, False)
    with pytest.raises(IndexError):
        TG.gather_sum(payload, idx - 1, False)
    with pytest.raises(IndexError):
        TG.gather_sum(payload, idx + 100, False)
    with pytest.raises(ValueError, match="rows_per_pass"):
        TG.gather_sum(payload, idx, False, rows_per_pass=0)
    with pytest.raises(ValueError, match="grid_blocks"):
        TG.gather_sum(payload, idx, False, grid_blocks=-1)
    assert TG.check_inputs(payload, idx) == (4, 100, 2, 8)


def test_many_rows_and_a_full_chunk_sum_to_the_f64_sum():
    """R = 300 at MC = 256: no discipline stages (R, MC) in shared memory any
    longer, so the wrapper takes any R (it refused this shape until the row
    sweep)."""
    rng = np.random.default_rng(4)
    payload = rng.standard_normal((300, 1000)).astype(np.float32)
    idx = rng.integers(0, 1000, (3, TG.MC)).astype(np.int32)
    cols = payload.astype(np.float64)[:, idx.reshape(-1)]
    for serial in (False, True):
        got = TG.gather_sum(torch.from_numpy(payload), torch.from_numpy(idx), serial,
                            rows_per_pass=7)
        assert got.shape == (300, 1)
        err = np.abs(got.numpy() - cols.sum(1, keepdims=True))
        assert np.all(err <= 1e-6 * np.abs(cols).sum(1, keepdims=True))


L2_H100 = 52_428_800  # bytes, as torch reports the H100's L2


@pytest.mark.parametrize("n", [100, 2_000_000])
@pytest.mark.parametrize("rows", [1, 3, 8, 16, 300])
def test_pass_rule_fits_the_l2_share_and_covers_the_rows(rows, n):
    p = TG.pass_size(rows, n, L2_H100)
    assert 1 <= p <= rows
    assert p == 1 or p * n * 4 <= TG.L2_SHARE * L2_H100
    if p < rows:  # the rule takes as many rows as fit
        assert (p + 1) * n * 4 > TG.L2_SHARE * L2_H100
    passes = TG.row_passes(rows, p)
    assert [r for r0, r1 in passes for r in range(r0, r1)] == list(range(rows))
    assert all(r1 - r0 == p for r0, r1 in passes[:-1])
    assert 1 <= passes[-1][1] - passes[-1][0] <= p


def test_probe_needs_a_card(tmp_path):
    """The probe measures the card only: without CUDA it raises instead of
    timing the CPU, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "probe.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        gather_probe.main(["--out", str(out)])
    assert not out.exists()
