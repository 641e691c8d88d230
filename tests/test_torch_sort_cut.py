"""The constructor's event cut (``pipeline.sort_cut``, span ``init.sort_cut``)
against the path it replaces on time-ordered input: a stable argsort, a
gather of the four columns, the BA interval's mask and
``systematic_subsample``, written here as the oracle. The pipeline's
columns must equal the oracle's bit for bit and in dtype on sorted input
(cut as a slice of the caller's columns), on unsorted input and on times
holding a NaN (both sorted as before); the counter ``init.presorted``
says which path ran.
"""

import numpy as np
import pytest

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu_torch import config as TC
from emba_tpu_torch import pipeline as TP
from emba_tpu_torch.camera import PinholeCamera

START, STOP = 0.1, 0.9
N = 5000
CASES = ["sorted", "ties", "unsorted", "nan", "bounds", "empty", "signed_zero", "float32"]


def oracle(events, t0, t1, rate):
    """The constructor's cut before the order check."""
    t, x, y, pol = events
    order = np.argsort(t, kind="stable")
    t, x, y, pol = t[order], x[order], y[order], pol[order]
    m = (t >= t0 + 1e-6) & (t <= t1)
    cols = t[m], x[m], y[m], pol[m]
    if rate < 2:
        return cols
    idx = np.arange(rate - 1, len(cols[0]), rate)
    return tuple(a[idx] for a in cols)


def make_events(case, rng):
    """(times, x, y, pol, sorted?) of one case."""
    t = np.sort(rng.uniform(0.0, 1.0, N))
    presorted = True
    if case == "ties":
        t = np.round(t, 2)
    elif case == "unsorted":
        t = rng.permutation(t)
        presorted = False
    elif case == "nan":
        t[N // 3] = np.nan
        presorted = False
    elif case == "bounds":
        # runs of events exactly at both ends of the interval, and just outside
        b0, b1 = START + 1e-6, STOP
        t[100:110] = np.nextafter(b0, -np.inf)
        t[110:120] = b0
        t[N - 120:N - 110] = b1
        t[N - 110:N - 100] = np.nextafter(b1, np.inf)
        t = np.sort(t)
    elif case == "empty":
        t = np.sort(rng.uniform(STOP + 0.5, STOP + 1.0, N))
    elif case == "signed_zero":
        t = np.concatenate([np.full(10, -1.0), [0.0, -0.0, 0.0, -0.0], t[14:] + 0.2])
    elif case == "float32":
        # times on float32's grid near the start: the mask compares in float32,
        # so the slice's ends must too
        b0 = np.float32(START + 1e-6)
        t = np.sort(np.concatenate([
            t[:-40].astype(np.float32),
            np.full(20, b0), np.full(20, np.nextafter(b0, np.float32(-1)))]))
    x = rng.integers(0, 16, N).astype(np.int32)
    y = rng.integers(0, 12, N).astype(np.int32)
    pol = rng.integers(0, 2, N).astype(np.int8)
    return t, x, y, pol, presorted


@pytest.mark.parametrize("rate", [1, 3])
@pytest.mark.parametrize("case", CASES)
def test_constructor_cut_matches_the_argsort_path(case, rate):
    """The pipeline's four columns equal the argsort -> gather -> mask ->
    subsample oracle's bit for bit and in dtype; on sorted input at rate 1
    they are read-only views of the caller's arrays, which keep their bits
    and stay writeable; init.presorted is 1 where the times were in order."""
    rng = np.random.default_rng(CASES.index(case))
    *events, presorted = make_events(case, rng)
    before = [a.copy() for a in events]
    cfg = TC.BAConfig(start_time=START, stop_time=STOP, event_sampling_rate=rate,
                      dtype="float64")
    cam = PinholeCamera.from_calib(16, 12, [[10.0, 0, 7.5], [0, 10.0, 5.5], [0, 0, 1]])
    pipe = TP.EmbaPipeline(cfg, cam, tuple(events), np.array([0.0, 1.0]),
                           np.stack([np.eye(3)] * 2), init_gx=np.zeros((8, 16)),
                           init_gy=np.zeros((8, 16)), device="cpu")
    want = oracle(events, START, STOP, rate)
    got = (pipe.t, pipe.x, pipe.y, pipe.pol)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
        assert not g.flags.writeable
    if case == "empty":
        assert len(pipe.t) == 0
    if case == "bounds" and rate == 1:
        assert np.sum(pipe.t == START + 1e-6) == 10 and np.sum(pipe.t == STOP) == 10
    assert pipe.record.counters["init.presorted"] == int(presorted)
    assert TP.is_time_ordered(events[0]) == presorted
    for g, a in zip(got, events):
        assert np.shares_memory(g, a) == (presorted and rate == 1 and len(g) > 0)
    for a, b in zip(events, before):
        assert a.flags.writeable and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n", [0, 1, 2, TP.ORDER_CHECK_BLOCK, TP.ORDER_CHECK_BLOCK + 1,
                               2 * TP.ORDER_CHECK_BLOCK + 5])
def test_order_check_reads_every_pair(n):
    """The blocked order check sees a pair out of order or a NaN wherever it
    lies, across block edges included."""
    t = np.arange(n, dtype=np.float64)
    assert TP.is_time_ordered(t)
    for i in sorted({0, n // 2, TP.ORDER_CHECK_BLOCK - 1, TP.ORDER_CHECK_BLOCK, n - 1}):
        if 0 <= i < n:
            bad = t.copy()
            bad[i] = np.nan
            assert not TP.is_time_ordered(bad), i
            if i + 1 < n:
                bad = t.copy()
                bad[i], bad[i + 1] = bad[i + 1], bad[i]
                assert not TP.is_time_ordered(bad), i
