"""The port's sharded window (``emba_tpu_torch.dist``) over gloo on 2, 3 and
4 CPU ranks in f64, against JAX's ``emba_tpu.dist`` on the conftest's
virtual mesh (``make_mesh(n, 1)``) and against the port's single-device
functions, on the problem of ``tests/test_dist.py`` (32x32 sensor, 128x64
panorama, 0.5 s) with the maps at 0.7 of the truth.

The ranks of each world size are spawned once (``dist.spawn``), run the
cases of ``tests/_torch_dist_worker.py`` and hand back numpy results.

Tolerances: the halo linearization equals the single-device one bit for
bit on every measurement (a selection moves no value); the reduced normal
equations, the row-chunk solves, the windows and the map-only solve to
1e-8 relative to each output's largest magnitude (the ranks' partial sums
are added in another order); a resume at the same world size bit for bit;
a resume at another world size to 1e-8, as the reference's own elastic
test allows (``tests/test_multihost.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
import _torch_threads  # noqa: F401  (one torch thread)
from emba_tpu import dist as jdist
from emba_tpu import model as JM
from emba_tpu import pairing as jpairing
from emba_tpu import solver as JS
from emba_tpu import spline as jspline
from emba_tpu_torch import dist, model as TM, solver as TS, synth

REL = 1e-8


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.fixture(scope="module")
def data():
    """The problem's arrays, handed to the ranks and to JAX alike."""
    sensor = synth.default_sensor(32, 32, f=30.0)
    scene = synth.generate(np.random.default_rng(9), sensor, pano_width=128,
                           pano_height=64, c_th=0.15, t_end=0.5, dt_knots=0.05,
                           num_steps=150, motion_amp=0.2)
    return dict(t=scene.t, x=scene.x, y=scene.y, pol=scene.pol, lut=sensor.bearing_lut(),
                width=sensor.width, height=sensor.height, knots=scene.traj.knots,
                dt=scene.traj.dt, t_end=0.5, gx=0.7 * scene.gx, gy=0.7 * scene.gy,
                cfg=dict(c_th=0.15, pano_width=128, pano_height=64, thres_valid_pixel=2,
                         alpha=1.0))


def jax_problem(data, order=2, cfg_kw=None):
    """JAX's window, config and state from the same arrays."""
    traj = jspline.Trajectory(t_beg=0.0, dt=data["dt"], knots=data["knots"], order=2)
    if order != 2:
        tt = np.linspace(0.0, data["t_end"], 200)
        traj = jspline.Trajectory.from_poses(tt, np.asarray(traj.evaluate(tt)), 0.0,
                                             data["t_end"], data["dt"], order=order)
    win = jpairing.build_window(data["t"], data["x"], data["y"], data["pol"],
                                data["width"], traj.locate, 100)
    dev = JM.DeviceWindow.from_window(win, data["lut"], data["width"], jnp.float64)
    cfg = JM.ModelConfig(**{**data["cfg"], "spline_order": order, **(cfg_kw or {})})
    return dev, cfg, tuple(jnp.asarray(a) for a in (traj.knots, data["gx"], data["gy"]))


def mesh(n):
    return jdist.make_mesh(n, 1, jax.devices()[:n])


# ---------------------------------------------------------------------------
# Worlds 3 and 4: halo, reduced blocks, row-chunk solves, map-only.
# ---------------------------------------------------------------------------

# world -> compaction cap of the reduced blocks: 8192 rows split over 4
# ranks; over 3 a compacted row space of 1536 (3 x 512)
UNIT_WORLDS = {3: 1536, 4: None}


@pytest.fixture(scope="module")
def units(data):
    return {w: dist.spawn(W.units_rank, w, "gloo", args=(data, cap), device="cpu",
                          timeout_s=300)
            for w, cap in UNIT_WORLDS.items()}


@pytest.fixture(scope="module")
def single(data):
    """The port's single-device linearization and normal equations."""
    dev, cfg, (k, gx, gy) = W.window(data)
    out = {}
    for w, cap in UNIT_WORLDS.items():
        padded = dist.pad_window(dev, w)
        ccfg = dataclasses.replace(cfg, compact_cap=cap)
        lin = TM.linearize(k, gx, gy, padded, ccfg)
        out[w] = (padded, lin, TM.form_normal_eq(lin, gx, gy, ccfg, k.shape[0]))
    return out


@pytest.mark.parametrize("world", sorted(UNIT_WORLDS))
def test_halo_linearization_exact(units, single, world):
    padded, lin, _ = single[world]
    n = padded.pol_signed.shape[0]
    nl = n // world
    meas = padded.has_prev.numpy()
    prev = padded.prev_idx.numpy()
    # the case the fold exists for: a prev two or more ranks back
    owner = np.arange(n) // nl
    assert np.sum(meas & (owner - prev // nl >= 2)) > 0
    for f in dataclasses.fields(lin):
        want = getattr(lin, f.name).numpy()
        if f.name == "num_ev_map":
            for r in units[world]:
                assert np.array_equal(r["lin"][f.name], want)
            continue
        got = np.concatenate([r["lin"][f.name] for r in units[world]], axis=-1)
        assert np.array_equal(got[..., meas], want[..., meas]), f.name


@pytest.mark.parametrize("world", sorted(UNIT_WORLDS))
def test_reduced_normal_eq(units, single, data, world):
    _, _, neq = single[world]
    ranks = units[world]
    for name in ("A11", "b1", "pix2row", "active_pix", "active_count", "dropped"):
        for r in ranks:
            assert rel_err(r["red"][name], getattr(neq, name).numpy()) <= REL, name
    for name in ("a22_xx", "a22_xy", "a22_yy", "b2_x", "b2_y", "A12", "active"):
        got = np.concatenate([r["red"][name] for r in ranks])
        assert rel_err(got, getattr(neq, name).numpy()) <= REL, name
    if world == 4:  # against JAX's shard_map build on a (4, 1) mesh
        dev, cfg, state = jax_problem(data)
        m = mesh(4)
        jneq = jdist.make_shardmap_normal_eq(m, cfg, state[0].shape[0], 32 * 32)(
            *jdist.replicate(m, *state), jdist.shard_window(dev, m))
        dim = neq.b1.shape[0]
        got = np.concatenate([r["red"]["A12"] for r in ranks])
        for name in ("A11", "b1", "a22_xx", "b2_x", "b2_y"):
            assert rel_err(ranks[0]["red"][name] if name in ("A11", "b1") else
                           np.concatenate([r["red"][name] for r in ranks]),
                           np.asarray(getattr(jneq, name))) <= REL, name
        ja12 = np.asarray(jneq.A12)
        jdp = ja12.shape[1] // 2
        dp = got.shape[1] // 2
        assert rel_err(got[:, :dim], ja12[:, :dim]) <= REL
        assert rel_err(got[:, dp:dp + dim], ja12[:, jdp:jdp + dim]) <= REL


def test_uncompacted_rows_must_split(units):
    """8192 rows split over 4 ranks; over 3 the form phase raises, as the
    reference's does."""
    assert all(r["split_error"] == "" for r in units[4])
    assert all("not divisible by 3" in r["split_error"] for r in units[3])


@pytest.mark.parametrize("solve", ["schur", "cg"])
@pytest.mark.parametrize("world", sorted(UNIT_WORLDS))
def test_rowchunk_solves(units, single, world, solve):
    _, _, neq = single[world]
    if solve == "schur":
        x1, x2 = TM.solve_normal_eq(neq, 1e-3, True)
    else:
        x1, x2, it, _rel = TM.solve_normal_eq_cg(neq, 1e-3, True)
    for r in units[world]:
        got = r[solve]
        assert rel_err(got[0], x1.numpy()) <= REL
        assert rel_err(got[1], x2.numpy()) <= REL
        if solve == "cg":
            assert got[2] == int(it)


@pytest.mark.parametrize("variant", ["quadratic", "irls"])
@pytest.mark.parametrize("world", sorted(UNIT_WORLDS))
def test_map_only_sharded(units, data, world, variant):
    dev, cfg, (k, _gx, _gy) = W.window(data)
    iters = 1
    if variant == "irls":
        cfg, iters = dataclasses.replace(cfg, use_irls=True, cost_type="cauchy", eta=0.5), 3
    z = torch.zeros((64, 128), dtype=torch.float64)
    gx, gy, costs = TM.solve_map_only(k, z, z.clone(), dev, cfg, num_iters=iters)
    jdev, jcfg, jstate = jax_problem(data)
    jcfg = dataclasses.replace(jcfg, use_irls=cfg.use_irls, cost_type=cfg.cost_type,
                               eta=cfg.eta)
    m = mesh(world)
    jz = jnp.zeros((64, 128))
    jgx, jgy, jcosts = jdist.solve_map_only_sharded(
        *jdist.replicate(m, jstate[0], jz, jz), jdist.shard_window_all(jdev, m), jcfg, m,
        32 * 32, num_iters=iters)
    for r in units[world]:
        rgx, rgy, rcosts, repeat = r[f"map_{variant}"]
        assert repeat, "two calls differ in bits"
        for want in ((gx.numpy(), gy.numpy(), costs), (jgx, jgy, jcosts)):
            assert rel_err(rgx, want[0]) <= REL and rel_err(rgy, want[1]) <= REL
            assert rel_err(rcosts, want[2]) <= REL


def test_pad_window_masks_tail(data):
    dev, cfg, (k, gx, gy) = W.window(data)
    n0 = dev.pol_signed.shape[0]
    padded = dist.pad_window(dev, 7)
    assert padded.pol_signed.shape[0] % 7 == 0 and padded.pol_signed.shape[0] > n0
    assert not padded.has_prev[n0:].any()
    assert torch.all(padded.bearings[:, n0:] == torch.tensor([[0.0], [0.0], [1.0]],
                                                             dtype=torch.float64))
    cost = [float(TM.data_cost(TM.linearize(k, gx, gy, d, cfg, False).e, cfg))
            for d in (dev, padded)]
    jdev = jdist.pad_window(jax_problem(data)[0], 7)
    assert np.array_equal(padded.prev_idx.numpy(), np.asarray(jdev.prev_idx))
    assert rel_err(cost[1], cost[0]) <= 1e-12


# ---------------------------------------------------------------------------
# World 2: the sharded windows, host loop and lm_while.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def windows(data):
    return dist.spawn(W.windows_rank, 2, "gloo", args=(data, list(W.WINDOWS)),
                      device="cpu", timeout_s=300)[0]


def _single_window(data, name):
    cfg_kw, order, use_cg = W.WINDOWS[name]
    dev, cfg, state = W.window(data, order, cfg_kw)
    k, gx, gy, st = TS.solve_window(*state, dev, cfg, TS.LMConfig(max_num_iter=W.WINDOW_ITERS),
                                    fix_first=True, use_cg=use_cg)
    return (k.numpy(), gx.numpy(), gy.numpy()), st


@pytest.mark.parametrize("name", list(W.WINDOWS))
def test_sharded_window_matches_single(windows, data, name):
    """Host loop and lm_while on 2 ranks against the port's single-device
    host loop: the same steps, the same forming stats, knots and maps to
    1e-8."""
    got = windows[name]
    want, st = _single_window(data, name)
    assert len(got["iterations"]) == len(st.iterations)
    assert [r["cost_new"] < r["cost_min"] for r in got["iterations"]] == [
        r["cost_new"] < r["cost_min"] for r in st.iterations]
    assert got["active"] == st.active_px_per_form
    assert got["dropped"] == st.dropped_meas_per_form
    for g, w in zip(got["host"], want):
        assert rel_err(g, w) <= REL
    fk, fgx, fgy, cost, it, conv, trace = got["fused"]
    assert it == len(st.iterations)
    for g, w in zip((fk, fgx, fgy), want):
        assert rel_err(g, w) <= REL
    assert list(trace[:, 3] > 0) == [r["cost_new"] < r["cost_min"] for r in st.iterations]
    assert rel_err(trace[:, 2], [r["cost_new"] for r in st.iterations]) <= REL


@pytest.mark.parametrize("name", ["classic", "stream_full", "order4"])
def test_sharded_window_matches_jax(windows, data, name):
    """The fused window on 2 ranks against JAX's sharded window on a (2, 1)
    mesh: iterations, accepts, Np and dropped per iteration (the trace) and
    the result."""
    cfg_kw, order, use_cg = W.WINDOWS[name]
    dev, cfg, state = jax_problem(data, order, cfg_kw)
    m = mesh(2)
    solve = jdist.make_solve_window_sharded(m, cfg, state[0].shape[0], 32 * 32,
                                            fix_first=True, max_num_iter=W.WINDOW_ITERS,
                                            return_trace=True, use_cg=use_cg)
    jk, jgx, jgy, jcost, jit, jconv, jtrace = solve(
        *jdist.replicate(m, *state), jdist.shard_window_all(dev, m),
        jnp.asarray(1.0), jnp.asarray(1e-3))
    fk, fgx, fgy, cost, it, conv, trace = windows[name]["fused"]
    assert it == int(jit) and conv == bool(jconv)
    jtr = np.asarray(jtrace)[:it]
    assert np.array_equal(trace[:, 3], jtr[:, 3])
    assert np.array_equal(trace[:, 4:], jtr[:, 4:])
    assert rel_err(cost, float(jcost)) <= REL
    for g, w in zip((fk, fgx, fgy), (jk, jgx, jgy)):
        assert rel_err(g, np.asarray(w)) <= REL


def test_sharded_host_window_matches_jax(windows, data):
    """The host loop on 2 ranks against JAX's host-driven sharded loop:
    iteration records, Np and dropped per forming pass, the result."""
    dev, cfg, state = jax_problem(data)
    m = mesh(2)
    jk, jgx, jgy, jst = jdist.solve_window_sharded_host(
        *jdist.replicate(m, *state), jdist.shard_window_all(dev, m), m, cfg, 32 * 32,
        JS.LMConfig(max_num_iter=W.WINDOW_ITERS), fix_first=True)
    got = windows["classic"]
    assert got["active"] == jst.active_px_per_form
    assert got["dropped"] == jst.dropped_meas_per_form
    assert rel_err([r["cost_new"] for r in got["iterations"]],
                   [r["cost_new"] for r in jst.iterations]) <= REL
    for g, w in zip(got["host"], (jk, jgx, jgy)):
        assert rel_err(g, np.asarray(w)) <= REL


# ---------------------------------------------------------------------------
# Checkpoints: bit-exact at the same world, elastic across worlds.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resumed(data):
    four = dist.spawn(W.resume_rank, 4, "gloo", args=(data,), device="cpu", timeout_s=300)
    two = dist.spawn(W.resume_rank, 2, "gloo", args=(data, four[0]["state"]), device="cpu",
                     timeout_s=300)
    dev, cfg, start = W.window(data)
    k, gx, gy, st = TS.solve_window(*start, dev, cfg, TS.LMConfig(max_num_iter=8),
                                    fix_first=True, resume_state=four[0]["state"])
    return four, two, (k.numpy(), gx.numpy(), gy.numpy(),
                       [r["cost_new"] for r in st.iterations])


def test_resume_same_world_bit_exact(resumed):
    four, _, _ = resumed
    assert four[0]["state"]["it"] == 4
    for r in four:
        for a, b in zip(r["resumed"][:3], r["full"][:3]):
            assert np.array_equal(a, b)
        assert r["resumed"][3] == r["full"][3][4:]


@pytest.mark.parametrize("world", [2, 1])
def test_elastic_resume(resumed, world):
    """A checkpoint of the 4-rank run resumed on 2 ranks and on one device
    lands on the uninterrupted 4-rank run's result."""
    four, two, one = resumed
    got = two[0]["resumed"] if world == 2 else one
    full = four[0]["full"]
    assert len(got[3]) == len(full[3]) - 4
    for a, b in zip(got[:3], full[:3]):
        assert rel_err(a, b) <= REL
    assert rel_err(got[3], full[3][4:]) <= REL


@pytest.mark.parametrize("hang", [False, True])
def test_spawn_fails_on_a_failed_rank(hang):
    """A rank that raises fails the parent at once, the other ranks killed
    in their collective; a rank that hangs fails it at the join timeout.
    The raising case has no join deadline: three interpreters importing
    torch on a loaded machine can take longer than the hanging case's 8 s,
    and the 40 s bound still catches a raise that does not reach the
    parent (the others would wait in their collective for
    ``dist.COLLECTIVE_TIMEOUT_S``, 60 s)."""
    import time

    failed = (torch.multiprocessing.ProcessRaisedException,
              torch.multiprocessing.ProcessExitedException)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError if hang else failed):
        dist.spawn(W.fail_rank, 3, "gloo", args=(hang,), device="cpu",
                   timeout_s=8 if hang else None)
    assert time.monotonic() - t0 < 40


def test_nccl_on_cpu_raises():
    with pytest.raises(ValueError, match="nccl"):
        dist.init(1, 0, "nccl", "file:///nonexistent", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        dist.init(1, 0, "mpi", "file:///nonexistent", device="cpu")


class _Joined(Exception):
    pass


@pytest.mark.parametrize("local_rank, want", [(None, 1), ("3", 3)])
def test_rank_card_is_current_device(monkeypatch, local_rank, want):
    """``dist.init`` makes the rank's card current (``LOCAL_RANK``, else
    the rank) before it joins the group, and ``require_cuda`` returns the
    current device, whatever ``LOCAL_RANK`` says; nccl with more ranks
    than cards raises. The card is simulated: four visible devices."""
    from emba_tpu_torch import device as tdevice

    current = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: current.__setitem__(0, torch.device(d).index))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])

    def joined(*a, **k):
        raise _Joined

    monkeypatch.setattr(dist.tdist, "init_process_group", joined)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert tdevice.require_cuda() == torch.device("cuda", 0)
    with pytest.raises(_Joined):
        dist.init(2, 1, "gloo", "file:///nonexistent", device="cuda")
    assert current[0] == want
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert tdevice.require_cuda() == torch.device("cuda", want)
    with pytest.raises(RuntimeError, match="needs 5 GPUs"):
        dist.init(5, 1, "nccl", "file:///nonexistent", device="cuda")
