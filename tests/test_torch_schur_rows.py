"""The Schur solve over the listed map rows (``kernels/schur_rows``' plain
versions and ``model.solve_normal_eq``) against the solve over every row of
the row space, as the port computed it before it listed the rows (kept
below as ``full_rows``), on the CPU.

Systems are random (numpy, seeded): A12 normal in the pose columns and
zero in the padding, 2x2 blocks of determinant about 1, A11 the active
rows' undamped Schur term plus a well-conditioned part (so S is positive
definite), and a share of active rows from none to all. The
listed rows add the same terms in another order, so float64 agrees to
1e-12 of each output's largest magnitude and float32 to 1e-5 (the
tolerance of the suite's other reordered f32 sums); x2 is exactly zero
on every row not listed.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)

from emba_tpu_torch import model as TM
from emba_tpu_torch.kernels import schur_rows as SR

R = 4096
FILLS = {"none": 0, "one": 1, "8%": 328, "29%": 1188, "all": R}


def system(fill: str, dp: int, dtype, seed: int = 0) -> TM.NormalEq:
    rng = np.random.default_rng(seed)
    dim = dp - 17  # 320 -> 303, 608 -> 591: padding columns besides the pose
    a12 = np.zeros((R, 2 * dp))
    a12[:, :dim] = rng.normal(size=(R, dim))
    a12[:, dp:dp + dim] = rng.normal(size=(R, dim))
    active = np.zeros(R, bool)
    active[rng.permutation(R)[:FILLS[fill]]] = True
    xx, xy, yy = 1.0 + rng.random(R), 0.5 * rng.random(R), 1.0 + rng.random(R)
    # A11 holds the undamped Schur term of the active rows, so S stays
    # positive definite, as the normal equations make it
    det = xx * yy - xy * xy
    w = active / det
    e, o = a12[:, :dim], a12[:, dp:dp + dim]
    ze, zo = e * (w * yy)[:, None] - o * (w * xy)[:, None], o * (w * xx)[:, None] - e * (
        w * xy)[:, None]
    b = rng.normal(size=(dim, dim))
    t = {k: torch.tensor(v, dtype=dtype) for k, v in dict(
        A11=e.T @ ze + o.T @ zo + b @ b.T + dim * np.eye(dim), b1=rng.normal(size=dim),
        a22_xx=xx, a22_xy=xy, a22_yy=yy, b2_x=rng.normal(size=R), b2_y=rng.normal(size=R),
        A12=a12).items()}
    act = torch.from_numpy(active)
    return TM.NormalEq(**t, active=act, pix2row=torch.zeros(1, dtype=torch.int32),
                       active_pix=act[:1], active_count=act.sum().to(torch.int32),
                       dropped=torch.zeros((), dtype=torch.int32))


def full_rows(neq: TM.NormalEq, lam: float, fix_first: bool):
    """(S_red, rhs_red, x1, x2) of the Schur solve over every row: the
    masked planes, their products with the per-row inverses, and the
    back substitution over all rows."""
    dt, dim = neq.b1.dtype, neq.b1.shape[0]
    dp = neq.A12.shape[1] // 2
    A11, b1 = neq.A11, neq.b1
    cols = torch.arange(dp)
    colmask = ((cols >= (3 if fix_first else 0)) & (cols < dim)).to(dt)
    if fix_first:
        m = (torch.arange(dim) >= 3).to(dt)
        A11 = A11 * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        b1 = b1 * m
    Ae, Ao = neq.A12[:, :dp] * colmask, neq.A12[:, dp:] * colmask
    a = neq.a22_xx * (1.0 + lam)
    b = neq.a22_xy
    c = neq.a22_yy * (1.0 + lam)
    det = a * c - b * b
    inv = (neq.active & (det.abs() >= 1e-30)).to(dt) / torch.where(
        det.abs() < 1e-30, torch.ones_like(det), det)
    m00, m01, m11 = c * inv, -b * inv, a * inv
    Ze, Zo = Ae * m00[:, None] + Ao * m01[:, None], Ae * m01[:, None] + Ao * m11[:, None]
    S_red = Ae.T @ Ze + Ao.T @ Zo
    rhs_red = (m00 * neq.b2_x + m01 * neq.b2_y) @ Ae + (m01 * neq.b2_x + m11 * neq.b2_y) @ Ao
    S = A11 + lam * torch.diag(torch.diag(A11)) - S_red[:dim, :dim]
    S = S + (1e-10 * torch.clamp(S.diag().max(), min=1.0) + 1e-30) * torch.eye(dim, dtype=dt)
    x1 = torch.cholesky_solve((b1 - rhs_red[:dim])[:, None], torch.linalg.cholesky(S))[:, 0]
    x1_pad = torch.nn.functional.pad(x1, (0, dp - dim))
    vx, vy = neq.b2_x - Ae @ x1_pad, neq.b2_y - Ao @ x1_pad
    return S_red, rhs_red, x1, torch.stack([m00 * vx + m01 * vy, m01 * vx + m11 * vy])


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-300))


def listed_parts(neq, lam, fix_first):
    """(S_red, rhs_red, rows, count, vectors) of the listed rows."""
    m00, m01, m11, live = TM._damped_a22_inv(neq, lam)
    rows, count = SR.row_list(live)
    vecs = (m00, m01, m11, neq.b2_x, neq.b2_y)
    lo = 3 if fix_first else 0
    S_red, rhs_red = SR.schur_reduce(neq.A12, rows, count, *vecs, lo, neq.b1.shape[0])
    return S_red, rhs_red, rows, count, vecs


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("dp", [320, 608])
@pytest.mark.parametrize("fix_first", [False, True])
@pytest.mark.parametrize("fill", list(FILLS))
def test_listed_rows_match_every_row(fill, fix_first, dp, dtype, tol):
    """S_red, rhs_red and x2 of the listed rows against the full-row
    formulas; in f64 the whole solve's x1 and x2 too (in f32 the Cholesky
    solve amplifies the reordered sums' rounding by cond(S)); x2 exactly
    zero on every unlisted row, and rows_total counts the listed rows."""
    neq = system(fill, dp, dtype, seed=dp + fix_first)
    lam = 1e-3
    want = full_rows(neq, lam, fix_first)
    S_red, rhs_red, rows, count, vecs = listed_parts(neq, lam, fix_first)
    assert int(count) == FILLS[fill]
    if FILLS[fill] == 0:
        assert not S_red.any() and not rhs_red.any()
    else:
        assert rel(S_red, want[0]) <= tol
        assert rel(rhs_red, want[1]) <= tol
    x1_pad = torch.nn.functional.pad(want[2], (0, dp - neq.b1.shape[0]))
    if fix_first:
        x1_pad[:3] = 0.0
    x2 = SR.back_substitute(neq.A12, rows, count, *vecs, x1_pad)
    assert not x2[:, ~neq.active].any()
    if FILLS[fill]:
        assert rel(x2, want[3]) <= tol
    total = torch.zeros((), dtype=torch.int64)
    x1, x2s = TM.solve_normal_eq(neq, lam, fix_first, rows_total=total)
    assert int(total) == FILLS[fill]
    assert not x2s[:, ~neq.active].any()
    if dtype == torch.float64:
        assert rel(x1, want[2]) <= tol
        if FILLS[fill]:
            assert rel(x2s, want[3]) <= tol


@pytest.mark.parametrize("mask", [[], [5], [0, 1, 2], [3, 7, 8, 11], list(range(12))],
                         ids=["empty", "one", "head", "scattered", "all"])
def test_row_list_is_ascending_then_the_rest(mask):
    """row_list: the listed rows ascending, then every other row ascending
    (a permutation), and their count as a 0-d int32 tensor."""
    m = torch.zeros(12, dtype=torch.bool)
    m[mask] = True
    rows, count = SR.row_list(m)
    assert rows.dtype == torch.int32 and count.dtype == torch.int32 and count.dim() == 0
    rest = [r for r in range(12) if r not in mask]
    assert rows.tolist() == sorted(mask) + rest and int(count) == len(mask)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_two_row_chunks_sum_to_the_whole(dtype, tol):
    """The map rows split in two chunks, as two ranks hold them: each
    chunk lists its own rows; their S_red and rhs_red parts sum to the
    whole's, and the solve of each chunk with the other's part as the
    ``reduce`` and the other's x2 as the ``gather`` gives the whole
    solve's x1 and x2 in f64 (the same x1 bits on both chunks)."""
    neq = system("8%", 320, dtype, seed=4)
    lam = 1e-3
    half = R // 2

    def chunk(lo, hi):
        return TM.NormalEq(
            A11=neq.A11, b1=neq.b1, a22_xx=neq.a22_xx[lo:hi], a22_xy=neq.a22_xy[lo:hi],
            a22_yy=neq.a22_yy[lo:hi], b2_x=neq.b2_x[lo:hi], b2_y=neq.b2_y[lo:hi],
            A12=neq.A12[lo:hi], active=neq.active[lo:hi], pix2row=neq.pix2row,
            active_pix=neq.active_pix, active_count=neq.active_count, dropped=neq.dropped)

    a, b = chunk(0, half), chunk(half, R)
    parts = [listed_parts(c, lam, True)[:2] for c in (a, b)]
    whole = listed_parts(neq, lam, True)[:2]
    for k in range(2):
        assert rel(parts[0][k] + parts[1][k], whole[k]) <= tol
    cat = [torch.cat([S, rhs[None]]) for S, rhs in parts]
    totals = [torch.zeros((), dtype=torch.int64) for _ in range(2)]
    x1a, x2a = TM.solve_normal_eq(a, lam, True, reduce=lambda t: t + cat[1],
                                  rows_total=totals[0])
    x1b, x2b = TM.solve_normal_eq(b, lam, True, reduce=lambda t: t + cat[0],
                                  rows_total=totals[1])
    assert torch.equal(x1a, x1b)
    _x1, x2 = TM.solve_normal_eq(a, lam, True, reduce=lambda t: t + cat[1],
                                 gather=lambda x: torch.cat([x, x2b], dim=1))
    assert torch.equal(x2, torch.cat([x2a, x2b], dim=1))
    x1w, x2w = TM.solve_normal_eq(neq, lam, True)
    if dtype == torch.float64:  # f32: the Cholesky solve amplifies by cond(S)
        assert rel(x1a, x1w) <= tol and rel(x2, x2w) <= tol
    assert int(totals[0] + totals[1]) == int(neq.active.sum())
