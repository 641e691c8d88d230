"""The active-row Schur kernel (``kernels/schur_rows``) on the card, at the
benchmark cells' shapes.

    python -m emba_tpu_torch.probes.schur_probe [--out PATH] [--reps N]

Each case is a synthetic system (seed 7) of R rows, dp_pad columns and
3K pose columns, of which a random share of rows is active, with damped
2x2 blocks of determinant about 1: the three cells' shapes and fills
(bicycle: R 2^19, dp_pad 320, 42k rows; boxes: 2^19, 608, 52k; dvx_4k:
2^21, 320, 600k), and bicycle's shape with every row active. For each:

* ``reduce_ms``, ``back_ms``, ``list_ms``: ``schur_reduce``,
  ``back_substitute`` and ``row_list`` timed with CUDA events (median of
  ``--reps``), replayed from a CUDA graph as the solve graph runs them;
* ``bound_ms``: the work S needs, its upper triangle over the c = 3K - 3
  live columns, 2 n c (c + 1) flops, at 67 TFLOP/s (the f32 FMA rate of an
  H100 SXM at 700 W), and ``share``, the bound over ``reduce_ms``;
  ``full_bound_ms`` and ``full_share``: the same for 4 n dp_pad^2 flops,
  the whole product over the padded columns;
* ``plain_ms``: ``schur_reduce_plain`` on the same f32 inputs, replayed;
* ``solve_ms``: the whole ``model.solve_normal_eq`` replayed from a graph,
  and ``full_rows_ms``: the same solve over every row of the row space, as
  the solve ran before it listed the rows (:func:`full_rows_solve`);
* ``s_err``, ``rhs_err``, ``x2_err``: the kernel's largest difference from
  a float64 sum over the listed rows, over that sum's largest magnitude
  (x2: over each row's |b2| + |a| . |x|), and ``bits_equal``, two calls.

It prints one JSON line a case and a last one with the card, and writes
them to PATH when ``--out`` is given. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import model as M
from ..device import card_name_and_power_limit, cuda_time_ms, full_precision, graph_time_ms
from ..device import require_cuda
from ..kernels import schur_rows as SR

F32_FMA_FLOPS = 67e12
CASES = (  # name, R, dp_pad, pose columns, listed rows
    ("bicycle", 1 << 19, 320, 291, 42_000),
    ("boxes", 1 << 19, 608, 603, 52_000),
    ("dvx_4k", 1 << 21, 320, 291, 600_000),
    ("bicycle_full", 1 << 19, 320, 291, 1 << 19),
)


def synthetic_system(r_pad, dp, dim, n, device, seed=7) -> M.NormalEq:
    """A NormalEq of R rows with ``n`` active ones at random, A12 normal in
    the pose columns and zero in the padding, damped blocks of determinant
    about 1, A11 diagonally dominant."""
    g = torch.Generator(device=device).manual_seed(seed)
    a12 = torch.zeros((r_pad, 2 * dp), device=device)
    a12[:, :dim] = torch.randn((r_pad, dim), generator=g, device=device)
    a12[:, dp:dp + dim] = torch.randn((r_pad, dim), generator=g, device=device)
    active = torch.zeros(r_pad, dtype=torch.bool, device=device)
    active[torch.randperm(r_pad, generator=g, device=device)[:n]] = True
    uni = [torch.rand(r_pad, generator=g, device=device) for _ in range(3)]
    a11 = torch.randn((dim, dim), generator=g, device=device)
    return M.NormalEq(
        A11=a11 @ a11.T + 4.0 * n * torch.eye(dim, device=device),
        b1=torch.randn(dim, generator=g, device=device),
        a22_xx=1.0 + uni[0], a22_xy=0.5 * uni[1], a22_yy=1.0 + uni[2],
        b2_x=torch.randn(r_pad, generator=g, device=device),
        b2_y=torch.randn(r_pad, generator=g, device=device),
        A12=a12, active=active, pix2row=torch.zeros(1, dtype=torch.int32, device=device),
        active_pix=active[:1], active_count=active.sum().to(torch.int32),
        dropped=torch.zeros((), dtype=torch.int32, device=device))


def full_rows_solve(neq: M.NormalEq, lam, fix_first: bool = False):
    """The Schur solve over every row of the row space, with the masked
    planes and products over all of them: what ``model.solve_normal_eq``
    computed before it listed the rows, kept as its yardstick."""
    dim, dp = neq.b1.shape[0], neq.A12.shape[1] // 2
    A11, b1, Ae, Ao = M._masked_planes(neq, fix_first)
    A11m = A11 + lam * torch.diag(torch.diag(A11))
    m00, m01, m11, _live = M._damped_a22_inv(neq, lam)
    Ze = Ae * m00[:, None] + Ao * m01[:, None]
    Zo = Ae * m01[:, None] + Ao * m11[:, None]
    S = A11m - (Ae.T @ Ze + Ao.T @ Zo)[:dim, :dim]
    rhs = b1 - ((m00 * neq.b2_x + m01 * neq.b2_y) @ Ae
                + (m01 * neq.b2_x + m11 * neq.b2_y) @ Ao)[:dim]
    eps = 1e-10 * torch.clamp(torch.max(torch.diag(S)), min=1.0) + 1e-30
    S = S + eps * torch.eye(dim, dtype=S.dtype, device=S.device)
    x1 = torch.cholesky_solve(rhs[:, None], torch.linalg.cholesky_ex(S).L)[:, 0]
    x1_pad = torch.nn.functional.pad(x1, (0, dp - dim))
    vx = neq.b2_x - Ae @ x1_pad
    vy = neq.b2_y - Ao @ x1_pad
    return x1, torch.stack([m00 * vx + m01 * vy, m01 * vx + m11 * vy])


def listed_f64(neq, rows, count, vecs, lo, hi, x):
    """(S, rhs, x2 on the listed rows, x2's scale) in float64 over the
    listed rows only (one host read of the count)."""
    n = int(count)
    r = rows[:n].long()
    dp = neq.A12.shape[1] // 2
    g = neq.A12[r].double()
    cols = torch.arange(dp, device=g.device)
    cm = ((cols >= lo) & (cols < hi)).double()
    a, o = g[:, :dp] * cm, g[:, dp:] * cm
    m00, m01, m11, bx, by = (v[r].double() for v in vecs)
    S = a.T @ (a * m00[:, None] + o * m01[:, None]) + o.T @ (a * m01[:, None]
                                                             + o * m11[:, None])
    rhs = (m00 * bx + m01 * by) @ a + (m01 * bx + m11 * by) @ o
    xd = x.double()
    vx, vy = bx - g[:, :dp] @ xd, by - g[:, dp:] @ xd
    x2 = torch.stack([m00 * vx + m01 * vy, m01 * vx + m11 * vy])
    scale = torch.stack([bx.abs() + g[:, :dp].abs() @ xd.abs(),
                         by.abs() + g[:, dp:].abs() @ xd.abs()])
    scale = scale * torch.stack([m00.abs() + m01.abs(), m01.abs() + m11.abs()])
    return S, rhs, x2, scale, r


def run_case(name, r_pad, dp, dim, n, device, reps):
    neq = synthetic_system(r_pad, dp, dim, n, device)
    lam = torch.tensor(1e-3, device=device)
    m00, m01, m11, live = M._damped_a22_inv(neq, lam)
    rows, count = SR.row_list(live)
    vecs = (m00, m01, m11, neq.b2_x, neq.b2_y)
    lo, hi = 3, dim
    x = torch.zeros(dp, device=device)
    x[lo:hi] = torch.randn(hi - lo, generator=torch.Generator(device=device).manual_seed(3),
                           device=device) * 1e-2
    S, rhs = SR.schur_reduce(neq.A12, rows, count, *vecs, lo, hi)
    S2, rhs2 = SR.schur_reduce(neq.A12, rows, count, *vecs, lo, hi)
    x2 = SR.back_substitute(neq.A12, rows, count, *vecs, x)
    x2b = SR.back_substitute(neq.A12, rows, count, *vecs, x)
    torch.cuda.synchronize()
    Sd, rhsd, x2d, x2s, r = listed_f64(neq, rows, count, vecs, lo, hi, x)
    others = torch.ones(r_pad, dtype=torch.bool, device=device)
    others[r] = False
    out = dict(
        case=name, rows=r_pad, dp_pad=dp, pose_cols=dim, listed=int(count),
        s_err=float((S.double() - Sd).abs().max() / Sd.abs().max()),
        s_symmetric=bool(torch.equal(S, S.T)),
        rhs_err=float((rhs.double() - rhsd).abs().max() / rhsd.abs().max()),
        x2_err=float(((x2[:, r].double() - x2d).abs() / x2s.clamp(min=1e-30)).max()),
        x2_zero_elsewhere=bool((x2[:, others] == 0).all()),
        bits_equal=bool(torch.equal(S, S2) and torch.equal(rhs, rhs2)
                        and torch.equal(x2, x2b)),
    )
    del Sd, rhsd, x2d, x2s, r, others
    out["list_ms"] = graph_time_ms(lambda: SR.row_list(live), reps)
    out["reduce_ms"] = graph_time_ms(
        lambda: SR.schur_reduce(neq.A12, rows, count, *vecs, lo, hi), reps)
    out["back_ms"] = graph_time_ms(
        lambda: SR.back_substitute(neq.A12, rows, count, *vecs, x), reps)
    out["reduce_eager_ms"] = cuda_time_ms(
        lambda: SR.schur_reduce(neq.A12, rows, count, *vecs, lo, hi), reps)
    c = hi - lo
    out["bound_ms"] = 2.0 * int(count) * c * (c + 1) / F32_FMA_FLOPS * 1e3
    out["share"] = out["bound_ms"] / out["reduce_ms"]
    out["full_bound_ms"] = 4.0 * int(count) * dp * dp / F32_FMA_FLOPS * 1e3
    out["full_share"] = out["full_bound_ms"] / out["reduce_ms"]
    out["plain_ms"] = graph_time_ms(
        lambda: SR.schur_reduce_plain(neq.A12, rows, count, *vecs, lo, hi), reps)
    out["solve_ms"] = graph_time_ms(lambda: M.solve_normal_eq(neq, lam, True), reps)
    out["full_rows_ms"] = graph_time_ms(lambda: full_rows_solve(neq, lam, True), reps)
    x1n, x2n = M.solve_normal_eq(neq, lam, True)
    x1f, x2f = full_rows_solve(neq, lam, True)
    out["x1_vs_full_rows"] = float((x1n - x1f).abs().max() / x1f.abs().max())
    out["x2_vs_full_rows"] = float((x2n - x2f).abs().max() / x2f.abs().max())
    out["splits"] = SR._splits(device.index, dp)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES))
    args = ap.parse_args(argv)
    device = require_cuda()
    full_precision()
    lines = []
    for case in CASES:
        if case[0] in args.cases.split(","):
            line = run_case(*case, device=device, reps=args.reps)
            print(json.dumps(line), flush=True)
            lines.append(line)
            torch.cuda.empty_cache()
    last = dict(device=dict(name=torch.cuda.get_device_name(device),
                            smi=card_name_and_power_limit()),
                launches=SR.launches)
    print(json.dumps(last))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines + [last]) + "\n")
    return last


if __name__ == "__main__":
    main()
