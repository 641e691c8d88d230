"""solve_ms: device time of the kernels the solve graph's replays launch
(the Schur solve and the trial state), per LM iteration, over the traced
jobs (``trace.reduce``)."""


def read(ctx):
    s = (ctx.trace or {}).get("phase_s", {}).get("solve")
    iters = sum(j["iterations"] for j in ctx.jobs)
    return 1e3 * s / iters if s and iters else None
