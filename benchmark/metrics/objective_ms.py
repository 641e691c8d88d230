"""objective_ms: device time of the kernels the objective graph's replays
launch, per LM iteration, over the traced jobs (``trace.reduce``)."""


def read(ctx):
    s = (ctx.trace or {}).get("phase_s", {}).get("objective")
    iters = sum(j["iterations"] for j in ctx.jobs)
    return 1e3 * s / iters if s and iters else None
