"""job_s: the measured window's wall over the jobs completed in it (host
clock; the window ends at the first job boundary after its seconds)."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs) if ctx.jobs else None
