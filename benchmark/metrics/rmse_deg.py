"""rmse_deg: the mean over the window's jobs of the refined trajectory's
rotation RMSE against the rendered ground truth at the front-end's pose
times inside the refined span, in degrees (``reference.rmse``)."""


def read(ctx):
    vals = [j["rmse_deg"] for j in ctx.jobs]
    return sum(vals) / len(vals) if vals else None
