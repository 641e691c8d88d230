"""device_idle: the share of the traced window in which no operation ran
on the device (``torch.profiler``, CUDA activity: 1 - busy / window), in
percent."""


def read(ctx):
    tr = ctx.trace or {}
    if not tr.get("window_s") or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
