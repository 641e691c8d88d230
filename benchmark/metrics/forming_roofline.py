"""forming_roofline: the forming passes' least time on the card
(``counts.forming.pass_bound_s`` of each pass's weighted measurements and
active rows) over the device time of the kernels the form graph's replays
launch, over the traced jobs, in percent."""

from benchmark.counts import forming


def read(ctx):
    s = (ctx.trace or {}).get("phase_s", {}).get("form")
    if not s:
        return None
    bound = 0.0
    for j in ctx.jobs:
        if j.get("weighted") is None:
            return None
        for rows in j["active_px_per_form"]:
            bound += forming.pass_bound_s(j["weighted"], rows, j["dim_pose"])
    return 100.0 * bound / s
