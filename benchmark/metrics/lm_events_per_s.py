"""lm_events_per_s: events times LM iterations over the LM loop's seconds
(each window's ``LMStats.time_total_s`` less its set-up), summed over the
window's jobs."""


def read(ctx):
    loop = sum(j["solve_s"] - j["setup_s"] for j in ctx.jobs)
    if loop <= 0:
        return None
    return sum(j["events"] * j["iterations"] for j in ctx.jobs) / loop
