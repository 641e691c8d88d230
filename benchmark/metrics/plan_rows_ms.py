"""plan_rows_ms: the sizing of a deferred compaction cap (the program's
span ``window.plan_rows``: the active pixels counted on the device at the
first window's start state, and the plan from them), mean over the
window's jobs, in milliseconds. None where a job's record has no such span
(its row space fitted without a count)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "window.plan_rows")
