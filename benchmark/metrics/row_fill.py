"""row_fill: the share of the rows the Schur solve runs over that hold an
active pixel: 100 x the active rows of the window's forming passes (each
pass's active pixels, at most its row space) over the row space (the
program's counter ``plan.rows``, R_pad) times the passes, summed over the
window's jobs, in percent. None where a job's record counts no row space."""

from benchmark import program_spans


def read(ctx):
    recs = program_spans.records(ctx)
    if recs is None:
        return None
    held = total = 0
    for rec, job in zip(recs, ctx.jobs):
        rows = rec.counters.get("plan.rows")
        if not rows:
            return None
        held += sum(min(a, rows) for a in job["active_px_per_form"])
        total += rows * len(job["active_px_per_form"])
    return 100.0 * held / total if total else None
