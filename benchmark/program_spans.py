"""The program's own run records of the measured window's jobs: the spans
and counters ``emba_tpu_torch.obs`` keeps for each ``EmbaPipeline`` run
(``obs.runs()``, newest last), read by the metrics of the pipeline's host
stages and of the LM driver's graph cache.

The records are the window's jobs when the last ``len(ctx.jobs)`` of them
match the jobs in order: each record's ``window.events`` and ``lm.steps``
counters equal the job's events and LM iterations. Where the program keeps
no records (a program without ``obs.runs``) or they do not match, every
function here returns None.
"""

from __future__ import annotations


def records(ctx):
    """The run records of ``ctx.jobs``, in order, or None."""
    if not ctx.jobs:
        return None
    try:
        from emba_tpu_torch import obs
    except ImportError:
        return None
    runs = getattr(obs, "runs", None)
    if runs is None:
        return None
    recs = runs()[-len(ctx.jobs):]
    if len(recs) != len(ctx.jobs):
        return None
    for rec, job in zip(recs, ctx.jobs):
        if (rec.counters.get("window.events") != job["events"]
                or rec.counters.get("lm.steps") != job["iterations"]):
            return None
    return recs


def mean_ms(ctx, name: str):
    """The mean over the window's jobs of the summed milliseconds of the
    spans called ``name`` in each job's record; None where a record has
    none."""
    recs = records(ctx)
    if recs is None:
        return None
    totals = [rec.totals().get(name) for rec in recs]
    if any(t is None for t in totals):
        return None
    return 1e3 * sum(t["total_s"] for t in totals) / len(totals)


def counter_sum(ctx, name: str):
    """The sum over the window's jobs of each record's counter ``name``
    (0 where a record has none), or None."""
    recs = records(ctx)
    if recs is None:
        return None
    return sum(rec.counters.get(name, 0) for rec in recs)
