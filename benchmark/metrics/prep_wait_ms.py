"""prep_wait_ms: the time the pipeline's loop waited for the window
preparation (the program's spans ``window.prep_wait``), summed over a job's
windows, mean over the window's jobs, in milliseconds."""

from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "window.prep_wait")
