"""prep_ms: the window preparation's busy time on the pipeline's worker
thread (the program's spans ``window.prepare``: event cut, pose fit,
pairing), summed over a job's windows, mean over the window's jobs, in
milliseconds."""

from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "window.prepare")
