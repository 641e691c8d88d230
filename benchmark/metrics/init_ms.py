"""init_ms: the pipeline's constructor (the program's span
``pipeline.init``: event sort and BA cut, the map's median filter, the
bearing LUT), mean over the window's jobs, in milliseconds."""

from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "pipeline.init")
