"""peak_gib: the card's peak reserved memory over the program's jobs
(``torch.cuda.max_memory_reserved``, the peaks reset after the scene was
rendered), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
