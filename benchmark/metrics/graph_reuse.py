"""graph_reuse: the share of the fused windows' graphed-loop lookups that
reused captured CUDA graphs (the program's counters ``lm.graph_hit`` and
``lm.graph_capture``), over the window's jobs, in percent. None where no
window looked one up (the CPU runs the loop eagerly)."""

from benchmark import program_spans


def read(ctx):
    hit = program_spans.counter_sum(ctx, "lm.graph_hit")
    capture = program_spans.counter_sum(ctx, "lm.graph_capture")
    if hit is None or hit + capture == 0:
        return None
    return 100.0 * hit / (hit + capture)
