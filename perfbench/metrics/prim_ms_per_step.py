"""Host time in the batched Prim per step of the profiled chunk: the union
of the ``sbt.prim`` spans on the window's thread (its size read included)
/ its steps, in ms. None where the program has no spans."""
from perfbench.spans import PRIM, interval, length, named, program_spans


def read(ctx):
    spans = program_spans(ctx.profile)
    if spans is None:
        return None
    return 1e-3 * length(interval(e) for e in named(spans, PRIM)) / ctx.profile.steps
