"""Host time blocked on the card per step in the profiled chunk: the union
of the ``sbt.sync/*`` spans on the window's thread (nested or overlapping
ones counted once) / its steps, in ms. None where the program has no
spans."""
from perfbench.spans import SYNC, interval, length, named, program_spans


def read(ctx):
    spans = program_spans(ctx.profile)
    if spans is None:
        return None
    return 1e-3 * length(interval(e) for e in named(spans, SYNC)) / ctx.profile.steps
