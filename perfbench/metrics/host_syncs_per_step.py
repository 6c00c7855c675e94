"""Host-device synchronisations of the program per step in the profiled
chunk: the ``sbt.sync/*`` spans on the window's thread / its steps (each
span wraps one read of the device where the host waits for the card).
None where the program has no spans."""
from perfbench.spans import SYNC, named, program_spans


def read(ctx):
    spans = program_spans(ctx.profile)
    if spans is None:
        return None
    return len(named(spans, SYNC)) / ctx.profile.steps
