"""Mean duration of an MC3 swap phase in the profiled chunk (which holds
one): the ``sbt.swap_phase`` spans on the window's thread, in ms. None
where the program has no spans or the chunk no swap phase."""
from perfbench.spans import SWAP, named, program_spans


def read(ctx):
    spans = program_spans(ctx.profile)
    phases = [] if spans is None else named(spans, SWAP)
    if not phases:
        return None
    return 1e-3 * sum(float(e["dur"]) for e in phases) / len(phases)
