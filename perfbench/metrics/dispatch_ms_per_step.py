"""Host time in the program that is not spent waiting on the card, per
step of the profiled chunk: the union of the ``sbt.chunk`` spans on the
window's thread less the part of it that ``sbt.sync/*`` spans cover / its
steps, in ms. What a CUDA graph or a fused step would remove. None where
the program has no spans."""
from perfbench.spans import CHUNK, SYNC, interval, length, named, overlap, program_spans


def read(ctx):
    spans = program_spans(ctx.profile)
    if spans is None:
        return None
    chunks = [interval(e) for e in named(spans, CHUNK)]
    syncs = [interval(e) for e in named(spans, SYNC)]
    return 1e-3 * (length(chunks) - overlap(chunks, syncs)) / ctx.profile.steps
