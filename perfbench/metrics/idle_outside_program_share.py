"""Device-idle time in the profiled chunk that no ``sbt.chunk`` span of
the window's thread covers / the window, in %: idle that the program's
code cannot explain (the harness, the profiler, the interpreter). None
where the program has no spans or the window no device operation."""
from perfbench.spans import CHUNK, idle, interval, length, named, overlap, program_spans


def read(ctx):
    win = ctx.profile
    spans = None if win is None or not win.device else program_spans(win)
    if spans is None:
        return None
    gaps = idle(win)
    outside = length(gaps) - overlap(gaps, [interval(e) for e in named(spans, CHUNK)])
    return 100.0 * outside / (win.t1 - win.t0)
