"""Device time of the sequential source sweep per step of the profiled
chunk, in ms: the kernels, copies and fills whose launch (a
``cudaGraphLaunch`` of a replayed step, or each launch of an eager one)
the host made inside an ``sbt.sweep`` span on the window's thread, matched
to the device operations by the profiler's correlation id, summed and
divided by the chunk's steps (every step, not only the sweep's). None
where the program has no ``sbt.sweep`` span in the chunk."""
from perfbench.spans import interval, named, program_spans

SWEEP = "sbt.sweep"


def correlation(e):
    return (e.get("args") or {}).get("correlation")


def read(ctx):
    spans = program_spans(ctx.profile)
    sweeps = [] if spans is None else [interval(e) for e in named(spans, SWEEP)]
    if not sweeps:
        return None
    tid = named(spans, SWEEP)[0].get("tid")
    launched = {correlation(e) for e in ctx.profile.host
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("tid") == tid
                and any(s <= float(e["ts"]) <= t for s, t in sweeps)}
    launched.discard(None)
    dur = sum(float(e["dur"]) for e in ctx.profile.device if correlation(e) in launched)
    return 1e-3 * dur / ctx.profile.steps
