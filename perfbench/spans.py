"""The program's own spans in a profiled window (``sbayes_tpu_torch/
tracing.py``: ``sbt.chunk``, ``sbt.op/<operator>``, ``sbt.prim``,
``sbt.swap_phase``, ``sbt.sync/<place>``), as the span metrics read them.

Only the spans of the window's thread count. ``Window`` keeps the spans
inside the window but not the window's own event, so its thread is found
as that of the longest ``sbt.chunk`` span: the harness's one call of the
chunk entry, which opens first and holds every other span of the chunk.
A window without any ``sbt.chunk`` span (a program without spans) has no
program spans: the readers then return None."""
from __future__ import annotations

from perfbench.tracing import merge

CHUNK = "sbt.chunk"
SYNC = "sbt.sync/"
PRIM = "sbt.prim"
SWAP = "sbt.swap_phase"


def interval(e) -> tuple:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def program_spans(win):
    """The program's spans on the window's thread, or None without any (or
    without a profiled window)."""
    chunks = [] if win is None else [e for e in win.spans if e.get("name") == CHUNK]
    if not chunks:
        return None
    tid = max(chunks, key=lambda e: float(e["dur"])).get("tid")
    return [e for e in win.spans if e.get("tid") == tid
            and str(e.get("name", "")).startswith("sbt.")]


def named(spans, name: str) -> list:
    """The spans called ``name``, or whose name starts with it if it ends in
    a slash."""
    if name.endswith("/"):
        return [e for e in spans if e["name"].startswith(name)]
    return [e for e in spans if e["name"] == name]


def length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merge(intervals))


def overlap(a, b) -> float:
    """The length of the intersection of the unions of two interval lists."""
    a, b = merge(a), merge(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(win) -> list:
    """The device's idle intervals in the window: its complement of ``busy``."""
    edges = [win.t0] + [x for iv in win.busy for x in iv] + [win.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
