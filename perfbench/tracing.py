"""The device trace of a profiled window, read from torch.profiler's
Chrome trace: device operations (kernels, copies, fills), the benchmark's
own spans (``record_function``) and the host operations beside them."""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"


def read_chrome_trace(prof) -> list:
    """The complete events ("ph" X) of a finished ``torch.profiler.profile``,
    through a file in the temporary directory that is removed after."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]


def merge(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


_MANGLED = re.compile(r"marginal_kernelILb([01])ELb([01])ELb([01])E")
_PLAIN = re.compile(r"marginal_kernel<\s*(true|false)\s*,\s*(true|false)\s*,\s*(true|false)")


def marginal_variant(name: str):
    """(ratio, heat, two_eff) of a marginal kernel's name, or None."""
    m = _PLAIN.search(name)
    if m:
        return tuple(x == "true" for x in m.groups())
    m = _MANGLED.search(name)
    if m:
        return tuple(x == "1" for x in m.groups())
    return None


class Window:
    """One profiled window: the device operations inside the benchmark's
    ``perfbench.window`` span, the union of their busy intervals, and the
    spans and host operations that explain the idle gaps between them."""

    def __init__(self, events: list, steps: int):
        wins = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not wins:
            raise RuntimeError("the profiled window's span is missing from the trace")
        w = wins[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.steps = steps
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and self.t0 <= float(e["ts"]) <= self.t1]
        self.spans = [e for e in events if e.get("cat") == "user_annotation"
                      and e.get("name") != WINDOW and self.t0 <= float(e["ts"]) <= self.t1]
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and self.t0 <= float(e["ts"]) <= self.t1]
        # Device work may run past the span's end (the window ends in a sync,
        # so only the last operation's tail): busy and window both end there.
        ends = [float(e["ts"]) + float(e["dur"]) for e in self.device]
        self.t1 = max([self.t1] + ends)
        self.busy = merge((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def kernels(self, pattern: str = None) -> list:
        return [e for e in self.device if e.get("cat") == "kernel"
                and (pattern is None or pattern in e.get("name", ""))]

    def top_device_ops(self, n: int = 10) -> list:
        total = defaultdict(float)
        for e in self.device:
            total[e.get("name", "?")[:96]] += float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def _innermost(self, events, t):
        inside = [e for e in events if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
        return min(inside, key=lambda e: float(e["dur"]))["name"] if inside else None

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest idle gaps of the device, each named by the
        benchmark's span around it and the innermost host operation that
        ran at its middle (what the host was doing while the card waited)."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            span = self._innermost(self.spans, mid) or "window"
            host = self._innermost(self.host, mid) or "python"
            out.append([f"{span} / {host}", (e - s) * 1e-6])
        return out
