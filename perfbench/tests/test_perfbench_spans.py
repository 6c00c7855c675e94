"""The six readers of the program's spans (``metrics/host_syncs_per_step``,
``sync_wait_ms_per_step``, ``dispatch_ms_per_step``, ``prim_ms_per_step``,
``swap_phase_ms``, ``idle_outside_program_share``) on a ``Window`` made of
hand-built complete events, with answers worked out by hand: nested and
overlapping syncs count once in the union, spans of another thread are
ignored, an idle gap half covered by ``sbt.chunk`` counts half, and a
window without program spans reads None."""
import pytest

from perfbench_helpers import ROOT  # noqa: F401  (puts the repository on the path)

from perfbench import harness
from perfbench.harness import Context
from perfbench.tracing import WINDOW, Window

READERS = ("host_syncs_per_step", "sync_wait_ms_per_step", "dispatch_ms_per_step",
           "prim_ms_per_step", "swap_phase_ms", "idle_outside_program_share")
STEPS = 4


def x(name, ts, end, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": tid}


# Window 0-1000 us on thread 1; the device busy 20-60, 140-900, 940-960, so
# idle 0-20, 60-140, 900-940, 960-1000.
DEVICE = [x("k1", 20, 60, "kernel", 7), x("k2", 140, 900, "kernel", 7),
          x("k3", 940, 960, "kernel", 7)]
PROGRAM = [
    x("sbt.chunk", 100, 900), x("sbt.chunk", 150, 850),       # nested entries: union 100-900
    x("sbt.op/a", 150, 450), x("sbt.op/b", 450, 850),
    x("sbt.prim", 200, 300), x("sbt.sync/mst.size", 250, 280),
    x("sbt.sync/x", 500, 600), x("sbt.sync/y", 550, 650),     # overlapping: union 500-650
    x("sbt.swap_phase", 700, 740), x("sbt.swap_phase", 800, 860),
]
OTHER_THREAD = [x("sbt.chunk", 200, 800, tid=2), x("sbt.sync/z", 300, 400, tid=2),
                x("sbt.prim", 300, 350, tid=2), x("sbt.swap_phase", 400, 500, tid=2)]
EXPECTED = {
    "host_syncs_per_step": 3 / STEPS,
    "sync_wait_ms_per_step": 1e-3 * (30 + 150) / STEPS,
    "dispatch_ms_per_step": 1e-3 * (800 - 180) / STEPS,
    "prim_ms_per_step": 1e-3 * 100 / STEPS,
    "swap_phase_ms": 1e-3 * (40 + 60) / 2,
    # idle outside 100-900: 0-20, 60-100 (half the gap 60-140), 900-940, 960-1000
    "idle_outside_program_share": 100.0 * (20 + 40 + 40 + 40) / 1000,
}


def context(*spans) -> Context:
    events = [x(WINDOW, 0, 1000)] + DEVICE + [e for group in spans for e in group]
    return Context(profile=Window(events, STEPS))


@pytest.mark.parametrize("name", READERS)
def test_reader_on_known_spans(name):
    assert harness.reader(name)(context(PROGRAM)) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_spans_of_another_thread_are_ignored(name):
    got = harness.reader(name)(context(OTHER_THREAD, PROGRAM))
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_no_program_spans_reads_none(name):
    assert harness.reader(name)(context()) is None
    assert harness.reader(name)(context([x("other.span", 100, 200)])) is None
    assert harness.reader(name)(Context(profile=None)) is None


def test_no_sync_or_prim_in_a_chunk_reads_zero():
    ctx = context([x("sbt.chunk", 0, 1000), x("sbt.op/a", 0, 1000)])
    assert harness.reader("host_syncs_per_step")(ctx) == 0
    assert harness.reader("sync_wait_ms_per_step")(ctx) == 0
    assert harness.reader("prim_ms_per_step")(ctx) == 0
    assert harness.reader("dispatch_ms_per_step")(ctx) == pytest.approx(1e-3 * 1000 / STEPS)
    assert harness.reader("idle_outside_program_share")(ctx) == 0
    assert harness.reader("swap_phase_ms")(ctx) is None
