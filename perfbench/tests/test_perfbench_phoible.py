"""The harness's run of ``phoible_k5.ens32`` without its look for a card, on
the CPU at a tiny PHOIBLE-like size (60 objects x 601 binary features in 12
families, K = 5, the cost-based geo prior) with every switch of the cell's
path on: the packed source and ragged feature tiles (forced through the
port's two rules: tiles of 128, the last of 89), the source sweep and the
log-space jump (on from 512 features). With the cell's own limits a sound
run is correct, a traced one reports every metric ``BENCHMARK.json`` lists
for the cell, and each fault of ``test_perfbench_faults.py``, planted in the
timed path, makes ``correct`` false; so does the control. The two readers
of the cell (``tile_passes_per_step``, ``sweep_ms_per_step``) on the
program's record and on a hand-built trace."""
import copy
import json
import time

import pytest

from perfbench_helpers import ROOT  # noqa: F401  (puts the repository on the path)
from perfbench import control, harness
from perfbench.harness import Context
from perfbench.tracing import WINDOW, Window
from test_perfbench_faults import (altered_answer, altered_kernel, half_the_batch,  # noqa: F401
                                   restore_marginal, unchanged)

CELL = "phoible_k5.ens32"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_phoible() -> tuple:
    """(cell, config) of the cell at 60 objects x 601 binary features in 12
    families, K = 5, sizes 3-10, a few chains: the same harness path, the
    same limits. The cell's chunks of 50 steps hold a sweep step but with
    probability 0.8^50 (the source operators take a fifth of the steps)."""
    cell, config = harness.load_cell(CELL)
    config = copy.deepcopy(config)
    config["data"].update(n_objects=60, n_features=601, n_families=12)
    config["model"]["prior"]["objects_per_cluster"].update(min=3, max=10)
    config["mcmc"]["initialization"].update(attempts=2, em_steps=5)
    cell = dict(cell, chains=6, check_chains=3, chunk=50, warmup_steps=20, op_time_rounds=1)
    return cell, config


@pytest.fixture
def switches(monkeypatch):
    """The packed source and tiles of 128 at the tiny size (the rules keep
    both for large models); what each run's runtime took, in a dict."""
    from sbayes_tpu_torch.model import constants

    monkeypatch.setattr(constants, "auto_source_packed", lambda *a, **k: True)
    monkeypatch.setattr(constants, "auto_feature_chunk", lambda *a, **k: 128)
    return {}


def run(seen: dict, fault=None, seed=5, trace=False):
    cell, config = tiny_phoible()

    def faults(rt):
        seen.update(packed=rt.consts.source_packed, chunk=rt.consts.feature_chunk,
                    sweeps=sum(s.sweep for s in rt._op_specs))
        if fault is not None:
            fault(rt)

    return harness.run(CELL, cell, config, seed, 0.5, trace, "cpu", time.perf_counter(), faults)


def test_the_tiny_override_keeps_the_cells_shape():
    cell, config = tiny_phoible()
    full, full_config = harness.load_cell(CELL)
    assert config["data"]["generator"] == "large" and config["data"]["n_states"] == 2
    assert config["data"]["na_fraction"] == 0.0 and full_config["data"]["n_features"] == 3183
    assert config["model"]["clusters"] == 5 and config["model"]["prior"]["geo"] == \
        full_config["model"]["prior"]["geo"]
    assert cell["limits"] == full["limits"] and cell["kind"] == "ensemble"
    assert (full["chains"], full["chunk"], full["warmup_steps"], full["check_chains"]) == \
        (32, 50, 100, 8)


@pytest.mark.parametrize("seed", [5, 2**31 + 1])
def test_sound_run_is_correct(switches, seed):
    res = run(switches, seed=seed)
    assert res["correct"], res["rows"]
    assert switches == {"packed": True, "chunk": 128, "sweeps": 2}
    assert res["outputs"][0]["source"].dtype.name == "int8"


def test_traced_run_reports_every_listed_metric(switches):
    res = run(switches, seed=7, trace=True)
    assert res["correct"], res["rows"]
    for trace in (False, True):
        listed = harness.cell_metrics(CELL, trace, BENCH)
        assert listed
        for m in listed:
            assert harness.reader(m["name"])(res["ctx"]) is not None, m["name"]
    names = {m["name"] for m in harness.cell_metrics(CELL, True, BENCH)}
    assert {"tile_passes_per_step", "sweep_ms_per_step"} <= names
    # no CUDA launch on the CPU: the sweep's spans are there, with no device time
    assert harness.reader("sweep_ms_per_step")(res["ctx"]) == 0.0
    assert harness.reader("tile_passes_per_step")(res["ctx"]) >= 0.0


@pytest.mark.parametrize("fault", [unchanged, half_the_batch, altered_answer, altered_kernel],
                         ids=lambda f: f.__name__)
def test_fault_makes_correct_false(switches, fault, restore_marginal):  # noqa: F811
    res = run(switches, fault)
    assert not res["correct"], res["rows"]


def test_control_is_not_correct(switches):
    from perfbench.compare import decide

    cell, config = tiny_phoible()
    res = run(switches)
    numbers = control.control_numbers(res["ctx"].arrays, config, res["outputs"], "cpu")
    assert not decide(numbers, cell["limits"])[0], numbers


def test_tile_passes_reader_reads_the_programs_record(monkeypatch):
    from sbayes_tpu_torch import tracing

    monkeypatch.setattr(tracing, "profiled", tracing.ProfiledRecord(steps=50, tile_passes=35))
    assert harness.reader("tile_passes_per_step")(None) == 0.7
    monkeypatch.setattr(tracing, "profiled", tracing.ProfiledRecord())
    assert harness.reader("tile_passes_per_step")(None) is None
    monkeypatch.delattr(tracing, "profiled")
    assert harness.reader("tile_passes_per_step")(None) is None


def x(name, ts, end, cat="user_annotation", tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_sweep_reader_on_a_hand_built_trace():
    """Two sweep steps, one replayed (a graph launch whose three kernels share
    its correlation id) and one eager (two launches): their device time,
    and none of the launches outside ``sbt.sweep`` or on another thread."""
    steps = 4
    events = [
        x(WINDOW, 0, 1000), x("sbt.chunk", 10, 990),
        x("sbt.sweep", 100, 200), x("sbt.graph", 110, 190),
        x("cudaGraphLaunch", 120, 130, "cuda_runtime", corr=7),
        x("sbt.sweep", 300, 400),
        x("cudaLaunchKernel", 310, 315, "cuda_runtime", corr=8),
        x("cudaLaunchKernel", 320, 325, "cuda_runtime", corr=9),
        x("cudaGraphLaunch", 500, 510, "cuda_runtime", corr=10),        # not in a sweep
        x("sbt.sweep", 600, 700, tid=2),
        x("cudaLaunchKernel", 610, 615, "cuda_runtime", tid=2, corr=11),  # another thread
        x("k", 130, 150, "kernel", 7, corr=7), x("k", 150, 170, "kernel", 7, corr=7),
        x("m", 170, 176, "gpu_memcpy", 7, corr=7),
        x("k", 330, 340, "kernel", 7, corr=8), x("k", 340, 344, "kernel", 7, corr=9),
        x("k", 520, 620, "kernel", 7, corr=10), x("k", 620, 700, "kernel", 7, corr=11),
    ]
    ctx = Context(profile=Window(events, steps))
    assert harness.reader("sweep_ms_per_step")(ctx) == pytest.approx(
        1e-3 * (20 + 20 + 6 + 10 + 4) / steps)
    plain = [e for e in events if e["name"] != "sbt.sweep"]
    assert harness.reader("sweep_ms_per_step")(Context(profile=Window(plain, steps))) is None
    assert harness.reader("sweep_ms_per_step")(Context(profile=None)) is None
