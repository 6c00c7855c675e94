"""The harness's run of ``grambank_k5.ens64`` without its look for a card,
on the CPU at a tiny many-family size (binary features, 20 families, K = 5,
the cost-based geo prior) with the cell's own limits: a sound run is
correct, a traced one reports the initializer's two metrics, and each
fault of ``test_perfbench_faults.py``, planted in the timed path, makes
``correct`` false; so does the control."""
import copy
import time

import pytest

from perfbench_helpers import ROOT  # noqa: F401  (puts the repository on the path)
from perfbench import control, harness
from test_perfbench_faults import (altered_answer, altered_kernel, half_the_batch,  # noqa: F401
                                   restore_marginal, unchanged)

CELL = "grambank_k5.ens64"


def tiny_grambank() -> tuple:
    """(cell, config) of the cell at 60 objects x 10 binary features in 20
    families, K = 5, sizes 3-10, a few chains: the same harness path, the
    same limits."""
    cell, config = harness.load_cell(CELL)
    config = copy.deepcopy(config)
    config["data"].update(n_objects=60, n_features=10, n_families=20)
    config["model"]["prior"]["objects_per_cluster"].update(min=3, max=10)
    config["mcmc"]["initialization"].update(attempts=2, em_steps=5)
    cell = dict(cell, chains=8, check_chains=4, chunk=10, warmup_steps=20, op_time_rounds=1)
    return cell, config


def run(faults=None, seed=5, trace=False):
    cell, config = tiny_grambank()
    return harness.run(CELL, cell, config, seed, 0.5, trace, "cpu", time.perf_counter(),
                       faults)


def test_the_tiny_override_keeps_the_cells_shape():
    cell, config = tiny_grambank()
    full, full_config = harness.load_cell(CELL)
    assert config["data"]["generator"] == "large" and config["data"]["n_states"] == 2
    assert config["model"]["clusters"] == 5 and config["model"]["prior"]["geo"] == \
        full_config["model"]["prior"]["geo"]
    assert cell["limits"] == full["limits"] and cell["kind"] == "ensemble"


@pytest.mark.parametrize("seed", [5, 2**31 + 1])
def test_sound_run_is_correct(seed):
    res = run(seed=seed)
    assert res["correct"], res["rows"]


def test_traced_run_reports_the_initializer_metrics():
    import json

    res = run(seed=7, trace=True)
    assert res["correct"], res["rows"]
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in harness.cell_metrics(CELL, True, benchmark)]
    assert names == ["init_em_s", "init_peak_gb"]
    assert harness.reader("init_em_s")(res["ctx"]) > 0
    # a CPU run has no device peak: the reader reports none
    assert harness.reader("init_peak_gb")(res["ctx"]) is None
    e2e = {m["name"] for m in harness.cell_metrics(CELL, False, benchmark)}
    assert e2e == {"chain_steps_per_s", "peak_mem_gb", "setup_s"}


def test_readers_report_nothing_without_the_record(monkeypatch):
    from sbayes_tpu_torch.sampling import initializer

    monkeypatch.delattr(initializer, "record")
    assert harness.reader("init_em_s")(None) is None
    assert harness.reader("init_peak_gb")(None) is None


@pytest.mark.parametrize("fault", [unchanged, half_the_batch, altered_answer, altered_kernel],
                         ids=lambda f: f.__name__)
def test_fault_makes_correct_false(fault, restore_marginal):  # noqa: F811
    res = run(fault)
    assert not res["correct"], res["rows"]


def test_control_is_not_correct():
    from perfbench.compare import decide

    cell, config = tiny_grambank()
    res = run()
    numbers = control.control_numbers(res["ctx"].arrays, config, res["outputs"], "cpu")
    assert not decide(numbers, cell["limits"])[0], numbers
