"""The harness's run without its look for a card, on the CPU at a tiny size
with the cells' own limits: a sound run is correct, and each fault that
such a cell can have, planted in the timed path, makes ``correct`` false;
so does the control (the reference in bfloat16 in the program's place)."""
import subprocess
import sys
import time

import pytest
import torch

from perfbench_helpers import ROOT, tiny_cell
from perfbench import control, harness

CELLS = ["sa100_k3.ens1024", "sa100_k3.mc3_4"]


def run(name, faults=None, seed=5):
    cell, config = tiny_cell(name)
    return harness.run(name, cell, config, seed, 0.5, False, "cpu", time.perf_counter(),
                       faults)


def wrap_apply(rt, change):
    """Route every MH step of ``rt`` through ``change(old, new)``."""
    original = rt.apply_fn

    def apply_fn(temps=None, prior_temps=None):
        apply = original(temps, prior_temps)

        def step(op, gen, states):
            new, accept, step_size, nf = apply(op, gen, states)
            return change(states, new), accept, step_size, nf
        return step

    rt.apply_fn = apply_fn


def unchanged(rt):
    wrap_apply(rt, lambda old, new: old)


def half_the_batch(rt):
    def change(old, new):
        keep = torch.arange(new.n_chains) < new.n_chains // 2
        return new.where(keep, old)
    wrap_apply(rt, change)


def altered_answer(rt):
    def change(old, new):
        bump = torch.zeros_like(new.log_lh)
        bump[0] = 0.5
        return new._replace(log_lh=new.log_lh + bump)
    wrap_apply(rt, change)


def altered_kernel(rt):
    from sbayes_tpu_torch.ops import marginal

    plain = marginal.marginal_plain

    def off(*args, **kw):
        return plain(*args, **kw) * 1.001
    marginal.marginal_plain = off


@pytest.fixture
def restore_marginal():
    from sbayes_tpu_torch.ops import marginal

    plain = marginal.marginal_plain
    yield
    marginal.marginal_plain = plain


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["rows"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_profiles_a_chunk_of_the_entry(name):
    cell, config = tiny_cell(name)
    res = harness.run(name, cell, config, 7, 0.5, True, "cpu", time.perf_counter())
    ctx = res["ctx"]
    assert res["correct"], res["rows"]
    assert ctx.profile.steps == cell["chunk"] and ctx.profile.window_s > 0
    assert len(ctx.op_ms) == len(set(ctx.op_ms)) and all(v > 0 for v in ctx.op_ms.values())


@pytest.mark.parametrize("fault", [unchanged, half_the_batch, altered_answer, altered_kernel],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_correct_false(name, fault, restore_marginal):
    res = run(name, fault)
    assert not res["correct"], res["rows"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    from perfbench.compare import decide

    cell, config = tiny_cell(name)
    res = run(name)
    numbers = control.control_numbers(res["ctx"].arrays, config, res["outputs"], "cpu")
    assert not decide(numbers, cell["limits"])[0], numbers


def test_no_result_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "sa100_k3.mc3_4",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "sa100_k3.mc3_4",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed",
                          "2147483647", "--seconds", "3", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
