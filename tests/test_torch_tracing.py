"""The port's spans (``sbayes_tpu_torch/tracing.py``) on the CPU: no span
without a profiler; under ``torch.profiler`` one ``sbt.op/<name>`` span a
step in the drawn order, nested as the readers of the benchmark expect
(``sbt.op``, ``sbt.prim`` and ``sbt.sync/*`` inside ``sbt.chunk``,
``sbt.prim`` inside ``sbt.op``); the same bits with and without the
profiler; one swap phase with its one read in an MC3 chunk that crosses
one swap interval. A small K = 3 model with a cost-based geo prior, so
that the Prim runs."""
import json
import warnings

import numpy as np
import pytest
import torch

from sbayes_tpu_torch import tracing

SEED = 11
CHAINS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rt():
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = synthetic_config(n_clusters=3, geo_prior="cost_based", rate=1e5)
    data = synthetic_data(n_objects=20, n_features=6, n_states=3, n_families=2, seed=4)
    return SamplerRuntime(Model(data, cfg.model, device="cpu"), cfg.mcmc)


@pytest.fixture(scope="module")
def start(rt):
    """(states, stats) after init and one step of every operator."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    gen, _ = make_generators(SEED, "cpu")
    states = rt.init_chains(gen, CHAINS)
    return rt.run_ops(gen, list(range(rt.n_ops)), states, rt.new_stats(CHAINS))


def profiled(fn, tmp_path) -> tuple:
    """(fn's result, the spans it recorded as (name, start, end, tid),
    in the order they started) under a CPU profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def inside(span, outers) -> bool:
    return any(o[1] <= span[1] and span[2] <= o[2] and o[3] == span[3] for o in outers)


def _copy(x):
    return type(x)(*(None if t is None else t.clone() for t in x))


def test_no_span_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = tracing.span("sbt.chunk"), tracing.span("sbt.op/x")
    assert a is b and a is tracing._OFF
    with a:
        with b:
            pass


def test_chunk_spans_nest_and_change_no_bits(rt, start, tmp_path):
    from sbayes_tpu_torch.sampling.runner import make_generators

    n_steps = 12

    def chunk():
        gen, op_gen = make_generators(SEED + 1, "cpu")
        return rt.run_chunk(gen, op_gen, _copy(start[0]), _copy(start[1]), n_steps, trace=True)

    plain = chunk()
    traced, spans = profiled(chunk, tmp_path)
    for a, b in zip(plain[:2], traced[:2]):
        for x, y in zip(a, b):
            if x is not None:
                assert torch.equal(x, y)
    np.testing.assert_array_equal(plain[2], traced[2])

    _, op_gen = make_generators(SEED + 1, "cpu")
    drawn = rt.draw_ops(op_gen, n_steps)
    ops = [s for s in spans if s[0].startswith("sbt.op/")]
    assert [s[0] for s in ops] == [f"sbt.op/{rt.op_names[i]}" for i in drawn]
    chunks = [s for s in spans if s[0] == "sbt.chunk"]
    assert chunks
    prims = [s for s in spans if s[0] == "sbt.prim"]
    syncs = [s for s in spans if s[0].startswith("sbt.sync/")]
    assert prims and syncs
    for s in ops + prims + syncs:
        assert inside(s, chunks), s
    for s in prims:
        assert inside(s, ops), s
    assert {s[0] for s in syncs} <= {"sbt.sync/mst.size", "sbt.sync/wide.redraw",
                                      "sbt.sync/run_ops.trace"}
    assert sum(s[0] == "sbt.sync/run_ops.trace" for s in syncs) == 1
    # every Prim reads its size once
    assert sum(s[0] == "sbt.sync/mst.size" for s in syncs) == len(prims)


def test_mc3_chunk_holds_one_swap_phase(rt, start, tmp_path):
    from sbayes_tpu_torch.sampling.runner import make_generators

    temps = torch.tensor([1.0, 1.1, 1.2, 1.3])
    interval, n_steps = 10, 10

    def chunk():
        gen, op_gen = make_generators(SEED + 2, "cpu")
        swaps = np.zeros((2, CHAINS, CHAINS), dtype=np.int64)
        return rt.run_mc3_chunk(gen, op_gen, _copy(start[0]), _copy(start[1]), temps, temps,
                                swaps, 5, n_steps, interval, 6, False), swaps

    plain, plain_swaps = chunk()
    (traced, swaps), spans = profiled(chunk, tmp_path)
    for a, b in zip(plain[:2], traced[:2]):
        for x, y in zip(a, b):
            if x is not None:
                assert torch.equal(x, y)
    np.testing.assert_array_equal(plain_swaps, swaps)
    assert traced[3] == 6 and swaps[1].sum() == 6

    phases = [s for s in spans if s[0] == "sbt.swap_phase"]
    assert len(phases) == 1
    chunks = [s for s in spans if s[0] == "sbt.chunk"]
    assert inside(phases[0], chunks)
    # one read of the ladder's parts; an accepted swap also copies the new
    # order of the rungs to the device
    reads = [s for s in spans if s[0].startswith("sbt.sync/") and inside(s, phases)]
    assert [s[0] for s in reads] == ["sbt.sync/mc3.log_lh_prior"] + (
        ["sbt.sync/mc3.permute"] if traced[2] else [])
    ops = [s for s in spans if s[0].startswith("sbt.op/")]
    assert len(ops) == n_steps
    assert not any(inside(s, phases) for s in ops)
