"""Tests of the PyTorch port that need a CUDA card (marker ``gpu``); they
skip without one. On the card: ``python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports no JAX: the card's machine has none."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).parent.parent


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    """chip_smoke's kernel comparison (both kernels, every marginal variant,
    each within its stated tolerance) at the full-width shapes, at 400
    features (feature tiles), at the odd shape (plain-load path, objects in
    no family), with 2, 4 and 5 components and with more groups than the
    default shared memory holds; the absolute and two-effect variants on the
    inputs of the K = 3 jump, with their launches on the K = 3 path and in
    the jump at 512 features; the heat variant on a batch at the per-chain
    temperatures of an MC3 ladder, launched there and not at unit
    temperatures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    rt, states, info = chip_smoke.phase_full_width(256, 200)
    assert info["launches"]["loglh"] > 0 and info["launches"]["marginal"] > 0
    rt_k3, states_k3, info_k3 = chip_smoke.phase_full_width(256, 200, n_clusters=3,
                                                            geo_prior="cost_based")
    temps = chip_smoke.ladder_temperatures(256)
    rt_mc3, states_mc3, info_mc3 = chip_smoke.phase_full_width(
        256, 200, n_clusters=3, geo_prior="cost_based", temps=temps)
    jump = chip_smoke.phase_jump_512(n_chains=32, n_steps=20)
    alt = chip_smoke.phase_alt_operators(rt_k3, states_k3, rt_mc3, states_mc3, temps)
    by_path = {"k1": info["launches"], "k3": info_k3["launches"],
               "mc3": info_mc3["launches"], "jump_512": jump["launches"]}
    residual_launches = chip_smoke.add_launches(*(alt[k]["launches"] for k in (
        "wide_residual", "wide_residual_counts", "wide_residual_counts_mc3")))
    rows = chip_smoke.phase_kernels(rt, states, rt_k3, states_k3, rt_mc3, states_mc3, temps,
                                    by_path, jump["two_eff"], residual_launches)
    by_name = {r["name"]: r for r in rows if r.get("inputs") != "residual"}
    residual = {r["name"]: r for r in rows if r.get("inputs") == "residual"}
    assert residual["marginal"]["launches"] == 4 * chip_smoke.ALT_STEPS
    assert residual["marginal_heat"]["launches"] == 2 * chip_smoke.ALT_STEPS
    assert by_name["marginal_abs"]["launches_by_path"]["k3"] > 0
    assert by_name["marginal_two_eff"]["launches_by_path"]["jump_512"] == 40
    assert by_name["marginal_heat"]["launches_by_path"]["mc3"] > 0
    assert by_name["marginal_heat"]["launches_by_path"]["k3"] == 0
    assert by_name["marginal_heat"]["mc3"]["inputs"] == "mc3"
    assert {r["name"] for r in rows} == {"loglh", "marginal", "marginal_heat",
                                         "marginal_two_eff", "marginal_abs"}
    first = rows[0]
    assert first["odd_shape"]["objects_in_no_family"] > 0
    assert set(first["odd_shape"]["errors"]) == set(first["feature_tiled"]["errors"])
    assert first["feature_tiled"]["f_tile"] < first["feature_tiled"]["F"]
    assert set(first["components"]) == {"C2", "C4", "C5"}
    assert first["many_groups"]["rows"] * 4 * 6 > 48 * 1024
    assert all(r["launch_floor_ms"] > 0 and r["device_floor_ms"] > 0 for r in rows)


@pytest.mark.gpu
def test_k3_geo_invariants_on_the_card():
    """chip_smoke's K = 3 phase at 256 chains x 200 steps with the cost-based
    geo prior: the carried skeleton aggregates equal ``geo_agg_of(clusters)``
    within 1e-3 relative, the counts exactly, no object is in two clusters,
    the jump (absolute marginal kernel) was launched and accepted sometimes;
    then the jump alone at 512 features (two-effect ratio kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    rt, states, info = chip_smoke.phase_full_width(256, 200, n_clusters=3,
                                                   geo_prior="cost_based")
    assert info["launches"]["marginal_abs"] > 0 and info["K"] == 3
    assert states.geo_agg.shape == (256, 3, 3) and states.geo_agg.is_cuda
    recomputed = rt.post.geo_agg_of(states.clusters)
    torch.testing.assert_close(states.geo_agg, recomputed, rtol=1e-3, atol=0)
    errs = info["carried_vs_recompute_max_abs"]
    assert errs["cl_counts"] == errs["conf_counts"] == errs["pat_counts"] == 0.0
    assert 0.0 < errs["jump_accept_rate"] < 1.0
    jump = chip_smoke.phase_jump_512(n_chains=32, n_steps=20)
    assert jump["launches"]["marginal_two_eff"] == 40 and jump["F"] == 512


@pytest.mark.gpu
@pytest.mark.parametrize("n_chains", [16, 1024])
def test_packed_loglh_and_object_tiled_marginal_on_the_card(n_chains):
    """The packed-source likelihood kernel and the marginal kernel's launch
    at a batch below the SM count (a (chain, object tile) grid) and at 1024
    chains (one block per chain), on random valid inputs at 400 features
    (feature tiles: the likelihood's (chain, feature tile) grid), against
    their plain versions within chip_smoke's tolerances; the packed kernel
    bit-equal to the bool one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.ops import loglh, marginal
    from sbayes_tpu_torch.ops.check import compare_with_plain
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    c = Model(synthetic_data(n_features=400), synthetic_config(n_clusters=2).model,
              device="cuda").consts
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tile = marginal.object_tile(n_chains, c.N, n_sm)
    assert (tile < c.N) == (n_chains < n_sm)
    assert loglh.feature_tile(c, packed=True) < c.F and loglh.feature_tile(c) < c.F
    chip_smoke.reset_counters()
    errs = compare_with_plain(c, chip_smoke.random_kernel_inputs(c, n_chains, 21))
    assert errs["loglh_packed_equals_bool"]
    assert loglh.launches.variants["packed"] == 5 and loglh.launches.variants["bool"] == 1
    assert all(errs[marginal.variant_name(*v)] >= 0 for v in marginal.VARIANTS)


@pytest.mark.gpu
def test_tiled_geo_costs_on_the_card():
    """The geo prior's masked reductions on CUDA tensors at a mid shape (16
    chains x 3,000 objects, where ``auto_cost_row_tile`` takes tiles of
    1,398 rows): each chain's cheapest-edge change of the geo prior, from
    the carried aggregates and with the MST recomputed, and the complete
    graph's triple, over the tiles bit-equal to one tile of all rows; the
    tiled call's peak memory below the untiled one's (16, N, N) temporary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sbayes_tpu_torch.model.constants import auto_cost_row_tile
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config
    from sbayes_tpu_torch.testing_scale import synthetic_data_large

    n, b = 3_000, 16
    data = synthetic_data_large(n, 8, 3, n_families=4, seed=3)
    gen = torch.Generator(device="cuda").manual_seed(5)
    labels = torch.randint(0, 6, (b, n), generator=gen, device="cuda")
    clusters = torch.stack([labels == k for k in range(3)], dim=1)          # (B, 3, N)
    i_cluster = torch.randint(0, 3, (b,), generator=gen, device="cuda")
    assert auto_cost_row_tile(b, n) == 1_398
    for skeleton in ("mst", "complete_graph"):
        cfg = synthetic_config(n_clusters=3, geo_prior="cost_based", rate=5.0,
                               skeleton=skeleton)
        post = Model(data, cfg.model, device="cuda").posterior
        agg = post.geo_agg_of(clusters)
        assert torch.equal(post.skeleton_triple(clusters.reshape(-1, n)),
                           post.skeleton_triple(clusters.reshape(-1, n), row_tile=n))
        for carried in (agg, None):
            peaks, out = [], []
            for tile in (None, n):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out.append(post.geo_prior_costs_per_object(clusters, i_cluster, geo_agg=carried,
                                                           row_tile=tile))
                torch.cuda.synchronize()
                peaks.append(torch.cuda.max_memory_allocated() - base)
            assert torch.equal(out[0], out[1]) and bool(torch.isfinite(out[0]).all())
            assert peaks[0] < peaks[1] and peaks[1] >= b * n * n * 4


@pytest.mark.gpu
def test_kernels_on_a_second_card_from_the_first():
    """Both kernels on tensors of cuda:1 while the calling thread's current
    device is cuda:0 (the device guard of each launch), every variant
    against its plain version within chip_smoke's tolerances, the launches
    counted at cuda:1; at 1100 families the launches also set the shared
    memory attribute on cuda:1. Skips below two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.ops import loglh
    from sbayes_tpu_torch.ops.check import compare_with_plain
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    for data in (synthetic_data(), synthetic_data(n_objects=1200, n_features=3, n_states=6,
                                                   n_families=1100, seed=3)):
        c = Model(data, synthetic_config(n_clusters=2).model, device="cuda:0").consts
        inputs = chip_smoke.random_kernel_inputs(c, 8, 3)
        c1 = c.to("cuda:1")
        inputs1 = {k: v.to("cuda:1") for k, v in inputs.items()}
        chip_smoke.reset_counters()
        with torch.cuda.device(0):
            errs = compare_with_plain(c1, inputs1)
        assert errs["loglh_packed_equals_bool"]
        assert {place[0] for place in loglh.launches.by_place} == {1}


@pytest.mark.gpu
def test_two_processes_on_one_card_equal_their_runs_alone():
    """1024 chains of the K = 3, cost-based model split into two shards on
    cuda:0 as ``rt.shard`` splits them (shard 0 in this process, shard 1
    in a worker process), 50 steps: each shard equals, bit for bit, its 512
    chains run alone here with that shard's generator and the same
    operator draws; the marginal kernel launched in both processes; no
    worker is left."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import multiprocessing

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sbayes_tpu_torch.parallel.mesh import ShardGenerators
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = chip_smoke.full_width_runtime(3, "cost_based")
    gen, _ = make_generators(5, "cuda")
    states = rt.init_chains(gen, 1024)
    try:
        sh = chip_smoke.split_runtime(rt, 1024, ("cuda:0", "cuda:0"))
        assert sh.n_local == 1
        gen, op_gen = make_generators(6, "cuda")
        sh.reset_launches()
        shards, stats = sh.run_chunk(ShardGenerators(gen), op_gen, sh.split(states),
                                     sh.new_stats(1024), 50)
        got = (sh.gather(shards), sh.gather(stats))
        launches = [chip_smoke.worker_launches(c) for c in sh.launch_counts()]
    finally:
        rt.close()
    assert multiprocessing.active_children() == []
    assert len(launches) == 2 and all(c["marginal"] > 0 for c in launches), launches
    gen, op_gen = make_generators(6, "cuda")
    ops = rt.draw_ops(op_gen, 50)
    alone = ShardGenerators(torch.Generator(device="cuda").manual_seed(6)).for_mesh(sh.mesh)
    for j in range(2):
        rows = slice(512 * j, 512 * (j + 1))
        st, ss = rt.run_ops(alone[j], ops, states.select(rows), rt.new_stats(512))
        assert chip_smoke.unequal_fields(st, got[0].select(rows)) == []
        assert chip_smoke.unequal_fields(ss, got[1].select(rows)) == []


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_loglh_split_entries_on_the_card(packed):
    """The likelihood kernel's two entries of the object split on random
    valid states of 64 chains at the south_america width and at 400
    features (feature tiles): ``loglh_counts`` of each block of 1 to 4
    blocks equal to its plain version (integer counts, exactly), and
    ``loglh_from_counts`` of the counts summed over the blocks bit-equal to
    the fused kernel and within chip_smoke's tolerance of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sbayes_tpu_torch.model.math import pack_source
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.ops import loglh
    from sbayes_tpu_torch.ops.check import LOGLH_TOL_REL
    from sbayes_tpu_torch.parallel.mesh import ObjectSplit
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    for n_features in (36, 400):
        c = Model(synthetic_data(n_features=n_features), synthetic_config(n_clusters=3).model,
                  device="cuda").consts
        inputs = chip_smoke.random_kernel_inputs(c, 64, 5)
        clusters = inputs["clusters"]
        source = pack_source(inputs["source"]) if packed else inputs["source"]
        fused = loglh.log_likelihood(c, clusters, source)
        for n_blocks in (1, 2, 3, 4):
            sp = ObjectSplit(c, ["cuda:0"] * n_blocks)
            total = None
            for (lo, hi), blk in zip(sp.bounds, sp.blocks):
                part = loglh.loglh_counts(blk, clusters[:, :, lo:hi], source[:, lo:hi])
                want = loglh.loglh_counts_plain(blk, clusters[:, :, lo:hi], source[:, lo:hi])
                assert all(torch.equal(a, b) for a, b in zip(part, want))
                total = part if total is None else tuple(a + b for a, b in zip(total, part))
            got = loglh.loglh_from_counts(c, *total)
            assert torch.equal(got, fused), (n_features, n_blocks)
            plain = loglh.loglh_from_counts_plain(c, *total)
            rel = float((got - plain).abs().max() / plain.abs().max())
            assert rel <= LOGLH_TOL_REL


@pytest.mark.gpu
def test_object_split_run_on_the_card():
    """A 1 x 2 chains x objects grid on cuda:0 at K = 3 (256 chains, 20 steps
    of ``run_chunk`` and the refresh): the counts entry and the marginal
    launched on each block's stream, ``loglh_from_counts`` on the head, the
    carried counts equal to the unsplit recompute of the gathered states and
    the split log-likelihood bit-equal to the fused kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sbayes_tpu_torch.ops import loglh
    from sbayes_tpu_torch.parallel.mesh import ShardGenerators, data_mesh
    from sbayes_tpu_torch.sampling.runner import grid_runtime, make_generators

    rt, states, _ = chip_smoke.phase_full_width(256, 200, n_clusters=3, geo_prior="cost_based")
    sh = grid_runtime(rt, data_mesh(1, 2, ["cuda:0", "cuda:0"]))
    sp = sh.splits[0]
    gen, op_gen = make_generators(3, "cuda")
    chip_smoke.reset_counters()
    shards, stats = sh.run_chunk(ShardGenerators(gen), op_gen, sh.split(states),
                                 sh.new_stats(256), 20)
    refs = sh.refresh(shards)
    torch.cuda.synchronize()
    for j in range(2):
        counts = chip_smoke.block_launches(sp, j)
        assert counts["loglh_counts"] > 0 and counts["marginal"] > 0, (j, counts)
    assert loglh.from_counts_launches.count > 0
    whole = sh.gather(shards)
    ref = rt.refresh(whole)
    for key in ("cl_counts", "conf_counts", "pat_counts"):
        assert torch.equal(getattr(refs[0], key), getattr(ref, key)), key
    assert torch.equal(refs[0].log_lh, loglh.log_likelihood(rt.consts, whole.clusters,
                                                            whole.source))
    chip_smoke.check_carried_state(sp.head, shards[0], refs[0], stats[0])


@pytest.mark.gpu
def test_run_experiment_on_the_fixture_yaml_on_the_card(tmp_path):
    """``cli.run_experiment`` on ``tests/fixtures/config.yaml`` on the card,
    the YAML read by the port's reader and ``results.log_likelihood`` at its
    default (true): both kernels launched, and the likelihood file (20 rows of
    objects x features, float32, finite and positive; ``na_values`` as bool)
    read back by the plain reader."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import shutil

    from sbayes_tpu_torch.cli import run_experiment
    from sbayes_tpu_torch.ops import loglh, marginal
    from sbayes_tpu_torch.results.hdf5 import read_datasets

    for f in ("config.yaml", "features.csv", "feature_states.csv"):
        shutil.copy(ROOT / "tests" / "fixtures" / f, tmp_path / f)
    loglh.launches.reset()
    marginal.launches.reset()
    run_experiment(tmp_path / "config.yaml", "gpu",
                   custom_settings={"results": {"path": str(tmp_path / "results")}})
    assert loglh.launches.count > 0 and marginal.launches.count > 0
    out = read_datasets(tmp_path / "results" / "gpu" / "K1" / "likelihood_K1_0.h5")
    lh = out["likelihood"]
    assert lh.dtype == "<f4" and lh.shape == (20, 10)
    assert bool(((lh > 0) & (lh < float("inf"))).all())
    assert out["na_values"].dtype == bool and int(out["na_values"].sum()) == 1


def _graphed_and_eager(rt, run):
    """``run()`` with the step graphs (``sampling/graphs.py``), then with the
    eager step: each result beside the change of ``graphs.record`` it made."""
    import dataclasses

    from sbayes_tpu_torch.sampling import graphs

    out = []
    for eager in (False, True):
        rt._eager = eager
        before = dataclasses.replace(graphs.record)
        got = run()
        torch.cuda.synchronize()
        out.append((got, {k: getattr(graphs.record, k) - getattr(before, k)
                          for k in ("steps", "replayed", "captures")}))
    rt._eager = False
    return out


@pytest.mark.gpu
def test_graphed_chunks_equal_eager_chunks_on_the_card():
    """Three chunks of ``run_chunk`` (100 steps each) of 64 chains of the
    south_america-shaped K = 3 model with the cost-based geo prior, replayed
    from the operators' CUDA graphs and stepped eagerly from the same start
    and seeds: end states and ``OperatorStats`` bit-equal; every step but
    the wide operator's replayed, each operator captured once; a chunk's
    returned state is not overwritten by the next chunk's replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = chip_smoke.full_width_runtime(3, "cost_based")
    start = rt.init_chains(make_generators(3, "cuda")[0], 64)
    wide = rt.op_names.index("gibbsish_sample_cluster_wide_geo")

    def run():
        gen, op_gen = make_generators(4, "cuda")
        states, stats, ends = start, rt.new_stats(64), []
        for _ in range(3):
            states, stats = rt.run_chunk(gen, op_gen, states, stats, 100)
            ends.append((states, type(states)(*(None if x is None else x.clone()
                                                for x in states))))
        return states, stats, ends

    (graphed, counts), (eager, eager_counts) = _graphed_and_eager(rt, run)
    for a, b in zip(graphed[:2], eager[:2]):
        assert chip_smoke.unequal_fields(a, b) == []
    for kept, copy in graphed[2]:
        assert chip_smoke.unequal_fields(kept, copy) == []
    _, op_gen = make_generators(4, "cuda")
    ops = [op for _ in range(3) for op in rt.draw_ops(op_gen, 100)]
    assert counts == {"steps": 300, "replayed": 300 - ops.count(wide),
                      "captures": len(set(ops) - {wide})}
    assert eager_counts == {"steps": 300, "replayed": 0, "captures": 0}


@pytest.mark.gpu
def test_graphed_mc3_ladder_equals_eager_on_the_card():
    """Two ``run_mc3_chunk`` calls of 100 steps of a 4-rung ladder (T = 1 +
    0.05 i) with a swap phase every 50 steps, graphed and eager from the
    same start and seeds: states, statistics, swap counts and accepts
    bit-equal; across the segments and chunks each operator captured once
    (one set of buffers for the ladder's temperatures)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = chip_smoke.full_width_runtime(3, "cost_based")
    start = rt.init_chains(make_generators(8, "cuda")[0], 4)
    temps = 1 + 0.05 * torch.arange(4, dtype=torch.float32, device="cuda")

    def run():
        gen, op_gen = make_generators(9, "cuda")
        states, stats = start, rt.new_stats(4)
        swaps, accepted = np.zeros((2, 4, 4), dtype=np.int64), 0
        for i in range(2):
            states, stats, acc, att = rt.run_mc3_chunk(gen, op_gen, states, stats, temps, temps,
                                                       swaps, 100 * i, 100, 50, 6, False)
            accepted += acc
        return states, stats, swaps, accepted, len(rt._graphs.graphs) if rt._graphs else 0

    (graphed, counts), (eager, eager_counts) = _graphed_and_eager(rt, run)
    for a, b in zip(graphed[:2], eager[:2]):
        assert chip_smoke.unequal_fields(a, b) == []
    np.testing.assert_array_equal(graphed[2], eager[2])
    assert graphed[2][1].sum() == 4 * 6 and graphed[3] == eager[3]
    assert counts["steps"] == 200 and counts["captures"] == graphed[4] > 0
    assert counts["replayed"] > 0.8 * counts["steps"] and eager_counts["replayed"] == 0


@pytest.mark.gpu
def test_profiler_sees_the_counted_launches_of_replays():
    """A chunk of 200 steps replayed from warm graphs under the profiler (the
    benchmark's trace reader): the marginal kernels in the trace equal the
    change of ``ops/marginal.py::launches`` (each replay adds its graph's
    captured launches); the steps' graphs run in ``sbt.graph`` spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from perfbench.tracing import WINDOW, Window, read_chrome_trace
    from sbayes_tpu_torch.ops.marginal import launches
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = chip_smoke.full_width_runtime(3, "cost_based")
    gen, op_gen = make_generators(10, "cuda")
    states, stats = rt.run_ops(gen, list(range(rt.n_ops)), rt.init_chains(gen, 64),
                               rt.new_stats(64))
    seen = []
    for _ in range(2):                       # the profiler can lose records: a second try
        torch.cuda.synchronize()
        before = launches.count
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                states, stats = rt.run_chunk(gen, op_gen, states, stats, 200)
                torch.cuda.synchronize()
        counted = launches.count - before
        events = read_chrome_trace(prof)
        seen.append(len(Window(events, 200).kernels("marginal_kernel")))
        if seen[-1] == counted:
            break
    assert counted > 0 and seen[-1] == counted, (seen, counted)
    assert sum(e["name"] == "sbt.graph" for e in events) > 150


@pytest.mark.gpu
def test_replayed_sweep_steps_equal_eager_on_the_card():
    """phoible_k5's model at 200 objects x 601 binary features in 12
    families, K = 5, with every switch of its path (packed source, tiles of
    128 with a last of 89, the sequential sweep, the log-space jump), 16
    chains from the EM start: each operator once and then the two sweep
    operators and the jump, 6 rounds, replayed from their CUDA graphs and
    stepped eagerly from the same start and seeds: end states and
    ``OperatorStats`` bit-equal, every sweep step replayed, and the tile
    passes (``model/math.py::tile_passes``) counted alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import copy
    import json

    import chip_smoke
    from perfbench import datagen, harness
    from sbayes_tpu_torch.config.schema import MCMCConfig, ModelConfig
    from sbayes_tpu_torch.model.math import tile_passes
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators

    config = copy.deepcopy(json.loads((ROOT / "perfbench" / "configs" / "phoible_k5.json")
                                      .read_text()))
    config["model"]["prior"]["objects_per_cluster"].update(min=3, max=30)
    config["mcmc"]["initialization"].update(attempts=2, em_steps=10)
    arrays = datagen.large(200, 601, 2, 12, seed=5, na_fraction=0.0)
    model = Model(harness.port_data(arrays), ModelConfig.from_dict(config["model"]),
                  device="cuda", source_packed=True, feature_chunk=128)
    rt = SamplerRuntime(model, MCMCConfig.from_dict(config["mcmc"]))
    sweeps = [i for i, s in enumerate(rt._op_specs) if s.sweep]
    assert len(sweeps) == 2 and rt.consts.source_packed
    ops = list(range(rt.n_ops)) + (sweeps + [rt.op_names.index("cluster_jump_gibbsish")]) * 6
    start = rt.init_chains(make_generators(6, "cuda")[0], 16)

    def run():
        gen, _ = make_generators(7, "cuda")
        before = tile_passes.count
        states, stats = rt.run_ops(gen, ops, start, rt.new_stats(16))
        return states, stats, tile_passes.count - before

    (graphed, counts), (eager, eager_counts) = _graphed_and_eager(rt, run)
    for a, b in zip(graphed[:2], eager[:2]):
        assert chip_smoke.unequal_fields(a, b) == []
    assert graphed[2] == eager[2]
    wide = rt.op_names.index("gibbsish_sample_cluster_wide_geo")
    assert counts["replayed"] == len(ops) - ops.count(wide) and eager_counts["replayed"] == 0
    assert (graphed[1].accepts[:, sweeps] == 7).all()
