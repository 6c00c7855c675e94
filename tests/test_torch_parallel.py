"""The port's chain split over devices (``sbayes_tpu_torch/parallel/mesh.py``
and ``ShardedRuntime`` in ``sampling/runner.py``) on the CPU, with a device
list that repeats ``cpu`` (the port's counterpart of the JAX tests' eight
virtual CPU devices): the mesh policy against the JAX package's; each shard
of a split run equal, bit for bit, to its shard run alone (the port's form
of ``tests/test_parallel.py``, whose unsplit reference is the whole batch:
torch's random streams depend on the batch, so here it is each shard with
its own generator and the shared operator draws); a one-shard mesh equal to
the unsplit code; the carried invariants of every shard; the MC3 swap
across shards against the unsplit swap loop; the best-of-W ladder warm-up;
and two statistical tests of the CLI against the JAX sampler on the fixture
(p > 0.005, the limit of ``tests/test_torch_mc3.py`` and
``tests/test_torch_slice.py``), each unsplit and split. The split is the
one ``SamplerRuntime.shard`` gives: shard 0 in this process, each other
shard in a worker process; the tests of its internals take it from
module-scoped pools (``pools``), each spawn costing about 3 s here."""
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
from scipy.stats import binomtest

import jax  # noqa: F401  (JAX stays on the CPU with 8 devices, see conftest)
import torch

import sbayes_tpu_torch.parallel.mesh as mesh

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the shards' threads and the test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_devices(monkeypatch, n: int):
    """Make ``auto_chain_mesh`` see ``n`` CPU devices."""
    monkeypatch.setattr(mesh, "visible_devices", lambda device_type="cuda": ["cpu"] * n)


@pytest.fixture(scope="module")
def small_rt():
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=16, n_features=5, n_states=3, n_families=2, seed=3)
    cfg = synthetic_config(n_clusters=2, geo_prior="cost_based")
    return SamplerRuntime(Model(data, cfg.model, device="cpu"), cfg.mcmc)


@pytest.fixture(scope="module")
def pools(small_rt):
    """The split of ``small_rt`` over 2 and over 4 CPU devices, as
    ``SamplerRuntime.shard`` makes it, its workers spawned once for the
    module."""
    import multiprocessing

    from sbayes_tpu_torch.sampling.runner import ShardedRuntime

    made = {n: ShardedRuntime(small_rt, mesh.chain_mesh(devices=["cpu"] * n)) for n in (2, 4)}
    yield made
    for sh in made.values():
        sh.close()
    assert multiprocessing.active_children() == []


def _blocks(x, n_blocks: int) -> list:
    return [mesh.chain_block(x, j, n_blocks) for j in range(n_blocks)]


def _copy(x):
    return type(x)(*(None if t is None else t.clone() for t in x))


def _assert_same(a, b):
    """Two ChainStates or OperatorStats equal in every field, bit for bit."""
    assert type(a) is type(b)
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name


def test_mesh_policy_matches_jax(monkeypatch):
    """``auto_chain_mesh`` on 8 CPU devices makes the JAX package's decision
    (on its 8 virtual CPU devices) for every chain count 1..40, and both
    give None under each spelling of ``SBAYES_TPU_SHARDING=off``."""
    from sbayes_tpu.parallel.mesh import auto_chain_mesh as jax_auto

    assert len(jax.devices()) == 8
    cpu_devices(monkeypatch, 8)
    monkeypatch.delenv("SBAYES_TPU_SHARDING", raising=False)
    for n in range(1, 41):
        want = jax_auto(n)
        got = mesh.auto_chain_mesh(n, device_type="cpu")
        assert (got is None) == (want is None), n
        if got is not None:
            assert len(got) == want.devices.size and set(got) == {torch.device("cpu")}
    for off in ("off", "0", "none", "OFF"):
        monkeypatch.setenv("SBAYES_TPU_SHARDING", off)
        assert mesh.auto_chain_mesh(8, device_type="cpu") is None and jax_auto(8) is None


def test_launch_counter_keeps_every_count_across_threads():
    """A launch counter keeps the counts of callers in threads of their own:
    16 threads (more than the cores) adding 2,000 launches each, with a
    short switch interval, lose none, in all and by variant."""
    import sys
    import threading

    from sbayes_tpu_torch.ops._cuda import LaunchCounter

    counter = LaunchCounter("stress")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda v=t % 2: [counter.add(v) for _ in range(2000)])
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert counter.count == 32000 and counter.variants == {0: 16000, 1: 16000}


def test_mesh_never_crosses_device_types(monkeypatch):
    """By default a CPU model never splits, and a device list of another
    type than the model's raises instead of moving the model."""
    monkeypatch.delenv("SBAYES_TPU_SHARDING", raising=False)
    assert mesh.auto_chain_mesh(8, device_type="cpu") is None
    with pytest.raises(ValueError, match="cannot split"):
        mesh.auto_chain_mesh(8, devices=["cpu", "cpu"], device_type="cuda")
    monkeypatch.setattr(mesh, "visible_devices", lambda device_type="cuda": ["meta"] * 2)
    with pytest.raises(ValueError, match="cannot split"):
        mesh.auto_chain_mesh(8, device_type="cpu")


@pytest.mark.parametrize("n_shards", [2, 4])
def test_each_shard_equals_its_run_alone(monkeypatch, small_rt, pools, n_shards):
    """8 chains split over ``n_shards`` CPU devices (shard 0 here, the others
    in worker processes), 25 steps: each shard equals, bit for bit, an
    unsplit run of its chains with that shard's generator and the same
    operator draws (clusters, source, weights, log_lh, log_prior, every
    carried count, every statistic)."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = small_rt
    cpu_devices(monkeypatch, n_shards)
    sh = pools[n_shards]
    assert sh.mesh == rt.split_mesh(8) and (sh.n_shards, sh.n_local) == (n_shards, 1)
    gen, op_gen = make_generators(5, "cpu")
    gens = mesh.ShardGenerators(gen)
    shards = sh.init_chains(gens, 8)
    start = sh.gather(shards)
    out, stats = sh.run_chunk(gens, op_gen, shards, sh.new_stats(8), 25)
    out, stats = _blocks(sh.gather(out), n_shards), _blocks(sh.gather(stats), n_shards)

    _, op_gen = make_generators(5, "cpu")
    ops = rt.draw_ops(op_gen, 25)
    alone = mesh.ShardGenerators(torch.Generator().manual_seed(5)).for_mesh(sh.mesh)
    b = 8 // n_shards
    for j in range(n_shards):
        st0 = rt.init_chains(alone[j], b)
        _assert_same(st0, start.select(slice(j * b, (j + 1) * b)))
        st, ss = rt.run_ops(alone[j], ops, st0, rt.new_stats(b))
        _assert_same(st, out[j])
        _assert_same(ss, stats[j])
    assert len({s.clusters.numpy().tobytes() for s in out}) == n_shards   # distinct streams


def test_one_shard_mesh_is_the_unsplit_code(monkeypatch, small_rt):
    """One device (no mesh) and ``SBAYES_TPU_SHARDING=off`` run today's
    ``init_chains`` / ``run_chunk`` / ``refresh`` / ``warmup`` bit for bit."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = small_rt
    runs = []
    for setup in ("one_device", "off"):
        if setup == "one_device":
            cpu_devices(monkeypatch, 1)
        else:
            cpu_devices(monkeypatch, 2)
            monkeypatch.setenv("SBAYES_TPU_SHARDING", "off")
        sh = rt.shard(8)
        assert sh.n_shards == 1
        gen, op_gen = make_generators(9, "cpu")
        gens = mesh.ShardGenerators(gen)
        shards = sh.init_chains(gens, 8)
        shards, stats = sh.run_chunk(gens, op_gen, shards, sh.new_stats(8), 20)
        runs.append((sh.gather(sh.refresh(shards)), stats[0],
                     rt.warmup(gen, op_gen, 4, 10)))
    gen, op_gen = make_generators(9, "cpu")
    states = rt.init_chains(gen, 8)
    states, stats = rt.run_chunk(gen, op_gen, states, rt.new_stats(8), 20)
    want = (rt.refresh(states), stats, rt.warmup(gen, op_gen, 4, 10))
    for got in runs:
        for a, b in zip(got, want):
            _assert_same(a, b)


def test_model_on_an_indexed_device_never_splits(monkeypatch, small_rt):
    """Only a model on a device without an index takes the automatic mesh:
    the same model on ``cpu:0`` (as a ``-t`` worker's model is on
    ``cuda:i``) stays one shard where the bare device splits in two."""
    rt = small_rt
    cpu_devices(monkeypatch, 2)
    monkeypatch.delenv("SBAYES_TPU_SHARDING", raising=False)
    assert rt.shard(8).n_shards == 2           # not started: no process was spawned
    rt.close()
    pinned = rt.replica(rt.consts.to("cpu:0"))
    assert pinned.device.index == 0 and pinned.shard(8).n_shards == 1


def test_unsplit_mc3_chunk_equals_the_plain_swap_loop(small_rt):
    """``SamplerRuntime.run_mc3_chunk`` (one shard of the split loop) equals,
    bit for bit, the plain loop written out here: ``run_chunk`` segments up
    to each swap step, ``swap_phase`` on the host-read ``log_lh`` /
    ``log_prior``, ``select(perm)`` of the states; the counts and the
    generators' streams too."""
    from sbayes_tpu_torch.sampling.runner import (
        draw_swap_proposals,
        make_generators,
        swap_pairs,
        swap_phase,
    )

    rt = small_rt
    n, steps, interval = 8, 23, 4
    temps = torch.linspace(1.0, 2.4, n)
    gen, op_gen = make_generators(21, "cpu")
    start = rt.init_chains(gen, n)
    seed_state = (gen.get_state(), op_gen.get_state())

    swaps = np.zeros((2, n, n), dtype=np.int64)
    got = rt.run_mc3_chunk(gen, op_gen, _copy(start), rt.new_stats(n), temps, temps, swaps,
                           3, steps, interval, 5, True)
    got_streams = (gen.get_state(), op_gen.get_state())

    gen.set_state(seed_state[0])
    op_gen.set_state(seed_state[1])
    want_swaps = np.zeros_like(swaps)
    pairs = swap_pairs(n, True)
    t = temps.numpy().astype(np.float64)
    states, stats, n_acc, n_att, done = _copy(start), rt.new_stats(n), 0, 0, 0
    while done < steps:
        seg = min(interval - (3 + done) % interval, steps - done)
        states, stats = rt.run_chunk(gen, op_gen, states, stats, seg, temps, temps)
        done += seg
        if (3 + done) % interval:
            continue
        order, log_u = draw_swap_proposals(op_gen, len(pairs), 5)
        perm, _, _, acc = swap_phase(states.log_lh.numpy(), states.log_prior.numpy(), t, t,
                                     pairs, order, log_u, want_swaps)
        if acc:
            states = states.select(torch.as_tensor(perm))
        n_acc, n_att = n_acc + acc, n_att + 5
    _assert_same(got[0], states)
    _assert_same(got[1], stats)
    assert got[2:] == (n_acc, n_att) and n_att == 5 * 6 and n_acc > 0
    assert np.array_equal(swaps, want_swaps)
    assert all(torch.equal(a, b) for a, b in zip(got_streams,
                                                 (gen.get_state(), op_gen.get_state())))


def test_kernel_build_runs_once_from_two_threads(monkeypatch, tmp_path):
    """A build from threads of their own runs once: two threads calling
    ``_cuda.build()`` on an empty build directory (``nvcc`` stubbed by a
    script that writes its output slowly) run one build, one compile per
    source and one link, and both get the one whole library; no build's
    scratch files are left beside it."""
    import stat
    import sys
    import threading

    from sbayes_tpu_torch.ops import _cuda

    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(f"#!{sys.executable}\n"
                    "import sys, time\n"
                    f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "with open(out, 'w') as f:\n"
                    "    f.write('partial')\n"
                    "    f.flush()\n"
                    "    time.sleep(0.3)\n"
                    "    f.write(' whole')\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "nvcc_path", lambda: str(stub))
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(_cuda.build())) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(libs) == 2
    assert libs[0] == libs[1] and libs[0].read_text() == "partial whole"
    calls = log.read_text().splitlines()
    assert sum(" -c " in c for c in calls) == len(_cuda.sources()) >= 2
    assert sum("-shared" in c for c in calls) == 1
    assert [p.name for p in libs[0].parent.iterdir()] == [libs[0].name]


def test_every_shard_carries_its_invariants(small_rt, pools):
    """After a split run (shard 1 in a worker process) the carried counts,
    skeleton aggregates and log-posterior parts of every shard equal
    ``post.fill_state`` of its clusters, source and weights (counts
    exactly); the split refresh is every shard's refresh alone, bit for
    bit, and the refresh of the gathered batch within f32 rounding, its
    counts exactly (the analogue of ``tests/test_parallel.py:218``)."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = small_rt
    sh = pools[2]
    gen, op_gen = make_generators(3, "cpu")
    gens = mesh.ShardGenerators(gen)
    shards, stats = sh.run_chunk(gens, op_gen, sh.init_chains(gens, 8), sh.new_stats(8), 40)
    assert sh.non_finite(stats) == 0
    for s in _blocks(sh.gather(shards), 2):
        ref = rt.post.fill_state(s)
        assert torch.equal(s.cl_counts, ref.cl_counts)
        assert torch.equal(s.conf_counts, ref.conf_counts)
        assert torch.equal(s.geo_agg[..., 1], ref.geo_agg[..., 1])     # edge counts
        torch.testing.assert_close(s.geo_agg, ref.geo_agg, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(s.log_lh, ref.log_lh, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(s.prior_parts, ref.prior_parts, rtol=1e-5, atol=1e-4)
    # The split refresh is each shard's own refresh, bit for bit; against the
    # refresh of the gathered batch the counts are exact and the f32 sums
    # may round in another order (torch's reductions depend on the batch).
    split = sh.refresh(shards)
    for got, s in zip(_blocks(sh.gather(split), 2), _blocks(sh.gather(shards), 2)):
        _assert_same(got, rt.refresh(s))
    whole = rt.refresh(sh.gather(shards))
    for name, a, b in zip(whole._fields, sh.gather(split), whole):
        if a.dtype == torch.bool or name in ("cl_counts", "conf_counts", "pat_counts"):
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5)


def test_split_and_gather_round_trip(small_rt, pools):
    """``chain_block`` then ``gather`` gives back a ChainState, an
    OperatorStats and a (B,) tensor bit for bit; the split runtime's
    ``split`` of None is None on every shard and its ``gather`` None; an
    uneven split raises; the constants are copied only to a new device."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = small_rt
    gen, op_gen = make_generators(8, "cpu")
    states, stats = rt.run_chunk(gen, op_gen, rt.init_chains(gen, 6), rt.new_stats(6), 5)
    temps = torch.linspace(1.0, 2.0, 6)
    for x in (states, stats):
        parts = _blocks(x, 3)
        assert [p[0].shape[0] for p in parts] == [2, 2, 2]
        _assert_same(mesh.gather(parts, "cpu"), x)
    assert torch.equal(mesh.gather(_blocks(temps, 2), "cpu"), temps)
    assert pools[2].split(None) == [None, None] and pools[2].gather([None, None]) is None
    with pytest.raises(ValueError, match="evenly"):
        mesh.chain_block(states, 0, 4)
    assert all(c is rt.consts for c in mesh.replicate(rt.model, ("cpu", "cpu")))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_permute_chains_equals_concat_select(small_rt, n_shards):
    """``permute_chains`` over 2 and 4 shards equals
    ``ChainState.concat(shards).select(perm)`` bit for bit for random
    permutations that move rungs across shards; a shard whose rungs keep
    their chains is the same object."""
    from sbayes_tpu_torch.sampling.runner import make_generators
    from sbayes_tpu_torch.sampling.state import ChainState

    rt = small_rt
    gen, _ = make_generators(4, "cpu")
    states = rt.init_chains(gen, 8)
    shards = _blocks(states, n_shards)
    rng = np.random.default_rng(n_shards)
    b = 8 // n_shards
    for _ in range(5):
        perm = rng.permutation(8)
        if (perm // b == np.arange(8) // b).all():
            continue
        got = mesh.permute_chains(shards, perm)
        want = _blocks(ChainState.concat(shards).select(torch.as_tensor(perm)), n_shards)
        for g, w in zip(got, want):
            _assert_same(g, w)
    perm = np.arange(8)
    perm[[0, 1]] = [1, 0]                     # a swap inside shard 0 only
    got = mesh.permute_chains(shards, perm)
    assert all(g is s for g, s in zip(got[1:], shards[1:])) and got[0] is not shards[0]


def test_split_mc3_chunk_swaps_as_the_unsplit_swap_phase(small_rt, pools):
    """A 4-rung ladder split over two CPU shards (shard 1 in a worker
    process), 60 steps with a swap phase every 10 (all pairs, 6 attempts):
    the split chunk equals, bit for bit, its reference built from unsplit
    parts on the same draws: each shard's steps alone (``run_ops``),
    ``swap_phase`` on the concatenated log-likelihoods and log-priors with
    the same proposals, and ``ChainState.concat(...).select(perm)``. Some
    swaps are accepted, some rejected, and some cross the shard boundary."""
    from sbayes_tpu_torch.sampling.runner import (
        _host,
        draw_swap_proposals,
        make_generators,
        swap_pairs,
        swap_phase,
    )
    from sbayes_tpu_torch.sampling.state import ChainState

    rt = small_rt
    n, steps, interval = 4, 60, 10
    sh = pools[2]
    temps = 1.0 + 0.5 * torch.arange(n, dtype=torch.float32)
    gen, op_gen = make_generators(12, "cpu")
    gens = mesh.ShardGenerators(gen)
    shards = sh.init_chains(gens, n)
    start = _blocks(sh.gather(shards), 2)
    m = np.zeros((2, n, n), np.int64)
    out, stats, n_acc, n_att = sh.run_mc3_chunk(gens, op_gen, shards, sh.new_stats(n),
                                                sh.split(temps), sh.split(temps), m, 0, steps,
                                                interval, 6, False)
    out, stats = _blocks(sh.gather(out), 2), _blocks(sh.gather(stats), 2)

    gens_ref = mesh.ShardGenerators(torch.Generator().manual_seed(12)).for_mesh(sh.mesh)
    for g in gens_ref:                                    # past the init draws
        rt.init_chains(g, 2)
    _, op_gen = make_generators(12, "cpu")
    pairs = swap_pairs(n, False)
    ref, ref_stats = start, [rt.new_stats(2), rt.new_stats(2)]
    m_ref = np.zeros_like(m)
    t_host = temps.numpy().astype(np.float64)
    crossed = acc_ref = 0
    for _ in range(steps // interval):
        ops = rt.draw_ops(op_gen, interval)
        runs = [rt.run_ops(gens_ref[j], ops, ref[j], ref_stats[j], temps[2 * j:2 * j + 2],
                           temps[2 * j:2 * j + 2]) for j in range(2)]
        ref, ref_stats = [r[0] for r in runs], [r[1] for r in runs]
        order, log_u = draw_swap_proposals(op_gen, len(pairs), 6)
        batch = ChainState.concat(ref)
        perm, _, _, acc = swap_phase(_host(batch.log_lh), _host(batch.log_prior), t_host,
                                     t_host, pairs, order, log_u, m_ref)
        crossed += int((perm[:2] >= 2).sum())
        acc_ref += acc
        ref = _blocks(batch.select(torch.as_tensor(perm)), 2)
    np.testing.assert_array_equal(m, m_ref)
    assert (n_acc, n_att) == (acc_ref, 6 * steps // interval)
    assert 0 < n_acc < n_att and crossed > 0
    for a, b in zip(out, ref):
        _assert_same(a, b)
    for a, b in zip(stats, ref_stats):
        _assert_same(a, b)


def test_warmup_ladder_over_shards_selects_best_per_rung(monkeypatch, small_rt):
    """The analogue of ``tests/test_parallel.py:152`` on a split warm-up:
    3 rungs x 4 warm-ups over two CPU shards (shard 1 in a worker process,
    as ``rt.shard`` splits), no steps: per rung the argmax by
    log-likelihood of its 4 initial states (each shard's init alone from
    its generator of the same seed); the rungs keep distinct states; with
    steps, one finite state per rung."""
    from sbayes_tpu_torch.sampling.runner import make_generators
    from sbayes_tpu_torch.sampling.state import ChainState

    rt = small_rt
    cpu_devices(monkeypatch, 2)
    n, W = 3, 4
    temps = 1.0 + 0.2 * torch.arange(n, dtype=torch.float32)
    try:
        gen, op_gen = make_generators(21, "cpu")
        picked = rt.warmup_ladder(gen, op_gen, n, W, temps, temps, n_steps=0)
        sh = rt.shard(n * W)
        assert (sh.n_shards, sh.n_local) == (2, 1) and sh.processes is not None
        gen, _ = make_generators(21, "cpu")
        alone = mesh.ShardGenerators(gen).for_mesh(sh.mesh)
        grid = ChainState.concat([rt.init_chains(g, n * W // 2) for g in alone])
        ll = grid.log_lh.numpy().reshape(n, W)
        sel = torch.as_tensor(ll.argmax(axis=1) + np.arange(n) * W)
        _assert_same(picked, grid.select(sel))
        assert len({r.tobytes() for r in picked.clusters.numpy()}) > 1
        gen, op_gen = make_generators(22, "cpu")
        picked2 = rt.warmup_ladder(gen, op_gen, n, 2, temps, temps, n_steps=10)
        assert picked2.n_chains == n and bool(torch.isfinite(picked2.log_lh).all())
    finally:
        rt.close()


# -------------------- the split samplers against the JAX sampler --------------------
#
# Both packages' ensembles draw one operator per step for all chains, and
# each operator keeps its own size distribution (ROADMAP C.1, C.8), so the
# port is held against JAX chains stepped through the same operator draws
# and read at the same steps. Samples of one chain are autocorrelated: the
# tests compare independent draws only (one value per run, per chain or per
# rung at one step).

@pytest.fixture(scope="module")
def jax_apply():
    """The JAX package's MH step on the fixture's posterior (config as it
    is: K = 1, cost-based geo prior), vmapped over chains and jitted once:
    (runtime, apply, operator names, weights)."""
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.data.loader import Data as JaxData
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.model.posterior import Posterior as JaxPosterior
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxConditionals
    from sbayes_tpu.sampling.kernel import make_mh_apply_fn
    from sbayes_tpu.sampling.operators import get_operator_schedule
    from sbayes_tpu.sampling.runner import SamplerRuntime as JaxRuntime

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = JaxConfig.from_config_file(FIXTURES / "config.yaml")
    rt = JaxRuntime(JaxModel(JaxData.from_config(cfg), cfg.model), cfg.mcmc)
    cond = JaxConditionals(JaxPosterior(rt.consts, False), 1.0, 1.0)
    specs = get_operator_schedule(cond, cfg.mcmc.operators)
    apply = jax.jit(jax.vmap(make_mh_apply_fn(cond, specs), in_axes=(None, 0, 0)))
    return rt, apply, [s.name for s in specs], [s.weight for s in specs]


def _jax_membership(jax_apply, ops: list, sample_at: list, n_chains: int = 256,
                    seed: int = 0) -> np.ndarray:
    """(len(sample_at), n_chains, N) memberships of ``n_chains`` JAX chains
    from their own initial states, stepped through the operators ``ops`` and
    read after each step of ``sample_at`` (1-based)."""
    rt, apply, _, _ = jax_apply
    states = rt.init_chains(jax.random.PRNGKey(seed), n_chains, shard=False)
    key = jax.random.PRNGKey(seed + 1)
    reads = []
    for i, op in enumerate(ops, start=1):
        key, k = jax.random.split(key)
        states = apply(op, jax.random.split(k, n_chains), states)[0]
        if i in sample_at:
            reads.append(np.asarray(states.clusters).any(1))
    return np.stack(reads)


def _port_ops(op_weights, op_gen, blocks: list, swaps: tuple = None) -> list:
    """The operators the port's runner draws from ``op_gen``: one draw of
    ``n`` steps for each entry of ``blocks``; ``swaps`` (n_pairs, attempts):
    one swap phase's proposals drawn after every block but the first."""
    from sbayes_tpu_torch.sampling.runner import draw_swap_proposals

    ops = []
    for i, n in enumerate(blocks):
        ops += torch.multinomial(op_weights, n, replacement=True, generator=op_gen).tolist()
        if swaps and i > 0:
            draw_swap_proposals(op_gen, *swaps)
    return ops


def _same_schedule(rt, jax_apply):
    names, weights = jax_apply[2:]
    assert rt.op_names == names
    np.testing.assert_allclose(rt.op_weights.numpy(), weights, rtol=1e-6)


def _clusters_file(path: Path) -> np.ndarray:
    return np.array([[c == "1" for c in row] for row in path.read_text().split()])


@pytest.fixture
def fixture_dir(tmp_path):
    for f in ("config.yaml", "features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, tmp_path / f)
    return tmp_path


@pytest.mark.parametrize("split", ["unsplit", "processes"])
def test_split_cli_ensemble_matches_jax(monkeypatch, fixture_dir, jax_apply, split):
    """``cli.main`` on the fixture config with ``runs: 32``, one CPU shard or
    split over two (shard 1 in a worker process; the warm-up race 2 x 32
    chains, the ensemble 2 x 16), 200 steps, 10 samples: each object's
    membership frequency per run (32 independent values) against the
    per-chain frequencies of 256 JAX chains stepped through the same
    operator draws and read at the same steps (Welch's t-test per object).
    Four runs' samples alone are too few and too correlated for a test."""
    import multiprocessing

    from scipy.stats import ttest_ind

    from sbayes_tpu_torch import cli
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators

    n_shards = 1 if split == "unsplit" else 2
    cpu_devices(monkeypatch, n_shards)
    seen = []
    monkeypatch.setattr(SamplerRuntime, "shard", _recording(SamplerRuntime.shard, seen))
    R = 32
    settings = {"mcmc": {"runs": R, "steps": 200, "samples": 10},
                "results": {"log_likelihood": False, "log_operator_step_times": False,
                            "path": str(fixture_dir / "results")}}
    before = set(multiprocessing.active_children())        # the module's pools
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(fixture_dir / "config.yaml", experiment_name="split", custom_settings=settings,
                 device="cpu")
    assert seen[:2] == [(2 * R, n_shards), (R, n_shards)], seen
    assert [p for p in multiprocessing.active_children() if p not in before] == []
    out = fixture_dir / "results" / "split" / "K1"
    port = np.stack([_clusters_file(out / f"clusters_K1_{r}.txt") for r in range(R)])
    assert port.shape == (R, 10, 5)

    _same_schedule(seen[-1], jax_apply)
    _, op_gen = make_generators(101, "cpu")
    ops = _port_ops(seen[-1].op_weights, op_gen, [50] + [20] * 10)
    want = _jax_membership(jax_apply, ops, [50 + 20 * s for s in range(1, 11)])
    failures = []
    for o in range(port.shape[-1]):
        pv = ttest_ind(port[:, :, o].mean(1), want[:, :, o].mean(0), equal_var=False).pvalue
        if not pv > 0.005:
            failures.append(f"object {o}: port {port[..., o].mean():.3f}, "
                            f"JAX {want[..., o].mean():.3f}, p={pv:.4f}")
    assert not failures, "split ensemble vs JAX:\n" + "\n".join(failures)


@pytest.mark.parametrize("split", ["unsplit", "processes"])
def test_split_mc3_ladder_cold_rungs_match_jax(monkeypatch, jax_apply, split):
    """An MC3 ladder of 192 rungs, one CPU shard or split over two shards of
    96 (shard 1 in a worker process; T = 1 for rungs 0-127, 1.5 for
    128-159, 2.5 for 160-191), 250 steps of ``run_mc3_chunk`` with a swap
    phase every 10 steps (all 191 adjacent pairs): at stationarity the
    rungs are independent draws of their tempered targets, so the 128 cold
    rungs at the last step are independent posterior draws. Each object's
    membership among them against 256 JAX chains on the same operator draws
    at that step (chi-square test per object). Swaps between the cold and
    the hot rungs are accepted and rejected, and swaps at rungs 95 <-> 96
    (the shard boundary of the split) are accepted."""
    from scipy.stats import chi2_contingency

    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators, swap_pairs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = SBayesConfig.from_config_file(FIXTURES / "config.yaml")
    rt = SamplerRuntime(Model(Data.from_config(cfg), cfg.model, device="cpu"), cfg.mcmc)
    _same_schedule(rt, jax_apply)
    n_shards = 1 if split == "unsplit" else 2
    cpu_devices(monkeypatch, n_shards)
    n, n_cold, steps, interval = 192, 128, 250, 10
    sh = rt.shard(n)
    assert sh.n_shards == n_shards
    temps = torch.cat([torch.ones(n_cold), torch.full((32,), 1.5), torch.full((32,), 2.5)])
    gen, op_gen = make_generators(17, "cpu")
    gens = mesh.ShardGenerators(gen)
    try:
        shards = sh.init_chains(gens, n)
        m = np.zeros((2, n, n), np.int64)
        shards, stats, n_acc, n_att = sh.run_mc3_chunk(
            gens, op_gen, shards, sh.new_stats(n), sh.split(temps), sh.split(temps), m, 0,
            steps, interval, n - 1, True)
        assert sh.non_finite(stats) == 0 and n_att == (n - 1) * steps // interval
        port = sh.gather(shards).clusters[:n_cold].any(1).numpy()
    finally:
        rt.close()
    assert 0 < m[0, n_cold - 1, n_cold] < m[1, n_cold - 1, n_cold]     # cold <-> hot
    assert m[0, 95, 96] > 0                                            # the shard boundary

    _, op_gen = make_generators(17, "cpu")
    ops = _port_ops(rt.op_weights, op_gen, [interval] * (steps // interval + 1),
                    (len(swap_pairs(n, True)), n - 1))[interval:]
    want = _jax_membership(jax_apply, ops, [steps], seed=1)[0]
    failures = []
    for o in range(port.shape[1]):
        table = [[port[:, o].sum(), n_cold - port[:, o].sum()],
                 [want[:, o].sum(), len(want) - want[:, o].sum()]]
        pv = chi2_contingency(table).pvalue
        if not pv > 0.005:
            failures.append(f"object {o}: port {port[:, o].mean():.3f}, "
                            f"JAX {want[:, o].mean():.3f}, p={pv:.4f}")
    assert not failures, "split MC3 cold rungs vs JAX:\n" + "\n".join(failures)


def _recording(shard, seen: list):
    """``SamplerRuntime.shard`` that records (chains, shards) of each call,
    and last the runtime."""
    def wrapped(self, n_chains, logger=None):
        sh = shard(self, n_chains, logger)
        seen[:] = [x for x in seen if isinstance(x, tuple)] + [(n_chains, sh.n_shards), self]
        return sh
    return wrapped
