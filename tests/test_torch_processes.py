"""The process split of a chain batch (``ShardedRuntime`` in
``sbayes_tpu_torch/sampling/runner.py`` with shard 0 in this process and
each other shard in a worker of ``parallel/processes.py``) on the CPU, with
meshes of ``cpu`` devices given explicitly: the split
``SamplerRuntime.shard`` gives wherever ``auto_chain_mesh`` gives a mesh.
It is held, bit for bit, to each shard's run alone (init, chunks, refresh,
records) and to the same shards stepped in this process (every shard
local, as a grid's rows are: an MC3 chunk whose swaps cross the process
boundary and the CLI's results files of an ensemble and of a ladder); the
cross-process ``permute_chains`` to ``ChainState.concat(...).select``. A
worker's error reaches the caller with its traceback and leaves no
process; a run leaves none; where there is no mesh nothing is spawned. The
workers of the module's runtime are spawned once per mesh (``pools``):
each spawn costs about 3 s here."""
import multiprocessing
import re
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import sbayes_tpu_torch.parallel.mesh as mesh

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as each worker on the CPU has: the same
    reductions in every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_rt():
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=16, n_features=5, n_states=3, n_families=2, seed=3)
    cfg = synthetic_config(n_clusters=2, geo_prior="cost_based")
    return SamplerRuntime(Model(data, cfg.model, device="cpu"), cfg.mcmc)


def cpu_mesh(n: int) -> tuple:
    return mesh.chain_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def pools(small_rt):
    """The process split of ``small_rt`` over 2 and over 4 CPU devices,
    started once for the module."""
    from sbayes_tpu_torch.sampling.runner import ShardedRuntime

    made = {n: ShardedRuntime(small_rt, cpu_mesh(n)) for n in (2, 4)}
    yield made
    for sh in made.values():
        sh.close()
    assert multiprocessing.active_children() == []


def local_split(rt, n_shards: int):
    """The chains over ``n_shards`` CPU shards, every shard stepped in this
    process (by ``rt``), one after another."""
    from sbayes_tpu_torch.sampling.runner import ShardedRuntime

    return ShardedRuntime(rt, rts=[rt] * n_shards)


def _left(before: set) -> list:
    """The child processes started since ``before`` (``active_children``)
    that still run: the module's ``pools`` stay."""
    return [p for p in multiprocessing.active_children() if p not in before]


def _assert_same(a, b):
    """Two ChainStates or OperatorStats equal in every field, bit for bit."""
    assert type(a) is type(b)
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name


def _assert_same_records(a: list, b: list):
    """Two lists of (SampleRecord, operator row) equal in every value."""
    assert len(a) == len(b)
    for (ra, rowa), (rb, rowb) in zip(a, b):
        for name, x in vars(ra).items():
            y = getattr(rb, name)
            if isinstance(x, np.ndarray):
                assert np.array_equal(x, y), name
            else:
                assert x == y or (x != x and y != y), name
        assert all(np.array_equal(x, y) for x, y in zip(rowa, rowb))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_process_split_equals_each_shard_alone(small_rt, pools, n_shards):
    """8 chains over ``n_shards`` CPU devices in processes, and each shard's
    chains run alone here from that shard's generator on the same operator
    draws: the split init, two chunks of 15 steps (each worker keeps its
    shard's generator across calls), the refresh, the (log_lh, log_prior)
    read, the non-finite count and every chain's record with its operator
    row, all bit-equal; a second ``ShardGenerators`` of the same seed
    starts its shards' streams anew in the workers too."""
    from sbayes_tpu_torch.parallel.processes import Remote
    from sbayes_tpu_torch.sampling.runner import make_generators
    from sbayes_tpu_torch.sampling.state import ChainState

    rt = small_rt
    procs = pools[n_shards]
    gen, op_gen = make_generators(5, "cpu")
    gens = mesh.ShardGenerators(gen)
    shards = procs.init_chains(gens, 8)
    init = procs.gather(shards)
    stats = procs.new_stats(8)
    for _ in range(2):
        shards, stats = procs.run_chunk(gens, op_gen, shards, stats, 15)
    kw = dict(i_step=30, with_likelihood=True, with_cluster_contribution=True)
    requests = [(c, kw) for c in (7, 0, 3)]
    got = (init, procs.gather(shards), procs.gather(stats), procs.gather(procs.refresh(shards)),
           procs.log_lh_prior(shards), procs.non_finite(stats), procs.records(shards, stats,
                                                                            requests))

    gen, op_gen = make_generators(5, "cpu")
    ops = [rt.draw_ops(op_gen, 15) for _ in range(2)]
    b = 8 // n_shards
    alone = []
    for g in mesh.ShardGenerators(gen).for_mesh(procs.mesh):
        st0 = rt.init_chains(g, b)
        st, ss = rt.run_ops(g, ops[0], st0, rt.new_stats(b))
        alone.append((st0, *rt.run_ops(g, ops[1], st, ss)))
    end = ChainState.concat([a[1] for a in alone])
    want = (ChainState.concat([a[0] for a in alone]), end,
            type(alone[0][2]).concat([a[2] for a in alone]),
            ChainState.concat([rt.refresh(a[1]) for a in alone]))
    for a, w in zip(got[:4], want):
        _assert_same(a, w)
    assert np.array_equal(got[4][0], end.log_lh.numpy())
    assert np.array_equal(got[4][1], end.log_prior.numpy())
    assert got[5] == 0
    _assert_same_records(got[6], [rt.records(alone[c // b][1], alone[c // b][2],
                                             [(c % b, kw)])[0] for c, kw in requests])
    assert all(isinstance(s, Remote) for s in shards[1:])
    again = procs.gather(procs.init_chains(mesh.ShardGenerators(make_generators(5, "cpu")[0]), 8))
    _assert_same(again, got[0])
    counts = procs.launch_counts()
    assert len(counts) == n_shards and all(c["loglh"]["count"] == 0 for c in counts)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_mc3_chunk_across_processes_equals_the_local_split(small_rt, pools, n_shards):
    """An 8-rung ladder over ``n_shards`` CPU devices, 40 steps with a swap
    phase every 5 (all pairs, 10 attempts): the process split gives the
    swap counts, acceptances, states and statistics of the same shards
    stepped in this process, and accepted swaps move chains across the
    process boundary."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = small_rt
    n, b = 8, 8 // n_shards
    temps = torch.linspace(1.0, 3.0, n)
    got = {}
    for name, sh in (("local", local_split(rt, n_shards)), ("processes", pools[n_shards])):
        gen, op_gen = make_generators(12, "cpu")
        gens = mesh.ShardGenerators(gen)
        m = np.zeros((2, n, n), np.int64)
        shards, stats, n_acc, n_att = sh.run_mc3_chunk(
            gens, op_gen, sh.init_chains(gens, n), sh.new_stats(n), sh.split(temps),
            sh.split(temps), m, 0, 40, 5, 10, False)
        got[name] = (sh.gather(shards), sh.gather(stats), m, n_acc, n_att)
    _assert_same(got["local"][0], got["processes"][0])
    _assert_same(got["local"][1], got["processes"][1])
    np.testing.assert_array_equal(got["local"][2], got["processes"][2])
    assert got["local"][3:] == got["processes"][3:] and got["processes"][4] == 80
    m = got["processes"][2]
    crossing = sum(int(m[0, i, j]) for i in range(n) for j in range(i + 1, n) if i // b != j // b)
    assert 0 < got["processes"][3] < 80 and crossing > 0


@pytest.mark.parametrize("n_shards", [2, 4])
def test_permute_chains_across_processes_equals_concat_select(small_rt, pools, n_shards):
    """``permute`` of the process split (the moved chains through host
    memory) equals ``ChainState.concat(shards).select(perm)`` bit for bit
    for random permutations applied one after the other; a swap inside
    one shard leaves every other shard the same object."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = small_rt
    sh = pools[n_shards]
    gen, _ = make_generators(4, "cpu")
    states = rt.init_chains(gen, 8)
    shards = sh.split(states)
    _assert_same(sh.gather(shards), states)
    rng = np.random.default_rng(n_shards)
    for _ in range(4):
        perm = rng.permutation(8)
        shards = sh.permute(shards, perm)
        states = states.select(torch.as_tensor(perm))
        _assert_same(sh.gather(shards), states)
    b = 8 // n_shards
    for j in (0, n_shards - 1):
        perm = np.arange(8)
        perm[[j * b, j * b + 1]] = [j * b + 1, j * b]
        got = sh.permute(shards, perm)
        assert all((g is s) == (i != j) for i, (g, s) in enumerate(zip(got, shards)))
        _assert_same(sh.gather(got), states.select(torch.as_tensor(perm)))


@pytest.fixture
def fixture_dir(tmp_path):
    for f in ("config.yaml", "features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, tmp_path / f)
    return tmp_path


def _files(root: Path) -> dict:
    """Every results file under ``root`` by relative path, its bytes; the
    operator statistics without their STEP-TIME column (wall time)."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            if p.name.startswith("operator_stats"):
                data = re.sub(rb"[0-9.]+ ms *", b"", data)
            out[str(p.relative_to(root))] = data
    return out


@pytest.mark.parametrize("mc3", [False, True], ids=["ensemble", "mc3"])
def test_cli_results_files_equal_the_local_split(monkeypatch, fixture_dir, mc3):
    """``cli.main`` on the fixture config with its chains split over two CPU
    devices: 4 runs as one ensemble (warm-up race and sampling split), or a
    ladder of 4 rungs with swaps every 20 steps; the results files of the
    process split equal, byte for byte (the operator statistics but their
    wall times), those of the same shards stepped in this process, and no
    process is left after the run."""
    from sbayes_tpu_torch import cli
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime

    monkeypatch.setattr(mesh, "visible_devices", lambda device_type="cuda": ["cpu"] * 2)
    monkeypatch.delenv("SBAYES_TPU_SHARDING", raising=False)
    mcmc = {"runs": 4, "steps": 200, "samples": 10, "warmup": {"warmup_chains": 4}}
    if mc3:
        mcmc = {"runs": 1, "steps": 200, "samples": 10, "warmup": {"warmup_chains": 2},
                "mc3": {"activate": True, "chains": 4, "swap_interval": 20}}
    settings = {"mcmc": mcmc, "results": {"log_operator_step_times": False, "log_file": False,
                                          "path": str(fixture_dir / "results")}}
    splits, before = [], set(multiprocessing.active_children())
    shard = SamplerRuntime.shard

    def recorded(self, n_chains, logger=None):
        sh = shard(self, n_chains, logger)
        splits.append((sh.n_shards, sh.n_local))
        return sh

    monkeypatch.setattr(SamplerRuntime, "shard", recorded)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(fixture_dir / "config.yaml", experiment_name="processes",
                 custom_settings=settings, device="cpu")
        assert (2, 1) in splits
        assert _left(before) == []
        monkeypatch.setattr(SamplerRuntime, "shard", lambda self, n_chains, logger=None:
                            local_split(self, len(self.split_mesh(n_chains))))
        cli.main(fixture_dir / "config.yaml", experiment_name="local",
                 custom_settings=settings, device="cpu")
    got = _files(fixture_dir / "results" / "processes")
    want = _files(fixture_dir / "results" / "local")
    assert got.keys() == want.keys()
    names = {Path(k).name.split("_K")[0] for k in got}
    assert {"stats", "clusters", "state", "likelihood", "operator_stats"} <= names
    if mc3:
        assert any(k.startswith("K1/hot_chains/") for k in got) and "mc3_swaps" in names
    for k in got:
        assert got[k] == want[k], k


def test_a_worker_error_reaches_the_caller(small_rt):
    """A command that raises in shard 1's worker raises ``WorkerError`` here
    with the worker's traceback, after every worker has stopped; the split
    then refuses further calls, and no process is left."""
    from sbayes_tpu_torch.parallel.processes import WorkerError
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, ShardedRuntime, make_generators

    before = set(multiprocessing.active_children())
    sh = ShardedRuntime(small_rt, cpu_mesh(3))
    gen, _ = make_generators(2, "cpu")
    shards = sh.init_chains(mesh.ShardGenerators(gen), 6)
    assert len(_left(before)) == 2
    with pytest.raises(WorkerError, match=r"(?s)shard 1:.*in refresh.*AttributeError"):
        sh.on_shard(1, SamplerRuntime.refresh, states=None)
    assert _left(before) == []
    with pytest.raises(RuntimeError, match="have ended"):
        sh.refresh(shards)


def test_no_mesh_never_spawns(monkeypatch, small_rt):
    """``SBAYES_TPU_SHARDING=off`` and a model on an indexed device give the
    batch as one local shard, the runtime itself, and the warm-up race
    under them spawns nothing; with a mesh ``shard`` gives shard 0 local
    and one worker; a grid (``grid_runtime``) is every row local."""
    from sbayes_tpu_torch.sampling.runner import grid_runtime, make_generators

    rt = small_rt
    before = set(multiprocessing.active_children())
    monkeypatch.setattr(mesh, "visible_devices", lambda device_type="cuda": ["cpu"] * 2)
    monkeypatch.setenv("SBAYES_TPU_SHARDING", "off")
    pinned = rt.replica(rt.consts.to("cpu:0"))
    for r in (rt, pinned):
        sh = r.shard(8)
        assert sh is r.shard(8) and (sh.n_shards, sh.n_local) == (1, 1) and sh.rts == [r]
        gen, op_gen = make_generators(3, "cpu")
        r.warmup(gen, op_gen, 8, 5)
        assert sh.start() is None and sh.processes is None and _left(before) == []
    monkeypatch.delenv("SBAYES_TPU_SHARDING")
    assert pinned.shard(8).n_shards == 1
    split = rt.shard(8)
    assert (split.n_shards, split.n_local) == (2, 1) and split.processes is None
    rt.close()
    grid = grid_runtime(rt, mesh.data_mesh(2, 1, ["cpu"] * 2))
    assert (grid.n_shards, grid.n_local) == (2, 2) and grid.start() is None
    assert _left(before) == []
