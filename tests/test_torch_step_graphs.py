"""The step as a CUDA graph can hold it, on the CPU (``sampling/graphs.py``):
the jump and the source operator over a group's members make no host copy
inside a step (``torch.tensor`` and the write of a Python scalar into a
tensor patched to raise), and their draws for a
fixed seed equal those of the formulas that did (the jump's two membership
writes of a Python scalar, the group tables built in every step); the size
prior under ``uniform_size`` and the sigmoid geo probability copy nothing
either and give the bits of the former scalar copies; the graph path never
engages on the CPU (``graphs.record`` counts the steps, replays none); the
wide operator, and under the Delaunay skeleton every cluster operator, is
marked as no graph's. A small K = 3 model with a cost-based geo prior."""
import dataclasses
import warnings

import pytest
import torch

SEED = 23
CHAINS = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def runtime(**prior):
    """The sampler of a small K = 3 model with a cost-based geo prior; ``prior``
    overrides entries of the model's prior config."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = synthetic_config(n_clusters=3, geo_prior="cost_based", rate=1e5)
        if prior:
            cfg = cfg.update({"model": {"prior": prior}})
    data = synthetic_data(n_objects=20, n_features=6, n_states=3, n_families=2, seed=4)
    return SamplerRuntime(Model(data, cfg.model, device="cpu"), cfg.mcmc)


@pytest.fixture(scope="module")
def rt():
    return runtime()


@pytest.fixture(scope="module")
def start(rt):
    """(states, stats) after init and one step of every operator."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    gen, _ = make_generators(SEED, "cpu")
    states = rt.init_chains(gen, CHAINS)
    return rt.run_ops(gen, list(range(rt.n_ops)), states, rt.new_stats(CHAINS))


def _op(rt, name):
    return rt._op_specs[rt.op_names.index(name)].fn


def _refuse(*args, **kw):
    raise AssertionError("torch.tensor inside a step: a copy from the host")


def refuse_host_copies(monkeypatch):
    """Make ``torch.tensor`` and the write of a Python scalar into a tensor
    (copied to the card on CUDA tensors) raise."""
    setitem = torch.Tensor.__setitem__

    def checked(self, idx, value):
        if isinstance(value, (bool, int, float)):
            raise AssertionError("a Python scalar written into a tensor inside a step")
        return setitem(self, idx, value)

    monkeypatch.setattr(torch, "tensor", _refuse)
    monkeypatch.setattr(torch.Tensor, "__setitem__", checked)


@pytest.mark.parametrize("name", ["cluster_jump_gibbsish", "gibbs_sample_sources_groups"])
def test_step_makes_no_host_copy(rt, start, monkeypatch, name):
    """The whole MH step of the operator (``apply``: operator, acceptance,
    deferred row write) builds no tensor from host values and writes no
    Python scalar into one."""
    apply = rt.apply_fn()
    refuse_host_copies(monkeypatch)
    state, accept, _, _ = apply(rt.op_names.index(name), torch.Generator().manual_seed(SEED),
                                start[0])
    assert state.n_chains == CHAINS and accept.shape == (CHAINS,)


def test_jump_moves_equal_the_unchanged_formula(rt, start, monkeypatch):
    """The candidate's memberships are those of the writes of a Python scalar
    at the drawn pair and object, for three seeds."""
    import sbayes_tpu_torch.sampling.operators as ops

    pair, pick = ops._random_cluster_pair, ops._masked_categorical
    states = start[0]
    ar = torch.arange(CHAINS)
    for seed in range(3):
        drawn = {}
        monkeypatch.setattr(ops, "_random_cluster_pair",
                            lambda *a: drawn.setdefault("pair", pair(*a)))
        monkeypatch.setattr(ops, "_masked_categorical",
                            lambda *a: drawn.setdefault("obj", pick(*a)))
        res = _op(rt, "cluster_jump_gibbsish")(torch.Generator().manual_seed(seed), states)
        (i_src, i_tgt), obj = drawn["pair"], drawn["obj"]
        want = states.clusters.clone()
        want[ar, i_src, obj] = False
        want[ar, i_tgt, obj] = True
        assert torch.equal(res.state.clusters, want)
        assert not torch.equal(want, states.clusters)


def test_group_source_draws_equal_the_unchanged_formula(rt, start):
    """The objects the source operator over a group's members resamples are
    those of the group draw with its tables built from host lists in the
    step, for four seeds."""
    from sbayes_tpu_torch.sampling.operators import _gumbel

    c, states = rt.consts, start[0]
    B, N, K = CHAINS, c.N, c.K
    n_conf = len(c.conf_names)
    comps = set()
    for seed in range(4):
        res = _op(rt, "gibbs_sample_sources_groups")(torch.Generator().manual_seed(seed), states)
        gen = torch.Generator().manual_seed(seed)
        comp = torch.randint(0, 1 + n_conf, (B,), generator=gen)
        n_groups = torch.tensor([K] + [int(n) for n in c.n_groups])
        g_idx = torch.randint(0, 10 ** 9, (B,), generator=gen) % n_groups[comp]
        offsets = torch.tensor([0] + [K + i * c.Gmax for i in range(n_conf)])
        stacked = torch.cat([states.clusters,
                             (c.groups > 0).reshape(1, -1, N).expand(B, -1, -1)], dim=1)
        member = stacked[torch.arange(B), offsets[comp] + g_idx]
        scores = torch.where(member, _gumbel(gen, (B, N), "cpu"), torch.tensor(float("-inf")))
        top_vals, top_idx = torch.topk(scores, min(30, N), dim=-1)
        assert torch.equal(res.source_rows[0], torch.where(torch.isfinite(top_vals), top_idx, N))
        comps |= set(comp.tolist())
    assert comps == set(range(1 + n_conf))


@pytest.mark.parametrize("prior", [
    {"objects_per_cluster": {"type": "uniform_size", "min": 2, "max": 8}},
    {"geo": {"type": "cost_based", "rate": 1e5, "probability_function": "sigmoid",
             "inflection_point": 3e5}}], ids=["uniform_size", "sigmoid"])
def test_priors_make_no_host_copy(start, monkeypatch, prior):
    """The size prior under ``uniform_size`` and the geo prior under the
    sigmoid probability make no host copy, and give the bits of their former
    scalar copies (``torch.tensor`` of N, of inflection point / scale)."""
    post = runtime(**prior).post
    clusters = start[0].clusters
    c = post.consts
    sizes = clusters.sum(-1).float()
    agg = torch.rand((CHAINS, c.K), generator=torch.Generator().manual_seed(1)) * 1e6
    if "geo" in prior:
        x0, s = c.geo.inflection_point, c.geo.scale
        log_expit = torch.nn.functional.logsigmoid
        want = log_expit(-(agg - x0) / s) - log_expit(torch.tensor(x0 / s, dtype=agg.dtype))
    else:
        n = torch.tensor(float(c.N))
        want = -(torch.lgamma(n + 1.0) - torch.lgamma(sizes + 1.0).sum(-1)
                 - torch.lgamma(n - sizes.sum(-1) + 1.0))
    refuse_host_copies(monkeypatch)
    got = post._geo_probability_function(agg) if "geo" in prior else post.size_prior(clusters)
    assert torch.equal(got, want)


def test_graphs_never_engage_on_the_cpu(rt, start):
    """A chunk on the CPU runs the eager step: the record counts its steps
    and neither a replay nor a capture."""
    from sbayes_tpu_torch.sampling import graphs
    from sbayes_tpu_torch.sampling.runner import make_generators

    before = dataclasses.replace(graphs.record)
    gen, op_gen = make_generators(SEED + 1, "cpu")
    rt.run_chunk(gen, op_gen, start[0], start[1], 12)
    assert graphs.record.steps == before.steps + 12
    assert graphs.record.replayed == before.replayed == 0
    assert graphs.record.captures == before.captures == 0
    assert rt._graphs is None


@pytest.mark.parametrize("skeleton", ["mst", "delaunay"])
def test_which_operators_a_graph_holds(skeleton):
    """Every scheduled operator but the wide one is a graph's; under the
    Delaunay skeleton, whose triples are computed on the host, no operator
    that changes the clusters is."""
    from sbayes_tpu_torch.sampling.operators import get_operator_schedule

    rt = runtime(geo={"type": "cost_based", "rate": 1e5, "skeleton": skeleton})
    specs = get_operator_schedule(rt.cond, rt.mcmc_config.operators)
    assert [s.graphable for s in rt._op_specs] == [s.graphable for s in specs]
    assert {s.changes for s in specs} == {"clusters", "source", "weights"}
    for s in specs:
        host = s.name == "gibbsish_sample_cluster_wide_geo" or (
            skeleton == "delaunay" and s.changes == "clusters")
        assert s.graphable is not host, s.name
