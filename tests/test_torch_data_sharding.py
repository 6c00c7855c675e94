"""The object-axis (data) split of the PyTorch port (``parallel/mesh.py``
``data_mesh`` / ``ObjectSplit`` / ``SplitSource``, the split posterior,
conditionals and marginal, ``sampling/runner.py::grid_runtime``) against
the JAX package's ``tests/test_data_sharding.py`` on its data and settings
(``synthetic_data(64, 8, 4, 2, seed=9)`` at K = 2; ``(48, 32, 3, 2,
seed=13)`` at feature tiles of 16 on a 2 x 4 chains x objects grid), on
CPU "devices" (``parallel.mesh.visible_devices`` replaced, as in
``tests/test_torch_parallel.py``).

Tolerances: counts, pattern counts and the log-likelihood of a split state
are exact (integer counts; the likelihood from the summed counts),
against the JAX package rtol 1e-5 for the log-likelihood (lgamma in
another order); the source prior and the marginals of a split are float
sums in another order (rtol 1e-6, atol 1e-4 on totals near 1e3); the
statistical test of the split sampler against the unsplit one holds each
p-value at 1e-3 or more (Bonferroni over the objects)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

KW = dict(n_objects=64, n_features=8, n_states=4, n_families=2, seed=9)
KW_SCALE = dict(n_objects=48, n_features=32, n_states=3, n_families=2, seed=13)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_grid(n_chain_shards, n_data_shards):
    """``data_mesh`` over CPU "devices": ``visible_devices`` replaced."""
    from sbayes_tpu_torch.parallel import mesh

    n = n_chain_shards * n_data_shards
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "visible_devices", lambda device_type="cuda": [torch.device("cpu")] * n)
        return mesh.data_mesh(n_chain_shards, n_data_shards)


@pytest.fixture(scope="module")
def setup():
    """The port's model and runtime, 8 initial states (the EM initializer,
    unsplit), and the JAX model of the same data."""
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    cfg = synthetic_config(n_clusters=2, geo_prior="uniform")
    rt = SamplerRuntime(Model(synthetic_data(**KW), cfg.model, device="cpu"), cfg.mcmc)
    gen, _ = make_generators(2, "cpu")
    states = rt.init_chains(gen, 8)
    jm = JaxModel(jax_data(**KW), jax_config(n_clusters=2, geo_prior="uniform").model)
    return rt, states, jm


def _split_state(rt, states, n_blocks):
    from sbayes_tpu_torch.sampling.runner import grid_runtime

    sh = grid_runtime(rt, _cpu_grid(1, n_blocks))
    return sh, sh.rts[0], sh.split(states)[0]


def test_data_mesh_blocks_and_constants(setup):
    """The grid is the devices in row-major order; blocks are contiguous,
    the first ``N % S`` one object longer; each block holds its slice of
    every object-axis array, the head no O(N F) array; only blocks after
    the first count traffic."""
    from sbayes_tpu_torch.parallel.mesh import (
        OBJECT_ARRAYS, OBJECT_FEATURE_ARRAYS, ObjectSplit, data_mesh, object_blocks)

    devs = [torch.device("cpu")] * 6
    assert data_mesh(2, 3, devs) == ((devs[0],) * 3, (devs[0],) * 3)
    with pytest.raises(ValueError):
        data_mesh(2, 4, devs)
    assert object_blocks(10, 4) == ((0, 3), (3, 6), (6, 8), (8, 10))
    assert object_blocks(64, 4) == ((0, 16), (16, 32), (32, 48), (48, 64))
    rt, states, _ = setup
    c = rt.consts
    sp = ObjectSplit(c, ["cpu"] * 3)
    assert sp.bounds == ((0, 22), (22, 43), (43, 64))
    for (lo, hi), blk in zip(sp.bounds, sp.blocks):
        assert blk.N == hi - lo and blk.cost_matrix is None
        for name, axis in OBJECT_ARRAYS.items():
            assert torch.equal(getattr(blk, name), getattr(c, name).narrow(axis, lo, hi - lo))
    assert all(getattr(sp.head, k) is None for k in OBJECT_FEATURE_ARRAYS)
    assert torch.equal(sp.head.groups, c.groups) and sp.head.N == c.N
    x = torch.ones(5)
    assert sp.to_block(0, x) is x and sp.traffic.bytes["to_blocks"] == 0
    sp.to_block(2, x)
    assert sp.traffic.bytes == {"to_blocks": 20, "to_head": 0}


@pytest.mark.parametrize("n_blocks", [1, 2, 4])
def test_split_posterior_matches_jax(setup, n_blocks):
    """``tests/test_data_sharding.py:46`` on the port: the posterior of a
    split state against the JAX package's ``Posterior.parts`` and
    ``fill_state`` on the same numpy state: counts exactly, the
    log-likelihood rtol 1e-5, every prior part rtol 1e-5."""
    from sbayes_tpu.model.posterior import Posterior as JaxPosterior
    from sbayes_tpu.sampling.state import ChainState as JaxState

    rt, states, jm = setup
    sh, srt, st = _split_state(rt, states, n_blocks)
    got = srt.post.fill_state(st)
    jpost = JaxPosterior(jm.consts)
    fill = jax.jit(jpost.fill_state)
    for b in range(states.n_chains):
        want = fill(JaxState(jnp.asarray(states.clusters[b].numpy()),
                             jnp.asarray(states.weights[b].numpy()),
                             jnp.asarray(states.source[b].numpy()), 0.0, 0.0, jnp.zeros(4)))
        np.testing.assert_array_equal(got.cl_counts[b].numpy(), np.asarray(want.cl_counts))
        np.testing.assert_array_equal(got.conf_counts[b].numpy(), np.asarray(want.conf_counts))
        np.testing.assert_allclose(float(got.log_lh[b]), float(want.log_lh), rtol=1e-5)
        np.testing.assert_allclose(got.prior_parts[b].numpy(), np.asarray(want.prior_parts),
                                   rtol=1e-5)
    assert torch.equal(srt.post.log_likelihood(st), got.log_lh)


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("n_blocks", [1, 2, 3, 4])
def test_loglh_from_summed_block_counts_is_the_fused_likelihood(setup, n_blocks, packed):
    """``loglh_from_counts`` of the per-block ``loglh_counts`` summed in block
    order equals the fused ``log_likelihood`` bit for bit (3 blocks: uneven,
    22 / 21 / 21 objects), with the bool and the packed source."""
    from sbayes_tpu_torch.model.math import pack_source
    from sbayes_tpu_torch.ops import loglh
    from sbayes_tpu_torch.parallel.mesh import ObjectSplit

    rt, states, _ = setup
    c = rt.consts
    source = pack_source(states.source) if packed else states.source
    sp = ObjectSplit(c, ["cpu"] * n_blocks)
    total = None
    for (lo, hi), blk in zip(sp.bounds, sp.blocks):
        part = loglh.loglh_counts(blk, states.clusters[:, :, lo:hi], source[:, lo:hi])
        total = part if total is None else tuple(a + b for a, b in zip(total, part))
    fused = loglh.log_likelihood(c, states.clusters, source)
    assert torch.equal(loglh.loglh_from_counts(c, *total), fused)
    want = loglh.loglh_counts_plain(c, states.clusters, source)
    assert all(torch.equal(a, b) for a, b in zip(total, want))


def test_one_object_shard_is_bit_equal_to_the_unsplit_runtime(setup):
    """A 1 x 1 grid runs the unsplit runtime's bits: 30 steps of
    ``run_chunk`` from the same states and generators give the same state,
    counts and operator statistics."""
    from sbayes_tpu_torch.parallel.mesh import ShardGenerators
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt, states, _ = setup
    g1, o1 = make_generators(5, "cpu")
    a, sa = rt.run_chunk(g1, o1, states, rt.new_stats(8), 30)
    sh, _, st = _split_state(rt, states, 1)
    g2, o2 = make_generators(5, "cpu")
    b, sb = sh.run_chunk(ShardGenerators.of(g2), o2, [st], sh.new_stats(8), 30)
    b = sh.gather(b)
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y), name
    for x, y in zip(sa, sb[0]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_split_deterministic_parts_equal_unsplit(setup, n_blocks):
    """On one state, split over 2 and 4 blocks: counts, pattern counts and
    the log-likelihood bit-equal to the unsplit ones, the source prior
    within float order; the gathered rows of features, NA and source
    equal; every marginal variant and the proposal probabilities of the
    Gibbsish, wide and jump operators equal within float order."""
    from sbayes_tpu_torch.model.math import gather_rows
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    rt, states, _ = setup
    full = rt.refresh(states)
    _, srt, st = _split_state(rt, states, n_blocks)
    got = srt.refresh(st)
    for name in ("cl_counts", "conf_counts", "pat_counts", "log_lh"):
        assert torch.equal(getattr(got, name), getattr(full, name)), name
    torch.testing.assert_close(got.prior_parts, full.prior_parts, rtol=1e-6, atol=1e-4)

    idx = torch.tensor([[0, 17, 63, 64], [40, 2, 33, 16]]).repeat(4, 1)
    for a, b in zip(srt.cond.gather_obj(idx), rt.cond.gather_obj(idx)):
        assert torch.equal(a, b)
    assert torch.equal(gather_rows(st.source, idx, rt.consts.C),
                       gather_rows(states.source, idx, rt.consts.C))

    f_split, f_full = OperatorFactory(srt.cond), OperatorFactory(rt.cond)
    ic = torch.tensor([0, 1] * 4)
    inv_t = torch.linspace(0.5, 1.0, 8)
    for kw in ({}, {"heat_effect_lh": True}):
        torch.testing.assert_close(f_split._cluster_posterior(got, ic, **kw),
                                   f_full._cluster_posterior(full, ic, **kw), rtol=1e-6, atol=0)
    for ratio in (True, False):
        torch.testing.assert_close(f_split._marginal_impl(got, ic, None, False, ratio),
                                   f_full._marginal_impl(full, ic, None, False, ratio),
                                   rtol=1e-6, atol=1e-5)
    counts = (full.cl_counts, full.conf_counts)
    for logspace in (True, False):
        torch.testing.assert_close(
            f_split._jump_probability(got, counts, ic, 1 - ic, logspace),
            f_full._jump_probability(full, counts, ic, 1 - ic, logspace), rtol=1e-6, atol=0)
    hot = [type(rt.cond)(rt.post, 1.0 / inv_t, 1.0), type(srt.cond)(srt.post, 1.0 / inv_t, 1.0)]
    probs = [OperatorFactory(c)._make_wide_cluster_probs(0.15, 0.01 / 64)(s, ic, torch.ones(
        8, 64, dtype=torch.bool)) for c, s in zip(hot, (full, got))]
    torch.testing.assert_close(probs[1], probs[0], rtol=1e-6, atol=1e-9)


def _schedule_ops(cond):
    from sbayes_tpu_torch.config.schema import OperatorsConfig
    from sbayes_tpu_torch.sampling.operators import get_operator_schedule

    return get_operator_schedule(cond, OperatorsConfig())


OP_NAMES = ["cluster_naive_n1", "cluster_naive_n1_geo", "cluster_naive_n2_geo",
            "cluster_gibbsish", "cluster_gibbsish_geo", "gibbsish_sample_cluster_wide_geo",
            "cluster_jump_gibbsish", "gibbs_sample_sources", "gibbs_sample_sources_groups",
            "gibbs_sample_weights"]


@pytest.mark.parametrize("op_name", OP_NAMES)
def test_one_mh_step_of_every_operator_on_split_state(setup, op_name):
    """``tests/test_data_sharding.py:69`` on the port: one MH step of each
    scheduled operator on a state split over 4 blocks: no accepted
    non-finite posterior, and the carried counts, pattern counts,
    log-likelihood and prior parts equal to a recompute of the stepped
    state."""
    from sbayes_tpu_torch.sampling.kernel import make_mh_apply_fn

    rt, states, _ = setup
    _, srt, st = _split_state(rt, states, 4)
    ops = _schedule_ops(srt.cond)
    assert [o.name for o in ops] == OP_NAMES
    apply = make_mh_apply_fn(srt.cond, ops)
    gen = torch.Generator().manual_seed(50 + OP_NAMES.index(op_name))
    new, accept, _size, nf = apply(OP_NAMES.index(op_name), gen, st)
    assert int(nf.sum()) == 0 and bool(torch.isfinite(new.log_lh).all())
    ref = srt.refresh(new)
    for name in ("cl_counts", "conf_counts", "pat_counts"):
        assert torch.equal(getattr(new, name), getattr(ref, name)), name
    torch.testing.assert_close(new.log_lh, ref.log_lh, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(new.prior_parts, ref.prior_parts, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("rule", ["wide_rows_cap", "source_sweep"])
def test_scale_path_rules_on_split_state(setup, rule):
    """The scale path's rules on a state split over 4 blocks: the wide
    operator at a rows cap of 6 (moves above it rejected) and the exact
    source sweep of a group's members, 5 MH steps each: finite, carried
    state equal to its recompute, and with the sweep every step accepted."""
    from sbayes_tpu_torch.sampling.kernel import make_mh_apply_fn
    from sbayes_tpu_torch.sampling.operators import OperatorFactory, OperatorSpec

    rt, states, _ = setup
    _, srt, st = _split_state(rt, states, 4)
    if rule == "wide_rows_cap":
        f = OperatorFactory(srt.cond, wide_rows_cap=6)
        spec = OperatorSpec("wide", 1.0, f.make_alter_cluster_wide(), "clusters")
    else:
        f = OperatorFactory(srt.cond, source_sweep=True)
        spec = OperatorSpec("sweep", 1.0, f.make_gibbs_sample_source("groups", 30), "source")
    apply = make_mh_apply_fn(srt.cond, [spec])
    gen = torch.Generator().manual_seed(7)
    n_acc = 0
    for _ in range(5):
        st, accept, size, nf = apply(0, gen, st)
        n_acc += int(accept.sum())
        assert int(nf.sum()) == 0
        if rule == "wide_rows_cap":
            assert not bool((accept & (size > 6)).any())
    if rule == "source_sweep":
        assert n_acc == 5 * 8
    ref = srt.refresh(st)
    for name in ("cl_counts", "conf_counts", "pat_counts"):
        assert torch.equal(getattr(st, name), getattr(ref, name)), name
    torch.testing.assert_close(st.log_lh, ref.log_lh, rtol=1e-5, atol=1e-3)


def test_run_chunk_on_a_2x4_grid_keeps_every_invariant():
    """``tests/test_data_sharding.py:95-178`` on the port: 25 steps of the
    production ``run_chunk`` on a 2 x 4 chains x objects grid at feature
    tiles of 16 (two chains, one per chain shard, each on 4 object blocks of
    12 objects; the rows stepped in turn from this thread, neither in a
    worker), from states initialised unsplit: finite, every step
    counted, no non-finite posterior, and the carried counts, pattern
    counts, prior parts and log-likelihood of the gathered states equal to
    the unsplit recompute (counts exactly; the carried log-likelihood is a
    sum of exact deltas in float32, rtol 1e-4 / atol 1e-2 as in the JAX
    test), the split recompute's log-likelihood equal to the unsplit one
    bit for bit, and the counts to the JAX package's."""
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.model.posterior import Posterior as JaxPosterior
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.parallel.mesh import ShardGenerators
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, grid_runtime, make_generators
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    cfg = synthetic_config(n_clusters=2, geo_prior="uniform")
    model = Model(synthetic_data(**KW_SCALE), cfg.model, device="cpu", feature_chunk=16)
    assert model.consts.feature_chunk == 16
    rt = SamplerRuntime(model, cfg.mcmc)
    gen, op_gen = make_generators(0, "cpu")
    states = rt.init_chains(gen, 2)
    sh = grid_runtime(rt, _cpu_grid(2, 4))
    assert (sh.n_shards, sh.n_local) == (2, 2) and [sp.bounds for sp in sh.splits] == [
        ((0, 12), (12, 24), (24, 36), (36, 48))] * 2
    shards, stats = sh.run_chunk(ShardGenerators.of(gen), op_gen, sh.split(states),
                                 sh.new_stats(2), 25)
    final = sh.gather(shards)
    assert bool(torch.isfinite(final.log_lh).all())
    assert sh.non_finite(stats) == 0
    assert sum(int((s.accepts + s.rejects).sum()) for s in stats) == 25 * 2
    ref = rt.refresh(final)
    for name in ("cl_counts", "conf_counts", "pat_counts"):
        assert torch.equal(getattr(final, name), getattr(ref, name)), name
    torch.testing.assert_close(final.log_lh, ref.log_lh, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(final.prior_parts, ref.prior_parts, rtol=1e-4, atol=1e-2)
    split_ref = sh.gather(sh.refresh(shards))
    assert torch.equal(split_ref.log_lh, ref.log_lh)
    jm = JaxModel(jax_data(**KW_SCALE), jax_config(n_clusters=2, geo_prior="uniform").model)
    fill = jax.jit(JaxPosterior(jm.consts).fill_state)
    for b in range(2):
        want = fill(JaxState(jnp.asarray(final.clusters[b].numpy()),
                             jnp.asarray(final.weights[b].numpy()),
                             jnp.asarray(final.source[b].numpy()), 0.0, 0.0, jnp.zeros(4)))
        np.testing.assert_array_equal(final.cl_counts[b].numpy(), np.asarray(want.cl_counts))
        np.testing.assert_array_equal(final.pat_counts[b].numpy(), np.asarray(want.pat_counts))
        np.testing.assert_allclose(float(final.log_lh[b]), float(want.log_lh), rtol=1e-5)


def test_grid_rows_equal_their_runs_alone(setup):
    """A 2 x 2 grid (two chain shards of 4 chains, each on 2 object blocks),
    20 steps of ``run_chunk``: each row, stepped in turn with the others,
    equals, bit for bit, its chains run alone by its own runtime from that
    row's generator on the same operator draws (every field of the gathered
    state, every statistic)."""
    from sbayes_tpu_torch.parallel.mesh import (
        ShardGenerators,
        chain_block,
        shard_state,
        unshard_state,
    )
    from sbayes_tpu_torch.sampling.runner import grid_runtime, make_generators

    def copy(x):
        return type(x)(*(None if t is None else t.clone() for t in x))

    def same(a, b):
        for name, x, y in zip(a._fields, a, b):
            assert (x is None) == (y is None), name
            assert x is None or (x.dtype == y.dtype and torch.equal(x, y)), name

    rt, states, _ = setup
    sh = grid_runtime(rt, _cpu_grid(2, 2))
    gen, op_gen = make_generators(7, "cpu")
    shards, stats = sh.run_chunk(ShardGenerators(gen), op_gen, sh.split(copy(states)),
                                 sh.new_stats(8), 20)

    gen, op_gen = make_generators(7, "cpu")
    ops = rt.draw_ops(op_gen, 20)
    alone = ShardGenerators(gen).for_mesh(sh.mesh)
    for j, rt_j in enumerate(sh.rts):
        start = shard_state(chain_block(copy(states), j, 2), sh.splits[j])
        st, ss = rt_j.run_ops(alone[j], ops, start, rt_j.new_stats(4))
        same(unshard_state(st, "cpu"), unshard_state(shards[j], "cpu"))
        same(ss, stats[j])
    assert not torch.equal(shards[0].clusters, shards[1].clusters)     # distinct streams


def test_split_sampler_matches_the_unsplit_sampler(setup):
    """The split sampler is the unsplit one's kernel: 128 chains from the
    same 8 initial states, 40 steps each on a 1 x 2 grid and unsplit, from
    different seeds. Each object's membership (Fisher's exact test,
    Bonferroni over the 64 objects), the cluster sizes (Mann-Whitney) and
    the mean of one weight (Welch's t-test) agree at p >= 1e-3."""
    from scipy.stats import fisher_exact, mannwhitneyu, ttest_ind

    from sbayes_tpu_torch.parallel.mesh import ShardGenerators
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt, states, _ = setup
    start = states.select(torch.arange(128) % 8)
    g1, o1 = make_generators(11, "cpu")
    a, _ = rt.run_chunk(g1, o1, start, rt.new_stats(128), 40)
    sh, _, st = _split_state(rt, start, 2)
    g2, o2 = make_generators(12, "cpu")
    b, _ = sh.run_chunk(ShardGenerators.of(g2), o2, [st], sh.new_stats(128), 40)
    b = sh.gather(b)
    mem_a = a.clusters.any(1).sum(0).numpy()
    mem_b = b.clusters.any(1).sum(0).numpy()
    p_obj = [fisher_exact([[x, 128 - x], [y, 128 - y]]).pvalue for x, y in zip(mem_a, mem_b)]
    assert min(p_obj) * 64 >= 1e-3
    sizes_a, sizes_b = a.clusters.sum(-1).flatten().numpy(), b.clusters.sum(-1).flatten().numpy()
    assert mannwhitneyu(sizes_a, sizes_b).pvalue >= 1e-3
    assert ttest_ind(a.weights[:, 0, 0].numpy(), b.weights[:, 0, 0].numpy(),
                     equal_var=False).pvalue >= 1e-3
    assert not torch.equal(a.clusters, b.clusters)      # independent draws
