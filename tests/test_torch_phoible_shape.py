"""The port at PHOIBLE's kind of shape (many binary features, many families),
where every switch of the scale path is on: the packed int8 source, feature
tiles with a shorter last tile, the sequential source sweep and the
log-space jump.

- The tile rule: 512-feature tiles with a last one of 111 at PHOIBLE's
  3,183 features, where the JAX package's divisor rule gives 1,061 tiles of 3.
- Ragged tiles against the untiled port at 60 objects x 601 binary features,
  K = 3, 12 families, tiles of 128 (4 of 128 and one of 89). Counts are
  exact integers (equal). Log-densities: rtol 1e-5, atol 1e-5 (float32 sums
  over the tiles in another order; those of tests/test_torch_feature_chunk.py).
  Per-cell likelihoods and probabilities: rtol 1e-6 (the same elementwise
  arithmetic on a slice).
- The port with every switch on against the benchmark's float64 reference
  (``perfbench/reference``) on seeded random states: counts equal; the
  log-likelihood and the prior parts within 1e-5 of the reference's
  magnitude (float32 sums of ~36,000 terms); the marginal's log-odds within
  1e-4 absolute per object, scaled by the 601 / 36 features summed
  (``ops/check.py``'s ``MARGINAL_TOL_ABS``, ``MARGINAL_TOL_FEATURES``).
- The EM start at many features in bounds (ROADMAP C.4), and a chunk of the
  sweep and the jump from it leaving valid states whose carried counts
  equal their recompute."""
import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import datagen, harness  # noqa: E402
from perfbench.reference.posterior import Reference  # noqa: E402
from test_torch_posterior_ops import numpy_state  # noqa: E402

N, F, FAMILIES, K, CHUNK, B = 60, 601, 12, 3, 128, 4
RTOL_DENSITY, ATOL_DENSITY = 1e-5, 1e-5
RTOL_TILES = 1e-6
REL_REFERENCE = 1e-5
MARGINAL_ATOL = 1e-4 * F / 36


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config() -> dict:
    """``phoible_k5``'s model at K = 3, sizes 3-30, the EM at 2 attempts of 10 steps."""
    cfg = copy.deepcopy(json.loads((ROOT / "perfbench" / "configs" / "phoible_k5.json")
                                   .read_text()))
    cfg["model"]["clusters"] = K
    cfg["model"]["prior"]["objects_per_cluster"].update(min=3, max=30)
    cfg["mcmc"]["initialization"].update(attempts=2, em_steps=10)
    return cfg


@pytest.fixture(scope="module")
def arrays():
    return datagen.large(N, F, 2, FAMILIES, seed=21, na_fraction=0.01)


def model(arrays, **switches):
    from sbayes_tpu_torch.config.schema import ModelConfig
    from sbayes_tpu_torch.model.model import Model

    return Model(harness.port_data(arrays), ModelConfig.from_dict(config()["model"]),
                 device="cpu", **switches)


def runtime(arrays, **switches):
    from sbayes_tpu_torch.config.schema import MCMCConfig
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime

    return SamplerRuntime(model(arrays, **switches), MCMCConfig.from_dict(config()["mcmc"]))


@pytest.fixture(scope="module")
def models(arrays):
    """The port untiled with the bool source, and with every switch on."""
    return {"plain": model(arrays, source_packed=False, feature_chunk=0),
            "switched": model(arrays, source_packed=True, feature_chunk=CHUNK)}


def states(m, seed=0):
    from sbayes_tpu_torch.sampling.state import ChainState

    c = m.consts
    ds = [numpy_state(c.K, c.N, c.F, c.C, c.na.numpy(), seed=seed + s, min_size=3)
          for s in range(B)]
    d = {k: np.stack([x[k] for x in ds]) for k in ds[0]}
    # an object in no cluster takes the universal component where it drew the cluster's
    outside = ~d["clusters"].any(1)[:, :, None]
    d["source"][..., 1] |= d["source"][..., 0] & outside
    d["source"][..., 0] &= ~outside
    st = ChainState.from_numpy(d)
    return m.posterior.fill_state(st._replace(source=m.posterior.source_form(st.source)))


def test_phoible_tiles_and_the_jax_rule():
    from sbayes_tpu.model.constants import auto_feature_chunk as jax_rule
    from sbayes_tpu_torch.model.constants import auto_feature_chunk
    from sbayes_tpu_torch.model.math import feature_tiles

    assert auto_feature_chunk(2186, 3183) == 512
    tiles = feature_tiles(3183, auto_feature_chunk(2186, 3183))
    assert [t.stop - t.start for t in tiles] == [512] * 6 + [111]
    # the JAX package's divisor rule: 3,183 = 3 x 1,061
    assert jax_rule(2186, 3183) == 3
    # a divisor within a factor of two of 512 stays the JAX package's
    for n, f in [(10_000, 5_000), (2_000, 2_001), (4_000, 1_000), (3_000, 1_500)]:
        assert auto_feature_chunk(n, f) == jax_rule(n, f)
    # small models take no tiles; a prime F past the threshold takes 512
    assert auto_feature_chunk(2186, 195) is None and auto_feature_chunk(5_000, 1_031) == 512


def test_the_model_takes_its_switches(models):
    from sbayes_tpu_torch.sampling.operators import OperatorFactory
    from sbayes_tpu_torch.sampling.conditionals import Conditionals

    c = models["switched"].consts
    assert c.source_packed and c.feature_chunk == CHUNK
    assert models["plain"].consts.feature_chunk is None
    factory = OperatorFactory(Conditionals(models["switched"].posterior))
    assert factory.source_sweep and factory.sweeps("groups") and not factory.sweeps("all")


def test_ragged_tiles_equal_untiled(models):
    from sbayes_tpu_torch.model.math import feature_tiles, tile_passes
    from sbayes_tpu_torch.sampling.conditionals import Conditionals

    ref, got = states(models["plain"]), states(models["switched"])
    for name in ("cl_counts", "conf_counts", "pat_counts"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=0, atol=0)
    for name in ("log_lh", "log_prior", "prior_parts"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=RTOL_DENSITY, atol=ATOL_DENSITY)
    plain = Conditionals(models["plain"].posterior)
    tiled = Conditionals(models["switched"].posterior)
    torch.testing.assert_close(tiled.likelihood_per_component_exact(got.clusters, got.source),
                               plain.likelihood_per_component_exact(ref.clusters, ref.source),
                               rtol=RTOL_TILES, atol=0)
    want = plain.source_posterior(ref.clusters, ref.weights, ref.source)
    tiles = feature_tiles(F, CHUNK)
    assert [t.stop - t.start for t in tiles] == [128] * 4 + [89]
    parts = torch.cat([tiled.source_posterior(got.clusters, got.weights, got.source, sl=sl)
                       for sl in tiles], dim=2)
    torch.testing.assert_close(parts, want, rtol=RTOL_TILES, atol=0)
    # one count a tile walked: the counts walk 5 tiles, the untiled model none
    before = tile_passes.count
    models["switched"].posterior.feature_counts(got.clusters, got.source)
    assert tile_passes.count - before == 5
    models["plain"].posterior.feature_counts(ref.clusters, ref.source)
    assert tile_passes.count - before == 5


def test_every_switch_against_the_reference(arrays, models):
    from sbayes_tpu_torch.ops import marginal

    m = models["switched"]
    st = states(m, seed=10)
    assert st.source.dtype == torch.int8
    ref = Reference(arrays, config()["model"])
    end = ref.evaluate(st.clusters.numpy(), st.weights.numpy(), st.source.numpy())
    for name in ("cl_counts", "conf_counts", "pat_counts"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), end[name])
    scale = np.maximum(1.0, np.abs(end["log_lh"]))
    assert (np.abs(st.log_lh.double().numpy() - end["log_lh"]) / scale).max() < REL_REFERENCE
    scale = np.maximum(1.0, np.abs(end["prior_parts"]).max())
    assert (np.abs(st.prior_parts.double().numpy() - end["prior_parts"]) / scale).max() \
        < REL_REFERENCE
    in_conf = np.stack([np.ones(N, bool), arrays["families"].any(0)], -1)
    inputs = harness.marginal_inputs(st, m.consts.applicable, in_conf, None)
    got = marginal.marginal(m.consts, *[torch.as_tensor(x) for x in inputs[:6]], None,
                            ratio=True).numpy()
    want = ref.marginal(*inputs)
    assert np.abs(want).max() > 10                     # log-odds of many features: power
    np.testing.assert_allclose(got, want, rtol=0, atol=MARGINAL_ATOL)


def test_em_start_in_bounds_at_many_features(arrays):
    """The discretization the JAX package shares (``_discretize_fuzzy_clusters``)
    leaves clusters below the minimum at 601 features (ROADMAP C.4); the
    port's EM start holds every cluster in bounds and keeps the chains the
    discretization left at the minimum or above as they were."""
    from sbayes_tpu_torch.sampling import initializer as init_mod

    rt = runtime(arrays, source_packed=True, feature_chunk=CHUNK)
    c = rt.consts
    init = init_mod.Initializer(rt.cond, initial_size=10, attempts=1, n_em_steps=10)
    kept = []
    plain = init._in_bounds

    def in_bounds(clusters, log_z, total_size):
        kept.append(clusters)
        return plain(clusters, log_z, total_size)

    init._in_bounds = in_bounds
    got = init.generate_clusters_em(torch.Generator().manual_seed(3), 8)
    js = kept[0].sum(-1)
    assert (js < c.min_size).any(), js                 # the finding shows at this shape
    sizes = got.sum(-1)
    assert ((sizes >= c.min_size) & (sizes <= c.max_size)).all(), sizes
    assert (got.sum(1) <= 1).all()
    whole = (js >= c.min_size).all(-1)
    assert torch.equal(got[whole], kept[0][whole])


def test_sweep_chunk_from_the_em_start(arrays):
    """``init_chains`` and a chunk of the sweep operators and the log-space
    jump with every switch on: valid states (sizes in bounds, disjoint
    clusters), the carried counts equal to their recompute, the carried
    log-likelihood within float32 rounding of it; the sweep accepts every
    step and moves sources."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = runtime(arrays, source_packed=True, feature_chunk=CHUNK)
    c = rt.consts
    assert [s.sweep for s in rt._op_specs].count(True) == 2
    gen, _ = make_generators(2**31 + 5, "cpu")
    st = rt.init_chains(gen, B)
    sweeps = [i for i, s in enumerate(rt._op_specs) if s.sweep]
    jump = rt.op_names.index("cluster_jump_gibbsish")
    stats = rt.new_stats(B)
    start = st.source.clone()
    st, stats = rt.run_ops(gen, (sweeps + [jump]) * 4, st, stats)
    sizes = st.clusters.sum(-1)
    assert ((sizes >= c.min_size) & (sizes <= c.max_size)).all(), sizes
    assert (st.clusters.sum(1) <= 1).all()
    again = rt.refresh(st)
    for name in ("cl_counts", "conf_counts", "pat_counts"):
        torch.testing.assert_close(getattr(st, name), getattr(again, name), rtol=0, atol=0)
    torch.testing.assert_close(st.log_lh, again.log_lh, rtol=RTOL_DENSITY, atol=1e-3)
    assert (st.source != start).any()
    assert (stats.accepts[:, sweeps] == 4).all()


def test_init_batches_by_the_attempt_chains_bytes():
    """One batch for the benchmark's other configurations, four for
    phoible_k5's 32 chains x 10 attempts."""
    from types import SimpleNamespace

    from sbayes_tpu_torch.sampling.initializer import Initializer

    def per(n, f, c, chains, attempts=10):
        init = SimpleNamespace(consts=SimpleNamespace(N=n, F=f, C=c), attempts=attempts)
        return Initializer.chains_per_batch(init, chains)

    assert per(100, 36, 3, 1024) == 1024                   # sa100_k3.ens1024
    assert per(2467, 195, 3, 64) == 64                     # grambank_k5.ens64
    assert per(2186, 3183, 3, 32) == 8                     # phoible_k5.ens32
    assert per(2186, 3183, 3, 1) == 1


def test_batched_init_statistically_equals_one_batch(monkeypatch):
    """The init in batches of one chain against one batch, at 60 objects x 40
    binary features, K = 3, 3 attempts a chain, 96 chains each from its own
    seed: the chosen states' log-likelihoods and cluster sizes come from
    the same distribution (two-sample Kolmogorov-Smirnov, p above 1e-3);
    in one batch the result is the same bits whatever the budget."""
    from scipy.stats import ks_2samp

    from sbayes_tpu_torch.sampling import initializer as init_mod
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = runtime(datagen.large(N, 40, 2, FAMILIES, seed=22, na_fraction=0.01))
    init = init_mod.Initializer(rt.cond, initial_size=5, attempts=3, n_em_steps=10)
    n = 96
    one = init.generate_sample(make_generators(1, "cpu")[0], n)
    monkeypatch.setattr(init_mod, "BATCH_BYTES", 1)
    assert init.chains_per_batch(n) == 1
    batched = init.generate_sample(make_generators(2, "cpu")[0], n)
    same_seed = init.generate_sample(make_generators(1, "cpu")[0], n)
    assert not torch.equal(same_seed.clusters, one.clusters)        # other draws, in batches
    lh = [rt.post.log_likelihood(s).numpy() for s in (one, batched)]
    assert ks_2samp(*lh).pvalue > 1e-3, lh
    sizes = [s.clusters.sum(-1).flatten().numpy() for s in (one, batched)]
    assert ks_2samp(*sizes).pvalue > 1e-3, sizes
    monkeypatch.setattr(init_mod, "BATCH_BYTES", 1 << 62)
    again = init.generate_sample(make_generators(1, "cpu")[0], n)
    for a, b in zip(one, again):
        assert (a is None and b is None) or torch.equal(a, b)


def test_sweep_spans_and_tile_passes_only_under_a_profiler(arrays):
    """A chunk with every switch on, run plain and under the profiler from
    the same start and seeds: the same bits; ``sbt.sweep`` spans (each
    around one ``sbt.op`` of a sweep operator) only in the profiled run;
    ``tracing.profiled`` counts the profiled chunk's steps and tile passes
    only, and its passes equal the counter's change."""
    from sbayes_tpu_torch import tracing
    from sbayes_tpu_torch.model.math import tile_passes
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = runtime(arrays, source_packed=True, feature_chunk=CHUNK)
    start = rt.init_chains(make_generators(4, "cpu")[0], B)
    sweeps = {f"sbt.op/{s.name}" for s in rt._op_specs if s.sweep}
    wide = rt.op_names.index("gibbsish_sample_cluster_wide_geo")
    ops = [wide] + [i for i, s in enumerate(rt._op_specs) if s.sweep] * 2

    def chunk():
        gen, _ = make_generators(5, "cpu")
        return rt.run_ops(gen, ops, start, rt.new_stats(B))

    assert tracing.span("sbt.sweep") is tracing._OFF
    before = (tracing.profiled.steps, tracing.profiled.tile_passes)
    plain = chunk()
    assert (tracing.profiled.steps, tracing.profiled.tile_passes) == before
    passes = tile_passes.count
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = chunk()
    assert tracing.profiled.steps - before[0] == len(ops)
    assert tracing.profiled.tile_passes - before[1] == tile_passes.count - passes
    for a, b in zip((*plain[0], *plain[1]), (*traced[0], *traced[1])):
        assert (a is None and b is None) or torch.equal(a, b)
    events = prof.events()
    spans = [e for e in events if e.name == "sbt.sweep"]
    assert len(spans) == 4
    inner = [e for e in events if e.name in sweeps]
    assert len(inner) == 4
    for s in spans:
        assert any(s.time_range.start <= e.time_range.start
                   and e.time_range.end <= s.time_range.end for e in inner)
