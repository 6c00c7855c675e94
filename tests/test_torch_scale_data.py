"""The port's copy of the scale workload's data generator
(``sbayes_tpu_torch/testing_scale.py``) against the JAX package's, at a small
size: the same arrays from the same arguments (exact: both are numpy drawn
from one seed), and the optional cache gives back what it stored."""
import numpy as np
import pytest

import jax

KW = dict(n_objects=60, n_features=40, n_states=5, n_families=4, seed=3)


def _arrays(data):
    return {"values": data.features.values, "na": data.features.na_values,
            "states": data.features.states, "locations": np.asarray(data.objects.locations),
            **{f"conf_{name}": conf.group_assignment for name, conf in data.confounders.items()}}


@pytest.mark.parametrize("kw", [KW, dict(KW, n_states=3, n_families=1, seed=0)],
                         ids=["default", "one_family"])
def test_synthetic_data_large_equals_jax(kw):
    from sbayes_tpu.testing_scale import synthetic_data_large as jax_large
    from sbayes_tpu_torch.testing_scale import synthetic_data_large

    got, want = synthetic_data_large(**kw), jax_large(**kw)
    assert got.features.na_number == want.features.na_number
    assert list(got.confounders) == list(want.confounders) == ["universal", "family"]
    assert got.objects.id == want.objects.id
    for name, a in _arrays(got).items():
        np.testing.assert_array_equal(a, _arrays(want)[name], err_msg=name)


def test_cache_dir_gives_back_the_drawn_arrays(tmp_path):
    from sbayes_tpu_torch.testing_scale import synthetic_data_large

    fresh = synthetic_data_large(**KW, cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("*.npz"))) == 1
    cached = synthetic_data_large(**KW, cache_dir=str(tmp_path))
    for name, a in _arrays(fresh).items():
        np.testing.assert_array_equal(a, _arrays(cached)[name], err_msg=name)


def test_scale_model_constants_on_small_data():
    """The scale workload's model (K = 5, uniform geo prior, sizes 10-3000)
    builds on the generator's data; the (N, N) cost matrix is not kept
    under the uniform geo prior above 2000 objects."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config
    from sbayes_tpu_torch.testing_scale import synthetic_data_large

    cfg = synthetic_config(n_clusters=5, geo_prior="uniform")
    cfg.model.prior.objects_per_cluster.min = 10
    cfg.model.prior.objects_per_cluster.max = 3000
    c = Model(synthetic_data_large(2100, 8, 5, n_families=10, seed=0), cfg.model,
              device="cpu").consts
    assert (c.K, c.N, c.F, c.S, c.C, c.Gmax) == (5, 2100, 8, 5, 3, 10)
    assert (c.min_size, c.max_size) == (10, 2100)
    assert tuple(c.cost_matrix.shape) == (1, 1)


def test_em_initializer_at_many_features_equals_jax(monkeypatch):
    """Pins a finding about the JAX package (ROADMAP C.4): on the scale
    workload's data at many features (400 objects x 600 features here) the
    EM responsibilities of the clusters underflow to 0, the discretization's
    ties put all but the last cluster's minimum into the first cluster and
    leave the others empty. The port's discretization gives the JAX
    package's sizes on every chain, their random streams apart; the port's
    EM start then draws such chains anew from the log responsibilities
    (``Initializer._in_bounds``), every cluster within the size bounds."""
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.runner import SamplerRuntime as JaxRuntime
    from sbayes_tpu.testing import synthetic_config as jax_config
    from sbayes_tpu.testing_scale import synthetic_data_large as jax_large
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators
    from sbayes_tpu_torch.testing import synthetic_config
    from sbayes_tpu_torch.testing_scale import synthetic_data_large

    shape = dict(n_objects=400, n_features=600, n_states=5, n_families=10, seed=0)
    jcfg, cfg = jax_config(n_clusters=5, geo_prior="uniform"), synthetic_config(
        n_clusters=5, geo_prior="uniform")
    for c in (jcfg, cfg):
        c.model.prior.objects_per_cluster.min = 10
        c.model.prior.objects_per_cluster.max = 3000
    jinit = jcfg.mcmc.initialization.model_copy(update={
        "attempts": 1, "em_steps": 3, "objects_per_cluster": 20})
    jrt = JaxRuntime(JaxModel(jax_large(**shape), jcfg.model),
                     jcfg.mcmc.model_copy(update={"initialization": jinit}))
    init = cfg.mcmc.initialization
    init.attempts, init.em_steps, init.objects_per_cluster = 1, 3, 20
    rt = SamplerRuntime(Model(synthetic_data_large(**shape), cfg.model, device="cpu"), cfg.mcmc)
    want = np.asarray(jrt.init_chains(jax.random.PRNGKey(0), 2, shard=False).clusters).sum(-1)
    drawn = rt.init_chains(make_generators(0, "cpu")[0], 2).clusters.sum(-1).numpy()
    assert ((drawn >= 10) & (drawn <= 3000)).all(), drawn
    from sbayes_tpu_torch.sampling.initializer import Initializer

    monkeypatch.setattr(Initializer, "_in_bounds", lambda self, clusters, *a: clusters)
    got = rt.init_chains(make_generators(0, "cpu")[0], 2).clusters.sum(-1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == [390, 0, 0, 0, 10]).all()
