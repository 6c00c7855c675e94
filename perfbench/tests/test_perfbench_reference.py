"""The plain reference against the program's own recompute on the CPU: on
hand-built states of a tiny model (the test imports the program; the
reference does not)."""
import copy

import numpy as np
import pytest
import torch

import perfbench_helpers  # noqa: F401
from perfbench import datagen, harness
from perfbench.reference.posterior import Reference


def tiny(geo: str, packed: bool, seed: int = 4):
    cell, config = harness.load_cell("sa100_k3.ens1024")
    config = copy.deepcopy(config)
    config["model"]["clusters"] = 3
    config["model"]["prior"]["objects_per_cluster"].update(min=1, max=20)
    if geo == "uniform":
        config["model"]["prior"]["geo"] = {"type": "uniform"}
    arrays = datagen.small(25, 7, 4, 3, seed)
    from sbayes_tpu_torch.config.schema import ModelConfig
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.model.posterior import Posterior

    model = Model(harness.port_data(arrays), ModelConfig.from_dict(config["model"]),
                  device="cpu", source_packed=packed)
    return arrays, config, model, Posterior(model.consts)


def hand_built_states(consts, B: int = 6, seed: int = 0):
    """Disjoint clusters of random sizes, weights from a Dirichlet, and each
    observation's component drawn among those available to its object."""
    from sbayes_tpu_torch.model.math import pack_source
    from sbayes_tpu_torch.sampling.state import ChainState

    rng = np.random.default_rng(seed)
    K, N, F, C = consts.K, consts.N, consts.F, consts.C
    label = rng.integers(-1, K, size=(B, N))
    clusters = label[:, None, :] == np.arange(K)[None, :, None]
    weights = rng.dirichlet(np.ones(C), size=(B, F)).astype(np.float32)
    comp = rng.integers(0, C, size=(B, N, F))
    comp = np.where((comp == 0) & (label[:, :, None] < 0), 1, comp)
    na = consts.na.numpy()
    onehot = (comp[..., None] == np.arange(C)) & ~na[None, :, :, None]
    source = torch.as_tensor(onehot)
    if consts.source_packed:
        source = pack_source(source)
    z = torch.zeros(B)
    return ChainState(torch.as_tensor(clusters), torch.as_tensor(weights), source, z, z,
                      torch.zeros(B, 4))


@pytest.mark.parametrize("geo,packed", [("cost_based", False), ("uniform", True)])
def test_reference_equals_fill_state(geo, packed):
    arrays, config, model, post = tiny(geo, packed)
    states = post.fill_state(hand_built_states(model.consts))
    ref = Reference(arrays, config["model"]).evaluate(
        states.clusters.numpy(), states.weights.numpy(), states.source.numpy())
    for key in ("cl_counts", "conf_counts", "pat_counts"):
        assert np.array_equal(ref[key], getattr(states, key).numpy()), key
    for key in ("log_lh", "log_prior", "prior_parts"):
        np.testing.assert_allclose(ref[key], getattr(states, key).numpy(), rtol=2e-6,
                                   atol=2e-4, err_msg=key)
    if geo == "cost_based":
        got = states.geo_agg.numpy()
        assert np.array_equal(ref["geo_agg"][..., 1], got[..., 1])
        np.testing.assert_allclose(ref["geo_agg"], got, rtol=1e-5)
        assert (ref["prior_parts"][:, 1] < 0).all()
    else:
        assert "geo_agg" not in ref


@pytest.mark.parametrize("heat", [False, True])
def test_reference_marginal_equals_the_program(heat):
    from sbayes_tpu_torch.ops.marginal import marginal_plain

    arrays, config, model, post = tiny("cost_based", False, seed=6)
    states = post.fill_state(hand_built_states(model.consts, B=5, seed=2))
    in_conf = np.stack([np.ones(25, bool), arrays["families"].any(0)], -1)
    temps = torch.linspace(1.0, 1.3, 5) if heat else None
    inputs = harness.marginal_inputs(states, model.consts.applicable, in_conf, temps)
    args = [None if x is None else torch.as_tensor(x) for x in inputs]
    want = marginal_plain(model.consts, *args[:6], args[6], ratio=True).numpy()
    got = Reference(arrays, config["model"]).marginal(*inputs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_reference_finds_a_changed_count_and_an_overlap():
    from perfbench.compare import state_numbers

    arrays, config, model, post = tiny("cost_based", False)
    states = post.fill_state(hand_built_states(model.consts))
    program = {k: getattr(states, k).numpy().copy() for k in (
        "cl_counts", "conf_counts", "pat_counts", "log_lh", "log_prior", "prior_parts",
        "geo_agg")}
    ref = Reference(arrays, config["model"])
    end = ref.evaluate(states.clusters.numpy(), states.weights.numpy(), states.source.numpy())
    assert state_numbers(program, end, 1, 20)["count_mismatch"] == 0
    program["cl_counts"][0, 0, 0, 0] += 1
    assert state_numbers(program, end, 1, 20)["count_mismatch"] == 1
    clusters = states.clusters.numpy().copy()
    clusters[0, :, 0] = True
    end = ref.evaluate(clusters, states.weights.numpy(), states.source.numpy())
    assert state_numbers(program, end, 1, 20)["invalid_chains"] >= 1
