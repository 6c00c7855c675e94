"""The packed int8 source form of the port (``ModelConstants.source_packed``)
against the bool one-hot form and against the JAX package, mirroring
tests/test_source_packed.py.

The packed (B, N, F) index with the sentinel C must behave exactly as the
bool (B, N, F, C) form: every helper picks the same floats, so whole
trajectories agree bit for bit under equal generators. The helpers equal
the JAX package's on the same numpy inputs (exact: integer and boolean
arrays, and one picked float per cell). A checkpoint of either form, of
either package, resumes into either form: its likelihood within rtol 1e-6
of the writer's (float32 sums in another order), its counts exactly."""
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_source(rng, shape, c, p_na=0.2):
    """Bool one-hot (..., C) with all-zero rows at a share ``p_na`` of cells."""
    idx = rng.integers(0, c, size=shape)
    na = rng.random(shape) < p_na
    return (idx[..., None] == np.arange(c)) & ~na[..., None]


def test_pack_unpack_roundtrip_equals_jax():
    from sbayes_tpu.model.math import pack_source as jax_pack
    from sbayes_tpu_torch.model.math import pack_source, source_is_packed, source_onehot

    src = _random_source(np.random.default_rng(0), (2, 17, 9), 4)
    packed = pack_source(torch.as_tensor(src))
    assert packed.dtype == torch.int8 and source_is_packed(packed)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack(jnp.asarray(src))))
    np.testing.assert_array_equal(source_onehot(packed, 4).numpy(), src)
    np.testing.assert_array_equal((packed == 4).numpy(), ~src.any(-1))   # NA -> sentinel C
    assert source_onehot(torch.as_tensor(src), 4).dtype == torch.bool   # identity on one-hot


def test_source_comp_and_pick_match_bool_form_and_jax():
    from sbayes_tpu.model.math import source_pick as jax_pick
    from sbayes_tpu_torch.model.math import pack_source, source_comp, source_pick

    rng = np.random.default_rng(1)
    src = torch.as_tensor(_random_source(rng, (3, 23, 7), 5))
    packed = pack_source(src)
    for i in range(5):
        torch.testing.assert_close(source_comp(packed, i), src[..., i], rtol=0, atol=0)
        torch.testing.assert_close(source_comp(packed, i, torch.float32),
                                   src[..., i].float(), rtol=0, atol=0)
    p = torch.as_tensor(rng.random((3, 23, 7, 5)), dtype=torch.float32)
    want = (p * src).sum(-1)
    torch.testing.assert_close(source_pick(p, packed), want, rtol=0, atol=0)
    torch.testing.assert_close(source_pick(p, src), want, rtol=0, atol=0)
    np.testing.assert_array_equal(
        source_pick(p, packed).numpy(),
        np.asarray(jax_pick(jnp.asarray(p.numpy()), jnp.asarray(packed.numpy()))))


def test_gather_scatter_rows_packed_match_bool():
    from sbayes_tpu_torch.model.math import gather_rows, pack_source, scatter_rows, source_onehot

    rng = np.random.default_rng(3)
    B, n, f, c, m = 2, 31, 6, 4, 5
    src = torch.as_tensor(_random_source(rng, (B, n, f), c))
    packed = pack_source(src)
    idx = torch.tensor([[0, 7, 30, n, n], [5, 1, n, 2, n]])            # N = padding
    rows_b = gather_rows(src, idx)
    rows_p = gather_rows(packed, idx, c)
    torch.testing.assert_close(rows_p, rows_b, rtol=0, atol=0)
    assert not bool(rows_p[idx == n].any())                            # padding: all-zero rows
    with pytest.raises(ValueError):
        gather_rows(packed, idx)
    new_rows = torch.as_tensor(_random_source(rng, (B, m, f), c))
    out_b = scatter_rows(src, idx, new_rows)
    out_p = scatter_rows(packed, idx, new_rows)
    assert out_p.dtype == torch.int8
    torch.testing.assert_close(source_onehot(out_p, c), out_b, rtol=0, atol=0)


def test_source_n_changed_matches_xor_and_jax():
    from sbayes_tpu.model.math import source_n_changed as jax_changed
    from sbayes_tpu_torch.model.math import pack_source, source_n_changed

    rng = np.random.default_rng(7)
    na = rng.random((2, 19, 8)) < 0.2
    a = torch.as_tensor(_random_source(rng, (2, 19, 8), 3, p_na=0.0) & ~na[..., None])
    b = torch.as_tensor(_random_source(rng, (2, 19, 8), 3, p_na=0.0) & ~na[..., None])
    want = (a ^ b).sum((1, 2, 3)).float()
    torch.testing.assert_close(source_n_changed(pack_source(a), pack_source(b)), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(source_n_changed(a, b), want, rtol=0, atol=0)
    for i in range(2):
        assert float(jax_changed(jnp.asarray(a[i].numpy()), jnp.asarray(b[i].numpy()))) \
            == float(want[i])


@pytest.mark.parametrize("n,f,c", [(100, 36, 3), (10_000, 5_000, 3), (2_000, 2_000, 4),
                                   (1_500, 4_000, 3), (50, 50, 130)])
def test_auto_source_packed_equals_jax(monkeypatch, n, f, c):
    from sbayes_tpu.model.constants import auto_source_packed as jax_rule
    from sbayes_tpu_torch.model.constants import auto_source_packed

    monkeypatch.delenv("SBAYES_TPU_SOURCE_DTYPE", raising=False)
    assert auto_source_packed(n, f, c) == jax_rule(n, f, c)


def _runtime(packed, **model_kw):
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=30, n_features=12, n_states=3, n_families=2, seed=7)
    config = synthetic_config(n_clusters=2, geo_prior="uniform")
    model = Model(data, config.model, device="cpu", source_packed=packed, **model_kw)
    return SamplerRuntime(model, config.mcmc)


@pytest.mark.parametrize("feature_chunk", [0, 5], ids=["untiled", "tiles_of_5"])
def test_packed_trajectory_matches_bool(feature_chunk):
    """Same generators, same model: the packed and bool forms give the same
    trajectory (every probability and count picks identical floats, so every
    accept decision agrees), untiled and over feature tiles."""
    from sbayes_tpu_torch.model.math import source_onehot
    from sbayes_tpu_torch.sampling.runner import make_generators

    results = {}
    for packed in (False, True):
        rt = _runtime(packed, feature_chunk=feature_chunk)
        assert rt.consts.source_packed == packed
        gen, op_gen = make_generators(1, "cpu")
        states = rt.init_chains(gen, 3)
        assert states.source.dtype == (torch.int8 if packed else torch.bool)
        states, stats = rt.run_chunk(gen, op_gen, states, rt.new_stats(3), 60)
        results[packed] = (states.log_lh, states.log_prior, stats.accepts, states.cl_counts,
                           source_onehot(states.source, rt.consts.C))
    for name, a, b in zip(("log_lh", "log_prior", "accepts", "cl_counts", "source"),
                          results[False], results[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_packed_sweep_matches_bool():
    """The sequential source sweep (forced on at 12 features) on both forms
    from equal states and generators: the same rows, counts and deltas."""
    from sbayes_tpu_torch.model.math import pack_source, source_onehot
    from sbayes_tpu_torch.sampling.kernel import make_mh_apply_fn
    from sbayes_tpu_torch.sampling.operators import OperatorFactory, OperatorSpec
    from sbayes_tpu_torch.sampling.runner import make_generators

    out = {}
    for packed in (False, True):
        rt = _runtime(packed)
        gen, _ = make_generators(2, "cpu")
        states = rt.init_chains(gen, 4)
        fact = OperatorFactory(rt.cond, source_sweep=True)
        op = fact.make_gibbs_sample_source("groups", max_size=30)
        assert op.__name__ == "op_rows_sweep"
        apply = make_mh_apply_fn(rt.cond, [OperatorSpec("sweep", 1.0, op, "source")])
        for _ in range(5):
            states, accept, _, _ = apply(0, gen, states)
            assert bool(accept.all())
        out[packed] = states
    for name in ("log_lh", "log_prior", "cl_counts", "conf_counts", "pat_counts"):
        torch.testing.assert_close(getattr(out[True], name), getattr(out[False], name),
                                   rtol=0, atol=0, msg=name)
    torch.testing.assert_close(source_onehot(out[True].source, 3), out[False].source,
                               rtol=0, atol=0)
    torch.testing.assert_close(pack_source(out[False].source), out[True].source, rtol=0, atol=0)


def test_packed_fill_state_invariants():
    """fill_state computes identical carried invariants from both forms."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    states = {}
    for packed in (False, True):
        rt = _runtime(packed)
        states[packed] = rt.init_chains(make_generators(2, "cpu")[0], 2)
    for name in ("log_lh", "log_prior", "prior_parts", "cl_counts", "conf_counts",
                 "pat_counts"):
        torch.testing.assert_close(getattr(states[True], name), getattr(states[False], name),
                                   rtol=0, atol=0, msg=name)


def _load(rt, path):
    """``MCMCSetup._load_state_pickle`` of a runtime ``rt`` (it reads nothing
    else of the setup)."""
    from sbayes_tpu_torch.sampling.runner import MCMCSetup

    setup = MCMCSetup.__new__(MCMCSetup)
    setup.runtime = rt
    return setup._load_state_pickle(path)


@pytest.mark.parametrize("written,read", [(False, True), (True, False), (True, True)],
                         ids=["bool_to_packed", "packed_to_bool", "packed_to_packed"])
def test_checkpoint_resumes_into_either_form(tmp_path, written, read):
    """A checkpoint (``to_numpy`` of one chain: the form the state holds)
    resumes through the runner's pickle reader into a runtime of either
    form: the same likelihood and counts."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    state = _runtime(written).init_chains(make_generators(3, "cpu")[0], 1)
    d = state.to_numpy(chain=0)
    assert d["source"].dtype == (np.int8 if written else bool)
    d["i_step"] = 40
    path = tmp_path / "state.pickle"
    with open(path, "wb") as f:
        pickle.dump(d, f)
    rt = _runtime(read)
    loaded, i_step = _load(rt, path)
    assert i_step == 40 and loaded.source.dtype == (torch.int8 if read else torch.bool)
    np.testing.assert_allclose(float(loaded.log_lh[0]), float(state.log_lh[0]), rtol=1e-6)
    for name in ("cl_counts", "conf_counts", "pat_counts"):
        torch.testing.assert_close(getattr(loaded, name), getattr(state, name), rtol=0, atol=0)


def test_jax_int8_checkpoint_resumes_in_the_port(monkeypatch, tmp_path):
    """A checkpoint of the JAX package's packed runtime (int8 source) resumes
    in the port, packed and bool: the JAX state's likelihood and counts."""
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.runner import SamplerRuntime as JaxRuntime
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data

    monkeypatch.setenv("SBAYES_TPU_SOURCE_DTYPE", "idx")
    data = jax_data(n_objects=30, n_features=12, n_states=3, n_families=2, seed=7)
    config = jax_config(n_clusters=2, geo_prior="uniform")
    jrt = JaxRuntime(JaxModel(data, config.model), config.mcmc)
    assert jrt.consts.source_packed
    jstate = jax.tree.map(lambda x: x[0], jrt.init_chains(jax.random.PRNGKey(3), 1,
                                                          shard=False))
    d = jstate.to_numpy()
    assert d["source"].dtype == np.int8 and d["source"].shape == (30, 12)
    path = tmp_path / "state.pickle"
    with open(path, "wb") as f:
        pickle.dump({**d, "i_step": 7}, f)
    for packed in (True, False):
        loaded, i_step = _load(_runtime(packed), path)
        assert i_step == 7
        np.testing.assert_allclose(float(loaded.log_lh[0]), float(jstate.log_lh), rtol=1e-6)
        for name in ("cl_counts", "conf_counts"):
            np.testing.assert_array_equal(getattr(loaded, name)[0].numpy(),
                                          np.asarray(getattr(jstate, name)), err_msg=name)
