"""The port's grow/shrink and wide cluster moves against the JAX operators
on one numpy state, with every random draw forced to the same value in
both packages (the two random streams never match): the moved cluster,
log_q and log_q_back.

Tolerance: log_q / log_q_back are a log proposal probability through a
sigmoid plus a sum of F source-row logs, in float32 on both sides: rtol
1e-4, atol 1e-4."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_posterior_ops import RTOL_PROPOSAL, _np, make_pair


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MIN_SIZE, MAX_SIZE = 2, 6
U_GROW, U_SHRINK = 0.25, 0.75     # the grow/shrink uniform against p_grow = 0.5
ATOL_LOG_Q = 1e-4


@pytest.fixture(scope="module")
def bounded():
    """A pair whose cluster sizes are bound to [2, 6], so that moves from
    and into both bounds are one step away."""
    return make_pair({"model": {"prior": {"objects_per_cluster": {
        "type": "uniform_area", "min": MIN_SIZE, "max": MAX_SIZE}}}})


def _cluster_state(pair, members):
    """Both packages' filled state with cluster 0 = ``members``, a valid
    source (each cell from a component available to its object), and two
    identical chains on the port's side."""
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu_torch.sampling.state import ChainState

    c = pair["jm"].consts
    rng = np.random.default_rng(5)
    clusters = np.zeros((1, c.N), bool)
    clusters[0, members] = True
    avail = np.concatenate([clusters[0][:, None], np.asarray(c.hc_conf) > 0.5], axis=1)
    score = rng.random((c.N, c.F, c.C)) * avail[:, None, :]
    na = np.asarray(c.na)
    source = (score.argmax(-1)[..., None] == np.arange(c.C)) & ~na[..., None]
    d = {**pair["d"], "clusters": clusters, "source": source}
    jstate = pair["jcond"].post.fill_state(JaxState.from_numpy(d))
    two = {k: np.stack([v, v]) if isinstance(v, np.ndarray) else np.asarray([v, v])
           for k, v in d.items()}
    return jstate, pair["cond"].post.fill_state(ChainState.from_numpy(two))


@pytest.fixture
def forced_draws(monkeypatch):
    """Replace the cluster operators' random draws in both packages by fixed
    ones: the grow/shrink uniform (JAX: ``forced["u"]``; port: U_GROW for
    chain 0, U_SHRINK for chain 1), the wide operator's per-object uniforms
    ``forced["u_objects"]``, the most probable allowed object, and the most
    probable source component of every resampled cell."""
    import sbayes_tpu.sampling.conditionals as jax_cond_mod
    import sbayes_tpu.sampling.operators as jax_ops_mod
    import sbayes_tpu_torch.sampling.conditionals as cond_mod
    import sbayes_tpu_torch.sampling.operators as ops_mod

    forced = {"u": U_GROW, "u_objects": None}
    jax_uniform, torch_rand = jax.random.uniform, torch.rand

    def fixed_uniform(key, shape=(), *args, **kw):
        shape = tuple(shape)
        if shape == ():
            return jnp.float32(forced["u"])
        if forced["u_objects"] is not None and shape == forced["u_objects"].shape:
            return jnp.asarray(forced["u_objects"])
        return jax_uniform(key, shape, *args, **kw)

    def fixed_rand(*size, **kw):
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
        if shape == (2,):
            return torch.tensor([U_GROW, U_SHRINK])
        if forced["u_objects"] is not None and shape == (2,) + forced["u_objects"].shape:
            return torch.as_tensor(np.stack([forced["u_objects"]] * 2))
        return torch_rand(*size, **kw)

    monkeypatch.setattr(jax.random, "uniform", fixed_uniform)
    monkeypatch.setattr(torch, "rand", fixed_rand)
    monkeypatch.setattr(jax_ops_mod, "_masked_categorical",
                        lambda key, p, mask: jnp.argmax(jnp.where(mask, p, -1.0)))
    monkeypatch.setattr(ops_mod, "_masked_categorical",
                        lambda gen, p, mask: torch.argmax(torch.where(mask, p, -1.0), -1))
    monkeypatch.setattr(jax_cond_mod, "sample_categorical_onehot",
                        lambda key, p: jnp.arange(p.shape[-1]) == jnp.argmax(p, -1)[..., None])
    monkeypatch.setattr(cond_mod, "sample_categorical_onehot",
                        lambda gen, p: torch.nn.functional.one_hot(p.argmax(-1),
                                                                   p.shape[-1]).bool())
    return forced


@pytest.mark.parametrize("size", [MIN_SIZE, MIN_SIZE + 1, 4, MAX_SIZE - 1, MAX_SIZE])
def test_grow_shrink_log_q_matches_jax(bounded, forced_draws, size):
    """The Gibbsish grow/shrink move against the JAX operator on the same
    state with the same forced draws (both directions): the same new
    cluster, log_q and log_q_back at every size, the bounds included (moves
    from a bound, whose direction is forced, and moves into one: log p_grow
    / log p_shrink in both densities and -log 2 on log_q_back from a
    bound)."""
    jstate, state = _cluster_state(bounded, np.arange(0, 3 * size, 3))
    jop = bounded["jfact"].make_alter_cluster(gibbsish=True, neighbourhood="everywhere",
                                              consider_geo=False)
    res = bounded["fact"].make_alter_cluster(gibbsish=True, neighbourhood="everywhere")(
        torch.Generator().manual_seed(0), state)
    for chain, u in enumerate((U_GROW, U_SHRINK)):
        forced_draws["u"] = u
        jres = jop(jax.random.PRNGKey(0), jstate)
        new_clusters = _np(res.state.clusters)[chain]
        np.testing.assert_array_equal(new_clusters, np.asarray(jres.state.clusters))
        grow = int(new_clusters.sum()) == size + 1
        assert grow == (size == MIN_SIZE or (size != MAX_SIZE and u < 0.5))
        for name in ("log_q", "log_q_back"):
            got = float(_np(getattr(res, name))[chain])
            want = float(getattr(jres, name))
            assert np.isfinite(got) and np.isfinite(want), name
            np.testing.assert_allclose(got, want, rtol=RTOL_PROPOSAL, atol=ATOL_LOG_Q,
                                       err_msg=f"{name}, grow={grow}")


@pytest.mark.parametrize("drop,add", [(1, 1), (0, 2), (2, 0)])
def test_wide_move_log_q_matches_jax(bounded, forced_draws, drop, add):
    """The wide membership resample against the JAX operator on the same
    state: a forced draw (uniform 0 keeps an available object, 1 leaves it
    out) drops ``drop`` members and adds ``add`` objects to a cluster of 4;
    the new cluster, log_q and log_q_back agree."""
    c = bounded["jm"].consts
    members = np.arange(0, 12, 3)
    jstate, state = _cluster_state(bounded, members)
    target = np.zeros(c.N, bool)
    target[members[drop:]] = True
    target[[1, 2][:add]] = True
    forced_draws["u_objects"] = np.where(target, 0.0, 1.0).astype(np.float32)
    jres = bounded["jfact"].make_alter_cluster_wide(consider_geo=False)(
        jax.random.PRNGKey(0), jstate)
    res = bounded["fact"].make_alter_cluster_wide()(torch.Generator().manual_seed(0), state)
    np.testing.assert_array_equal(np.asarray(jres.state.clusters)[0], target)
    np.testing.assert_array_equal(_np(res.state.clusters)[0, 0], target)
    for name in ("log_q", "log_q_back"):
        got, want = float(_np(getattr(res, name))[0]), float(getattr(jres, name))
        assert np.isfinite(got) and np.isfinite(want), name
        np.testing.assert_allclose(got, want, rtol=RTOL_PROPOSAL, atol=ATOL_LOG_Q, err_msg=name)
