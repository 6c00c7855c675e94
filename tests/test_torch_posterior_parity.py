"""The PyTorch port samples the same posterior as the JAX package.

512 chains x 3000 steps of each package on the same synthetic data (K = 1,
uniform geo prior), on the CPU; each chain's final state is one draw. The
per-object membership frequencies, the mean cluster size and the per-
operator acceptance rates must agree within sampling noise: |z| < 4 for
each membership (30 objects) and for the mean size, 0.03 for each
acceptance rate. Slow (JAX compiles the ensemble program): not in the
default tier."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

KW = dict(n_objects=30, n_features=10, n_states=4, n_families=3, seed=21)
N_CHAINS, N_STEPS = 512, 3000


def _jax_run():
    from sbayes_tpu.model.model import Model
    from sbayes_tpu.sampling.kernel import OperatorStats
    from sbayes_tpu.sampling.runner import SamplerRuntime
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    cfg = synthetic_config(n_clusters=1)
    rt = SamplerRuntime(Model(synthetic_data(**KW), cfg.model), cfg.mcmc)
    states = rt.init_chains(jax.random.PRNGKey(0), N_CHAINS, shard=False)
    stats = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(N_CHAINS))
    ones = jnp.ones(N_CHAINS, jnp.float32)
    carry = rt.run_chunk(jax.random.split(jax.random.PRNGKey(1), N_CHAINS), states, stats,
                         ones, ones, N_STEPS)
    acc, rej = np.asarray(carry.stats.accepts).sum(0), np.asarray(carry.stats.rejects).sum(0)
    return np.asarray(carry.state.clusters)[:, 0], acc / np.maximum(acc + rej, 1), rt.op_names


def _torch_run():
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    cfg = synthetic_config(n_clusters=1)
    rt = SamplerRuntime(Model(synthetic_data(**KW), cfg.model, device="cpu"), cfg.mcmc)
    gen, op_gen = make_generators(0, "cpu")
    states = rt.init_chains(gen, N_CHAINS)
    states, stats = rt.run_chunk(gen, op_gen, states, rt.new_stats(N_CHAINS), N_STEPS)
    acc, rej = stats.accepts.sum(0).numpy(), stats.rejects.sum(0).numpy()
    return states.clusters[:, 0].numpy(), acc / np.maximum(acc + rej, 1), rt.op_names


@pytest.mark.slow
def test_port_samples_the_jax_posterior():
    cl_j, acc_j, names_j = _jax_run()
    cl_t, acc_t, names_t = _torch_run()
    n = N_CHAINS
    p_j, p_t = cl_j.mean(0), cl_t.mean(0)
    se = np.sqrt(p_j * (1 - p_j) / n + p_t * (1 - p_t) / n) + 1e-9
    assert np.abs((p_j - p_t) / se).max() < 4
    s_j, s_t = cl_j.sum(1), cl_t.sum(1)
    z_size = (s_j.mean() - s_t.mean()) / np.sqrt(s_j.var() / n + s_t.var() / n)
    assert abs(z_size) < 4
    assert names_j == names_t
    np.testing.assert_allclose(acc_t, acc_j, atol=0.03)
