"""Kernel 1 of the PyTorch port (collapsed likelihood, ``ops/loglh.py``)
against the JAX package, on the CPU, where the wrapper runs its plain
PyTorch version; plus a check of the kernel's C interface.

Tolerances: rtol 1e-5 against the JAX XLA path (both evaluate lgamma of the
same exact integer counts in float32; only summation order differs), rtol
1e-4 against the Pallas kernel in interpret mode (its lgamma is an 8-step
Stirling series)."""
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

KW = dict(n_objects=30, n_features=8, n_states=4, n_families=3, seed=5)


def random_states(consts_np, B, seed):
    """Numpy batch of (clusters (B, K, N), source (B, N, F, C)): disjoint
    clusters, one-hot source on observed cells, zero at NA."""
    K, N, F, C, na = consts_np
    rng = np.random.default_rng(seed)
    label = rng.integers(0, K + 1, size=(B, N))                  # K = in no cluster
    clusters = np.stack([label == k for k in range(K)], axis=1)
    comp = rng.integers(0, C, size=(B, N, F))
    source = (comp[..., None] == np.arange(C)) & ~na[None, :, :, None]
    return clusters, source


@pytest.fixture(scope="module", params=[1, 2], ids=["K1", "K2"])
def models(request):
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    K = request.param
    jm = JaxModel(jax_data(**KW), jax_config(n_clusters=K).model)
    m = Model(synthetic_data(**KW), synthetic_config(n_clusters=K).model, device="cpu")
    c = m.consts
    clusters, source = random_states((c.K, c.N, c.F, c.C, c.na.numpy()), 6, seed=11 + K)
    return jm, m, clusters, source


def test_plain_matches_jax_xla(models):
    from sbayes_tpu.model.posterior import Posterior as JaxPosterior
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu_torch.ops.loglh import log_likelihood

    jm, m, clusters, source = models
    post = JaxPosterior(jm.consts, use_pallas=False)
    f = jax.jit(lambda cl, src: post.log_likelihood(JaxState(
        cl, jnp.zeros((m.consts.F, m.consts.C)), src, 0.0, 0.0, jnp.zeros(4))))
    want = np.asarray([f(cl, src) for cl, src in zip(clusters, source)])
    got = log_likelihood(m.consts, torch.as_tensor(clusters), torch.as_tensor(source)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_plain_matches_jax_pallas_interpret(models):
    from sbayes_tpu.ops.pallas_kernels import make_pallas_log_likelihood
    from sbayes_tpu_torch.ops.loglh import log_likelihood

    jm, m, clusters, source = models
    want = np.asarray(make_pallas_log_likelihood(jm.consts, interpret=True)(
        jnp.asarray(clusters), jnp.asarray(source)))
    got = log_likelihood(m.consts, torch.as_tensor(clusters), torch.as_tensor(source)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_posterior_log_likelihood_is_the_kernel_function(models):
    """``Posterior.log_likelihood`` (the path's caller) equals the counts form."""
    from sbayes_tpu_torch.model.posterior import Posterior
    from sbayes_tpu_torch.sampling.state import ChainState

    _, m, clusters, source = models
    post = Posterior(m.consts)
    cl, src = torch.as_tensor(clusters), torch.as_tensor(source)
    B = cl.shape[0]
    state = ChainState(cl, torch.full((B, m.consts.F, m.consts.C), 1.0 / m.consts.C), src,
                       torch.zeros(B), torch.zeros(B), torch.zeros(B, 4))
    want = post.log_likelihood_from_counts(*post.feature_counts(cl, src))
    torch.testing.assert_close(post.log_likelihood(state), want, rtol=0, atol=0)


def _c_signatures():
    """{name: [param kinds]} of every ``extern "C"`` entry point in csrc/."""
    out = {}
    csrc = Path(__file__).parent.parent / "sbayes_tpu_torch" / "csrc"
    for src in csrc.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",")]
            out[m.group(1)] = ["ptr" if "*" in p else "int" for p in params]
    return out


def test_ctypes_signatures_match_the_cuda_sources():
    """The ctypes argument types of each C entry point match the source (a
    wrong count or a pointer passed as int would only show on the card)."""
    import ctypes

    from sbayes_tpu_torch.ops import _cuda

    sigs = _c_signatures()
    assert set(sigs) == set(_cuda.SIGNATURES)
    for name, argtypes in _cuda.SIGNATURES.items():
        kinds = ["ptr" if t is ctypes.c_void_p else "int" for t in argtypes]
        assert kinds == sigs[name], name


def test_wrapper_uses_plain_version_only_for_cpu_tensors(models, monkeypatch):
    """On the CPU the wrapper never touches the CUDA path (no build, no count)."""
    from sbayes_tpu_torch.ops import _cuda, loglh

    _, m, clusters, source = models
    monkeypatch.setattr(_cuda, "library", lambda: pytest.fail("CUDA library loaded on CPU"))
    before = loglh.launches.count
    loglh.log_likelihood(m.consts, torch.as_tensor(clusters), torch.as_tensor(source))
    assert loglh.launches.count == before
