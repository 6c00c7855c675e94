"""Kernel 1 of the PyTorch port (collapsed likelihood, ``ops/loglh.py``)
against the JAX package, on the CPU, where the wrapper runs its plain
PyTorch version; plus a check of the kernel's C interface.

Tolerances: rtol 1e-5 against the JAX XLA path (both evaluate lgamma of the
same exact integer counts in float32; only summation order differs), rtol
1e-4 against the Pallas kernel in interpret mode (its lgamma is an 8-step
Stirling series)."""
import dataclasses
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


def test_concentration_table_holds_the_model_only_inputs(models):
    """The precomputed table of the kernel: row 0 is the cluster prior, then
    the confounder groups (padding groups included); the concentrations
    unchanged (zeros at excluded states included), then their sum; and
    lgamma of its entries is what the plain version computes from the
    concentrations (rtol 1e-6: the sum is rounded once from float64)."""
    _, m, _, _ = models
    c = m.consts
    a = torch.cat([c.conc_cluster[None], c.conc_conf.reshape(-1, c.F, c.S)])
    assert (a == 0).any() and (a > 0).any()
    assert c.conc_table.shape == (1 + (c.C - 1) * c.Gmax, c.F, c.S + 1)
    assert c.conc_table.dtype == torch.float32 and c.conc_table.is_contiguous()
    torch.testing.assert_close(c.conc_table[..., :c.S], a, rtol=0, atol=0)
    torch.testing.assert_close(c.conc_table[..., c.S], a.sum(-1), rtol=1e-6, atol=0)
    torch.testing.assert_close(torch.lgamma(c.conc_table[..., c.S]), torch.lgamma(a.sum(-1)),
                               rtol=1e-6, atol=1e-6)
    pos = a > 0
    torch.testing.assert_close(torch.lgamma(c.conc_table[..., :c.S][pos]), torch.lgamma(a[pos]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("conc", [0.5, 1.0 / 3.0, 7.25], ids=["jeffreys", "third", "large"])
def test_concentration_table_of_other_concentrations(conc):
    """``concentration_table`` on non-unit concentrations with excluded
    states and a padding group of zeros only (sum 0: such a row holds no
    counts)."""
    from sbayes_tpu_torch.model.constants import concentration_table

    applicable = np.array([[1, 1, 0], [1, 1, 1]], bool)
    cl = np.where(applicable, conc, 0.0).astype(np.float32)
    conf = np.stack([cl * 2, np.zeros_like(cl)])[None]                    # (1, 2, F, S)
    table = concentration_table(cl, conf)
    assert table.shape == (3, 2, 4) and table.dtype == np.float32
    np.testing.assert_array_equal(table[0, :, :3], cl)
    np.testing.assert_array_equal(table[1, :, :3], cl * 2)
    np.testing.assert_allclose(table[:2, :, 3], [[2 * conc, 3 * conc], [4 * conc, 6 * conc]],
                               rtol=1e-6)
    assert (table[2] == 0).all()


@pytest.mark.parametrize("conc", [1e-3, 0.5, 1.0, 1.0 / 3.0, 6.0, 31.5, 2500.0],
                         ids=["tiny", "jeffreys", "uniform", "third", "sum6", "large", "huge"])
def test_log_rising_matches_lgamma(conc):
    """sum_{i<c} log(a + i), the kernel's form, against
    lgamma(c + a) - lgamma(a) in float64 for every count an object set of
    128 can produce. Tolerance rtol 2e-6 + atol 2e-6: c float32 logs summed
    in float32."""
    from sbayes_tpu_torch.ops.loglh import log_rising

    counts = torch.arange(0, 129)
    a = torch.full((129,), conc, dtype=torch.float32)
    got = log_rising(a, counts)
    a64 = a.double()
    want = torch.lgamma(a64 + counts) - torch.lgamma(a64)
    assert got.dtype == torch.float32 and got[0] == 0.0
    torch.testing.assert_close(got.double(), want, rtol=2e-6, atol=2e-6)


def test_zero_counts_contribute_exactly_zero(models):
    """What the kernel skips is exactly 0 in the plain version: a cell with
    count 0 (lgamma(a) - lgamma(a)) and a (row, feature) with n = 0."""
    from sbayes_tpu_torch.model.math import dirichlet_categorical_logpdf

    _, m, _, _ = models
    c = m.consts
    a = c.conc_conf                                                       # (C-1, G, F, S)
    zero = torch.zeros_like(a)
    assert (dirichlet_categorical_logpdf(zero, a)[c.group_valid] == 0).all()
    pos = a > 0
    assert ((torch.lgamma(zero + a) - torch.lgamma(a))[pos] == 0).all()
    counts = zero.clone()
    counts[..., 0] = 3.0                                                  # one cell per feature
    full = dirichlet_categorical_logpdf(counts, a)[c.group_valid]
    sum_a = a.sum(-1)
    only = (torch.lgamma(sum_a) - torch.lgamma(3.0 + sum_a)
            + torch.lgamma(3.0 + a[..., 0]) - torch.lgamma(a[..., 0]))[c.group_valid]
    torch.testing.assert_close(full, only, rtol=0, atol=0)


def test_kernel_arithmetic_matches_plain(models):
    """The kernel's arithmetic in plain PyTorch (exact counts, the
    concentration table, no lgamma: sum_{i<c} log(a + i) per cell with
    a > 0, minus sum_{i<n} log(sum a + i) per (row, feature)) against the
    plain version. rtol 1e-5 of the total, the kernel's own tolerance on
    the card."""
    from sbayes_tpu_torch.model.math import compute_feature_counts
    from sbayes_tpu_torch.ops.loglh import log_likelihood_plain, log_rising

    _, m, clusters, source = models
    c = m.consts
    cl, src = torch.as_tensor(clusters), torch.as_tensor(source)
    cl_counts, conf_counts = compute_feature_counts(cl, src, c.features, c.groups)
    B = cl.shape[0]
    counts = torch.cat([cl_counts, conf_counts.reshape(B, -1, c.F, c.S)], dim=1)    # (B, rows, F, S)
    model_row = torch.cat([torch.zeros(c.K, dtype=torch.long),
                           1 + torch.arange((c.C - 1) * c.Gmax)])
    table = c.conc_table[model_row]                                       # (rows, F, S + 1)
    a, sum_a = table[..., :c.S], table[..., c.S]
    one = torch.ones_like(a)
    cells = torch.where(a > 0, log_rising(torch.where(a > 0, a, one), counts),
                        torch.zeros_like(counts))
    n = counts.sum(-1)
    assert (n[:, sum_a == 0] == 0).all()
    rows = log_rising(torch.where(sum_a > 0, sum_a, torch.ones_like(sum_a)), n)
    got = cells.sum((-1, -2, -3)) - rows.sum((-1, -2))
    torch.testing.assert_close(got, log_likelihood_plain(c, cl, src), rtol=1e-5, atol=0)


def test_bound_counts_live_in_the_module(models):
    """``bytes_moved`` and ``operations`` of the likelihood: bytes grow by the
    per-chain part only, operations are linear in the chains."""
    from sbayes_tpu_torch.ops import loglh

    _, m, _, _ = models
    c = m.consts
    per_chain = loglh.bytes_moved(c, 3) - loglh.bytes_moved(c, 2)
    assert per_chain == c.K * c.N + int((c.feat_idx < c.S).sum()) * c.C + 4
    assert loglh.bytes_moved(c, 0) > 4 * (1 + int(sum(c.n_groups))) * c.F * (c.S + 1)
    rows = c.K + (c.C - 1) * c.Gmax
    assert loglh.operations(c, 2) == 2 * (c.N * c.F * c.C + rows * c.F * (3 * c.S + 4))


def test_packed_plain_equals_bool_and_jax(models):
    """The plain version on the packed int8 source (sentinel C at NA) gives
    the bool form's result bit for bit, over feature tiles too, and JAX's
    within rtol 1e-5 (the JAX XLA path on its own packed form)."""
    from sbayes_tpu.model.math import pack_source as jax_pack
    from sbayes_tpu.model.posterior import Posterior as JaxPosterior
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu_torch.model.math import pack_source
    from sbayes_tpu_torch.ops.loglh import log_likelihood, log_likelihood_plain

    jm, m, clusters, source = models
    c = m.consts
    cl, src = torch.as_tensor(clusters), torch.as_tensor(source)
    packed = pack_source(src)
    want = log_likelihood_plain(c, cl, src)
    torch.testing.assert_close(log_likelihood_plain(c, cl, packed), want, rtol=0, atol=0)
    torch.testing.assert_close(log_likelihood(c, cl, packed), want, rtol=0, atol=0)
    tiled = dataclasses.replace(c, feature_chunk=3)
    torch.testing.assert_close(log_likelihood_plain(tiled, cl, packed),
                               log_likelihood_plain(tiled, cl, src), rtol=0, atol=0)
    post = JaxPosterior(jm.consts, use_pallas=False)
    f = jax.jit(lambda k, s: post.log_likelihood(JaxState(
        k, jnp.zeros((c.F, c.C)), jax_pack(s), 0.0, 0.0, jnp.zeros(4))))
    jax_want = np.asarray([f(k, s) for k, s in zip(clusters, source)])
    np.testing.assert_allclose(log_likelihood(c, cl, packed).numpy(), jax_want, rtol=1e-5)


def test_packed_bound_counts_one_byte_per_cell(models):
    """With the packed source the function reads one byte per observed cell
    (instead of C) and the scan of the C bytes is gone from the operations."""
    from sbayes_tpu_torch.ops import loglh

    _, m, _, _ = models
    c = m.consts
    observed = int((c.feat_idx < c.S).sum())
    assert (loglh.bytes_moved(c, 2) - loglh.bytes_moved(c, 2, packed=True)
            == 2 * observed * (c.C - 1))
    assert (loglh.operations(c, 2) - loglh.operations(c, 2, packed=True)
            == 2 * c.N * c.F * (c.C - 1))
