"""The EM of the port's initializer (``Initializer.em_step``) against the
form it replaced, kept here as a plain function: the group log-likelihoods
gathered from an (n, G, N, F) table with a last column for NA, and the geo
term computed for every group row before the confounder rows were
overwritten. A small many-family shape with the cost-based geo prior: 60
objects x 10 binary features, 20 families, K = 3, 8% NA, 4 chains x 3
attempts. Also: the init at that shape stays within the size bounds and
fills the module's record; its spans open only under a profiler and leave
the bits as they are."""
import copy
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import datagen, harness  # noqa: E402
from sbayes_tpu_torch.model.math import normalize  # noqa: E402
from sbayes_tpu_torch.sampling import initializer as init_mod  # noqa: E402
from sbayes_tpu_torch.sampling.conditionals import Conditionals  # noqa: E402

N, F, S, FAMILIES, K = 60, 10, 2, 20, 3
CHAINS, ATTEMPTS, EM_STEPS = 4, 3, 50
# One step from the same responsibilities: the two forms add the same
# float32 logs in another order (and 0 where the gather added log of a sum
# of p within an ulp of 1); measured at most 3.6e-7 on responsibilities in
# [0, 1], so 2e-6 leaves about 5x room.
STEP_ATOL = 2e-6
# Fifty steps, each form fed its own output: the order differences carry
# over; measured at most 3.2e-6, so 2e-5 leaves about 6x room.
CHAIN_ATOL = 2e-5


def old_em_step(init, z, i_step):
    """The EM step as the port computed it before the contraction."""
    c = init.consts
    n = z.shape[0]
    f_ar = torch.arange(c.F, device=z.device)[None]
    p = normalize(torch.einsum("bgn,nfs->bgfs", z, c.features) + 0.5 * c.applicable.float())
    # NA observations count as "any state": their term is sum_s p.
    p_any = torch.cat([p, p.sum(-1, keepdim=True)], dim=-1)
    group_lls = torch.log(torch.clamp(p_any[:, :, f_ar, c.feat_idx.long()], min=1e-35)).sum(-1)
    lh = group_lls / (init.n_em_steps / (1.0 + i_step)) ** 3
    if c.geo.prior_type == "cost_based":
        log_geo = -(torch.softmax(c.N * z, dim=2) @ c.cost_matrix) / c.geo.scale / 2.0
        mean = torch.logsumexp(log_geo[:, :c.K].reshape(n, -1), dim=-1) - math.log(c.K * c.N)
        log_geo[:, c.K:] = mean[:, None, None]
        lh = lh + log_geo
    lh = torch.where(init.groups_available, lh, torch.full((), float("-inf"), device=z.device))
    return torch.softmax(lh, dim=1)


def old_generate_clusters_em(init, gen, n):
    """The EM's clusters with ``old_em_step``, the same draws in the same order."""
    c = init.consts
    total_size = init_mod._truncnorm_sample(
        gen, n, mid=float(c.K * init.initial_size), lower=float(c.K * c.min_size),
        upper=float(min(c.N, c.K * c.max_size)),
        scale=float(max(20.0, c.K * init.initial_size - c.K * c.min_size)), device=c.device)
    total_size = torch.clamp(torch.round(total_size).long(), c.K * c.min_size, c.N)
    avail = init.groups_available
    z = torch.rand((n, avail.shape[0], c.N), generator=gen, device=c.device) * avail
    z = z / torch.clamp(z.sum(1, keepdim=True), min=1e-35)
    for i_step in range(init.n_em_steps):
        z = old_em_step(init, z, i_step)
    return init._discretize_fuzzy_clusters(z, total_size)


def small_config():
    """``grambank_k5``'s model at K = 3, sizes 3-20, the EM at 3 attempts."""
    config = copy.deepcopy(json.loads(
        (ROOT / "perfbench" / "configs" / "grambank_k5.json").read_text()))
    config["model"]["clusters"] = K
    config["model"]["prior"]["objects_per_cluster"].update(min=3, max=20)
    config["mcmc"]["initialization"].update(attempts=ATTEMPTS, em_steps=EM_STEPS)
    return config


def runtime(seed):
    arrays = datagen.large(N, F, S, FAMILIES, seed, na_fraction=0.08)
    return harness.build_runtime(arrays, small_config(), "cpu")


def initializer(rt):
    return init_mod.Initializer(Conditionals(rt.post), initial_size=10, attempts=ATTEMPTS,
                                n_em_steps=EM_STEPS)


def start(init, seed):
    avail = init.groups_available
    z = torch.rand((CHAINS * ATTEMPTS,) + avail.shape,
                   generator=torch.Generator().manual_seed(seed)) * avail
    return z / z.sum(1, keepdim=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
def test_em_step_equals_the_gather_form(seed):
    rt = runtime(seed)
    c = rt.consts
    assert c.geo.prior_type == "cost_based" and c.na.float().mean() > 0.04
    init = initializer(rt)
    assert init.groups_available.shape[0] == K + 1 + FAMILIES
    z_old = z_new = start(init, seed)
    for i_step in range(EM_STEPS):
        one = init.em_step(z_old, i_step)
        z_old, z_new = old_em_step(init, z_old, i_step), init.em_step(z_new, i_step)
        torch.testing.assert_close(one, z_old, rtol=0, atol=STEP_ATOL)
        torch.testing.assert_close(z_new, z_old, rtol=0, atol=CHAIN_ATOL)
    # the steps moved the responsibilities far from the start (a largest
    # share about 0.15 of 24 rows): the check has power
    assert z_old.max(1).values.mean() > 0.5


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_em_clusters_equal_the_gather_form(seed):
    init = initializer(runtime(seed))
    n = CHAINS * ATTEMPTS
    got = init.generate_clusters_em(torch.Generator().manual_seed(seed), n)
    want = old_generate_clusters_em(init, torch.Generator().manual_seed(seed), n)
    assert got.shape == (n, K, N) and got.any()
    assert torch.equal(got, want)


class LargestOutputs(TorchDispatchMode):
    """The most elements of any tensor an operation made, and the shapes of
    the matrix products' operands."""

    def __init__(self):
        super().__init__()
        self.numel, self.products = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.products.append((tuple(args[0].shape), tuple(args[1].shape)))
        return out


def test_no_group_object_feature_temporary_and_geo_on_cluster_rows():
    init = initializer(runtime(6))
    z = start(init, 6)
    n, G = z.shape[:2]
    with LargestOutputs() as new:
        init.em_step(z, 0)
    with LargestOutputs() as old:
        old_em_step(init, z, 0)
    assert old.numel >= n * G * N * F                   # the check has power
    assert new.numel <= n * G * N
    cost_rows = [a[-2] for a, b in new.products if b[-2:] == (N, N)]
    assert cost_rows == [n * K]
    assert [a[-2] for a, b in old.products if b[-2:] == (N, N)] == [n * G]


def test_init_chains_in_bounds_and_record_filled():
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = runtime(7)
    c = rt.consts
    init_mod.record.em_s = init_mod.record.peak_bytes = 123
    states = rt.init_chains(make_generators(7, "cpu")[0], CHAINS)
    sizes = states.clusters.sum(-1)
    assert states.clusters.shape == (CHAINS, K, N)
    assert ((sizes >= c.min_size) & (sizes <= c.max_size)).all(), sizes
    assert (states.clusters.sum(1) <= 1).all()
    assert torch.isfinite(states.log_lh).all() and torch.isfinite(states.log_prior).all()
    assert 0 < init_mod.record.em_s < 123
    # a CPU run has no device peak: none is recorded
    assert init_mod.record.peak_bytes is None


def test_init_spans_only_under_a_profiler_and_the_same_bits(tmp_path):
    from sbayes_tpu_torch import tracing
    from sbayes_tpu_torch.sampling.runner import make_generators

    assert tracing.span("sbt.init/em") is tracing._OFF
    rt = runtime(8)
    plain = rt.init_chains(make_generators(8, "cpu")[0], CHAINS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = rt.init_chains(make_generators(8, "cpu")[0], CHAINS)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = sorted((float(e["ts"]), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("sbt.init/"))
    assert [name for _, name in spans] == ["sbt.init/em", "sbt.init/refine"]
    for field in ("clusters", "weights", "source", "log_lh", "log_prior", "geo_agg"):
        a, b = getattr(plain, field), getattr(traced, field)
        assert torch.equal(a, b), field
    assert np.isfinite(plain.log_lh.numpy()).all()
