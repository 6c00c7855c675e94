"""The port on ``grambank_k5``'s model (binary features, many families,
K = 5, the cost-based geo prior) against the benchmark's plain float64
reference (``perfbench/reference``), on seeded random states: the carried
counts, the log-likelihood, each prior part and the marginal's log-odds,
each within the limit the cell ``grambank_k5.ens64`` holds its runs to. On
the CPU at a small Grambank-like shape; on a card (marker ``gpu``) both
kernels and every marginal variant against their plain versions at the
cell's own shape, where the marginal tiles the features in shared memory
and the Prim takes its block path. This file imports no JAX."""
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
from perfbench.compare import rel_gap, state_numbers  # noqa: E402
from perfbench.reference.posterior import Reference  # noqa: E402

CELL = "grambank_k5.ens64"


def grambank_config(min_size=None, max_size=None):
    cell, config = harness.load_cell(CELL)
    config = copy.deepcopy(config)
    if min_size is not None:
        config["model"]["prior"]["objects_per_cluster"].update(min=min_size, max=max_size)
    return cell, config


def random_states(consts, B, seed, min_size, max_size):
    """Disjoint clusters of sizes drawn in [min_size, max_size], weights from
    a Dirichlet, and each observation's component drawn among those
    available to its object, in the model's source form."""
    from sbayes_tpu_torch.model.math import pack_source
    from sbayes_tpu_torch.sampling.state import ChainState

    rng = np.random.default_rng(seed)
    K, N, F, C = consts.K, consts.N, consts.F, consts.C
    clusters = np.zeros((B, K, N), bool)
    for b in range(B):
        sizes = rng.integers(min_size, max_size + 1, size=K)
        order = rng.permutation(N)
        starts = np.concatenate([[0], np.cumsum(sizes)])
        for k in range(K):
            clusters[b, k, order[starts[k]:starts[k + 1]]] = True
    member = clusters.any(1)
    weights = rng.dirichlet(np.ones(C), size=(B, F)).astype(np.float32)
    comp = rng.integers(0, C, size=(B, N, F))
    comp = np.where((comp == 0) & ~member[:, :, None], 1, comp)
    onehot = (comp[..., None] == np.arange(C)) & ~consts.na.cpu().numpy()[None, :, :, None]
    source = torch.as_tensor(onehot, device=consts.device)
    if consts.source_packed:
        source = pack_source(source)
    z = torch.zeros(B, device=consts.device)
    return ChainState(torch.as_tensor(clusters, device=consts.device),
                      torch.as_tensor(weights, device=consts.device), source, z, z,
                      torch.zeros(B, 4, device=consts.device))


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_port_equals_the_reference_at_a_small_grambank_shape(seed, packed):
    from sbayes_tpu_torch.config.schema import ModelConfig
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.model.posterior import Posterior
    from sbayes_tpu_torch.ops.marginal import marginal

    cell, config = grambank_config(3, 12)
    arrays = datagen.large(90, 14, 2, 30, seed, na_fraction=0.08)
    model = Model(harness.port_data(arrays), ModelConfig.from_dict(config["model"]),
                  device="cpu", source_packed=packed)
    c = model.consts
    assert (c.K, c.S, c.Gmax, c.geo.prior_type) == (5, 2, 30, "cost_based")
    states = Posterior(c).fill_state(random_states(c, 6, seed, 3, 12))
    ref = Reference(arrays, config["model"])
    program = {k: getattr(states, k).numpy() for k in (
        "cl_counts", "conf_counts", "pat_counts", "log_lh", "log_prior", "prior_parts",
        "geo_agg")}
    end = ref.evaluate(states.clusters.numpy(), states.weights.numpy(), states.source.numpy())
    numbers = state_numbers(program, end, ref.min_size, ref.max_size)
    in_conf = np.stack([np.ones(c.N, bool), arrays["families"].any(0)], -1)
    inputs = harness.marginal_inputs(states, c.applicable, in_conf, None)
    got = marginal(c, *[torch.as_tensor(x) for x in inputs[:6]], None, ratio=True).numpy()
    numbers["marginal_gap"] = rel_gap(got, ref.marginal(*inputs))
    limits = cell["limits"]
    for name, value in numbers.items():
        assert value <= limits[name], (name, value)
    assert (end["prior_parts"][:, 1] < 0).all()                 # the geo prior is on
    assert np.abs(end["log_lh"]).min() > 100                     # gaps are relative here


@pytest.mark.gpu
def test_kernels_match_plain_at_the_cells_shape():
    """Both kernels and every marginal variant against their plain versions
    (``ops/check.py``'s tolerances) on 64 random in-bounds states of the
    cell's model: the marginal in feature tiles of shared memory, each block
    staging only its objects' group rows (fewer than the padded 1 + 2 x 215
    a feature), the Prim a block a mask (N = 2,467)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sbayes_tpu_torch.ops import check, marginal

    cell, config = grambank_config()
    arrays = datagen.draw(config["data"], 2**31 + 9)
    rt = harness.build_runtime(arrays, config, "cuda")
    c = rt.consts
    assert (c.N, c.F, c.Gmax) == (2467, 195, 215) and c.N > 1024
    shape = marginal.launch_shape(c, int(cell["chains"]),
                                  torch.cuda.get_device_properties(0).multi_processor_count)
    assert 1 + shape.rows < 1 + (c.C - 1) * c.Gmax and shape.f_tile < c.F
    size = config["model"]["prior"]["objects_per_cluster"]
    states = rt.post.fill_state(random_states(c, int(cell["chains"]), 5, size["min"],
                                              size["max"]))
    errs = check.compare_with_plain(c, check.path_kernel_inputs(rt, states))
    errs_jump = check.compare_with_plain(c, check.jump_kernel_inputs(rt.cond, states))
    assert "mst_stats_rel" in errs and "marginal" in errs and "marginal_abs" in errs_jump
    print(json.dumps({"path": errs, "jump": errs_jump, "obj_tile": shape.obj_tile,
                      "rows": shape.rows, "f_tile": shape.f_tile}))
