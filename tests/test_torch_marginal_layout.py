"""The marginal kernel's object layout (``ops/marginal.py``: ``object_order``,
``tile_rows``, ``ObjectLayout``, ``launch_shape``): the objects sorted by
their group in the confounder with the most groups, so that a block of the
kernel stages only the group rows its own objects read.

On the CPU, on data from ``perfbench/datagen.py`` at Grambank's and
PHOIBLE's shapes and on a small model with isolates (objects in no family)
and two many-group confounders (C = 4): the order is a stable sort, every
group an object of a tile reads lies in the rows its block stages, a block
at PHOIBLE's shape (32 chains, 132 SMs) stages at most 32 confounder rows a
feature, and the staged bytes are those reckoned by hand. On a card (marker
``gpu``) the kernel against its plain version within ``ops/check.py``'s
tolerances, every variant, where a table row is not a multiple of 16 bytes,
the last feature tile is ragged, the families are in random order, some
objects are in no family and C = 4. This file imports no JAX."""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import datagen  # noqa: E402
from sbayes_tpu_torch.ops import marginal  # noqa: E402

N_SM = 132
SEED = 2**31 + 11


@dataclasses.dataclass(eq=False)
class Shape:
    """What the layout reads of the model constants, at a data set's shape."""

    group_idx: torch.Tensor   # (C-1, N) int32, -1 = in no group
    n_groups: np.ndarray      # (C-1,)
    feat_idx_t: torch.Tensor  # (F, N) int8, S = NA
    S: int

    @property
    def N(self):
        return self.group_idx.shape[1]

    @property
    def F(self):
        return self.feat_idx_t.shape[0]

    @property
    def C(self):
        return self.group_idx.shape[0] + 1


def config_shape(name: str) -> Shape:
    """A configuration's data drawn by ``perfbench/datagen.py``, with the
    universal confounder and the families as the port builds them."""
    data = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())["data"]
    arrays = datagen.draw(data, SEED)
    fam = arrays["families"]
    values = arrays["values"]
    family = np.where(fam.any(0), fam.argmax(0), -1)
    groups = np.stack([np.zeros_like(family), family]).astype(np.int32)
    feat = np.where(values.any(-1), values.argmax(-1), values.shape[-1]).astype(np.int8)
    return Shape(torch.as_tensor(groups), np.array([1, fam.shape[0]]),
                 torch.as_tensor(np.ascontiguousarray(feat.T)), values.shape[-1])


@pytest.fixture(scope="module")
def shapes():
    """Grambank's and PHOIBLE's shapes, and a small model (CPU constants)
    with isolates and C = 4: universal, family (a fifth in none) and a
    random partition ``area``, both of 9 groups."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    names = ("universal", "family", "area")
    data = synthetic_data(n_objects=61, n_features=7, n_states=5, n_families=9,
                          no_family_share=0.2, seed=4, confounders=names)
    small = Model(data, synthetic_config(n_clusters=2, confounders=names).model,
                  device="cpu").consts
    assert small.C == 4 and (small.group_idx < 0).any()
    return {"grambank": config_shape("grambank_k5"), "phoible": config_shape("phoible_k5"),
            "small_c4": small}


CASES = [("grambank", 64), ("phoible", 32), ("small_c4", 4), ("small_c4", 1)]


@pytest.mark.parametrize("name", ["grambank", "phoible", "small_c4"])
def test_order_is_a_stable_sort_by_the_most_grouped_confounder(shapes, name):
    c = shapes[name]
    groups = c.group_idx.numpy()
    order = marginal.object_order(groups, np.asarray(c.n_groups))
    assert order.dtype == np.int32 and sorted(order.tolist()) == list(range(c.N))
    key = groups[int(np.argmax(c.n_groups))]
    want = sorted(range(c.N), key=lambda n: (key[n] < 0, key[n], n))
    assert order.tolist() == want
    lay = marginal.layout(c)
    assert torch.equal(lay.order, torch.as_tensor(order))
    assert torch.equal(lay.feat_idx_t, c.feat_idx_t[:, order.astype(np.int64)])
    assert torch.equal(lay.group_idx, c.group_idx[:, order.astype(np.int64)])
    assert marginal.layout(c) is lay


@pytest.mark.parametrize("name,n_chains", CASES)
def test_every_group_a_tile_reads_is_staged(shapes, name, n_chains):
    """Each object's group of each confounder lies in the rows its block
    stages, [lo, lo + rows), and the confounders' rows follow each other."""
    c = shapes[name]
    tile = marginal.object_tile(n_chains, c.N, N_SM)
    shape = marginal.launch_shape(c, n_chains, N_SM)
    assert shape.obj_tile == tile
    assert shape.lo.is_contiguous() and shape.first_row.is_contiguous()
    lo, first = shape.lo.numpy(), shape.first_row.numpy()
    groups = marginal.layout(c).sorted_groups
    assert lo.shape == (-(-c.N // tile), c.C - 1) and first.shape == (len(lo), c.C)
    assert shape.rows == first[:, -1].max()
    for t in range(len(lo)):
        assert first[t, 0] == 0
        for k in range(c.C - 1):
            g = groups[k, t * tile:(t + 1) * tile]
            g = g[g >= 0]
            n_rows = first[t, k + 1] - first[t, k]
            assert n_rows == (g.max() - g.min() + 1 if len(g) else 0)
            assert ((lo[t, k] <= g) & (g < lo[t, k] + n_rows)).all()


@pytest.mark.parametrize("n_effect_rows", [1, 2])
def test_phoible_blocks_stage_few_rows(shapes, n_effect_rows):
    """At PHOIBLE's shape, 32 chains on 132 SMs: tiles of 243 objects, no
    block staging more than 32 confounder rows (the universal's one and the
    families of its objects) where the padded table has 430, so the 3,183
    features fit 17 shared-memory tiles, not 266."""
    c = shapes["phoible"]
    shape = marginal.launch_shape(c, 32, N_SM, two_eff=n_effect_rows == 2)
    assert shape.obj_tile == 243 and shape.rows <= 32
    assert -(-c.F // shape.f_tile) <= 17
    padded = marginal.feature_tile(c.F, c.S, c.C, 2 * 215, n_effect_rows)
    assert -(-c.F // padded) >= 265


@pytest.mark.parametrize("name,n_chains", CASES)
@pytest.mark.parametrize("ratio,two_eff", [(True, False), (True, True), (False, False)])
def test_staged_bytes_reckoned_by_hand(shapes, name, n_chains, ratio, two_eff):
    """The counter's bytes a launch: per chain, per block, per feature, the E
    effect rows and the confounder rows from each one's first group to its
    last among the block's objects, S floats each."""
    c = shapes[name]
    tile = marginal.object_tile(n_chains, c.N, N_SM)
    key = c.group_idx.numpy()[int(np.argmax(c.n_groups))]
    order = sorted(range(c.N), key=lambda n: (key[n] < 0, key[n], n))
    E = 1 if ratio and not two_eff else 2
    rows = 0
    for t0 in range(0, c.N, tile):
        rows += E
        for groups in c.group_idx.numpy():
            g = [groups[n] for n in order[t0:t0 + tile] if groups[n] >= 0]
            rows += max(g) - min(g) + 1 if g else 0
    shape = marginal.launch_shape(c, n_chains, N_SM, ratio, two_eff)
    assert shape.staged_bytes == n_chains * rows * c.F * c.S * 4


def test_tile_rule_holds_the_budget():
    """Features per shared-memory tile: all where the tables fit the budget,
    else a multiple of 4 whose tables fit, as large as fits; one feature
    where a feature's rows alone pass it (the kernel then asks for more)."""
    def floats(ft, S, C, rows, E):
        return sum(-(-x // 4) * 4 for x in (E * ft * S, rows * ft * S, ft * C))

    for F, S, C, rows, E in [(36, 6, 3, 7, 1), (3183, 2, 3, 28, 2), (195, 2, 3, 47, 1),
                             (1001, 3, 4, 50, 2), (3, 6, 2, 2300, 1), (7, 5, 4, 9, 2)]:
        ft = marginal.feature_tile(F, S, C, rows, E)
        if floats(F, S, C, rows, E) * 4 <= marginal.SMEM_BUDGET:
            assert ft == F
            continue
        assert 1 <= ft < F
        if floats(1, S, C, rows, E) * 4 > marginal.SMEM_BUDGET:
            assert ft == 1
            continue
        assert floats(ft, S, C, rows, E) * 4 <= marginal.SMEM_BUDGET
        assert ft % 4 == 0 or ft < 4
        assert floats(ft + 4, S, C, rows, E) * 4 > marginal.SMEM_BUDGET


@pytest.mark.parametrize("n_chains,tile", [(1024, 100), (4, 2)])
def test_south_america_shape_stages_one_tile(n_chains, tile):
    """``sa100_k3``'s shape (100 x 36 x 6, universal + 6 families): at 1024
    chains one block a chain stages the universal's row and the 6
    families, at 4 (the MC3 ladder) blocks of 2 objects stage at most 3;
    the features fit one tile either way, as with the padded table, so the
    per-object results keep their bits."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    c = Model(synthetic_data(), synthetic_config(n_clusters=3).model, device="cpu").consts
    shape = marginal.launch_shape(c, n_chains, N_SM)
    assert shape.obj_tile == tile
    if tile == c.N:
        assert shape.rows == 1 + c.Gmax < 2 * c.Gmax
    else:
        assert shape.rows <= 3
    assert shape.f_tile == c.F == marginal.feature_tile(c.F, c.S, c.C, 2 * c.Gmax, 2)


def test_layout_is_kept_per_constants_object(shapes):
    """One layout per constants object while it lives; a copy of the
    constants (a block's or another device's) gets its own; the counter is
    one the CUDA graphs replay."""
    from sbayes_tpu_torch.ops import check

    c = shapes["small_c4"]
    lay = marginal.layout(c)
    copy = dataclasses.replace(c)
    assert marginal.layout(copy) is not lay and marginal.layout(c) is lay
    key = id(copy)
    del copy
    assert key not in marginal._layouts
    assert marginal.staged_bytes in check.COUNTERS


@pytest.mark.gpu
@pytest.mark.parametrize("n_chains", [4, 0])
def test_kernel_matches_plain_on_sorted_tiles(n_chains):
    """Every marginal variant (``ops/check.py::compare_with_plain``: ratio,
    heat, two_eff, absolute) against the plain version on random inputs at
    300 objects x 1001 features x 3 states (a table row of 12,012 bytes, not
    a multiple of 16), C = 4 (universal, family with a fifth of the objects
    in none, a random partition of 40 groups), objects in random family
    order; at 4 chains (object tiles of 5) and at as many chains as the
    card has SMs (0: one block a chain, all objects); the last feature tile
    ragged in both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.ops.check import compare_with_plain
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    names = ("universal", "family", "area")
    data = synthetic_data(n_objects=300, n_features=1001, n_states=3, n_families=40,
                          no_family_share=0.2, seed=6, confounders=names)
    c = Model(data, synthetic_config(n_clusters=2, confounders=names).model,
              device="cuda").consts
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_chains = n_chains or n_sm
    assert c.C == 4 and (c.group_idx < 0).any() and (c.F * c.S * 4) % 16
    family = c.group_idx[1].cpu().numpy()
    assert (np.diff(family[family >= 0]) < 0).any()
    for ratio, two_eff in [(True, False), (True, True), (False, False)]:
        shape = marginal.launch_shape(c, n_chains, n_sm, ratio, two_eff)
        assert shape.f_tile < c.F and c.F % shape.f_tile
    before = marginal.launches.count
    errs = compare_with_plain(c, chip_smoke.random_kernel_inputs(c, n_chains, 23))
    assert marginal.launches.count - before == len(marginal.VARIANTS)
    assert all(errs[marginal.variant_name(*v)] >= 0 for v in marginal.VARIANTS)
    print(json.dumps({"chains": n_chains, "errors": errs}))
