"""The benchmark's frozen copies give what the program's originals give."""
import numpy as np
import pytest

import perfbench_helpers  # noqa: F401  (the repository on the path)
from perfbench import datagen, yardstick
from perfbench.reference import geodesic


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_small_generator_equals_synthetic_data(seed):
    from sbayes_tpu_torch.testing import synthetic_data

    want = synthetic_data(n_objects=40, n_features=9, n_states=5, n_families=4, seed=seed)
    got = datagen.small(40, 9, 5, 4, seed)
    assert np.array_equal(got["values"], want.features.values)
    assert np.array_equal(got["applicable"], want.features.states)
    assert np.array_equal(got["families"], want.confounders["family"].group_assignment)
    assert np.array_equal(got["locations"], want.objects.locations)


def test_large_generator_equals_synthetic_data_large():
    from sbayes_tpu_torch.testing_scale import synthetic_data_large

    want = synthetic_data_large(n_objects=300, n_features=700, n_states=5, n_families=4,
                                seed=2**31 + 5)
    got = datagen.large(300, 700, 5, 4, 2**31 + 5)
    assert np.array_equal(got["values"], want.features.values)
    assert np.array_equal(got["families"], want.confounders["family"].group_assignment)
    assert np.array_equal(got["locations"], want.objects.locations)
    assert np.array_equal(got["applicable"], want.features.states)


def port_consts(arrays, packed):
    from perfbench import harness
    from sbayes_tpu_torch.config.schema import ModelConfig
    from sbayes_tpu_torch.model.constants import build_model_constants

    cell, config = harness.load_cell("sa100_k3.ens1024")
    return build_model_constants(harness.port_data(arrays),
                                 ModelConfig.from_dict(config["model"]), device="cpu",
                                 source_packed=packed)


@pytest.mark.parametrize("shape,packed", [((100, 36, 6, 6), False), ((60, 24, 5, 3), True)],
                         ids=["sa100_k3", "small_packed"])
def test_marginal_counts_equal_the_program(shape, packed):
    from sbayes_tpu_torch.ops import marginal

    arrays = datagen.small(*shape, seed=3)
    consts = port_consts(arrays, packed)
    N, F, _ = arrays["values"].shape
    fam = arrays["families"]
    group_of = np.stack([np.zeros(N, int), np.where(fam.any(0), fam.argmax(0), -1)])
    cells = yardstick.effect_cells_read(arrays["values"], group_of)
    assert cells == marginal.effect_cells_read(consts)
    for variant in marginal.VARIANTS:
        ratio, heat, two = variant
        for B in (4, 1024):
            assert (yardstick.marginal_bytes(cells, N, F, 3, B, ratio, two, heat)
                    == marginal.bytes_moved(consts, B, ratio, two, heat))
            assert (yardstick.marginal_operations(N, F, 3, B, ratio, two, heat)
                    == marginal.operations(consts, B, ratio, two, heat))


def test_ess_equals_the_program():
    from sbayes_tpu_torch.results import ess

    rng = np.random.default_rng(1)
    x = np.cumsum(rng.normal(size=(16, 300)), axis=1) * 0.1 + rng.normal(size=(16, 300))
    assert yardstick.multichain_ess(x) == ess.multichain_ess(x)


def test_geodesic_equals_the_program():
    from sbayes_tpu_torch.data.geo import vincenty_inverse

    loc = datagen.small(50, 4, 3, 2, seed=8)["locations"]
    lon, lat = loc[:, 0], loc[:, 1]
    want = vincenty_inverse(lat[:, None], lon[:, None], lat[None], lon[None])
    assert np.array_equal(geodesic.cost_matrix(loc, True), want)
