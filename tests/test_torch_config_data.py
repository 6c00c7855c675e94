"""The PyTorch port's host layer against the JAX package: config schema,
loaded data and model constants (on the CPU).

Everything here is exact: the config is the same values, the data the same
arrays, the constants the same numbers (float32 on both sides)."""
import shutil
import warnings
from enum import Enum
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)
import torch

FIXTURES = Path(__file__).parent / "fixtures"
UNIFORM_GEO = {"model": {"prior": {"geo": {"type": "uniform"}}}}


def _plain(v):
    """Config values in comparable form: enums by value, paths as str."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, Enum):
        return v.value
    if isinstance(v, Path):
        return str(v)
    return v


@pytest.fixture
def fixture_dir(tmp_path):
    for f in ("config.yaml", "features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, tmp_path / f)
    return tmp_path


@pytest.mark.parametrize("custom", [None, UNIFORM_GEO], ids=["as_is", "uniform_geo"])
def test_fixture_config_equals_jax(fixture_dir, custom):
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu_torch.config.schema import SBayesConfig

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JaxConfig.from_config_file(fixture_dir / "config.yaml", custom)
        got = SBayesConfig.from_config_file(fixture_dir / "config.yaml", custom)
    assert _plain(got.model_dump()) == _plain(want.model_dump())


def test_synthetic_config_equals_jax():
    from sbayes_tpu.testing import synthetic_config as jax_config
    from sbayes_tpu_torch.testing import synthetic_config

    for kw in ({}, {"n_clusters": 1}, {"geo_prior": "cost_based"}):
        want = _plain(jax_config(**kw).model_dump())
        got = _plain(synthetic_config(**kw).model_dump())
        # the results directory lies under each package's own temp path, and
        # the (unread) data paths point at each package's own module
        for d in (want, got):
            d["results"].pop("path")
            d.pop("data")
        assert got == want


@pytest.mark.parametrize("values", [
    {"mcmc": {"steps": 1001, "samples": 10}},          # steps % samples != 0
    {"model": {"clusters": 1, "extra_key": 3}},        # unknown key
    {"model": {"prior": {"geo": {"type": "cost_based", "rate": None}}}},
])
def test_config_validators_refuse_like_jax(fixture_dir, values):
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu_torch.config.schema import SBayesConfig

    with pytest.raises(Exception):
        JaxConfig.from_config_file(fixture_dir / "config.yaml", values)
    with pytest.raises(ValueError):
        SBayesConfig.from_config_file(fixture_dir / "config.yaml", values)


def _datas(fixture_dir):
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.data.loader import Data as JaxData
    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig.from_config_file(fixture_dir / "config.yaml", UNIFORM_GEO)
        cfg = SBayesConfig.from_config_file(fixture_dir / "config.yaml", UNIFORM_GEO)
    return jcfg, JaxData.from_config(jcfg), cfg, Data.from_config(cfg)


def test_fixture_data_equals_jax(fixture_dir):
    _, jdata, _, data = _datas(fixture_dir)
    np.testing.assert_array_equal(data.features.values, jdata.features.values)
    np.testing.assert_array_equal(data.features.na_values, jdata.features.na_values)
    np.testing.assert_array_equal(data.features.states, jdata.features.states)
    assert list(data.features.names) == list(jdata.features.names)
    assert data.features.state_names == jdata.features.state_names
    np.testing.assert_array_equal(data.objects.locations, jdata.objects.locations)
    assert list(data.confounders) == list(jdata.confounders)
    for name, conf in data.confounders.items():
        np.testing.assert_array_equal(conf.group_assignment,
                                      jdata.confounders[name].group_assignment)
        assert list(conf.group_names) == list(jdata.confounders[name].group_names)


ARRAYS = ("features", "na", "applicable", "n_states_per_feature", "groups", "group_valid",
          "hc_conf", "conc_cluster", "unif_conc", "conc_conf", "conc_weights", "adjacency",
          "locations", "static_pat", "pat_bits")


def _assert_constants_equal(c, jc):
    for name in ARRAYS:
        got = c.__getattribute__(name).cpu().numpy()
        want = np.asarray(getattr(jc, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)
    np.testing.assert_array_equal(c.n_groups, jc.n_groups)
    for attr in ("conf_names", "group_names", "weights_prior_uniform", "size_prior_type",
                 "min_size", "max_size", "K", "N", "F", "S", "C", "Gmax"):
        assert getattr(c, attr) == getattr(jc, attr), attr
    # the int8 feature index both kernels read, against the JAX layout helper
    from sbayes_tpu.ops.pallas_marginal import idx_layout_host

    want_idx = idx_layout_host(np.asarray(jc.features), jc.S)[:, :jc.F]
    np.testing.assert_array_equal(c.feat_idx.numpy(), want_idx)
    # per-object group index (-1 = in no group) against the one-hot groups
    groups = np.asarray(jc.groups)
    for i_c in range(jc.C - 1):
        gi = c.group_idx[i_c].numpy()
        for n in range(jc.N):
            if groups[i_c, :, n].any():
                assert groups[i_c, gi[n], n] == 1
            else:
                assert gi[n] == -1


def test_fixture_constants_equal_jax(fixture_dir):
    from sbayes_tpu.model.constants import build_model_constants as jax_build
    from sbayes_tpu_torch.model.constants import build_model_constants

    jcfg, jdata, cfg, data = _datas(fixture_dir)
    c = build_model_constants(data, cfg.model, device="cpu")
    assert c.device == torch.device("cpu")
    _assert_constants_equal(c, jax_build(jdata, jcfg.model))


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_synthetic_constants_equal_jax(n_clusters):
    from sbayes_tpu.model.constants import build_model_constants as jax_build
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.constants import build_model_constants
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    kw = dict(n_objects=40, n_features=10, n_states=5, n_families=4, seed=3)
    c = build_model_constants(synthetic_data(**kw), synthetic_config(n_clusters).model,
                              device="cpu")
    _assert_constants_equal(c, jax_build(jax_data(**kw), jax_config(n_clusters).model))


def test_cost_based_geo_is_refused(fixture_dir):
    """The fixture config as it is (cost-based geo prior) belongs to a later
    slice: building constants refuses it instead of falling back."""
    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.constants import build_model_constants

    cfg = SBayesConfig.from_config_file(fixture_dir / "config.yaml")
    with pytest.raises(NotImplementedError, match="geo prior"):
        build_model_constants(Data.from_config(cfg), cfg.model, device="cpu")


def test_cuda_device_without_card_raises():
    from sbayes_tpu_torch.model.constants import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
