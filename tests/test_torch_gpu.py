"""Tests of the PyTorch port that need a CUDA card (marker ``gpu``); they
skip without one. On the card: ``python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports no JAX: the card's machine has none."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).parent.parent


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    """chip_smoke's kernel comparison (both kernels, every marginal variant,
    each within its stated tolerance) at the full-width shapes, at 400
    features (feature tiles), at the odd shape (plain-load path, objects in
    no family), with 2, 4 and 5 components and with more groups than the
    default shared memory holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    rt, states, info = chip_smoke.phase_full_width(256, 200)
    assert info["launches"]["loglh"] > 0 and info["launches"]["marginal"] > 0
    rows = chip_smoke.phase_kernels(rt, states, info["launches"])
    assert {r["name"] for r in rows} == {"loglh", "marginal", "marginal_heat",
                                         "marginal_two_eff", "marginal_abs"}
    first = rows[0]
    assert first["odd_shape"]["objects_in_no_family"] > 0
    assert set(first["odd_shape"]["errors"]) == set(first["feature_tiled"]["errors"])
    assert first["feature_tiled"]["f_tile"] < first["feature_tiled"]["F"]
    assert set(first["components"]) == {"C2", "C4", "C5"}
    assert first["many_groups"]["rows"] * 4 * 6 > 48 * 1024
    assert all(r["launch_floor_ms"] > 0 and r["device_floor_ms"] > 0 for r in rows)
