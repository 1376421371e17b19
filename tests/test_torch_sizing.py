"""The port's copy of models/sizing.py against the JAX package's: every
solver, the three `check`s, the degradation chain of estimate_module_size
and calc_phi_hyperparam give the same numbers (exact: both are pure
Python), and the parameter tree the port builds has the solver's count.
"""
import numpy as np
import pytest
import torch

from brief_pytorch_tpu.models import sizing as js
from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.models import sizing as ts

FAMILY_KEYS = {
    "SIREN": {}, "SIRENFT": {"ratio": 2.2}, "SIREN_Pyramid": {"features_dis": 3},
    "SIRENPS": {"ratio": 1.4}, "SIREN_RELU": {}, "SIREN_SIGMOID": {},
    "SIRENPos": {"T": [2.0, 3.0, 2.0]}, "NeRF": {"frequencies": 4},
    "FFN": {"embsize": 12, "scale": 5}, "MFNFourier": {}, "MFNGabor": {},
}
FAMILIES = sorted(FAMILY_KEYS)


def _cfg(name, coords=3, layers=4, **kw):
    cfg = {"name": name, "coords_channel": coords, "data_channel": 1,
           "layers": layers, "w0": 20, **FAMILY_KEYS[name], **kw}
    if name == "SIRENPos":
        cfg["T"] = cfg["T"][:coords]
    return cfg


def test_registries_match_jax():
    assert list(ts.ALL_CALC_PHI_FEATURES) == list(js.ALL_CALC_PHI_FEATURES)
    assert list(ts.ALL_CALC_PHI_PARAM_COUNT) == \
        list(js.ALL_CALC_PHI_PARAM_COUNT)
    assert list(ts.ALL_CHECK_PARAM_COUNT) == list(js.ALL_CHECK_PARAM_COUNT)
    assert list(tphi.ALLPHI) == list(ts.ALL_CALC_PHI_FEATURES)


@pytest.mark.parametrize("coords,layers", [(3, 4), (2, 3), (3, 6)])
@pytest.mark.parametrize("name", FAMILIES)
def test_estimate_module_size_matches_jax(name, coords, layers):
    """features, parameter count, theory bytes and the (mutated) family
    name, over budgets from below every family's minimum upwards."""
    for ideal in [120.0, 700.0, 2400.0, 6516.0, 40000.0, 3.3e5]:
        jc, tc = _cfg(name, coords, layers), _cfg(name, coords, layers)
        try:
            want = js.estimate_module_size(ideal, jc, False)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                ts.estimate_module_size(ideal, tc, False)
            continue
        got = ts.estimate_module_size(ideal, tc, False)
        assert got == want and type(got[0]) is type(want[0])
        assert tc == jc          # the degradation chain mutates alike


@pytest.mark.parametrize("name", ["SIREN_Pyramid", "SIRENFT", "SIRENPS"])
def test_degradation_chain(name):
    """Below a family's minimum the name degrades (Pyramid -> SIRENFT ->
    SIREN, SIRENPS -> SIREN), as in JAX; above it, it stays."""
    seen = set()
    for ideal in [8.0, 40.0, 200.0, 1000.0, 4000.0, 1e5]:
        for extra in ({}, {"features_dis": 30}):
            if extra and name != "SIREN_Pyramid":
                continue
            tc, jc = _cfg(name, **extra), _cfg(name, **extra)
            got = ts.estimate_module_size(ideal, tc, False)
            assert got == js.estimate_module_size(ideal, jc, False)
            assert tc == jc
            seen.add(tc["name"])
            if tc["name"] == "SIRENFT" and name == "SIREN_Pyramid":
                assert tc["features_plus"] == tc["features_dis"]
    want = {"SIREN_Pyramid": {"SIREN_Pyramid", "SIRENFT", "SIREN"},
            "SIRENFT": {"SIRENFT", "SIREN"}, "SIRENPS": {"SIRENPS", "SIREN"}}
    assert seen == want[name]


@pytest.mark.parametrize("name", FAMILIES)
def test_solvers_and_checks_match_jax(name):
    kw = {k: v for k, v in _cfg(name).items() if k != "name"}
    for count in [300.0, 5000.0, 123456.0]:
        try:
            want = js.ALL_CALC_PHI_FEATURES[name](count, **kw)
        except ValueError:
            with pytest.raises(ValueError):
                ts.ALL_CALC_PHI_FEATURES[name](count, **kw)
            continue
        got = ts.ALL_CALC_PHI_FEATURES[name](count, **kw)
        assert got == want and type(got) is type(want)
        assert ts.ALL_CALC_PHI_PARAM_COUNT[name](features=got, **kw) == \
            js.ALL_CALC_PHI_PARAM_COUNT[name](features=want, **kw)
        if name in ts.ALL_CHECK_PARAM_COUNT:
            assert ts.ALL_CHECK_PARAM_COUNT[name](count, **kw) == \
                js.ALL_CHECK_PARAM_COUNT[name](count, **kw)
        try:    # the standalone solver's defaults (ratio 1) divide by 0
            want = js.calc_phi_hyperparam(count, name, 5)
        except (ValueError, ZeroDivisionError) as e:
            with pytest.raises(type(e)):
                ts.calc_phi_hyperparam(count, name, 5)
        else:
            assert ts.calc_phi_hyperparam(count, name, 5) == want


@pytest.mark.parametrize("name,res", [(n, False) for n in FAMILIES]
                         + [("SIREN", True)])
def test_built_tree_has_the_solvers_count(name, res):
    """The parameter tree model.init builds has exactly the count the
    sizing promised (NFGR.prepare_module relies on it).  res: SIREN only,
    the one family whose reference res count matches what it builds."""
    cfg = _cfg(name, res=res) if res else _cfg(name)
    features, count, theory = ts.estimate_module_size(20000.0, cfg, False)
    cfg["features"] = features
    params = tphi.init_phi(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert tphi.get_param_count(params) == count
    assert theory == 4.0 * count
    assert abs(theory - 20000.0) / 20000.0 < 0.08
