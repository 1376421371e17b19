"""Closed-form parameter-count solvers for the φ-network zoo.

The port's own copy of brief_pytorch_tpu/models/sizing.py (pure Python; the
two must give the same features for every family, tests/test_torch_sizing.py).

Each network family exposes:
  calc_param_count(features, **cfg) -> int      exact parameter count
  calc_features(param_count, **cfg) -> number   inverse (quadratic solve)
  check_param_count(param_count, **cfg) -> bool (families with minima only)

These are pure functions of the architecture hyperparameters; they are used
to size a network to an exact byte budget before training (reference
utils/Networks.py: SIREN 291-314, SIRENFT 346-369, SIREN_Pyramid 416-457,
SIRENPS 487-552, SIREN_RELU 580-599, SIREN_SIGMOID 627-646, SIRENPos 49-62,
NeRF 118-136, FFN 189-207, MFNFourier 717-727, MFNGabor 784-794) and the
model-degradation chain (reference main.py:214-246).

Note some families deliberately return *float* features (SIRENFT, SIRENPS):
the constructor floors them; we preserve that contract for sideinfos
round-trip compatibility.
"""
from __future__ import annotations

import math
from typing import Dict


def _quad_pos_root(a: float, b: float, c: float) -> float:
    """Positive root of a f^2 + b f + c = 0 (a may be 0)."""
    if a == 0:
        return -c / b
    return (-b + math.sqrt(b * b - 4 * a * c)) / (2 * a)


# ---------------------------------------------------------------- SIREN ---
def siren_param_count(coords_channel=3, data_channel=1, features=256, layers=5,
                      res=False, **_) -> int:
    f, c, o, l = features, coords_channel, data_channel, layers
    if res:
        return int(c * f + f + 2 * (l - 2) * (f * f + f) + f * o + o)
    return int(c * f + f + (l - 2) * (f * f + f) + f * o + o)


def siren_features(param_count, coords_channel=3, data_channel=1, layers=5,
                   res=False, **_) -> int:
    c, o, l = coords_channel, data_channel, layers
    if res:
        a, b, cc = (l - 2) * 2, c + 1 + 2 * l - 4 + o, -param_count + o
    else:
        a, b, cc = l - 2, c + 1 + l - 2 + o, -param_count + o
    return round(_quad_pos_root(a, b, cc))


# -------------------------------------------------------------- SIRENFT ---
def sirenft_param_count(coords_channel=3, data_channel=1, features=256, layers=5,
                        res=False, ratio=1, **_) -> int:
    ff = int(features * ratio)
    f = int(features)
    c, o, l = coords_channel, data_channel, layers
    return int(c * ff + ff + ff * f + f + (l - 3) * (f * f + f) + f * o + o)


def sirenft_features(param_count, coords_channel=3, data_channel=1, layers=5,
                     res=False, ratio=1, **_) -> float:
    c, o, l, r = coords_channel, data_channel, layers, ratio
    a = r + l - 3
    b = c * r + r + 1 + l - 3 + o
    cc = o - param_count
    return _quad_pos_root(a, b, cc)  # float on purpose (ref Networks.py:363-369)


def sirenft_check(param_count, coords_channel=3, data_channel=1, layers=5,
                  res=False, ratio=1, **_) -> bool:
    limit = sirenft_param_count(coords_channel, data_channel, 1, layers, res, ratio)
    return param_count >= limit


# -------------------------------------------------------- SIREN_Pyramid ---
def siren_pyramid_param_count(coords_channel=3, data_channel=1, features=256,
                              layers=5, res=False, features_dis=10, **_) -> int:
    f, c, o, l, d = features, coords_channel, data_channel, layers, features_dis
    if res:
        return int(c * f + f + 2 * (l - 2) * (f * f + f) + f * o + o)
    pc = c * f + f
    for i in range(l - 2):
        pc += (f - i * d) * (f - (i + 1) * d) + (f - (i + 1) * d)
    pc += (f - (l - 2) * d) * o + o
    return int(pc)


def siren_pyramid_features(param_count, coords_channel=3, data_channel=1,
                           layers=5, res=False, features_dis=10, **_) -> int:
    l, c0, d, o = layers, coords_channel, features_dis, data_channel
    if res:
        a, b, cc = (l - 2) * 2, c0 + 1 + 2 * l - 4 + o, -param_count + o
        return round(_quad_pos_root(a, b, cc))
    a = (l - 2)
    b = c0 + 1 + (1 - d) * (l - 2) - (l - 2) * (l - 3) * d + o
    cc = ((l - 2) * (1 - d) ** 2 / 4 - (l - 2) * (l - 3) * d
          + (l - 2) * (l - 3) * (2 * l - 5) * d * d / 6
          - (l - 2) * (1 + d) ** 2 / 4 - (l - 2) * d * o + o - param_count)
    features = round(_quad_pos_root(a, b, cc))
    if features - (l - 2) * d <= 0:
        raise ValueError("pyramid collapses to non-positive width")
    return features


def siren_pyramid_check(param_count, coords_channel=3, data_channel=1, layers=5,
                        res=False, features_dis=10, **_) -> bool:
    f = 1 + (layers - 2) * features_dis
    limit = siren_pyramid_param_count(coords_channel, data_channel, f, layers,
                                      False, features_dis)
    return param_count >= limit


# -------------------------------------------------------------- SIRENPS ---
def sirenps_widths(features, layers, ratio):
    """Per-layer (in, out) widths of the geometric pyramid."""
    dims = [(None, int(features * ratio ** (layers - 2)))]
    for i in range(layers - 2):
        l1 = int(features * ratio ** (layers - 2 - i))
        l2 = int(features * ratio ** (layers - 2 - i - 1))
        dims.append((l1, l2))
    return dims


def sirenps_param_count(coords_channel=3, data_channel=1, features=256, layers=5,
                        res=False, ratio=1, **_) -> int:
    c, o, l, r = coords_channel, data_channel, layers, ratio
    if res:
        f = features
        return int(c * f + f + 2 * (l - 2) * (f * f + f) + f * o + o)
    l2 = int(features * r ** (l - 2))
    pc = c * l2 + l2
    for i in range(l - 2):
        a = int(features * r ** (l - 2 - i))
        b = int(features * r ** (l - 2 - i - 1))
        pc += a * b + b
    pc += features * o + o
    return int(pc)


def sirenps_features(param_count, coords_channel=3, data_channel=1, layers=5,
                     res=False, ratio=1, **_) -> float:
    c, o, l, r = coords_channel, data_channel, layers, ratio
    if res:
        a, b, cc = (l - 2) * 2, c + 1 + 2 * l - 4 + o, -param_count + o
        return round(_quad_pos_root(a, b, cc))
    a = r * (1 - (r * r) ** (l - 2)) / (1 - r * r)
    b = (1 - r ** (l - 2)) / (1 - r) + (c + 1) * r ** (l - 2) + o
    cc = o - param_count
    features = _quad_pos_root(a, b, cc)
    if features <= 0:
        raise ValueError("non-positive features")
    return features


def sirenps_check(param_count, coords_channel=3, data_channel=1, layers=5,
                  res=False, ratio=1, **_) -> bool:
    limit = sirenps_param_count(coords_channel, data_channel, 1, layers, False, ratio)
    return param_count >= limit


# ----------------------------------------------------------------- NeRF ---
def nerf_param_count(coords_channel=3, data_channel=1, features=256,
                     frequencies=10, layers=5, skip=True, **_) -> int:
    d = coords_channel + 2 * coords_channel * frequencies
    f, o, l = features, data_channel, layers
    base = d * f + f + (l - 2) * (f * f + f) + f * o + o
    return int(base + (d * f if skip else 0))


def nerf_features(param_count, coords_channel=3, data_channel=1, frequencies=10,
                  layers=5, skip=True, **_) -> int:
    d = coords_channel + 2 * coords_channel * frequencies
    a = layers - 2
    b = (2 * d if skip else d) + 1 + layers - 2 + data_channel
    cc = -param_count + data_channel
    return round(_quad_pos_root(a, b, cc))


# ------------------------------------------------------------------ FFN ---
def ffn_param_count(coords_channel=3, data_channel=1, features=256, embsize=256,
                    layers=5, skip=False, **_) -> int:
    d = 2 * embsize
    f, o, l = features, data_channel, layers
    base = d * f + f + (l - 2) * (f * f + f) + f * o + o + coords_channel * embsize
    return int(base + (d * f if skip else 0))


def ffn_features(param_count, coords_channel=3, data_channel=1, embsize=256,
                 layers=5, skip=False, **_) -> int:
    d = 2 * embsize
    a = layers - 2
    b = (2 * d if skip else d) + 1 + layers - 2 + data_channel
    cc = -param_count + data_channel + coords_channel * embsize
    return round(_quad_pos_root(a, b, cc))


# ------------------------------------------------------------------ MFN ---
def mfnfourier_param_count(coords_channel=3, data_channel=1, features=256,
                           layers=5, **_) -> int:
    f, c, o, l = features, coords_channel, data_channel, layers
    return int((l - 2) * (f * f + f) + f * o + o + (l - 1) * (c * f + f))


def mfnfourier_features(param_count, coords_channel=3, data_channel=1,
                        layers=5, **_) -> int:
    a = layers - 2
    b = layers - 2 + data_channel + (layers - 1) * (1 + coords_channel)
    cc = -param_count + data_channel
    return round(_quad_pos_root(a, b, cc))


def mfngabor_param_count(coords_channel=3, data_channel=1, features=256,
                         layers=5, **_) -> int:
    f, c, o, l = features, coords_channel, data_channel, layers
    return int((l - 2) * (f * f + f) + f * o + o + (l - 1) * (2 * c * f + 2 * f))


def mfngabor_features(param_count, coords_channel=3, data_channel=1,
                      layers=5, **_) -> int:
    a = layers - 2
    b = layers - 2 + data_channel + (layers - 1) * (2 + 2 * coords_channel)
    cc = -param_count + data_channel
    return round(_quad_pos_root(a, b, cc))


# ------------------------------------------------------------ registries ---
ALL_CALC_PHI_PARAM_COUNT: Dict[str, callable] = {
    "SIREN": siren_param_count,
    "SIRENFT": sirenft_param_count,
    "SIREN_Pyramid": siren_pyramid_param_count,
    "SIRENPS": sirenps_param_count,
    "SIREN_RELU": siren_param_count,
    "SIREN_SIGMOID": siren_param_count,
    "SIRENPos": siren_param_count,
    "NeRF": nerf_param_count,
    "FFN": ffn_param_count,
    "MFNFourier": mfnfourier_param_count,
    "MFNGabor": mfngabor_param_count,
}

ALL_CALC_PHI_FEATURES: Dict[str, callable] = {
    "SIREN": siren_features,
    "SIRENFT": sirenft_features,
    "SIREN_Pyramid": siren_pyramid_features,
    "SIRENPS": sirenps_features,
    "SIREN_RELU": siren_features,
    "SIREN_SIGMOID": siren_features,
    "SIRENPos": siren_features,
    "NeRF": nerf_features,
    "FFN": ffn_features,
    "MFNFourier": mfnfourier_features,
    "MFNGabor": mfngabor_features,
}

ALL_CHECK_PARAM_COUNT: Dict[str, callable] = {
    "SIRENFT": sirenft_check,
    "SIREN_Pyramid": siren_pyramid_check,
    "SIRENPS": sirenps_check,
}


def estimate_module_size(ideal_module_size: float, phi_cfg: dict, half: bool):
    """Size a network to a byte budget with the model-degradation chain.

    Mirrors reference main.py:214-246: SIREN_Pyramid -> SIRENFT -> SIREN and
    SIRENPS -> SIREN when the budget is below the family's minimum.  MUTATES
    phi_cfg['name'] (and 'features') like the reference mutates opt.Module.phi.

    Returns (phi_features, actual_param_count, theory_module_size_bytes).
    """
    bytes_per_param = 2.0 if half else 4.0
    ideal_count = ideal_module_size / bytes_per_param
    name = phi_cfg["name"]
    if name == "SIREN_Pyramid" and not siren_pyramid_check(ideal_count, **_clean(phi_cfg)):
        name = "SIRENFT"
        phi_cfg["name"] = name
        # reference main.py:226 sets features_plus (unused by SIRENFT); kept
        # for config-compat only.
        phi_cfg["features_plus"] = phi_cfg.get("features_dis", 10)
    if name == "SIRENFT" and not sirenft_check(ideal_count, **_clean(phi_cfg)):
        name = "SIREN"
        phi_cfg["name"] = name
    if name == "SIRENPS" and not sirenps_check(ideal_count, **_clean(phi_cfg)):
        name = "SIREN"
        phi_cfg["name"] = name
    features = ALL_CALC_PHI_FEATURES[name](param_count=ideal_count, **_clean(phi_cfg))
    actual = ALL_CALC_PHI_PARAM_COUNT[name](features=features, **_clean(phi_cfg))
    theory = actual * bytes_per_param
    return features, actual, theory


def _clean(cfg: dict) -> dict:
    """Drop keys that would shadow explicit arguments."""
    return {k: v for k, v in cfg.items()
            if k not in ("name", "features", "param_count")}


def calc_phi_hyperparam(param_count: float, name: str, layers: int,
                        coords_channel: int = 3, data_channel: int = 1,
                        res: bool = False, frequencies: int = 10,
                        skip: bool = True, embsize: int = 256, **kwargs
                        ) -> int:
    """Standalone feature solver (reference utils/Networks.py:857-927).

    Delegates to the per-family solvers above.  Note: the reference's
    standalone function swaps the MFNFourier/MFNGabor coefficient formulas
    relative to its own class statics (Networks.py:717-727 vs 902-915); the
    class statics are the ones used by the sizing path, so we follow those.
    """
    solver = ALL_CALC_PHI_FEATURES[name]
    return int(solver(param_count, coords_channel=coords_channel,
                      data_channel=data_channel, layers=layers, res=res,
                      frequencies=frequencies, skip=skip, embsize=embsize))
