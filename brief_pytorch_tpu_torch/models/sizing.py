"""Closed-form parameter-count solver for the SIREN chain families.

Trimmed copy of brief_pytorch_tpu/models/sizing.py: the SIREN formulas
(reference utils/Networks.py:291-314), which also size SIRENPos, and the
byte-budget sizing of estimate_module_size.  The other families' solvers
come with their φ ports (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict


def _quad_pos_root(a: float, b: float, c: float) -> float:
    """Positive root of a f^2 + b f + c = 0 (a may be 0)."""
    if a == 0:
        return -c / b
    return (-b + math.sqrt(b * b - 4 * a * c)) / (2 * a)


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


ALL_CALC_PHI_PARAM_COUNT: Dict[str, callable] = {
    "SIREN": siren_param_count,
    "SIRENPos": siren_param_count,
}

ALL_CALC_PHI_FEATURES: Dict[str, callable] = {
    "SIREN": siren_features,
    "SIRENPos": siren_features,
}


def estimate_module_size(ideal_module_size: float, phi_cfg: dict, half: bool):
    """Size a network to a byte budget (reference main.py:214-246).

    Returns (phi_features, actual_param_count, theory_module_size_bytes).
    """
    name = phi_cfg["name"]
    if name not in ALL_CALC_PHI_FEATURES:
        raise NotImplementedError(
            f"sizing for φ family {name!r} is not ported yet (ROADMAP.md)")
    bytes_per_param = 2.0 if half else 4.0
    ideal_count = ideal_module_size / bytes_per_param
    features = ALL_CALC_PHI_FEATURES[name](param_count=ideal_count,
                                           **_clean(phi_cfg))
    actual = ALL_CALC_PHI_PARAM_COUNT[name](features=features,
                                            **_clean(phi_cfg))
    return features, actual, actual * bytes_per_param


def _clean(cfg: dict) -> dict:
    """Drop keys that would shadow explicit arguments."""
    return {k: v for k, v in cfg.items()
            if k not in ("name", "features", "param_count")}
