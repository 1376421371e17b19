"""Data normalisation / inverse normalisation with sideinfo bookkeeping.

Capability parity: reference `utils/io.py:65-214` (normalize_data /
invnormalize_data) and `utils/tool.py:8-30` (get_type_max / range_limit).

Numerics contract (important for PSNR parity): normalisation happens in
float32 on the host; inverse normalisation clips to the normalised range,
rescales, and casts to the original dtype exactly as the reference does.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np

ArrayLike = Union[np.ndarray, float, int]

# dtype -> dynamic range used for PSNR/weights (reference utils/tool.py:8-24).
_TYPE_MAX = {
    "uint8": 255,
    "uint12": 4098,
    "uint16": 65535,
    "float32": 65535,
    "float64": 65535,
    "int16": 65535,
}

# dtype -> saturation value used when casting back (reference utils/io.py:113-129).
_INV_MAX = {
    "uint8": 255,
    "uint16": 65535,
    "float32": 1e8,
    "float64": 1e8,
}


def get_type_max(data: np.ndarray) -> float:
    """Dynamic range of a dtype (reference utils/tool.py:8-24)."""
    name = data.dtype.name if isinstance(data, np.ndarray) else np.asarray(data).dtype.name
    if name not in _TYPE_MAX:
        raise NotImplementedError(f"unsupported dtype {name}")
    return _TYPE_MAX[name]


def range_limit(data: np.ndarray, rng) -> list:
    """Validate a [lo, hi] clip range against the dtype max
    (reference utils/tool.py:26-30)."""
    lo, hi = rng
    mx = get_type_max(data)
    assert lo >= 0 and lo <= hi and hi <= mx, "Improper range setting!"
    return [lo, hi]


def normalize_data(data: ArrayLike, name: str, min=None, max=None,
                   ) -> Tuple[np.ndarray, Dict]:
    """Normalise to training range; return (float32 array, sideinfos dict).

    Supported names match the reference (utils/io.py:65-110):
    'minmaxany_<a>_<b>', 'minmax01_0mean', 'minmax01_0mean1std', 'none'.
    """
    data = np.asarray(data)
    dtype = data.dtype.name
    data = data.astype(np.float32)
    if "minmaxany" in name:
        scale_min, scale_max = (float(x) for x in name.split("_")[1:])
        if min is None:
            min = float(data.min())
        if max is None:
            max = float(data.max())
        data = (data - min) / (max - min)
        data = data * (scale_max - scale_min) + scale_min
        side = {"dtype": dtype, "min": min, "max": max,
                "normalized_min": float(data.min()), "normalized_max": float(data.max())}
        return data, side
    if name == "minmax01_0mean":
        mn, mx = float(data.min()), float(data.max())
        data = (data - mn) / (mx - mn)
        mean = float(data.mean())
        data = data - mean
        return data, {"dtype": dtype, "min": mn, "max": mx, "mean": mean,
                      "normalized_min": -mean, "normalized_max": 1 - mean}
    if name == "minmax01_0mean1std":
        mn, mx = float(data.min()), float(data.max())
        data = (data - mn) / (mx - mn)
        mean, std = float(data.mean()), float(data.std())
        data = (data - mean) / std
        return data, {"dtype": dtype, "min": mn, "max": mx, "mean": mean, "std": std,
                      "normalized_min": (-mean) / std, "normalized_max": (1 - mean) / std}
    if name == "none":
        mn, mx = float(data.min()), float(data.max())
        return data, {"dtype": dtype, "min": mn, "max": mx,
                      "normalized_min": mn, "normalized_max": mx}
    raise NotImplementedError(f"unknown normalize '{name}'")


def invnormalize_data(data: np.ndarray, sideinfos: Dict, name: str) -> np.ndarray:
    """Inverse of normalize_data; restores dtype with clipping
    (reference utils/io.py:111-214)."""
    data = np.asarray(data, dtype=np.float32)
    dtype_name = sideinfos["dtype"]
    np_dtype = np.dtype(dtype_name)
    if "minmaxany" in name:
        scale_min, scale_max = (float(x) for x in name.split("_")[1:])
        mn, mx = sideinfos["min"], sideinfos["max"]
        data = (data - scale_min) / (scale_max - scale_min)
        data = np.clip(data, 0.0, 1.0)
        data = data * (mx - mn) + mn
        return data.astype(np_dtype)
    if name == "minmax01":
        mn, mx = sideinfos["min"], sideinfos["max"]
        return (np.clip(data, 0, 1) * (mx - mn) + mn).astype(np_dtype)
    if name == "minmaxn11":
        mn, mx = sideinfos["min"], sideinfos["max"]
        data = np.clip(data, -1, 1) / 2 + 0.5
        return (data * (mx - mn) + mn).astype(np_dtype)
    if name == "minmax01_0mean":
        mn, mx, mean = sideinfos["min"], sideinfos["max"], sideinfos["mean"]
        data = np.clip(data + mean, 0, 1)
        return (data * (mx - mn) + mn).astype(np_dtype)
    if name == "minmax01_0mean1std":
        mn, mx = sideinfos["min"], sideinfos["max"]
        mean, std = sideinfos["mean"], sideinfos["std"]
        data = np.clip(data * std + mean, 0, 1)
        return (data * (mx - mn) + mn).astype(np_dtype)
    if name == "none":
        mn, mx = sideinfos["min"], sideinfos["max"]
        return np.clip(data, mn, mx).astype(np_dtype)
    raise NotImplementedError(f"unknown normalize '{name}'")
