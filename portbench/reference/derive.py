"""What the program derives from a configuration and its volume, worked out
again in plain NumPy: the byte budget, the blocks and their budgets, each
network's width, the preprocessing, the normalization, the loss weights and
the coordinates of a voxel.

This is the benchmark's own copy of the reference BRIEF arithmetic
(main.py:199-264, utils/misc.py:244-428, adaptive_blocking.py:425-460,
Networks.py:291-314), frozen here so that a change to the program cannot
move the yardstick.  It imports NumPy and OpenCV only.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

TYPE_MAX = {"uint8": 255, "uint16": 65535}


def read_volume(path: str) -> np.ndarray:
    """A multi-page TIFF as (d, h, w, 1), or a one-page one as (h, w, 1)."""
    import cv2
    ok, pages = cv2.imreadmulti(path, flags=cv2.IMREAD_UNCHANGED)
    if not ok or not pages:
        raise ValueError(f"{path}: not a TIFF OpenCV reads")
    vol = np.stack(pages) if len(pages) > 1 else pages[0]
    return vol[..., None]


def preprocess(vol: np.ndarray, level: int, clip: Sequence[int]) -> np.ndarray:
    """Denoise and clip.  With level 0 on unsigned data the reference's
    opening only zeroes voxels that are already 0 (the opening of a mask
    lies inside the mask), so only the clip is left."""
    if level != 0 or vol.dtype.kind != "u":
        raise NotImplementedError("denoise level 0 on unsigned data only")
    lo, hi = clip
    if not 0 <= lo <= hi <= TYPE_MAX[vol.dtype.name]:
        raise ValueError(f"clip {clip} outside the dtype's range")
    return vol.clip(lo, hi)


def budget_bytes(data_path: str, ratio: float) -> float:
    """The byte budget: the file's size over filesize_ratio."""
    return os.path.getsize(data_path) / float(ratio)


def siren_width(budget: float, layers: int, c_in: int = 3, c_out: int = 1
                ) -> int:
    """The SIREN width whose parameters fill a float32 budget: the positive
    root of (l-2) f^2 + (c + l - 1 + o) f + o - count, rounded."""
    count = budget / 4.0
    a, b, cc = layers - 2, c_in + 1 + layers - 2 + c_out, c_out - count
    return round((-b + math.sqrt(b * b - 4 * a * cc)) / (2 * a))


def siren_dims(width: int, layers: int, c_in: int = 3, c_out: int = 1
               ) -> List[Tuple[int, int]]:
    """(fan_in, fan_out) of each linear layer."""
    return [(c_in, width)] + [(width, width)] * (layers - 2) + \
        [(width, c_out)]


def _factors(n: int) -> List[int]:
    return [1] + [i for i in range(2, n) if n % i == 0]


def divide_counts(d: int, h: int, w: int, nb: int) -> Tuple[int, int, int]:
    """adaptotal's (nd, nh, nw): the most blocks up to nb, then the most
    nearly cubic."""
    best_num, best, best_var = 0, None, None
    for nd in _factors(d):
        for nh in _factors(h):
            for nw in _factors(w):
                num = nd * nh * nw
                if num > nb:
                    continue
                size = np.array([d / nd, h / nh, w / nw])
                var = ((size - size.mean()) ** 2).mean()
                if num > best_num or (num == best_num and var < best_var):
                    best_num, best, best_var = num, (nd, nh, nw), var
    return best


def blocks(vol: np.ndarray, divide_type: str) -> List[Dict]:
    """The blocks of an 'adaptotal_-1_-1_-1_<nb>' division of a (d, h, w, c)
    volume, in row-major block order: extents and data."""
    parts = divide_type.split("_")
    if parts[0] != "adaptotal" or parts[1:4] != ["-1", "-1", "-1"]:
        raise NotImplementedError(divide_type)
    d, h, w = vol.shape[:3]
    nd, nh, nw = divide_counts(d, h, w, int(parts[4]))
    cd, ch, cw = d // nd, h // nh, w // nw
    secs = [list(range(0, n, s)) + [n] for n, s in ((d, cd), (h, ch), (w, cw))]
    out = []
    for z0, z1 in zip(secs[0], secs[0][1:]):
        for y0, y1 in zip(secs[1], secs[1][1:]):
            for x0, x1 in zip(secs[2], secs[2][1:]):
                out.append({"extent": (z0, z1, y0, y1, x0, x1),
                            "data": vol[z0:z1, y0:y1, x0:x1]})
    return out


def split_by_var(budget: float, parts: List[np.ndarray]) -> List[float]:
    """The budget split by each block's variance (every share above the
    configs' 26-byte threshold, which is checked)."""
    var = [float(((p - p.mean()) ** 2).mean()) for p in parts]
    return [budget * v / sum(var) for v in var]


def normalize(vol: np.ndarray, name: str) -> Tuple[np.ndarray, float, float]:
    """minmaxany_<a>_<b> in float32: (normalized, min, max)."""
    kind, a, b = name.split("_")
    if kind != "minmaxany":
        raise NotImplementedError(name)
    x = vol.astype(np.float32)
    mn, mx = float(x.min()), float(x.max())
    x = (x - mn) / (mx - mn)
    return x * (float(b) - float(a)) + float(a), mn, mx


def normalized_value(v: float, name: str, mn: float, mx: float) -> float:
    """One raw value normalized as the volume was (the loss threshold)."""
    _, a, b = name.split("_")
    x = (np.float32(v) - np.float32(mn)) / (np.float32(mx) - np.float32(mn))
    return float(x * (np.float32(b) - np.float32(a)) + np.float32(a))


def loss_weights(vol: np.ndarray, rules: Sequence[str]) -> np.ndarray:
    """Per-voxel loss weights ('value_<lo>_<hi>_<scale>' rules)."""
    wt = np.ones(vol.shape, np.float32)
    for rule in rules:
        kind, lo, hi, scale = rule.split("_")
        if kind != "value":
            raise NotImplementedError(rule)
        wt[(vol >= float(lo)) & (vol <= float(hi))] = float(scale)
    return wt


def coords_mode(mode: str) -> Tuple[float, float]:
    lo, hi = mode.split(",")
    return float(lo), float(hi)


def axis_step(n: int, mode: str) -> float:
    """The float32 spacing of n grid points over the coordinate range."""
    lo, hi = coords_mode(mode)
    return float(np.float32((hi - lo) / (n - 1))) if n > 1 else 0.0
