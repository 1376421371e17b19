"""Pre/post-processing: denoise threshold / morphological open + clip,
per-voxel loss weights, checkpoint schedules.

Copy of brief_pytorch_tpu/post/preprocess.py, with scipy's binary_opening
replaced by a NumPy box-structure opening of the same semantics (equal to
scipy.ndimage.binary_opening with a ones((...)) structure, iterations=1,
tests/test_torch_preprocess.py).

Capability parity: reference utils/misc.py:244-307.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence, Union

import numpy as np

from brief_pytorch_tpu_torch.core.normalize import range_limit


def _shift_reduce(a: np.ndarray, offsets: Sequence[Sequence[int]], op):
    """op-reduce of `a` shifted by every offset combination; voxels shifted
    in from outside the array are False (scipy's border_value=0)."""
    out = None
    for combo in itertools.product(*offsets):
        sh = np.zeros(a.shape, dtype=bool)
        src, dst = [], []
        for o, n in zip(combo, a.shape):
            if o >= 0:
                dst.append(slice(0, n - o))
                src.append(slice(o, n))
            else:
                dst.append(slice(-o, n))
                src.append(slice(0, n + o))
        sh[tuple(dst)] = a[tuple(src)]
        out = sh if out is None else op(out, sh)
    return out


def binary_opening_box(mask: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """Erosion then dilation with a box of `size` (one entry per axis),
    centred at size // 2 like scipy.ndimage."""
    ero = [list(range(-(s // 2), s - s // 2)) for s in size]
    dil = [[-o for o in offs] for offs in ero]
    return _shift_reduce(_shift_reduce(mask, ero, np.logical_and), dil,
                         np.logical_or)


def preprocess(data: np.ndarray, denoise_level: int,
               denoise_close: Union[bool, List[int]],
               clip_range: List[int]) -> np.ndarray:
    """Zero out background noise (optionally only morphologically-open
    regions) and clip (reference utils/misc.py:244-254).  Mutates in place
    like the reference."""
    if denoise_close is False:
        data[data <= denoise_level] = 0
    else:
        close = list(denoise_close)
        if data.ndim == 4:
            size = close + [1]
        elif data.ndim == 3:
            size = close[:2] + [1]
        else:
            raise NotImplementedError(data.shape)
        data[binary_opening_box(data <= denoise_level, size)] = 0
    lo, hi = range_limit(data, clip_range)
    return data.clip(lo, hi)


def parse_checkpoints(checkpoints: Union[str, int], max_steps: int) -> List[int]:
    """Checkpoint step list: 'none' | 'every_<n>' | int | 'a,b,c'
    (reference utils/misc.py:255-271)."""
    if checkpoints == "none":
        return [max_steps]
    if isinstance(checkpoints, int):
        if checkpoints >= max_steps:
            return [max_steps]
        return [checkpoints, max_steps]
    if "every" in checkpoints:
        _, interval = checkpoints.split("_")
        interval = int(interval)
        out = list(range(interval, max_steps, interval))
        out.append(max_steps)
        return out
    out = [int(s) for s in checkpoints.split(",") if int(s) < max_steps]
    out.append(max_steps)
    return out


def parse_weight(data: np.ndarray, weight_type_list: List[str]) -> np.ndarray:
    """Per-voxel loss-weight map from rules
    ('quantile_<ge>_<ql>_<qh>_<scale>', 'value_<lo>_<hi>_<scale>',
     'exp_<midx>_<midv>', 'none') — reference utils/misc.py:272-307."""
    data = np.asarray(data)
    weight = np.ones_like(data, dtype=np.float32)
    for weight_type in weight_type_list:
        if "quantile" in weight_type:
            _, ge_thres, ql, qh, scale = weight_type.split("_")
            ge_thres, ql, qh, scale = (float(ge_thres), float(ql),
                                       float(qh), float(scale))
            sel = data[data >= ge_thres]
            lo = np.quantile(sel, ql)
            hi = np.quantile(sel, qh)
            lo, hi = range_limit(data, [lo, hi])
            weight[(data >= lo) & (data <= hi)] = scale
        elif "value" in weight_type:
            _, lo, hi, scale = weight_type.split("_")
            lo, hi, scale = float(lo), float(hi), float(scale)
            lo, hi = range_limit(data, [lo, hi])
            weight[(data >= lo) & (data <= hi)] = scale
        elif "exp" in weight_type:
            _, mid_x, mid_value = weight_type.split("_")
            mid_x, mid_value = float(mid_x), float(mid_value)
            a = -np.log(mid_value) / mid_x
            weight = np.exp(-a * data.astype(np.float64)).astype(np.float32)
        elif weight_type == "none":
            pass
        else:
            raise NotImplementedError(weight_type)
    return weight
