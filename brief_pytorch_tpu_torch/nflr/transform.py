"""3-D augmentations for NFLR training batches (channels-first numpy).

Copy of brief_pytorch_tpu/nflr/transform.py
(pure Python: the port keeps its own).

Capability parity: reference utils/transform.py:6-135 (Transform pipeline,
Crop3d, RandomCrop3d, Resize3d, RandomResize3d, FlipRoat3d/fliproat3d).
Operators act on (n, c, d, h, w) arrays; each has the reference's `check`
gate so disabled entries drop out of the pipeline.
"""
from __future__ import annotations

import random
from typing import List

import numpy as np


class Transform:
    """Ordered operator pipeline (reference utils/transform.py:6-17)."""

    def __init__(self, operator_instance_list: List):
        self.operator_instance_list = [op for op in operator_instance_list
                                       if op.check()]

    @staticmethod
    def from_opt(opt) -> "Transform":
        """Build from a Transform config node with Resize3d/RandomResize3d/
        Crop3d/RandomCrop3d/FlipRoat3d sub-nodes (reference
        utils/dataset.py:163-165 ordering)."""
        ops = [Resize3d(**dict(opt["Resize3d"])),
               RandomResize3d(**dict(opt["RandomResize3d"])),
               Crop3d(**dict(opt["Crop3d"])),
               RandomCrop3d(**dict(opt["RandomCrop3d"])),
               FlipRoat3d(**dict(opt["FlipRoat3d"]))]
        return Transform(ops)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        for op in self.operator_instance_list:
            img = op(img)
        return img


class Crop3d:
    """Fixed-origin crop (reference utils/transform.py:18-41)."""

    def __init__(self, crop_d: int, crop_h: int, crop_w: int,
                 crop_d_start: int = 0, crop_h_start: int = 0,
                 crop_w_start: int = 0):
        self.size = (crop_d, crop_h, crop_w)
        self.start = (crop_d_start, crop_h_start, crop_w_start)

    def check(self) -> bool:
        return all(self.size)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if not self.check():
            return img
        sl = [slice(None), slice(None)]
        for axis in range(3):
            n = img.shape[2 + axis]
            s0 = self.start[axis]
            length = min(self.size[axis], n - s0)
            sl.append(slice(s0, s0 + length))
        return img[tuple(sl)]


class RandomCrop3d:
    """Random-origin crop (reference utils/transform.py:42-59)."""

    def __init__(self, randomcrop_d: int, randomcrop_h: int,
                 randomcrop_w: int):
        self.size = (randomcrop_d, randomcrop_h, randomcrop_w)

    def check(self) -> bool:
        return all(self.size)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        starts = [random.randint(0, max(0, img.shape[2 + a] - self.size[a]))
                  for a in range(3)]
        return Crop3d(*self.size, *starts)(img)


def _trilinear_resize(img: np.ndarray, out_shape) -> np.ndarray:
    """Trilinear resize with align_corners=False (torch F.interpolate
    semantics used at reference utils/transform.py:77)."""
    n, c, *in_shape = img.shape
    coords = []
    for axis, out_n in enumerate(out_shape):
        in_n = in_shape[axis]
        # align_corners=False: x_in = (i + 0.5) * in/out - 0.5
        x = (np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5
        coords.append(np.clip(x, 0, in_n - 1))
    out = img.astype(np.float32)
    for axis in range(3):
        x = coords[axis]
        lo = np.floor(x).astype(int)
        hi = np.minimum(lo + 1, out.shape[2 + axis] - 1)
        frac = (x - lo).reshape([-1 if a == axis else 1 for a in range(3)])
        lo_v = np.take(out, lo, axis=2 + axis)
        hi_v = np.take(out, hi, axis=2 + axis)
        out = lo_v * (1 - frac) + hi_v * frac
    return out


class Resize3d:
    """(reference utils/transform.py:60-78)"""

    def __init__(self, resize_d: int, resize_h: int, resize_w: int,
                 mode: str = "trilinear"):
        self.size = (resize_d, resize_h, resize_w)
        self.mode = mode

    def check(self) -> bool:
        return all(self.size)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        assert self.mode == "trilinear", self.mode
        return _trilinear_resize(img, self.size)


class RandomResize3d:
    """(reference utils/transform.py:79-101)"""

    def __init__(self, resize_d_ratio, resize_h_ratio, resize_w_ratio,
                 mode: str = "trilinear"):
        self.ratios = (list(resize_d_ratio), list(resize_h_ratio),
                       list(resize_w_ratio))
        self.mode = mode

    def check(self) -> bool:
        return any(r != [1, 1] for r in self.ratios)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        out_shape = []
        for axis in range(3):
            lo, hi = self.ratios[axis]
            r = random.random() * (hi - lo) + lo
            out_shape.append(max(1, int(r * img.shape[2 + axis])))
        return Resize3d(*out_shape, self.mode)(img)


class FlipRoat3d:
    """Random flips + axis-swap 'rot90's (reference utils/transform.py:
    102-135; the reference's rot90s are pure axis transpositions)."""

    def __init__(self, flip: bool, drot90: bool, hrot90: bool, wrot90: bool):
        self.flip, self.drot90 = flip, drot90
        self.hrot90, self.wrot90 = hrot90, wrot90

    def check(self) -> bool:
        return self.flip or self.drot90 or self.hrot90 or self.wrot90

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return fliproat3d(
            img,
            (random.random() < 0.5) and self.flip,
            (random.random() < 0.5) and self.flip,
            (random.random() < 0.5) and self.flip,
            (random.random() < 0.5) and self.drot90,
            (random.random() < 0.5) and self.hrot90,
            (random.random() < 0.5) and self.wrot90)


def fliproat3d(img: np.ndarray, dflip: bool, hflip: bool, wflip: bool,
               drot90: bool, hrot90: bool, wrot90: bool) -> np.ndarray:
    """(reference utils/transform.py:122-135)"""
    if dflip:
        img = np.flip(img, -3)
    if hflip:
        img = np.flip(img, -2)
    if wflip:
        img = np.flip(img, -1)
    if drot90:      # n c d h w -> n c d w h
        img = np.swapaxes(img, -1, -2)
    if hrot90:      # n c d h w -> n c w h d
        img = np.swapaxes(img, -1, -3)
    if wrot90:      # n c d h w -> n c h d w
        img = np.swapaxes(img, -2, -3)
    return np.ascontiguousarray(img)
