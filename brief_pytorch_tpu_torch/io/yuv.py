"""Raw YUV (planar I420) import, 8-bit and 10-bit little-endian.

A NumPy copy of brief_pytorch_tpu/io/yuv.py (reference
utils/tool.py:105-186, yuv_import / yuv2bgr); cv2 is imported only by
yuv2bgr.
The reference reads one byte at a time in Python loops; here each plane is
one vectorised np.frombuffer reshape (~1000x faster, same values), keeping
the reference's quirky 10-bit downconversion `(lo + hi*255) // 4` bit-exact.

yuv2bgr's fixed crop window (reference tool.py:181: rows 600:1624, cols
1340:2364 — sized for their microscope captures) is exposed as an optional
`crop` argument with the same default.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _read_plane(buf: memoryview, offset: int, h: int, w: int, bits: str
                ) -> Tuple[np.ndarray, int]:
    if bits == "8bit":
        plane = np.frombuffer(buf, np.uint8, h * w, offset).reshape(h, w)
        return plane.copy(), offset + h * w
    if bits == "10bit":
        raw = np.frombuffer(buf, np.uint8, h * w * 2, offset
                            ).astype(np.int32).reshape(h, w, 2)
        # reference tool.py:124: (lo + hi*255)//4, cast to uint8
        plane = ((raw[..., 0] + raw[..., 1] * 255) // 4).astype(np.uint8)
        return plane, offset + h * w * 2
    raise NotImplementedError(bits)


def _frame_size(h: int, w: int, bits: str) -> int:
    base = h * w * 3 // 2
    return base * (2 if bits == "10bit" else 1)


def yuv_import(filename: str, dims: Tuple[int, int], numfrm: int,
               startfrm: int, type: str = "8bit"
               ) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Read planar I420 frames -> (Y, U, V) lists of uint8 planes
    (reference utils/tool.py:105-144)."""
    h, w = dims
    with open(filename, "rb") as f:
        f.seek(_frame_size(h, w, type) * startfrm)
        data = memoryview(f.read(_frame_size(h, w, type) * numfrm))
    Y, U, V = [], [], []
    off = 0
    for _ in range(numfrm):
        y, off = _read_plane(data, off, h, w, type)
        u, off = _read_plane(data, off, h // 2, w // 2, type)
        v, off = _read_plane(data, off, h // 2, w // 2, type)
        Y.append(y)
        U.append(u)
        V.append(v)
    return Y, U, V


def yuv2bgr(filename: str, height: int, width: int, numfrm: int,
            startfrm: int, type: str = "8bit",
            crop: Optional[Tuple[int, int, int, int]] = (600, 1024, 1340, 1024)
            ) -> Tuple[np.ndarray, np.ndarray]:
    """I420 -> (yuv_video (n, h*3/2, w), bgr_video) via cv2 color conversion
    (reference utils/tool.py:146-186).  crop = (row0, rows, col0, cols) or
    None for full frames."""
    import cv2
    Y, U, V = yuv_import(filename, (height, width), numfrm, startfrm, type)
    yuv_video, bgr_video = [], []
    for y, u, v in zip(Y, U, V):
        yuv_img = np.concatenate([y.reshape(-1), u.reshape(-1),
                                  v.reshape(-1)])
        yuv_img = yuv_img.reshape(height * 3 // 2, width)
        bgr = cv2.cvtColor(yuv_img, cv2.COLOR_YUV2BGR_I420)
        if crop is not None:
            r0, rh, c0, cw = crop
            bgr = bgr[r0:r0 + rh, c0:c0 + cw]
        yuv_video.append(yuv_img)
        bgr_video.append(bgr)
    return np.asarray(yuv_video), np.asarray(bgr_video)
