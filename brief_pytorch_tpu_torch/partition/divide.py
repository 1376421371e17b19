"""Uniform volume division, parameter allocation, merge.

Copy of brief_pytorch_tpu/partition/divide.py (reference utils/misc.py:
329-445 and utils/adaptive_blocking.py:16-24, 425-460) with numpy in place
of cv2: a 3-channel image is scored on its BGR->gray conversion with
cv2's weights (0.114, 0.587, 0.299) in float, and the 2-D boundary
visualisation draws its 2-pixel red rectangles with numpy (a picture for
the user, not pixel-identical to cv2.rectangle).  The port reads TIFF
volumes only (io/image.py), so the 3-D paths are the ones a run takes;
they are exact against the JAX package (tests/test_torch_partition.py).

Chunk naming contract (the deblock tools and the merged-module layout
read it): 3-D 'd_{z0}_{z1}-h_{y0}_{y1}-w_{x0}_{x1}', 2-D
'h_{y0}_{y1}-w_{x0}_{x1}', with INCLUSIVE end indices.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import numpy as np

from brief_pytorch_tpu_torch.core.normalize import get_type_max

BOUNDARY = 2000          # 3-D boundary marker value (reference misc.py:357-362)


def bgr_to_gray(image: np.ndarray) -> np.ndarray:
    """(h, w, 3) BGR -> (h, w) with cv2's COLOR_BGR2GRAY weights."""
    return image[..., :3].astype(np.float64) @ np.array([0.114, 0.587, 0.299])


def cal_feature(image: np.ndarray) -> float:
    """FFT sharpness score max/sum (reference adaptive_blocking.py:16-24).
    2-D (h,w,c) images are converted to grayscale; 3-D uses a 3-axis FFT."""
    if image.ndim == 3:
        if image.shape[-1] == 3:
            gray = bgr_to_gray(image)
        else:
            gray = image[..., 0] if image.shape[-1] == 1 else image
        f = np.fft.fft(np.fft.fft(gray, axis=0), axis=1)
    elif image.ndim == 4 or image.ndim == 2:
        f = image
        for ax in range(min(3, image.ndim)):
            f = np.fft.fft(f, axis=ax)
    else:
        raise NotImplementedError(image.shape)
    f = np.abs(f)
    total = int(f.sum())
    if total == 0:   # all-zero chunk (blank background)
        return 0.0
    return int(f.max()) / total


def chunk_name(chunk: Dict) -> str:
    if "d" in chunk:
        return "d_{}_{}-h_{}_{}-w_{}_{}".format(*chunk["d"], *chunk["h"],
                                                *chunk["w"])
    return "h_{}_{}-w_{}_{}".format(*chunk["h"], *chunk["w"])


def parse_chunk_name(name: str) -> Dict[str, List[int]]:
    """Inverse of chunk_name (reference main.py:304-311)."""
    out = {}
    for part in name.split("-"):
        bits = part.split("_")
        out[bits[0]] = [int(x) for x in bits[1:]]
    return out


def draw_rectangle(img: np.ndarray, y0: int, x0: int, y1: int, x1: int
                   ) -> None:
    """A 2-pixel red (BGR (0, 0, 255), clipped to the dtype) border from
    (y0, x0) to (y1, x1) inclusive, in place."""
    h, w = img.shape[:2]
    color = np.zeros(img.shape[-1] if img.ndim == 3 else 1, np.float64)
    color[min(2, color.size - 1)] = 255
    if np.issubdtype(img.dtype, np.integer):
        color = np.minimum(color, np.iinfo(img.dtype).max)
    color = color.astype(img.dtype) if img.ndim == 3 else color[0]
    ys, xs = slice(max(y0, 0), min(y1 + 1, h)), slice(max(x0, 0), min(x1 + 1, w))
    for y in (y0, y0 + 1, y1 - 1, y1):
        if 0 <= y < h:
            img[y, xs] = color
    for x in (x0, x0 + 1, x1 - 1, x1):
        if 0 <= x < w:
            img[ys, x] = color


def divide_data(data: np.ndarray, divide_type: str
                ) -> Tuple[List[Dict], np.ndarray]:
    """Grid split: 'total_nd_nh_nw' (number of chunks per axis) or
    'every_dsz_hsz_wsz' (chunk sizes).  Returns (chunk list, boundary-drawn
    visualisation volume) — reference utils/misc.py:329-394."""
    divide_img = copy.deepcopy(data)
    chunks: List[Dict] = []
    if data.ndim == 4:
        if "total" in divide_type:
            _, nd, nh, nw = divide_type.split("_")
            cd = int(data.shape[0] / int(nd))
            ch = int(data.shape[1] / int(nh))
            cw = int(data.shape[2] / int(nw))
        elif "every" in divide_type:
            _, cd, ch, cw = divide_type.split("_")
            cd, ch, cw = int(cd), int(ch), int(cw)
        else:
            raise NotImplementedError(divide_type)
        dsec = [i for i in range(data.shape[0]) if i % cd == 0] + [data.shape[0]]
        hsec = [i for i in range(data.shape[1]) if i % ch == 0] + [data.shape[1]]
        wsec = [i for i in range(data.shape[2]) if i % cw == 0] + [data.shape[2]]
        for di in range(len(dsec) - 1):
            for hi in range(len(hsec) - 1):
                for wi in range(len(wsec) - 1):
                    chunks.append({
                        "data": data[dsec[di]:dsec[di + 1],
                                     hsec[hi]:hsec[hi + 1],
                                     wsec[wi]:wsec[wi + 1]],
                        "d": [dsec[di], dsec[di + 1] - 1],
                        "h": [hsec[hi], hsec[hi + 1] - 1],
                        "w": [wsec[wi], wsec[wi + 1] - 1]})
                    z, y, x = dsec[di], hsec[hi], wsec[wi]
                    d = dsec[di + 1] - dsec[di]
                    h = hsec[hi + 1] - hsec[hi]
                    w = wsec[wi + 1] - wsec[wi]
                    divide_img[z, y:y + h, x:x + w] = BOUNDARY
                    divide_img[z + d - 1, y:y + h, x:x + w] = BOUNDARY
                    divide_img[z:z + d, y, x:x + w] = BOUNDARY
                    divide_img[z:z + d, y + h - 1, x:x + w] = BOUNDARY
                    divide_img[z:z + d, y:y + h, x] = BOUNDARY
                    divide_img[z:z + d, y:y + h, x + w - 1] = BOUNDARY
    elif data.ndim == 3:
        if "total" in divide_type:
            _, _, nh, nw = divide_type.split("_")
            ch = int(data.shape[0] / int(nh))
            cw = int(data.shape[1] / int(nw))
        elif "every" in divide_type:
            _, _, ch, cw = divide_type.split("_")
            ch, cw = int(ch), int(cw)
        else:
            raise NotImplementedError(divide_type)
        hsec = [i for i in range(data.shape[0]) if i % ch == 0] + [data.shape[0]]
        wsec = [i for i in range(data.shape[1]) if i % cw == 0] + [data.shape[1]]
        for hi in range(len(hsec) - 1):
            for wi in range(len(wsec) - 1):
                chunks.append({
                    "data": data[hsec[hi]:hsec[hi + 1], wsec[wi]:wsec[wi + 1]],
                    "h": [hsec[hi], hsec[hi + 1] - 1],
                    "w": [wsec[wi], wsec[wi + 1] - 1]})
                draw_rectangle(divide_img, hsec[hi], wsec[wi], hsec[hi + 1],
                               wsec[wi + 1])
    else:
        raise NotImplementedError(data.shape)
    for chunk in chunks:
        chunk["total_size"] = data.size
        chunk["size"] = chunk["data"].size
        chunk["name"] = chunk_name(chunk)
    return chunks, divide_img


def cal_factor(n: int) -> List[int]:
    """All proper divisors of n including 1 (reference
    adaptive_blocking.py:425-430)."""
    return [1] + [i for i in range(2, n) if n % i == 0]


def cal_divide_num(d: int, h: int, w: int, Nb: int, param_size: float
                   ) -> np.ndarray:
    """Pick (nd, nh, nw) dividing the volume into at most Nb near-cubic
    chunks (reference adaptive_blocking.py:432-460).  Nb <= 0 defaults to
    param_size/(4*1361) — the mean SIREN block size heuristic."""
    if Nb <= 0:
        Nb = max(1, int(param_size / (4 * 1361)))
    best_num, best = 0, None
    best_var = None
    for nd in cal_factor(d):
        for nh in cal_factor(h):
            for nw in cal_factor(w):
                num = nd * nh * nw
                if num > Nb:
                    continue
                size = np.array([d / nd, h / nh, w / nw])
                var = ((size - size.mean()) ** 2).mean()
                if num > best_num or (num == best_num and var < best_var):
                    best_num, best, best_var = num, np.array([nd, nh, nw]), var
    return best


def _variance(data: np.ndarray) -> float:
    return float(((data - data.mean()) ** 2).mean())


def alloc_param(chunks: List[Dict], param_size: float, param_alloc: str,
                param_size_thres: float) -> List[Dict]:
    """Split a byte budget across chunks; drop sub-threshold chunks and
    re-allocate recursively (reference utils/misc.py:395-428).

    Modes: 'equal', 'by_size', 'by_var' (variance share), 'by_d'
    (1/FFT-sharpness share), 'by_dv' (size/FFT-sharpness share).
    """
    if param_alloc == "equal":
        for c in chunks:
            c["param_size"] = param_size / len(chunks)
    elif param_alloc == "by_size":
        for c in chunks:
            c["param_size"] = param_size * c["size"] / c["total_size"]
    elif param_alloc == "by_var":
        tot = sum(_variance(c["data"]) for c in chunks)
        for c in chunks:
            c["param_size"] = float(param_size * _variance(c["data"]) / tot)
    elif param_alloc == "by_d":
        tot = sum(1.0 / cal_feature(c["data"]) for c in chunks)
        for c in chunks:
            c["param_size"] = float(
                param_size * (1.0 / cal_feature(c["data"])) / tot)
    elif param_alloc == "by_dv":
        tot = sum(c["size"] / cal_feature(c["data"]) for c in chunks)
        for c in chunks:
            c["param_size"] = float(
                param_size * (c["size"] / cal_feature(c["data"])) / tot)
    else:
        raise NotImplementedError(param_alloc)
    kept = [c for c in chunks if c["param_size"] >= param_size_thres]
    if len(kept) < len(chunks):
        return alloc_param(kept, param_size, param_alloc, param_size_thres)
    return kept


def merge_divided_data(chunks: List[Dict], data_shape) -> np.ndarray:
    """Sum decoded chunks into a zero volume, clip to dtype max, cast
    (reference utils/misc.py:430-445)."""
    mx = get_type_max(chunks[0]["data"])
    out = np.zeros(tuple(data_shape), dtype=np.float32)
    for c in chunks:
        h0, h1 = c["h"]
        w0, w1 = c["w"]
        if len(data_shape) == 4:
            d0, d1 = c["d"]
            out[d0:d1 + 1, h0:h1 + 1, w0:w1 + 1] += c["data"]
        elif len(data_shape) == 3:
            out[h0:h1 + 1, w0:w1 + 1] += c["data"]
        else:
            raise NotImplementedError(data_shape)
    out = out.clip(None, mx)
    return out.astype(chunks[0]["data"].dtype)
