"""H.264-style deblocking filter over INR block boundaries.

    python -m brief_pytorch_tpu_torch.post.deblock -stp <step dir>

Copy of brief_pytorch_tpu/post/deblock.py, bit-identical to it and so to
native/deblock.cpp (tests/test_torch_deblock.py): NumPy on the host, the
volume read and written through this package's io/image.py.  Reference
deblock.py:6-136 and deblock.cpp:13-321: an in-loop-style boundary
smoother run as a post-processing step on the merged decompressed
volume, with boundary lines derived from the compressed module
directory names ('d_{z0}_{z1}-h_{y0}_{y1}-w_{x0}_{x1}').

Numerics contract: the reference ships two implementations that differ in
arithmetic (deblock.py:29-31 uses float division; deblock.cpp:47-49
promotes to int and truncates).  This is the *integer* (C++/H.264)
variant.  Block/module listings are SORTED: the reference applies
boundary lines in raw os.listdir order, making its output depend on
filesystem readdir order (in-place filtering is order-sensitive).

Vectorisation: the reference filters one pixel at a time
(deblock.py:61-76).  Along a single boundary line the updates are
independent (a vertical line touches each image row once; a horizontal
line touches each column once), so whole lines are vectorised with NumPy
while keeping the reference's *sequential line order* (line crossings see
earlier lines' writes, exactly like the reference).
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def alpha(x: float) -> float:
    """Edge-strength threshold (reference deblock.py:6-7)."""
    return 0.8 * (2.0 ** (x / 6.0) - 1.0)


def beta(x: float) -> float:
    """Gradient threshold (reference deblock.py:9-10)."""
    return 0.5 * x - 7.0


def _trunc_div(a: np.ndarray, b: int) -> np.ndarray:
    """C-style integer division (truncate toward zero) for signed arrays."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


def filter_line_windows(win: np.ndarray, index_a: float, index_b: float,
                        thres: float) -> np.ndarray:
    """Filter a batch of 6-sample boundary windows.

    win: (n, 6) int64 samples [p2 p1 p0 | q0 q1 q2] straddling the boundary.
    Returns (n, 4) filtered [p1 p0 q0 q1]; unfiltered windows pass through.
    Integer arithmetic per reference deblock.cpp:41-71; the judge test is
    reference deblock.py:19-25 / deblock.cpp:31-39.
    """
    win = win.astype(np.int64)
    p2, p1, p0, q0, q1, q2 = (win[:, i] for i in range(6))
    a, b = alpha(index_a), beta(index_b)

    # judge_filter: skip bright areas; require small jumps across the edge
    ok = ((p1 + p0 + q0 + q1) // 4 <= thres)
    ok &= np.abs(p0 - q0) < a
    ok &= (np.abs(p1 - p0) < b) & (np.abs(q1 - q0) < b)

    delta0 = _trunc_div(4 * (q0 - p0) + (p1 - q1) + 4, 8)
    mid = _trunc_div(p0 + q0 + 1, 2)
    deltap1 = _trunc_div(p2 + mid - 2 * p1, 2)
    deltaq1 = _trunc_div(q2 + mid - 2 * q1, 2)

    c1 = 20
    c0 = c1 + (np.abs(p2 - p0) < b).astype(np.int64) \
            + (np.abs(q2 - q0) < b).astype(np.int64)
    delta0 = np.clip(delta0, -c0, c0)
    deltap1 = np.clip(deltap1, -c1, c1)
    deltaq1 = np.clip(deltaq1, -c1, c1)

    out = np.stack([p1 + deltap1, p0 + delta0, q0 - delta0, q1 + deltaq1],
                   axis=1)
    return np.where(ok[:, None], out, win[:, 1:5])


def filter2d(line: Sequence[int], img: np.ndarray, index_a: float,
             index_b: float, thres: float) -> np.ndarray:
    """Filter one boundary line of a 2-D image in place
    (reference deblock.py:50-77, whole-line vectorised).

    line: (x1, y1, x2, y2).  x1 == x2 -> vertical boundary (filter across x);
    y1 == y2 -> horizontal boundary (filter across y).  Lines too close to
    the image edge are skipped like the reference (deblock.py:55-60).
    """
    x1, y1, x2, y2 = (int(v) for v in line)
    H, W = img.shape[:2]
    if x1 == x2:
        x = x1
        if x - 3 < 0 or x + 3 > W - 1:
            return img
        ys = np.arange(y1, y2 + 1)
        win = img[ys[:, None], np.arange(x - 3, x + 3)[None, :]]
        img[ys[:, None], np.arange(x - 2, x + 2)[None, :]] = \
            filter_line_windows(win, index_a, index_b, thres).astype(img.dtype)
    elif y1 == y2:
        y = y1
        if y - 3 < 0 or y + 3 > H - 1:
            return img
        xs = np.arange(x1, x2 + 1)
        win = img[np.arange(y - 3, y + 3)[None, :], xs[:, None]]
        img[np.arange(y - 2, y + 2)[None, :], xs[:, None]] = \
            filter_line_windows(win, index_a, index_b, thres).astype(img.dtype)
    return img


def collect_lines_2d(block_names: List[str]) -> List[List[int]]:
    """Dedup'd boundary lines [x1, y1, x2, y2] from 2-D chunk names
    'h_{y1}_{y2}-w_{x1}_{x2}' (reference deblock.py:95-108)."""
    lines: List[List[int]] = []
    for name in block_names:
        h, w = name.split("-")
        y1, y2 = (int(v) for v in h.split("_")[1:])
        x1, x2 = (int(v) for v in w.split("_")[1:])
        for cand in ([x1, y1, x1, y2], [x2, y1, x2, y2],
                     [x1, y1, x2, y1], [x1, y2, x2, y2]):
            if cand not in lines:
                lines.append(cand)
    return lines


def collect_lines_3d(block_names: List[str]) -> List[List[int]]:
    """Boundary lines [z, x1, y1, x2, y2] from 3-D chunk names
    'd_{z1}_{z2}-h_{y1}_{y2}-w_{x1}_{x2}'.

    Dedup quirk preserved from the reference (deblock.py:120-132): presence
    is only checked at z1 before appending the whole z-range.
    """
    lines: List[List[int]] = []
    for name in block_names:
        d, h, w = name.split("-")
        z1, z2 = (int(v) for v in d.split("_")[1:])
        y1, y2 = (int(v) for v in h.split("_")[1:])
        x1, x2 = (int(v) for v in w.split("_")[1:])
        l_new = [z1, x1, y1, x1, y2] not in lines
        r_new = [z1, x2, y1, x2, y2] not in lines
        d_new = [z1, x1, y1, x2, y1] not in lines
        u_new = [z1, x1, y2, x2, y2] not in lines
        for i in range(z1, z2 + 1):
            if l_new:
                lines.append([i, x1, y1, x1, y2])
            if r_new:
                lines.append([i, x2, y1, x2, y2])
            if d_new:
                lines.append([i, x1, y1, x2, y1])
            if u_new:
                lines.append([i, x1, y2, x2, y2])
    return lines


def deblock_image(img: np.ndarray, block_names: List[str], index_a: float,
                  index_b: float, thres: float) -> np.ndarray:
    """Deblock a (h,w,c) image or (d,h,w,c) volume in place
    (reference deblock.py:95-136)."""
    if img.ndim == 3:
        lines = collect_lines_2d(block_names)
        for k in range(img.shape[-1]):
            for p in lines:
                filter2d(p, img[:, :, k], index_a, index_b, thres)
    elif img.ndim == 4:
        lines = collect_lines_3d(block_names)
        for k in range(img.shape[-1]):
            for p in lines:
                filter2d(p[1:], img[p[0], :, :, k], index_a, index_b, thres)
    else:
        raise NotImplementedError(img.shape)
    return img


def main(step_dir: str, index_a: float = 51, index_b: float = 2000,
         thres: float = 65535) -> str:
    """Deblock the decompressed volume of a DivideTask step directory
    (reference deblock.py:79-136 file contract).  Returns the output path.
    """
    from brief_pytorch_tpu_torch.io.image import read_img, save_img
    decompressed_dir = os.path.join(step_dir, "decompressed")
    save_dir = os.path.join(step_dir, "deblock")
    os.makedirs(save_dir, exist_ok=True)
    origin_name = sorted(os.listdir(decompressed_dir))[0]
    save_path = os.path.join(save_dir,
                             origin_name[:-4] + "_deblocked_python.tif")
    module_dir = os.path.join(step_dir, "compressed", "module")
    img = read_img(os.path.join(decompressed_dir, origin_name))
    block_names = sorted(os.listdir(module_dir))
    img = deblock_image(img, block_names, index_a, index_b, thres)
    save_img(save_path, img)
    return save_path


def cli(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="Deblock")
    parser.add_argument("-stp", type=str, default="", help="step path")
    parser.add_argument("--index_a", type=float, default=51)
    parser.add_argument("--index_b", type=float, default=2000)
    parser.add_argument("--thres", type=float, default=65535)
    args = parser.parse_args(argv)
    return main(args.stp, args.index_a, args.index_b, args.thres)


if __name__ == "__main__":
    cli()
