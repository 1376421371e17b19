"""Quality metrics: MSE, PSNR (dtype-max range), slice-averaged SSIM.

Torch port of brief_pytorch_tpu/eval/metrics.py:24-158, 225-260
(reference utils/misc.py:447-499 and the vendored pure-torch SSIM,
utils/ssim.py:9-120: gaussian window 11, sigma 1.5, K=(0.01, 0.03),
separable valid-mode filtering).  MSE and PSNR run in NumPy float32 like
the JAX package; SSIM runs as separable torch convolutions on a chosen
device.  3-D volumes are evaluated as 2-D SSIM per depth slice, then
averaged (reference utils/misc.py:458-475).  MS-SSIM is not ported yet
(ROADMAP.md).

TF32 is switched off for the SSIM convolutions: cuDNN runs float32
convolutions in TF32 by default, which keeps ~3 decimal digits — the JAX
package needed Precision.HIGHEST on the TPU for the same reason (its
SSIM drifted by 0.03 without it).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from brief_pytorch_tpu_torch.core.device import resolve_device
from brief_pytorch_tpu_torch.core.normalize import get_type_max


def cal_mse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(((a - b) ** 2).mean())


def cal_psnr(origin: np.ndarray, decompressed: np.ndarray,
             data_range: float) -> float:
    """PSNR over the dtype dynamic range (reference utils/misc.py:451-456)."""
    a = np.asarray(origin, np.float32) / data_range
    b = np.asarray(decompressed, np.float32) / data_range
    mse = float(np.mean((a - b) ** 2))
    return float(-10.0 * np.log10(mse))


def _gauss_kernel1d(size: int = 11, sigma: float = 1.5, device=None
                    ) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) \
        - size // 2
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _conv_last(z: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Valid 1-D correlation along the last axis; axes shorter than the
    window pass through unfiltered (reference utils/ssim.py:44-51)."""
    k = win.shape[0]
    if z.shape[-1] < k:
        return z
    out = F.conv1d(z.reshape(-1, 1, z.shape[-1]), win.reshape(1, 1, k))
    return out.reshape(z.shape[:-1] + (z.shape[-1] - k + 1,))


def _filter_sep2d(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode gaussian blur over the last two axes."""
    x = _conv_last(x, win)
    return _conv_last(x.transpose(-1, -2), win).transpose(-1, -2)


def _ssim_map(x: torch.Tensor, y: torch.Tensor, data_range: float,
              win_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM of (n, c, h, w) pairs, in the JAX package's
    float32-robust form: centred by the global mean before the variance
    filters, variances clamped at 0."""
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    win = _gauss_kernel1d(win_size, 1.5, x.device)
    m = 0.5 * (x.mean() + y.mean())
    xc, yc = x - m, y - m
    mu1 = _filter_sep2d(x, win)
    mu2 = _filter_sep2d(y, win)
    mu1c, mu2c = mu1 - m, mu2 - m
    s1 = torch.clamp_min(_filter_sep2d(xc * xc, win) - mu1c * mu1c, 0.0)
    s2 = torch.clamp_min(_filter_sep2d(yc * yc, win) - mu2c * mu2c, 0.0)
    s12 = _filter_sep2d(xc * yc, win) - mu1c * mu2c
    cs = (2 * s12 + C2) / (s1 + s2 + C2)
    return ((2 * mu1 * mu2 + C1) / (mu1 * mu1 + mu2 * mu2 + C1)) * cs


@torch.no_grad()
def cal_ssim(origin: np.ndarray, decompressed: np.ndarray, data_range: float,
             slice_batch: int = 64, device=None) -> float:
    """SSIM; (h, w, c) images -> 2-D SSIM; (d, h, w, c) volumes -> mean of
    per-depth-slice 2-D SSIM (reference utils/misc.py:458-475).

    Inputs are pre-scaled by data_range, as in the JAX package.  device:
    where the filters run (None: the CUDA card)."""
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    a = np.asarray(origin, np.float32) / data_range
    b = np.asarray(decompressed, np.float32) / data_range
    if a.ndim == 3:      # (h, w, c) -> (1, c, h, w)
        x = torch.from_numpy(a.transpose(2, 0, 1)[None].copy()).to(device)
        y = torch.from_numpy(b.transpose(2, 0, 1)[None].copy()).to(device)
        return float(_ssim_map(x, y, 1.0).mean())
    if a.ndim == 4:      # (d, h, w, c): slices as batch
        total = 0.0
        for s in range(0, a.shape[0], slice_batch):
            x = torch.from_numpy(
                a[s:s + slice_batch].transpose(0, 3, 1, 2).copy()).to(device)
            y = torch.from_numpy(
                b[s:s + slice_batch].transpose(0, 3, 1, 2).copy()).to(device)
            total += float(_ssim_map(x, y, 1.0).mean(dim=(1, 2, 3)).sum())
        return total / a.shape[0]
    raise NotImplementedError(a.shape)


def eval_performance(steps: int, data1: np.ndarray, data2: np.ndarray,
                     logger=None, mse: bool = True, psnr: bool = True,
                     ssim: bool = True, device=None) -> Dict[str, float]:
    """Compute and optionally log quality metrics
    (reference utils/misc.py:477-499)."""
    out: Dict[str, float] = {"steps": steps}
    max_range = get_type_max(data1)
    a = np.asarray(data1, np.float32)
    b = np.asarray(data2, np.float32)
    if mse:
        out["mse"] = cal_mse(a, b)
        if logger:
            logger.log_metrics({"mse": out["mse"]}, steps)
    if psnr:
        out["psnr"] = cal_psnr(a, b, max_range)
        if logger:
            logger.log_metrics({"psnr": out["psnr"]}, steps)
    if ssim:
        out["ssim"] = cal_ssim(a, b, max_range, device=device)
        if logger:
            logger.log_metrics({"ssim": out["ssim"]}, steps)
    return out


def mip_ops(data: np.ndarray, save_dir=None, data_name: str = "",
            suffix: str = ""):
    """Max-intensity projections along the 3 axes
    (reference utils/misc.py:233-242)."""
    if data.ndim != 4:
        raise ValueError(f"mip_ops takes a (d, h, w, c) volume, got "
                         f"{data.shape}")
    mips = (data.max(0), data.max(1), data.max(2))
    if save_dir is not None:
        from brief_pytorch_tpu_torch.io.image import save_img
        for name, mip in zip(("d", "h", "w"), mips):
            save_img(os.path.join(save_dir, f"{data_name}_mip_{name}{suffix}"),
                     mip)
    return mips
