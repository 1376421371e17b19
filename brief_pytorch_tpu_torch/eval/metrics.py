"""Quality metrics: MSE, PSNR (dtype-max range), slice-averaged SSIM.

Torch port of brief_pytorch_tpu/eval/metrics.py:24-158, 225-260
(reference utils/misc.py:447-499 and the vendored pure-torch SSIM,
utils/ssim.py:9-120: gaussian window 11, sigma 1.5, K=(0.01, 0.03),
separable valid-mode filtering).  MSE and PSNR run in NumPy float32 like
the JAX package; SSIM runs as separable torch convolutions on a chosen
device.  3-D volumes are evaluated as 2-D SSIM per depth slice, then
averaged (reference utils/misc.py:458-475).  MS-SSIM (cal_ms_ssim, JAX
eval/metrics.py:160-222, reference utils/ssim.py:153-225) runs the same
filters over 2 or 3 spatial axes on the chosen device.

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


def _filter_sep_nd(x: torch.Tensor, win: torch.Tensor, spatial_dims: int
                   ) -> torch.Tensor:
    """Separable valid-mode gaussian blur over the last `spatial_dims`
    axes (2 or 3; JAX metrics.py:71-80)."""
    x = _filter_sep2d(x, win)                    # along w, h
    if spatial_dims == 2:
        return x
    if spatial_dims != 3:
        raise NotImplementedError(spatial_dims)
    return _conv_last(x.movedim(-3, -1), win).movedim(-1, -3)   # along d


def _ssim_cs_maps(x: torch.Tensor, y: torch.Tensor, data_range: float,
                  win_size: int = 11, spatial_dims: int = 2):
    """Per-pixel (ssim_map, cs_map) of (n, c, *spatial) pairs, in the JAX
    package's float32-robust form (metrics.py:83-111): centred by the
    global mean before the variance filters, variances clamped at 0."""
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    win = _gauss_kernel1d(win_size, 1.5, x.device)
    filt = lambda z: _filter_sep_nd(z, win, spatial_dims)
    m = 0.5 * (x.mean() + y.mean())
    xc, yc = x - m, y - m
    mu1 = filt(x)
    mu2 = filt(y)
    mu1c, mu2c = mu1 - m, mu2 - m
    s1 = torch.clamp_min(filt(xc * xc) - mu1c * mu1c, 0.0)
    s2 = torch.clamp_min(filt(yc * yc) - mu2c * mu2c, 0.0)
    s12 = filt(xc * yc) - mu1c * mu2c
    cs = (2 * s12 + C2) / (s1 + s2 + C2)
    return ((2 * mu1 * mu2 + C1) / (mu1 * mu1 + mu2 * mu2 + C1)) * cs, cs


def _ssim_map(x: torch.Tensor, y: torch.Tensor, data_range: float,
              win_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM of (n, c, h, w) pairs."""
    return _ssim_cs_maps(x, y, data_range, win_size)[0]


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


MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _avg_pool2(x: torch.Tensor, spatial_dims: int) -> torch.Tensor:
    """2x mean pooling over the last `spatial_dims` axes, an odd extent
    zero-padded on both sides with the pads counted in the mean
    (reference utils/ssim.py:214-216, JAX metrics.py:163-177)."""
    pads = []
    for d in range(x.ndim - 1, x.ndim - 1 - spatial_dims, -1):
        pads += [x.shape[d] % 2] * 2
    x = F.pad(x, pads)
    for d in range(x.ndim - spatial_dims, x.ndim):
        n = x.shape[d] // 2
        x = x.narrow(d, 0, 2 * n).unflatten(d, (n, 2)).sum(d + 1)
    return x / float(2 ** spatial_dims)


def _ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float,
             win_size: int = 11, spatial_dims: int = 2) -> torch.Tensor:
    """MS-SSIM of (n, c, *spatial) pairs (reference utils/ssim.py:153-225,
    JAX metrics.py:180-199): 5 levels, per-level relu'd cs means, the
    relu'd last-level ssim mean, their weighted geometric mean; the
    scalar batch and channel mean."""
    levels = len(MS_SSIM_WEIGHTS)
    axes = tuple(range(2, 2 + spatial_dims))
    mcs = []
    ssim_pc = None
    for i in range(levels):
        ssim_map, cs_map = _ssim_cs_maps(x, y, data_range, win_size,
                                         spatial_dims)
        ssim_pc = ssim_map.mean(dim=axes)
        if i < levels - 1:
            mcs.append(torch.clamp_min(cs_map.mean(dim=axes), 0.0))
            x = _avg_pool2(x, spatial_dims)
            y = _avg_pool2(y, spatial_dims)
    stack = torch.stack(mcs + [torch.clamp_min(ssim_pc, 0.0)])
    w = torch.tensor(MS_SSIM_WEIGHTS, dtype=stack.dtype,
                     device=stack.device).reshape(-1, 1, 1)
    return torch.prod(stack ** w, dim=0).mean()


@torch.no_grad()
def cal_ms_ssim(origin: np.ndarray, decompressed: np.ndarray,
                data_range: float, win_size: int = 11, device=None) -> float:
    """MS-SSIM; (h, w, c) images filter and pool over 2 axes, (d, h, w, c)
    volumes over 3 (the reference's 4-d / 5-d branches,
    utils/ssim.py:181-185).  Needs min(h, w) > (win_size - 1) * 16 for
    the 4 downsamplings (utils/ssim.py:195-197).  device: where the
    filters run (None: the CUDA card); TF32 off, as in cal_ssim."""
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    a = np.asarray(origin, np.float32) / data_range
    b = np.asarray(decompressed, np.float32) / data_range
    if min(a.shape[-3:-1] if a.ndim == 4 else a.shape[:2]) <= \
            (win_size - 1) * 16:
        raise ValueError(
            f"Image side must exceed {(win_size - 1) * 16} for ms-ssim")
    if a.ndim not in (3, 4):
        raise NotImplementedError(a.shape)
    # (h, w, c) -> (1, c, h, w); (d, h, w, c) -> (1, c, d, h, w)
    perm = (2, 0, 1) if a.ndim == 3 else (3, 0, 1, 2)
    x = torch.from_numpy(a.transpose(perm)[None].copy()).to(device)
    y = torch.from_numpy(b.transpose(perm)[None].copy()).to(device)
    return float(_ms_ssim(x, y, 1.0, win_size, a.ndim - 1))


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
