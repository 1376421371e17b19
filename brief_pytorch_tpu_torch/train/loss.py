"""Training losses: weighted MSE / weighted smooth-L1.

Torch port of brief_pytorch_tpu/train/loss.py (reference main.py:171-197:
datal2 / datasmoothl1, per-voxel weight, weight_thres override where
predictions at or below the threshold get weight 1).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _apply_weight(loss, data_hat, weight, weight_thres: Optional[float]):
    if weight_thres:
        weight = torch.where(data_hat <= weight_thres, 1.0, weight)
    return (loss * weight).mean()


def datal2(data_gt, data_hat, weight, weight_thres=None):
    loss = (data_hat - data_gt) ** 2
    return _apply_weight(loss, data_hat, weight, weight_thres)


def datasmoothl1(data_gt, data_hat, weight, weight_thres=None, beta=0.01):
    d = (data_hat - data_gt).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return _apply_weight(loss, data_hat, weight, weight_thres)


def make_loss(name: str, beta: float = 0.01) -> Callable:
    if name == "datal2":
        return datal2
    if name == "datasmoothl1":
        return lambda gt, hat, w, thres=None: datasmoothl1(gt, hat, w, thres,
                                                           beta)
    raise NotImplementedError(name)
