"""Optimisers and LR schedules, written to optax's update rules.

Torch port of brief_pytorch_tpu/train/optim.py (reference utils/misc.py:
174-197: Adam / Adamax / SGD; MultiStepLR / StepLR / CyclicLR / none).
`torch.optim` is not used: its Adamax adds eps inside the max and its
schedules step differently.  These follow optax 0.2:

  * Adamax: mu = (1-b1) g + b1 mu;  nu = max(|g| + eps, b2 nu);
    update = -lr * (mu / (1 - b1^t)) / nu  with t the incremented count
    and 1 - b^t rounded in float32;
  * Adam:   mu as above, nu = (1-b2) g^2 + b2 nu;
    update = -lr * mu_hat / (sqrt(nu_hat) + eps);
  * SGD:    update = -lr * g;
  * the learning rate is the schedule at the count read BEFORE it is
    incremented (optax.scale_by_schedule), so step 0 uses schedule(0);
    MultiStepLR is optax.piecewise_constant_schedule (lr * gamma per
    milestone m with count >= m).

Parameters and moments are updated in place, one step per training
iteration, like the reference's scheduler.step() (main.py:400).  Scalars
(the count, the learning rate, the bias correction) live on the host, so
a step never waits for the device.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.tree import tree_leaves, tree_pairs


def make_schedule(base_lr: float, sched_cfg: Dict | None) -> Callable:
    """step count -> learning rate (a Python float)."""
    if not sched_cfg or sched_cfg.get("name", "none") == "none":
        return lambda step: base_lr
    name = sched_cfg["name"]
    if name == "MultiStepLR":
        milestones = sorted(int(m) for m in sched_cfg.get("milestones", []))
        gamma = float(sched_cfg.get("gamma", 0.1))

        def multistep(step):
            v = base_lr
            for m in milestones:
                if step >= m:
                    v *= gamma
            return v
        return multistep
    if name == "StepLR":
        step_size = int(sched_cfg["step_size"])
        gamma = float(sched_cfg.get("gamma", 0.1))
        return lambda step: base_lr * gamma ** (step // step_size)
    if name == "CyclicLR":
        base = float(sched_cfg.get("base_lr", base_lr))
        max_lr = float(sched_cfg.get("max_lr", base_lr * 10))
        up = int(sched_cfg.get("step_size_up", 2000))
        down = int(sched_cfg.get("step_size_down", up))

        def cyclic(step):
            pos = step % (up + down)
            frac = pos / up if pos < up else 1.0 - (pos - up) / down
            return base + (max_lr - base) * frac
        return cyclic
    raise NotImplementedError(name)


class Optimizer:
    """Adam, Adamax or SGD with a schedule, updating params in place.

    params: any tree of dicts and lists of tensors (core/tree.py).
    state: {"count": int, "mu": [tensor], "nu": [tensor]} — the moments
    in the order of the params' leaves (tree_leaves: a chain's layers one
    by one, w then b)."""

    def __init__(self, name: str, lr: float, sched_cfg: Dict | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if name not in ("Adam", "Adamax", "SGD"):
            raise NotImplementedError(name)
        self.name = name
        self.schedule = make_schedule(float(lr), sched_cfg)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict) -> Dict:
        leaves = tree_leaves(params)
        if self.name == "SGD":
            return {"count": 0, "mu": [], "nu": []}
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def step(self, params: Dict, grads: Dict, state: Dict) -> None:
        """One update of params (in place) from grads, a tree with the
        params' keys."""
        lr = self.schedule(state["count"])
        state["count"] += 1
        t = state["count"]
        b1, b2, eps = self.b1, self.b2, self.eps
        # bias corrections 1 - b**t rounded in float32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        for i, (p, g) in enumerate(tree_pairs(params, grads)):
            if self.name == "SGD":
                p.add_(-lr * g)
                continue
            mu = state["mu"][i]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu = state["nu"][i]
            if self.name == "Adamax":
                torch.maximum(g.abs() + eps, b2 * nu, out=nu)
                upd = (mu / bc1) / nu
            else:
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            p.add_(-lr * upd)


def make_optimizer(name: str, lr: float, sched_cfg: Dict | None = None
                   ) -> Optimizer:
    return Optimizer(name, lr, sched_cfg)
