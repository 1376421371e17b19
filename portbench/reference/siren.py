"""The plain SIREN chain the benchmark holds the program against: forward,
the weighted L2 loss, its gradients by autograd, and the Adamax step, in
plain torch at a precision the caller chooses: float64 for the reference,
float32 with TF32 products for the control.

Layer i computes z = h @ W_i + b_i; every layer but the last is followed
by sin(w0 z), with the configuration's w0 on the first layer and 30 on the
others (Sitzmann et al. 2020; the reference's Networks.py:235-314).  It
imports torch only.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

HIDDEN_W0 = 30.0


@contextlib.contextmanager
def full_float32():
    """Float32 products in full float32: the card's TF32 mode off."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero), as the tensor cores round a TF32 product's inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 and float32 sums, forward
    and backward alike: the control's arithmetic, on any device."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).T, tf32_round(a).T @ g


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError("the TF32 control runs on float32 tensors")
        return _TF32MatMul.apply(a, b)
    return a @ b


def forward(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
            x: torch.Tensor, w0: float, tf32: bool = False) -> torch.Tensor:
    """layers: [(W (in, out), b (out,))]; x: (N, in) -> (N, out); tf32:
    every product's operands rounded to TF32 (the control)."""
    h = x
    last = len(layers) - 1
    for i, (w, b) in enumerate(layers):
        z = matmul(h, w, tf32) + b
        if i == last:
            return z
        h = torch.sin((w0 if i == 0 else HIDDEN_W0) * z)
    raise ValueError("no layers")


def loss_and_grads(layers, x: torch.Tensor, y: torch.Tensor,
                   wt: torch.Tensor, w0: float,
                   thres: Optional[float] = None, tf32: bool = False
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The weighted mean squared error of one batch and its gradient for
    each leaf, in the order W_0, b_0, W_1, ...  Where thres is set, a voxel
    predicted at or below it weighs 1."""
    leaves = [t.detach().clone().requires_grad_(True)
              for layer in layers for t in layer]
    pairs = list(zip(leaves[::2], leaves[1::2]))
    with full_float32():
        pred = forward(pairs, x, w0, tf32)
    if thres is not None:
        wt = torch.where(pred <= thres, torch.ones_like(wt), wt)
    loss = ((pred - y) ** 2 * wt).mean()
    with full_float32():
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), [g.detach() for g in grads]


class Adamax:
    """optax.adamax: mu = (1-b1) g + b1 mu; nu = max(|g| + eps, b2 nu);
    p -= lr (mu / (1 - b1^t)) / nu, lr from a MultiStepLR schedule."""

    def __init__(self, lr: float, milestones=(), gamma: float = 0.1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.milestones, self.gamma = lr, list(milestones), gamma
        self.b1, self.b2, self.eps = b1, b2, eps
        self.t = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        if not self.mu:
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        lr = self.lr * self.gamma ** sum(self.t >= m for m in self.milestones)
        self.t += 1
        bc = 1.0 - self.b1 ** self.t
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            torch.maximum(g.abs() + self.eps, self.b2 * nu, out=nu)
            p.sub_(lr * (mu / bc) / nu)
