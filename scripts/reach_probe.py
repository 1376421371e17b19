#!/usr/bin/env python3
"""Two measurements behind chip_smoke.py phase 20's choices, on the card.

    python3 scripts/reach_probe.py        # from the repository root

1. Autograd's peak device memory for one step of SIREN 3-20971-1 through
   model.apply at 100,000 and 50,000 coordinates (or OOM).
2. A fleet of 4 chains of 20 layers (true widths 24, 28, 30, 32) with
   alternating relu / sigmoid activations, datasmoothl1, unit masks and
   per-block thresholds, N = 100,000: the kernel's and the float32 plain
   version's weight gradients of the last three layers against the plain
   version evaluated in float64.
Prints PROBE lines.
"""
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from brief_pytorch_tpu_torch.models.phi import init_phi
from brief_pytorch_tpu_torch.ops import fused_train
from brief_pytorch_tpu_torch.parallel.block_trainer import build_stacked
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
for n in (100_000, 50_000):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_phi({"name": "SIREN", "coords_channel": 3, "data_channel": 1,
                      "features": 20971, "layers": 2, "w0": 20})
    params = model.init(torch.Generator().manual_seed(0), dev)
    x = torch.rand(n, 3, device=dev) * 2 - 1
    y = torch.rand(n, 1, device=dev)
    leaves = [t.requires_grad_(True) for l in params["layers"] for t in l.values()]
    try:
        loss = ((model.apply(params, x) - y) ** 2).mean()
        g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        print(f"PROBE autograd 3-20971-1 n={n}: ok, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    except torch.cuda.OutOfMemoryError as e:
        print(f"PROBE autograd 3-20971-1 n={n}: OOM ({str(e)[:120]})", flush=True)
    del params, leaves, x, y
    loss = g = None
torch.cuda.empty_cache()
# the 20-layer relu/sigmoid fleet: kernel and plain float32 against float64
models = [init_phi({"name": "SIREN", "coords_channel": 3, "data_channel": 1,
                    "features": f, "layers": 20, "w0": 20}) for f in (24, 28, 30, 32)]
_, params, masks = build_stacked(models, 0, device=dev)
L = params["layers"]
rng = np.random.default_rng(0)
n = 100_000
t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
c, v, w = t(rng.uniform(-1, 1, (4, 3, n))), t(rng.uniform(0, 100, (4, 1, n))), t(rng.uniform(1, 2, (4, 1, n)))
thr = torch.tensor([60.0, -np.inf, 40.0, -np.inf], device=dev)
um = list(masks[:-1]) + [None]
acts = tuple((("relu", 1.0), ("sigmoid", 1.0))[l % 2] for l in range(19)) + (("none", 1.0),)
kw = dict(loss_name="datasmoothl1", beta=0.01)
lk, gk = fused_train.fused_train_grads_fleet(L, c, v, w, acts, unit_masks=um, thres=thr, **kw)
lp, gp = fused_train.fused_train_grads_reference(L, c, v, w, acts, weight_thres=thr, unit_masks=um, **kw)
d = lambda x: x.double()
L64 = [{k: d(x) for k, x in l.items()} for l in L]
um64 = [None if m is None else d(m) for m in um]
l64, g64 = fused_train.fused_train_grads_reference(L64, d(c), d(v), d(w), acts, weight_thres=d(thr), unit_masks=um64, **kw)
for l in (17, 18, 19):
    a, b, r = gk["layers"][l]["w"].double(), gp["layers"][l]["w"].double(), g64["layers"][l]["w"]
    print(f"PROBE relu fleet w{l}: kernel-plain {float((a - b).abs().max()):.3e} "
          f"kernel-f64 {float((a - r).abs().max()):.3e} plain-f64 {float((b - r).abs().max()):.3e} "
          f"max|f64| {float(r.abs().max()):.3e}", flush=True)
