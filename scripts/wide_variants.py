#!/usr/bin/env python3
"""Where kernel 1's wide layout spends its time: variants of the package
(copies under outputs/wide_variants/<name>/, each with its own build/)
built side by side, then one train call of each at the given chains,
every kernel launch of the call with its device time (torch.profiler).

    python3 scripts/wide_variants.py base,noload,nobar,noepi,w8 \
        3-191x4-1:100000 3-64x23-1:100000

Variants (text replacements in ops/csrc/fused_train.cu, csrc/wide.cuh,
ops/wide.py):
  base    the code as it is;
  noload  the products' W slabs never copied (the ring holds stale
          values: results wrong, time without the slabs' traffic);
  nobar   noload and no barrier between slabs (the product loop alone);
  noepi   the activations in the tile kernel's epilogues replaced by the
          identity (no sines);
  w8      blocks of 8 warps instead of 16 (each warp 2 x 4 mma tiles at
          128 coordinates a tile);
  t64     tiles of at most 64 coordinates (deeper slabs, half the W
          reuse);
  k4      slabs of 4 k-blocks at 128 coordinates a tile too (where the
          larger ring fits: chains narrower than 3-191x4-1).
Each replacement must match the package's source, or the script stops.
A shape is c_in-f x hidden-c_out:N (SIREN, w0 = 20, datal2 with
weight_thres 0.05, as scripts/time_fused_train.py).  Prints per variant
and shape the call's CUDA-event time (chip_smoke.time_ms) and each
launch's device microseconds, then the card's name and power limit.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FT = "csrc/fused_train.cu"
VARIANTS = {
    "base": [],
    "noload": [(FT, "      wl::cp16(dst + 4 * c, from + 4 * c);",
                "      (void)dst; (void)from; (void)c;")],
    "nobar": [(FT, "      wl::cp16(dst + 4 * c, from + 4 * c);",
               "      (void)dst; (void)from; (void)c;"),
              (FT, "    wl::cp_wait<wl::kStages - 2>();\n"
                   "    __syncthreads();   // slab s is in; slab s - 1's "
                   "stage is free\n", "")],
    "noepi": [(FT, "brief::act_fwd(kAct, ly.w0, z, &h, &dv);",
               "h = z; dv = 1.f;"),
              (FT, "brief::act_fwd(kAct, in.w0, zv[i][j][e], &h, &dv);",
               "h = zv[i][j][e]; dv = 1.f;"),
              (FT, "  if (kAct == brief::kActSine) return brief::fast_sin("
                   "w0 * z);", "  return z;")],
    "w8": [("csrc/wide.cuh", "constexpr int kThreads = 512;",
            "constexpr int kThreads = 256;"),
           ("wide.py", "THREADS = 512 ", "THREADS = 256 ")],
    "t64": [("wide.py", "TILES = (128, 64) ", "TILES = (64,) ")],
    "k4": [(FT, "  static constexpr int kKS = kT == 128 ? 2 : 4;",
            "  static constexpr int kKS = 4;"),
           ("wide.py", "    return 2 if tile == 128 else 4", "    return 4")],
}

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from brief_pytorch_tpu_torch.models.phi import init_phi
from brief_pytorch_tpu_torch.ops import fused_train
from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs
from torch.profiler import ProfilerActivity, profile
dev = torch.device("cuda", 0)
kw = dict(loss_name="datal2", beta=0.01, weight_thres=0.05)
for shape in sys.argv[2:]:
    c_in, f, hidden, c_out, n = map(int, __import__("re").fullmatch(
        r"(\d+)-(\d+)x(\d+)-(\d+):(\d+)", shape).groups())
    model = init_phi({"name": "SIREN", "coords_channel": c_in,
                      "data_channel": c_out, "features": f,
                      "layers": hidden + 1, "w0": 20})
    layers = model.init(torch.Generator().manual_seed(1), dev)["layers"]
    acts = chain_layer_specs(model.spec)
    rng = np.random.default_rng(0)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    c = to(rng.uniform(-1, 1, (c_in, n)))
    v = to(rng.uniform(0, 100, (c_out, n)))
    w = to(rng.uniform(1, 2, (c_out, n)))
    k = lambda: fused_train.fused_train_grads(layers, c, v, w, acts, **kw)
    ms = cs.time_ms(k)
    k()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        k()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if getattr(e.device_type, "name", "") == "CUDA"),
                 key=lambda e: e.time_range.start)
    print(json.dumps({"variant": sys.argv[1], "shape": shape, "ms": ms,
                      "launches_us": [
                          [e.name.split("(")[0].split("::")[-1],
                           round(e.time_range.elapsed_us(), 1)]
                          for e in evs]}), flush=True)
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit(__doc__)
    names, shapes = argv[0].split(","), argv[1:]
    out = os.path.join(ROOT, "outputs", "wide_variants")
    procs = []
    for name in names:
        dst = os.path.join(out, name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "brief_pytorch_tpu_torch"),
                        os.path.join(dst, "brief_pytorch_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
        for f, a, b in VARIANTS[name]:
            p = os.path.join(dst, "brief_pytorch_tpu_torch", "ops", f)
            s = open(p).read()
            if a not in s:
                raise SystemExit(f"variant {name}: {a!r} not in {f}")
            open(p, "w").write(s.replace(a, b))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
             "from brief_pytorch_tpu_torch.ops import build; "
             "build.build(['fused_train'])"], cwd=dst))
    if any(p.wait() for p in procs):
        raise SystemExit("a variant did not build")
    for name in names:
        subprocess.run([sys.executable, "-c", CHILD, name, *shapes],
                       cwd=os.path.join(out, name), check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
