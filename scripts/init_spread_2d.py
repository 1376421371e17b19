#!/usr/bin/env python3
"""How much a small 2-D SingleTask run's PSNR depends on its initial
weights, on the CPU: the port (brief_pytorch_tpu_torch) trains the
96 x 96 PNG of tests/test_torch_media.py (SIREN, coords_channel 2, 4,000
bytes) from its own initial weights and from the JAX package's, seed by
seed; the batch draws are the port's in both.

    JAX_PLATFORMS=cpu python3 scripts/init_spread_2d.py [--seeds 6] \\
        [--steps 200]

Prints one line a seed: PSNR from the port's init and from JAX's.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    import jax
    import torch
    from brief_pytorch_tpu.models import phi as jphi
    from brief_pytorch_tpu_torch.cli import main as tcli
    from brief_pytorch_tpu_torch.io import image as timage
    from brief_pytorch_tpu_torch.models import phi as tphi
    from test_torch_media import _pattern, _yaml
    torch.set_num_threads(1)
    own = tphi.SIREN.init
    seed = [0]

    def jax_init(self, gen, device=None):
        p = jphi.init_phi(dict(self.cfg)).init(jax.random.PRNGKey(seed[0]))
        return tphi.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, p), device)

    for seed[0] in range(args.seeds):
        row = []
        for name, init in (("port", own), ("jax", jax_init)):
            tphi.SIREN.init = init
            tmp = pathlib.Path(tempfile.mkdtemp())
            data = str(tmp / "m.png")
            timage.save_img(data, _pattern())
            path = _yaml(tmp, data, "torch", 2, 1, args.steps, 4000)
            text = open(path).read().replace("seed: 42", f"seed: {seed[0]}")
            open(path, "w").write(text)
            psnr = tcli.main(["-p", path, "-g", "cpu"])["psnr"]
            row.append(f"{name}_init_psnr={psnr:.3f}")
        tphi.SIREN.init = own
        print(f"seed={seed[0]} " + " ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
