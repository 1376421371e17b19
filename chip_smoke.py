#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (brief_pytorch_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases, each printing one line, each failure ending the run with a
non-zero exit:
  1. the card's name and power limit (nvidia-smi) and torch's version;
     build every CUDA kernel from ops/csrc (one nvcc per source, at once);
  2. fast_sincos on the card against its plain version over |x| <= 200;
  3. the fused train-step kernel against its plain version at the default
     run's full width (SIREN 5 x 22, w0 = 20, N = 262,144), timed with CUDA
     events beside its plain version and its bound;
  4. the grid-decode kernel the same way on the 64^3 and 256^3 grids;
  5. the SingleTask command (cli.main, opt/SingleTask/default.yaml) on the
     bundled 64^3 fixture for COMPRESS_STEPS steps with one checkpoint:
     both kernels' launch counters above 0, PSNR above PSNR_FLOOR, the
     weight binaries written, and the standalone decompress of the
     artifacts equal to the checkpoint's decode.
Then one JSON line of the kernels, the card's name and power limit, and
the last line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import csv
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "dataset", "brain", "64x64x64",
                       "brain-64_128-64_128-192_256.tif")
CONFIG = os.path.join(ROOT, "opt", "SingleTask", "default.yaml")
COMPRESS_STEPS = 3000
PSNR_FLOOR = 40.0          # dB; 42.016 measured on an H100 (PERF.md)
N_COORDS = 64 ** 3         # randomcube over the whole 64^3 fixture
H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
SINCOS_FLOPS = 25            # fast_sincos incl. the w0 multiplies
SIN_FLOPS = 16               # fast_sin incl. the w0 multiply


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn()'s device work, after
    `warmup` calls.

    Each rep first queues a ~5 ms spin on the card, so the host has queued
    all of fn()'s kernels before the start event fires: the time is the
    device time of the wrapper's kernels, not the host's launch latency."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def chain_macs(widths) -> int:
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL torch.cuda.is_available() is false", flush=True)
        return 2
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.ops import build, fused_decode, fused_train
    from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs
    from brief_pytorch_tpu_torch.ops.fast_math import (fast_sincos,
                                                       fast_sincos_device)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. card, build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    say("1-build", card=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=f"{build_s:.1f}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                say("1-ptxas", source=name, info=repr(line.strip()))

    # ---- 2. fast_sincos ----
    x = torch.linspace(-200.0, 200.0, 1 << 22, device=dev)
    s_dev, c_dev = fast_sincos_device(x)
    s_ref, c_ref = fast_sincos(x)
    err = max(float((s_dev - s_ref).abs().max()),
              float((c_dev - c_ref).abs().max()))
    x64 = x.double()
    err_true = max(float((s_dev.double() - torch.sin(x64)).abs().max()),
                   float((c_dev.double() - torch.cos(x64)).abs().max()))
    say("2-fast_sincos", max_abs_err_vs_plain=f"{err:.3e}",
        max_abs_err_vs_float64=f"{err_true:.3e}")
    if err > 4e-6 or err_true > 1e-5:
        fail("fast_sincos on the card disagrees (tolerance 4e-6 vs the "
             "plain version, 1e-5 vs float64 sin/cos)")

    # ---- 3. kernel 1: fused train step at the default run's width ----
    cfg = cfglib.load(CONFIG).CompressFramework
    phi = dict(cfg.Module.phi)
    phi["features"] = 22
    model = init_phi(phi)
    params = model.init(torch.Generator().manual_seed(0), dev)
    acts = chain_layer_specs(model.spec)
    layers = params["layers"]
    widths = [3] + [int(l["w"].shape[1]) for l in layers]
    rng = np.random.default_rng(0)
    n = N_COORDS
    coords = torch.from_numpy(
        rng.uniform(-1, 1, (3, n)).astype(np.float32)).to(dev)
    values = torch.from_numpy(
        rng.uniform(0, 100, (1, n)).astype(np.float32)).to(dev)
    weights = torch.from_numpy(
        rng.uniform(1, 2, (1, n)).astype(np.float32)).to(dev)
    kw = dict(loss_name="datal2", beta=0.01, weight_thres=0.05)

    def k1():
        return fused_train.fused_train_grads(layers, coords, values, weights,
                                             acts, **kw)

    def p1():
        return fused_train.fused_train_grads_reference(
            layers, coords, values, weights, acts, **kw)

    loss_k, g_k = k1()
    loss_p, g_p = p1()
    torch.cuda.synchronize()
    err1 = abs(float(loss_k) - float(loss_p))
    if err1 > 1e-5 * abs(float(loss_p)):
        fail(f"fused_train loss {float(loss_k)} vs plain {float(loss_p)}")
    for l, (a, b) in enumerate(zip(g_k["layers"], g_p["layers"])):
        for key in ("w", "b"):
            d = float((a[key] - b[key]).abs().max())
            scale = float(b[key].abs().max())
            err1 = max(err1, d)
            if not d <= 1e-4 * scale + 1e-6:
                fail(f"fused_train grad {key}{l}: max abs err {d} "
                     f"(max |plain| {scale})")
    ms1 = time_ms(k1)
    plain1 = time_ms(p1)
    macs = chain_macs(widths)
    sine_units = sum(w for w, (a, _) in zip(widths[1:], acts) if a == "sine")
    flops1 = n * (2 * macs            # forward
                  + 2 * macs          # weight gradients
                  + 2 * (macs - widths[0] * widths[1])   # input gradients
                  + SINCOS_FLOPS * sine_units)
    bytes1 = 4 * (n * (3 + 1 + 1) + 2 * (sum(l["w"].numel() + l["b"].numel()
                                             for l in layers) + 1))
    b1, by1 = bound_ms(bytes1, flops1)
    say("3-fused_train", n=n, widths=widths, max_abs_err=f"{err1:.3e}",
        ms=f"{ms1:.4f}", plain_ms=f"{plain1:.4f}", bound_ms=f"{b1:.4f}",
        bound_by=by1, tolerance="loss rel 1e-5; grads 1e-4*max|plain|+1e-6")

    # ---- 4. kernel 2: grid decode, 64^3 (main path) and 256^3 ----
    dec_rows = {}
    for side in (64, 256):
        spatial = (side, side, side)

        def k2():
            return fused_decode.fused_decode_grid(layers, spatial, acts,
                                                  "-1,1")

        def p2():
            return fused_decode.fused_decode_grid_reference(
                layers, spatial, acts, "-1,1")

        out_k, out_p = k2(), p2()
        torch.cuda.synchronize()
        if out_k.shape != (side ** 3, 1) or not torch.isfinite(out_k).all():
            fail(f"fused_decode {spatial}: shape {tuple(out_k.shape)} or "
                 "non-finite values")
        err2 = float((out_k - out_p).abs().max())
        scale = float(out_p.abs().max())
        if not err2 <= 1e-5 * scale + 1e-5:
            fail(f"fused_decode {spatial}: max abs err {err2} "
                 f"(max |plain| {scale})")
        del out_k, out_p
        ms2 = time_ms(k2)
        plain2 = time_ms(p2, reps=20)
        pop = side ** 3
        flops2 = pop * (2 * macs + SIN_FLOPS * sine_units)
        bytes2 = 4 * (pop * widths[-1] + sum(side for _ in spatial[1:])
                      + sum(l["w"].numel() + l["b"].numel() for l in layers))
        b2, by2 = bound_ms(bytes2, flops2)
        dec_rows[side] = dict(max_abs_err=err2, ms=ms2, plain_ms=plain2,
                              bound_ms=b2, bound_by=by2)
        say("4-fused_decode", grid=f"{side}^3", max_abs_err=f"{err2:.3e}",
            ms=f"{ms2:.4f}", plain_ms=f"{plain2:.4f}", bound_ms=f"{b2:.4f}",
            bound_by=by2, mvox_per_s=f"{pop / ms2 / 1e3:.1f}",
            tolerance="1e-5*max|plain|+1e-5")

    # ---- 5. the SingleTask command on the 64^3 fixture ----
    from brief_pytorch_tpu_torch.cli import main as cli
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.train.fit import NFGR

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        opt = cfglib.load(CONFIG)
        opt.Dataset.data_path = FIXTURE
        opt.Log.outputs_dir = out_dir
        opt.Log.tensorboard = False
        opt.Log.time = False
        c = opt.CompressFramework
        c.Compress.max_steps = COMPRESS_STEPS
        c.Compress.checkpoints = "none"
        c.Decompress.mip = False
        yaml_path = os.path.join(out_dir, "smoke.yaml")
        cfglib.save(opt, yaml_path)

        fused_train.launches = 0
        fused_decode.launches = 0
        t0 = time.perf_counter()
        summary = cli.main(["-p", yaml_path, "-g", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_train": fused_train.launches,
                    "fused_decode": fused_decode.launches}
        if launches["fused_train"] != COMPRESS_STEPS or \
                launches["fused_decode"] < 1:
            fail(f"the main path missed a kernel: launches {launches}")
        run_dir = os.path.join(out_dir, opt.Log.project_name)
        with open(os.path.join(run_dir, "performance.csv")) as f:
            rows = list(csv.DictReader(f))
        psnr = float(rows[-1]["psnr"])
        ssim = float(rows[-1]["ssim"])
        if not math.isfinite(psnr) or psnr < PSNR_FLOOR:
            fail(f"PSNR {psnr} below the floor {PSNR_FLOOR}")
        comp = os.path.join(run_dir, f"steps{COMPRESS_STEPS}", "compressed")
        module = os.path.join(comp, "module")
        if not any(f.startswith("weight-") for f in os.listdir(module)):
            fail("no weight-* binaries written")
        dec = NFGR.decompress(c, module, os.path.join(comp, "sideinfos.yaml"),
                              device=dev)
        ck = read_img(os.path.join(
            run_dir, f"steps{COMPRESS_STEPS}", "decompressed",
            os.path.basename(FIXTURE).replace(".tif", "_decompressed.tif")))
        if dec.shape != (64, 64, 64, 1) or dec.dtype != np.uint16 or \
                not np.array_equal(dec, ck):
            fail("standalone decompress differs from the checkpoint decode")
        train_s = summary["train_s"]
        say("5-compress", steps=COMPRESS_STEPS, launches=json.dumps(launches),
            psnr=f"{psnr:.3f}", ssim=f"{ssim:.4f}", psnr_floor=PSNR_FLOOR,
            train_s=f"{train_s:.3f}",
            steps_per_s=f"{COMPRESS_STEPS / train_s:.1f}",
            coords_per_s=f"{COMPRESS_STEPS * N_COORDS / train_s:.4g}",
            checkpoint_s=f"{summary['checkpoint_s']:.3f}",
            wall_s=f"{wall:.3f}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    kernels = [
        {"name": "fused_train_grads", "route": "cuda",
         "source": "brief_pytorch_tpu_torch/ops/csrc/fused_train.cu",
         "replaces": "brief_pytorch_tpu/ops/pallas_train.py:281",
         "launches": launches["fused_train"], "max_abs_err": err1,
         "ms": ms1, "plain_ms": plain1, "bound_ms": b1, "bound_by": by1,
         "library_ms": None, "shape": f"SIREN {widths}, N={n}"},
        {"name": "fused_decode_grid", "route": "cuda",
         "source": "brief_pytorch_tpu_torch/ops/csrc/fused_decode.cu",
         "replaces": "brief_pytorch_tpu/ops/pallas_decode.py:172",
         "launches": launches["fused_decode"],
         "max_abs_err": dec_rows[64]["max_abs_err"], "ms": dec_rows[64]["ms"],
         "plain_ms": dec_rows[64]["plain_ms"],
         "bound_ms": dec_rows[64]["bound_ms"],
         "bound_by": dec_rows[64]["bound_by"], "library_ms": None,
         "shape": f"SIREN {widths}, 64^3 grid",
         "at_256": dec_rows[256]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
