#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (brief_pytorch_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases, each printing one line, each failure ending the run with a
non-zero exit:
  1. the card's name and power limit (nvidia-smi) and torch's version;
     build every CUDA kernel from ops/csrc (one nvcc per source, at once;
     the wide layout's products, csrc/wide.cuh, go into fused_train.cu,
     the 3xTF32 mma helpers, csrc/tf32.cuh, into fused_train.cu and,
     through the tensor-core chain csrc/chain_tc.cuh, into fused_decode.cu
     and fused_siren.cu);
  2. fast_sincos on the card against its plain version over |x| <= 200;
  3. the fused train-step kernel against its plain version at the default
     run's full width (SIREN 5 x 22, w0 = 20, N = 262,144; the narrow
     layout, products on the tensor cores in 3xTF32), timed with CUDA
     events beside its plain version, its float32 bound and its
     tensor-core bound (tc_bound_ms), naming the layout that ran; then the
     same for TRAIN_CASES, the chains the old narrow layout also took: a
     SIREN_Pyramid chain (narrow) and its edges 5 x 64 and 7 x 48 (tiled);
  4. the grid-decode kernel the same way (decode_check) on the 64^3 and
     256^3 grids (5 x 22) and the widest HiP-CT chunk of phase 7
     (3-66x6-1, SIREN w0 = 10, 64x256x256), all in its narrow form, and,
     in its wide form, on the 64x512x512 grid of the demo volumes at
     DEMO_RUNS' widths (5 x 191, 5 x 242), beside the plain version (in
     slabs of DECODE_SLAB voxels past 2^24), two more calls bitwise
     equal, and its distance from a float64 evaluation of the chain
     (float64_chain on the kernel's coordinates), max and mean, at most
     F64_RATIO x the plain version's; the kernels a call launches
     (the decode library's own count, fused_decode.kernels_launched: 1
     in the narrow form, which splits its weights in place, 2 in the
     wide form); both bounds (decode_bounds: float32 and
     tensor-core), the form, its tile and warps per SM printed; after
     phase 5 the same checks on phase 5's trained chain over the 64^3
     grid;
  5. the SingleTask command (cli.main, opt/SingleTask/default.yaml) on the
     bundled 64^3 fixture for COMPRESS_STEPS steps with one checkpoint:
     both kernels' launch counters above 0, PSNR above PSNR_FLOOR, the
     weight binaries written, and the standalone decompress of the
     artifacts equal to the checkpoint's decode;
  6. the train kernel's fleet form at the shapes phases 7 and 8 give it
     (fleet_check): 4 blocks padded to 3-66x6-1, true widths
     FLEET_WIDTHS through unit masks, SIREN w0 = 10, N = 100,000 per
     block (the tiled layout), and brain64's 8 blocks of 3-7x4-1, w0 = 20,
     N = 20,000 (the narrow layout, with its tc_bound_ms), and 4 blocks
     padded to 3-128x6-1,
     true widths WIDE_FLEET_WIDTHS, N = 100,003 (the wide layout, which
     takes any bucket padded past the tiled layout's reach), each with
     finite and -inf thresholds, against its plain version for both
     losses and a relu/sigmoid chain, each block against the one-chain
     kernel on its unpadded chain, padded gradients exactly 0, three runs
     bitwise equal;
     timed beside the plain version and the bound; the wide one-chain
     layout at phase 12's chains (3-191x4-1, 3-242x4-1, N = 100,000)
     checked against its plain version and timed the same way;
  7. the DivideTask command on opt/DivideTask/hipct.yaml, verbatim (the
     tracked demo volume dataset/example/hipct-0_64-0_512-0_512.tif, LZW;
     by_var must give phase 6's FLEET_WIDTHS), HIPCT_STEPS steps with one
     checkpoint and no MIPs: one kernel launch per step,
     the standalone decompress_divide launching the decode kernel once per
     chunk and within 1 LSB of the checkpoint's merged volume on >= 99.9%
     of voxels, PSNR above HIPCT_PSNR_FLOOR and within HIPCT_AUTOGRAD_DB
     of the same run through autograd (Compress.fused_train: false);
     then `python -m brief_pytorch_tpu_torch.post.deblock -stp` on its
     checkpoint: the deblocked TIFF of the merged volume's shape and
     dtype, changed only within 3 voxels of the blocks' boundaries;
  8. opt/DivideTask/brain64.yaml (8 blocks of 32^3, randompoint, on the
     fleet kernel at phase 6's shape) and opt/DivideTask/default.yaml
     (adaptive blocks, fullbatch buckets through autograd) on the bundled
     fixture for FIXTURE_STEPS steps each: artifacts written, PSNR finite;
  9. the batch-major fused forward kernel (ops/fused_siren.py: kernel 2's
     tensor-core chain, 3xTF32, with rows of an (N, C) input) against its
     plain version, timed beside it and both bounds, naming the form, at
     SIREN_CASES: the slab the batch-major decode gives it (5 x 22, N =
     10,112) and the SingleTask default's full width (N = 262,144), a
     HiP-CT block's chain (3-64x6-1, N = 100,003: a tail that is no
     multiple of any tile), the wide form (3-186x4-1; SIREN 3-1024x4-1 at
     N = 65,536 with its activations in a device scratch), a
     SIREN_Pyramid chain, SIREN_RELU and SIREN_SIGMOID, SIRENPos through
     make_fused_apply, two coordinates (coords_channel 2): forward within
     2e-6 + 2e-6 * max|plain| (SIREN_TOL: 1e-5 * max|plain| + 1e-5 for
     3-1024x4-1, kernel 2's phase-4 tolerance), gradients of
     (out^2).mean() for every w, b and for coords within 1e-6 of autograd
     through model.apply, two runs bitwise equal, and the distance from a
     float64 evaluation of the chain (float64_chain), max and mean, at
     most 2x the plain version's (F64_RATIO: float32's accuracy);
 10. the batch-major route at full width on phase 5's archive:
     reconstruct_flattened(apply_fn=fused_apply_or(model, model.apply))
     over the 64^3 grid in slabs of the yaml's Decompress.sample_size:
     exactly ceil(262,144 / slab) launches of the forward kernel and none
     of the grid kernel; its distance from the same route through a
     float64 evaluation of the chain, max and mean, at most 1.5x that of
     the route through model.apply (F64_RATIO; normalized values reach
     100), and after inverse normalization within 1 LSB of the default
     (grid-kernel) decode on >= 99.9% of voxels; both routes timed;
 11. every other φ family through the SingleTask command on the fixture
     (FAMILIES, FAMILY_STEPS steps, one checkpoint): the five plain-chain
     families on both kernels (one train launch per step), res-SIREN,
     NeRF, FFN and the MFNs on neither (autograd, slab decode); artifacts
     of the right kind, parameter count within 5% of the 80x budget, the
     standalone decompress equal to the checkpoint's decode, PSNR above
     its floor; then opt/DivideTask/brain64.yaml with MFNFourier (the
     fleet's solo path) and with NeRF (a stacked skip/encoder bucket),
     decompress_divide within 1 LSB of the merged checkpoint;
 12. this slice's path: the SingleTask command (opt/SingleTask/default.yaml
     verbatim but for the data, the tracked HiP-CT demo volume, and the
     cuts below) at each of DEMO_RUNS: 80x (SIREN 5 x 191) for 500 steps
     and 50x (5 x 242) for 200, one checkpoint, no MIPs; the sampler
     randompoint at 100,000 (cube_size_guard), one launch of the train
     kernel's wide layout per step, the decode kernel's wide form in the
     checkpoint and in the standalone NFGR.decompress, whose volume equals
     the checkpoint's; PSNR within DEMO_AUTOGRAD_DB of the same steps
     through autograd (Compress.fused_train: false);
 13. resume at full width, through the command (resume_run): the
     SingleTask default on the 64^3 fixture (5 x 22, kernel 1's narrow
     layout) over RESUME_STEPS["single"] steps and hipct.yaml verbatim on
     its demo volume (the 3-66x6-1 bucket, the tiled fleet layout) over
     RESUME_STEPS["hipct"], checkpoints at half and at the end: a run
     preempted right after its state at half, resumed with -resume, ends
     with weight binaries equal byte for byte to the uninterrupted run's,
     launching the train kernel for the second half only; a state of
     another lr_phi raises;
 14. MultiTask (multitask_run): opt/MultiTask/default.yaml (the SingleTask
     SIREN 5 x 22 on kernels 1 and 2, total_2_2_2 with 8 blocks on kernel
     1's narrow fleet form; 2,000 steps each) with only the outputs dir
     and the data path changed, through the MultiTask command: both
     experiments finish, finite PSNRs, one train launch a step,
     temp_opt_* removed;
 15. media at full width (media_files: a 2048^2 uint16 PNG, the 4 x 4
     mosaic of HiP-CT planes 0, 4, ..., 60; 64 frames of 512^2 x 3 uint8
     BGR video from the HiP-CT and vessel planes, MP4, read back through
     read_img), opt/SingleTask/default.yaml at 80x of the raw pixels
     (given_size; the files are compressed): kernel 1 and kernel 2
     against their plain versions at the widths the configs give (2
     coordinates; c_out = 3 in both wide forms), then the SingleTask
     command on each (media_run: one train launch a step, the decode
     kernel in the checkpoint and the standalone decompress, which equals
     the checkpoint's image, PSNR within DEMO_AUTOGRAD_DB of autograd's,
     cal_ms_ssim on the card within 2e-4 of the CPU's) and the PNG with
     total_1_2_2 (media_divide_run: 4 blocks of 1024^2 on the fleet form,
     which fleet_check holds against its plain version at C = 2; the
     h_*-w_* chunks; decompress_divide within 1 LSB on >= 99.9%);
 16. `half` (half_run): the SingleTask default on the 64^3 fixture for
     HALF_STEPS steps, no kernel launched, the 2-byte sizing's width,
     PSNR within HALF_DB of float32 autograd on the same network; then
     brain64.yaml: finite PSNR, decompress_divide within 1 LSB;
 17. hipct.yaml (EXCEPTION_STEPS, HIPCT_STEPS steps): the one-chain
     kernel at the solo block's chain, then a step-level exception for
     the block by_var gives 66 features (exception_run: the block on the
     one-chain kernel at its proportional steps, the other three on the
     fleet kernel, decompress_divide within 1 LSB, resume_run bitwise),
     and raw_gather / vector_len 8 (gather_run: PSNR within
     HIPCT_AUTOGRAD_DB of phase 7's, steps/s and resident bytes beside
     phase 7's);
 18. NFLR (brief_pytorch_tpu_torch.nflr, no kernel of its own: torch ops,
     F.conv3d with TF32 off) at the RD script's widths on the 64^3
     fixture (SIREN 5 x 48, y_channel 24, ps 8, ol 2: 1,331 patches,
     681,472 coordinates a step, Lambda 8000), through nflr.rd's
     train_on_volume / rd_point and the framework's train():
     18a NFLR_Coding_Hyper_AutoDecoder for NFLR_STEPS["train"] steps and
     NFLR_STEPS["sga"] SGA steps: steps/s, wall / CUDA-event / kernel ms
     a step, the device's idle share, the loss at the first and the last
     step (it must fall), file bytes, bits per voxel, PSNR on the uint16
     range (above NFLR_PSNR_FLOOR) and SSIM; the decode from memory equal
     to the decode from the file;
     18b the other five frameworks for NFLR_SHORT steps each: the decode
     from memory equal to the file's, a finite PSNR; the card's archive
     decoded by a CPU framework on the same weights: for
     NFLR_Coding_AutoDecoder (factorized tables, built on the host) the
     same latents exactly and the volume within 1 LSB on >= 99.9% of
     voxels; for the hyperprior variants whether the latents are the
     same, reported;
     18c the Hyper auto-decoder through train(): NFLR_RESUME_STEPS steps
     with a state every half, preempted right after the state at half
     and resumed, equal byte for byte to the uninterrupted run (the
     trained module, every trainstate.npz leaf);
     18d the rANS backend (native/rans.cpp built into build/) and the
     pure-Python codec give the same bytes, and 18a's streams back, on
     18a's symbols; the backend is printed.
     No kernel of kernels 1-3 is launched in phase 18.
Then one JSON line of the kernels, the card's name and power limit, and
the last line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import atexit
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
MULTITASK = os.path.join(ROOT, "opt", "MultiTask", "default.yaml")
DIVIDE = os.path.join(ROOT, "opt", "DivideTask")
COMPRESS_STEPS = 3000
PSNR_FLOOR = 40.0          # dB; 41.985 measured on an H100 (PERF.md)
N_COORDS = 64 ** 3         # randomcube over the whole 64^3 fixture
HIPCT = os.path.join(ROOT, "dataset", "example",
                     "hipct-0_64-0_512-0_512.tif")   # LZW, tracked
VESSEL = os.path.join(ROOT, "dataset", "example",
                      "vessel-0_64-0_512-0_512.tif")
HIPCT_STEPS = 500          # cut from the config's 80,000
# phase 13: steps of each resumed run (preempted at half), cut from the
# configs' 20,000 and 80,000
RESUME_STEPS = {"single": 2000, "hipct": 500}
HIPCT_PSNR_FLOOR = 24.0    # dB; 25.181 on the first H100 run (PERF.md)
HIPCT_AUTOGRAD_DB = 0.5    # dB; the kernel run's PSNR against autograd's
FIXTURE_STEPS = 300        # cut from the configs' 20,000
FLEET_WIDTHS = (51, 54, 60, 66)   # phase 7's true widths (padded to 66)
FLEET_N = 100_000          # the hipct config's sample_size
BRAIN64_WIDTHS = (7,) * 8  # brain64.yaml's 8 blocks (by_size at 80x)
BRAIN64_N = 20_000         # brain64.yaml's sample_size
WIDE_FLEET_WIDTHS = (98, 106, 117, 128)   # a bucket past the tiled layout
WIDE_FLEET_N = 100_003     # the hipct sample_size, with a ragged tail
# phase 12: (filesize_ratio, steps, SIREN width default.yaml gives the
# demo volume at that ratio); cube_size_guard makes the step randompoint
DEMO_RUNS = [(80, 500, 191), (50, 200, 242)]
DEMO_N = 100_000           # default.yaml's sample_size
DEMO_AUTOGRAD_DB = 0.5     # dB; the kernel run's PSNR against autograd's
DECODE_SLAB = 1 << 20      # voxels per slab of the plain decode (phase 4)
# phase 15: steps of the PNG and MP4 SingleTask runs and the 2-D fleet
MEDIA_STEPS = {"png": 500, "mp4": 200}
MEDIA_DIVIDE_STEPS = 300
MEDIA_N = 100_000          # default.yaml's sample_size (cube_size_guard)
# phase 16: `half` runs and the PSNR band against float32 autograd
HALF_STEPS = 1000
HALF_DIVIDE_STEPS = 300
HALF_DB = 1.0              # dB, fixed before the first card run
# phase 17: hipct.yaml with a step-level exception (preempted at half)
EXCEPTION_STEPS = 500
# phase 18: NFLR at the RD script's widths (scripts/nflr_rd_torch.py)
NFLR_LAMBDA = 8000.0
NFLR_STEPS = {"train": 600, "sga": 200}
NFLR_SHORT = {"train": 30, "sga": 30}
NFLR_RESUME_STEPS = 400
# dB, fixed before the first card run: 0.28 dB above the 24.92 dB of a
# network that outputs 0 (the fixture's minimum everywhere; PERF.md)
NFLR_PSNR_FLOOR = 25.2
H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12     # TF32 on the tensor cores, dense
SINCOS_FLOPS = 25            # fast_sincos incl. the w0 multiplies
SIN_FLOPS = 16               # fast_sin incl. the w0 multiply
# phase 9: (label, family config, N, in the kernels line as)
SIREN_BASE = {"coords_channel": 3, "data_channel": 1, "layers": 5, "w0": 20}
SIREN_CASES = [
    ("slab", {"name": "SIREN", "features": 22}, 10_112, "main"),
    ("default", {"name": "SIREN", "features": 22}, N_COORDS, "at_262144"),
    ("hipct-block", {"name": "SIREN", "features": 64, "layers": 7, "w0": 10},
     100_003, "hipct_block"),
    ("wide", {"name": "SIREN", "features": 186}, N_COORDS, "wide"),
    ("pyramid", {"name": "SIREN_Pyramid", "features": 27, "features_dis": 3},
     N_COORDS, None),
    ("relu", {"name": "SIREN_RELU", "features": 22}, N_COORDS, None),
    ("sigmoid", {"name": "SIREN_SIGMOID", "features": 22}, N_COORDS, None),
    ("sirenpos", {"name": "SIRENPos", "features": 22, "T": [2.0, 3.0, 2.0]},
     N_COORDS, None),
    ("wide-1024", {"name": "SIREN", "features": 1024}, 65_536, "wide_1024"),
    ("c2", {"name": "SIREN", "features": 22, "coords_channel": 2}, N_COORDS,
     None),
]
# phase 9 forward tolerance (absolute, times max|plain|) where it is not
# the default (2e-6, 2e-6)
SIREN_TOL = {"wide-1024": (1e-5, 1e-5)}
GRAD_N = 8192                # coordinates of phase 9's gradient check
# phases 4, 9 and 10: the kernel's distance from a float64 evaluation of
# the chain (float64_chain), max and mean, at most this many times the
# plain version's (phases 4, 9) or model.apply's route (phase 10): float32's
# accuracy.  The tensor core's truncating sums, three mma.sync a k-block
# into one accumulator, were 2.3x (max) and 3.0x (mean) on phase 10's
# trained chain.
F64_RATIO = {"phase4": 2.0, "phase9": 2.0, "phase10": 1.5}
# phase 3: chains the old narrow layout took, beyond the default's 5 x 22:
# (label, family config, the layout the plan must pick)
TRAIN_CASES = [
    ("pyramid", {"name": "SIREN_Pyramid", "features": 27,
                 "features_dis": 3}, "narrow"),
    ("edge-5x64", {"name": "SIREN", "features": 64}, "tiled"),
    ("edge-7x48", {"name": "SIREN", "features": 48, "layers": 7}, "tiled"),
]
# phase 11: Module.phi keys per family (each sizes within 5% of the 80x
# budget), whether both kernels run it, and its PSNR floor in dB after
# FAMILY_STEPS steps (the first H100 run's value less 1 dB, PERF.md)
FAMILY_STEPS = 1000
FAMILIES = [
    ("SIRENFT", {"ratio": 4}, True, 26.8),
    ("SIREN_Pyramid", {"features_dis": 3}, True, 27.4),
    ("SIRENPS", {"ratio": 1.25}, True, 26.8),
    ("SIREN_RELU", {}, True, 40.4),
    ("SIREN_SIGMOID", {}, True, 27.5),
    ("SIREN", {"res": True}, False, 26.6),
    ("NeRF", {}, False, 39.9),
    ("FFN", {"embsize": 16}, False, 31.7),
    ("MFNFourier", {}, False, 25.1),
    ("MFNGabor", {}, False, 25.6),
]
DIVIDE_FAMILIES = [("MFNFourier", {}, 8), ("NeRF", {}, 0)]   # solo blocks


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    print(f"FAIL {msg}", file=sys.stderr, flush=True)
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


def tc_bound_ms(n_bytes: float, product_flops: float, other_flops: float):
    """The least time of a kernel whose products run on the tensor cores in
    3xTF32: the largest of bytes / 3.35 TB/s, 3 x the product flops / 495
    TFLOP/s and the other (sine, elementwise) flops / 67 TFLOP/s."""
    return max(n_bytes / H100_BYTES_PER_S, 3 * product_flops / H100_TF32_FLOPS,
               other_flops / H100_F32_FLOPS) * 1e3


def train_tc_bound_ms(widths, acts, n: int, n_bytes: float) -> float:
    """tc_bound_ms of one fused train call on n coordinates of a chain:
    the three products of train_flops on the tensor cores, its sines on
    the CUDA cores (true widths, not the padding)."""
    sine = n * SINCOS_FLOPS * sum(w for w, (a, _) in zip(widths[1:], acts)
                                  if a == "sine")
    return tc_bound_ms(n_bytes, train_flops(widths, acts, n) - sine, sine)


def chain_macs(widths) -> int:
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def train_flops(widths, acts, n: int) -> float:
    """Float32 operations of one fused train call on n coordinates: 2 per
    multiply-add of the forward, weight-gradient and input-gradient
    products, SINCOS_FLOPS per sine unit."""
    macs = chain_macs(widths)
    sine = sum(w for w, (a, _) in zip(widths[1:], acts) if a == "sine")
    return n * (4 * macs + 2 * (macs - widths[0] * widths[1])
                + SINCOS_FLOPS * sine)


def compare_grads(lk, gk, lp, gp, what: str) -> float:
    """Fail unless the kernel's (loss, grads) match the plain version's:
    loss rel 1e-5, each gradient 1e-4 * max|plain| + 1e-6.  Returns the
    largest absolute difference."""
    err = float((lk - lp).abs().max())
    if not bool(((lk - lp).abs() <= 1e-5 * lp.abs()).all()):
        fail(f"{what}: loss {lk.tolist()} vs plain {lp.tolist()}")
    for l, (a, b) in enumerate(zip(gk, gp)):
        for key in ("w", "b"):
            d = float((a[key] - b[key]).abs().max())
            scale = float(b[key].abs().max())
            err = max(err, d)
            if not d <= 1e-4 * scale + 1e-6:
                fail(f"{what}: grad {key}{l}: max abs err {d} "
                     f"(max |plain| {scale})")
    return err


def chain_check(dev, label: str, phi: dict, n: int, layout: str, kw: dict,
                phase: str = "3-fused_train") -> dict:
    """The one-chain train kernel on a chain of the φ config `phi` (w0,
    layers and channels from the SingleTask default unless `phi` sets
    them) at n coordinates:
    the plan must pick `layout`; against its plain version (compare_grads'
    tolerances), two more runs bitwise equal, timed beside the plain
    version, bound_ms and (narrow) tc_bound_ms.  Returns its JSON row."""
    import torch
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.ops import fused_train
    from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs
    model = init_phi({**SIREN_BASE, **phi})
    layers = model.init(torch.Generator().manual_seed(2), dev)["layers"]
    acts = chain_layer_specs(model.spec)
    widths = fused_train.chain_widths(model.spec)
    p = fused_train.choose_plan(widths)
    if p is None or p["layout"] != layout:
        fail(f"chain {widths}: layout {p and p['layout']}, not {layout}")
    rng = np.random.default_rng(3)
    to_dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    cin, cout = widths[0], widths[-1]
    c = to_dev(rng.uniform(-1, 1, (cin, n)))
    v = to_dev(rng.uniform(0, 100, (cout, n)))
    w = to_dev(rng.uniform(1, 2, (cout, n)))

    def k():
        return fused_train.fused_train_grads(layers, c, v, w, acts, **kw)

    def pl():
        return fused_train.fused_train_grads_reference(layers, c, v, w, acts,
                                                       **kw)

    (lk, gk), (lp, gp) = k(), pl()
    torch.cuda.synchronize()
    one = lambda g: [{a: b[None] for a, b in x.items()} for x in g["layers"]]
    err = compare_grads(lk[None], one(gk), lp[None], one(gp),
                        f"{label} {widths}")
    for lr, gr in [k() for _ in range(2)]:
        if not torch.equal(lr, lk) or not all(
                torch.equal(x[key], y[key]) for x, y in
                zip(gr["layers"], gk["layers"]) for key in ("w", "b")):
            fail(f"{label} {widths}: runs differ bitwise")
    ms = time_ms(k)
    plain = time_ms(pl, reps=5)
    n_bytes = 4 * (n * (cin + 2 * cout) + 2 * sum(
        l["w"].numel() + l["b"].numel() for l in layers) + 1)
    b, by = bound_ms(n_bytes, train_flops(widths, acts, n))
    row = dict(shape=f"SIREN {widths}, N={n}", layout=layout,
               max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
               bound_by=by)
    if layout == "narrow":
        row["tc_bound_ms"] = train_tc_bound_ms(widths, acts, n, n_bytes)
    say(phase, case=label, widths=widths, n=n, layout=layout,
        max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
        bound_ms=f"{b:.4f}", bound_by=by,
        **({"tc_bound_ms": f"{row['tc_bound_ms']:.4f}"}
           if layout == "narrow" else {}),
        tolerance="loss rel 1e-5; grads 1e-4*max|plain|+1e-6; 3 runs "
                  "bitwise")
    return row


def decode_bounds(widths, acts, spatial, n_params: int):
    """(bound_ms, bound_by, tc_bound_ms) of one grid decode: the bytes are
    the output, the plane tables and the weights, each once; the float32
    bound counts 2 flops a multiply-add and SIN_FLOPS a sine unit; the
    tensor-core bound puts the products on the tensor cores in 3xTF32
    (tc_bound_ms), the sines on the CUDA cores."""
    pop = int(np.prod(spatial))
    products = pop * 2 * chain_macs(widths)
    sine = pop * SIN_FLOPS * sum(w for w, (a, _) in zip(widths[1:], acts)
                                 if a == "sine")
    n_bytes = 4 * (pop * widths[-1] + sum(spatial[1:]) + n_params)
    b, by = bound_ms(n_bytes, products + sine)
    return b, by, tc_bound_ms(n_bytes, products, sine)


def grid_coords(fused_decode, spatial, mode: str, dev, voxels):
    """The coordinates the decode kernel builds for the flat voxels
    [start, stop): the plain version's own (which builds them bit for bit
    as the kernel does), through one identity layer (exact in float32),
    so that every build of the package gives them."""
    import torch
    c = len(spatial)
    eye = [{"w": torch.eye(c, device=dev), "b": torch.zeros(c, device=dev)}]
    return fused_decode.fused_decode_grid_reference(
        eye, spatial, (("none", 1.0),), mode, voxels=voxels)


def f64_distances(fused_decode, out, plain, spatial, layers, acts,
                  mode: str, dev) -> dict:
    """Max and mean distance of the decode `out` and of its plain version
    from float64_chain on the kernel's coordinates, DECODE_SLAB voxels at
    a time, on the card."""
    import torch
    chain64 = float64_chain(layers, acts)
    pop = out.shape[0]
    d = {"max_err_vs_float64": 0.0, "plain_max_err_vs_float64": 0.0}
    sums = {"": 0.0, "plain_": 0.0}
    for start in range(0, pop, DECODE_SLAB):
        stop = min(pop, start + DECODE_SLAB)
        truth = chain64(grid_coords(fused_decode, spatial, mode, dev,
                                    (start, stop)))
        for name, x in (("", out), ("plain_", plain)):
            e = (x[start:stop].double() - truth).abs()
            key = f"{name}max_err_vs_float64"
            d[key] = max(d[key], float(e.max()))
            sums[name] += float(e.sum())
        del truth
    torch.cuda.synchronize()
    for name, v in sums.items():
        d[f"{name}mean_err_vs_float64"] = v / (pop * out.shape[1])
    return d


def kernels_per_call(fn, layout: str) -> int:
    """How many kernels one call of fn(), a grid decode, launches on the
    card, by the decode library's own count (fused_decode.kernels_launched);
    torch's own kernels (the wrapper's coordinate tables) are not counted.
    The narrow form must launch 1, the wide form 2 (pack_kernel first)."""
    from brief_pytorch_tpu_torch.ops import fused_decode
    before = fused_decode.kernels_launched()
    fn()
    n = fused_decode.kernels_launched() - before
    want = 1 if layout == "narrow" else 2
    if n != want:
        fail(f"fused_decode {layout}: {n} kernels a call, want {want}")
    return n


def decode_check(dev, label: str, spatial, layers, acts, mode: str = "-1,1",
                 reps: int = 25, plain_reps: int = 20,
                 phase: str = "4-fused_decode") -> dict:
    """The grid-decode kernel on one chain and grid: finite values of the
    right shape within 1e-5 * max|plain| + 1e-5 of the plain version (in
    slabs of DECODE_SLAB voxels past 2^24), two more calls bitwise equal,
    its distance from a float64 evaluation of the chain (f64_distances),
    max and mean, at most F64_RATIO["phase4"] x the plain version's; the
    kernels one call launches (kernels_per_call: the narrow form splits
    its weights in place, one launch; the wide form two, pack_kernel
    first); timed beside the plain version (plain_reps 0: not timed) and
    both bounds.  Returns its row."""
    import torch
    from brief_pytorch_tpu_torch.ops import fused_decode
    widths = [len(spatial)] + [int(l["w"].shape[1]) for l in layers]
    p = fused_decode.choose_plan(widths)
    pop = int(np.prod(spatial))
    slab = DECODE_SLAB if pop > 1 << 24 or p["layout"] == "wide" else None

    def k():
        return fused_decode.fused_decode_grid(layers, spatial, acts, mode)

    def pl():
        return fused_decode.fused_decode_grid_reference(layers, spatial,
                                                        acts, mode, slab=slab)

    out_k, out_p = k(), pl()
    torch.cuda.synchronize()
    if out_k.shape != (pop, widths[-1]) or not torch.isfinite(out_k).all():
        fail(f"fused_decode {label} {spatial}: shape {tuple(out_k.shape)} or "
             "non-finite values")
    err = float((out_k - out_p).abs().max())
    scale = float(out_p.abs().max())
    if not err <= 1e-5 * scale + 1e-5:
        fail(f"fused_decode {label} {spatial} {widths}: max abs err {err} "
             f"(max |plain| {scale})")
    f64 = f64_check(f"fused_decode {label} {spatial} {widths}", None, None,
                    None, F64_RATIO["phase4"], f64_distances(
                        fused_decode, out_k, out_p, spatial, layers, acts,
                        mode, dev))
    del out_p
    for _ in range(2):
        if not torch.equal(k(), out_k):
            fail(f"fused_decode {label} {spatial}: calls differ bitwise")
    del out_k
    per_call = kernels_per_call(k, p["layout"])
    ms = time_ms(k, reps=reps)
    plain = time_ms(pl, reps=plain_reps, warmup=1) if plain_reps else None
    b, by, tc = decode_bounds(widths, acts, spatial, sum(
        l["w"].numel() + l["b"].numel() for l in layers))
    grid = "x".join(map(str, spatial))
    tile = p.get("tile", p.get("block"))
    row = dict(shape=f"SIREN {widths}, {grid} grid", layout=p["layout"],
               tile=tile, inst=p.get("inst"),
               warps_per_sm=p.get("warps_per_sm"),
               kernels_per_call=per_call, max_abs_err=err, **f64, ms=ms,
               plain_ms=plain, bound_ms=b, bound_by=by, tc_bound_ms=tc)
    say(phase, case=label, grid=grid, widths=widths,
        layout=p["layout"], tile=tile, inst=p.get("inst"),
        warps_per_sm=p.get("warps_per_sm"), kernels_per_call=per_call,
        max_abs_err=f"{err:.3e}",
        **{k: f"{v:.3e}" for k, v in f64.items()},
        ms=f"{ms:.4f}", plain_ms=plain and f"{plain:.4f}", bound_ms=f"{b:.4f}",
        bound_by=by, tc_bound_ms=f"{tc:.4f}",
        mvox_per_s=f"{pop / ms / 1e3:.1f}",
        tolerance=f"1e-5*max|plain|+1e-5; 3 calls bitwise; float64 "
                  f"{F64_RATIO['phase4']:g}x plain")
    return row


def fleet_check(dev, rng, true_widths, layers: int, w0: float, n: int,
                thres, layout: str, cin: int = 3,
                phase: str = "6-fused_train_fleet") -> dict:
    """The train kernel's fleet form on B = len(true_widths) SIREN chains
    padded to the widest (unit masks), n coordinates per block, per-block
    thresholds `thres` (-inf: none), in the kernel layout `layout` (the
    plan must pick it): against its plain version for both
    losses and a relu/sigmoid chain, each block against the one-chain
    kernel on its unpadded chain, padded gradients exactly 0, three runs
    bitwise equal; then timed beside the plain version and the bound.
    Fails the run on any disagreement; returns the kernel's JSON row."""
    import torch
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.ops import fused_train
    from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs
    from brief_pytorch_tpu_torch.parallel.block_trainer import build_stacked
    models = [init_phi({"name": "SIREN", "coords_channel": cin,
                        "data_channel": 1, "features": f, "layers": layers,
                        "w0": w0}) for f in true_widths]
    _, params, masks = build_stacked(models, 0, device=dev)
    flayers = params["layers"]
    padded = [cin] + [int(l["w"].shape[-1]) for l in flayers]
    acts = chain_layer_specs(models[-1].spec)
    nb = len(true_widths)
    to_dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    fc = to_dev(rng.uniform(-1, 1, (nb, cin, n)))
    fv = to_dev(rng.uniform(0, 100, (nb, 1, n)))
    fw = to_dev(rng.uniform(1, 2, (nb, 1, n)))
    fthres = torch.tensor(thres, dtype=torch.float32, device=dev)
    um = list(masks[:-1]) + [None]
    what = f"fleet {nb} x {padded}"

    def k6(loss_name="datal2", acts6=acts):
        return fused_train.fused_train_grads_fleet(
            flayers, fc, fv, fw, acts6, loss_name=loss_name, beta=0.01,
            unit_masks=um, thres=fthres)

    def p6(loss_name="datal2", acts6=acts):
        return fused_train.fused_train_grads_reference(
            flayers, fc, fv, fw, acts6, loss_name=loss_name, beta=0.01,
            weight_thres=fthres, unit_masks=um)

    relu_sig = tuple((("relu", 1.0), ("sigmoid", 1.0))[l % 2]
                     for l in range(len(acts) - 1)) + (("none", 1.0),)
    err = 0.0
    for loss_name, acts6 in (("datal2", acts), ("datasmoothl1", acts),
                             ("datasmoothl1", relu_sig)):
        (lk, gk), (lp, gp) = k6(loss_name, acts6), p6(loss_name, acts6)
        torch.cuda.synchronize()
        err = max(err, compare_grads(lk, gk["layers"], lp, gp["layers"],
                                     f"{what} {loss_name} {acts6[:2]}"))
    loss_f, g_f = k6()
    for i, m in enumerate(models):
        dims = [(e.fan_in, e.fan_out) for e in m.spec.entries]
        own = [{"w": l["w"][i, :a, :b].contiguous(),
                "b": l["b"][i, :b].contiguous()}
               for l, (a, b) in zip(flayers, dims)]
        t = float(fthres[i])
        ls, gs = fused_train.fused_train_grads(
            own, fc[i], fv[i], fw[i], acts, loss_name="datal2", beta=0.01,
            weight_thres=t if math.isfinite(t) else None)
        compare_grads(loss_f[i], [{"w": g["w"][i, :a, :b], "b": g["b"][i, :b]}
                                  for g, (a, b) in zip(g_f["layers"], dims)],
                      ls, gs["layers"], f"{what} block {i} vs one chain")
        for l, ((a, b), g) in enumerate(zip(dims, g_f["layers"])):
            pad = int(torch.count_nonzero(g["w"][i, a:, :])
                      + torch.count_nonzero(g["w"][i, :, b:])
                      + torch.count_nonzero(g["b"][i, b:]))
            if pad:
                fail(f"{what} block {i} layer {l}: {pad} nonzero gradients "
                     "of padded units")
    for loss_r, g_r in [k6() for _ in range(3)]:
        if not torch.equal(loss_r, loss_f) or not all(
                torch.equal(a[k], b[k]) for a, b in
                zip(g_r["layers"], g_f["layers"]) for k in ("w", "b")):
            fail(f"{what}: runs differ bitwise")
    ms = time_ms(k6)
    plain = time_ms(p6, reps=5)
    flops = sum(train_flops([cin] + [f] * (layers - 1) + [1], acts, n)
                for f in true_widths)
    flops_pad = nb * train_flops(padded, acts, n)
    n_par = sum(l["w"].numel() + l["b"].numel() for l in flayers)
    n_bytes = 4 * (nb * n * (cin + 1 + 1) + 2 * n_par + nb
                   + sum(m.numel() for m in masks[:-1]))
    b, by = bound_ms(n_bytes, flops)
    b_pad, _ = bound_ms(n_bytes, flops_pad)
    tc = sum(train_tc_bound_ms([cin] + [f] * (layers - 1) + [1], acts, n,
                               n_bytes / nb) for f in true_widths)
    p = fused_train.choose_plan(padded)
    if p["layout"] != layout:
        fail(f"{what}: layout {p['layout']}, not {layout}")
    say(phase, blocks=nb, n=n, padded=padded,
        true_widths=list(true_widths), thres=fthres.tolist(), layout=layout,
        tile=p["block"], max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain:.4f}", bound_ms=f"{b:.4f}",
        bound_padded_ms=f"{b_pad:.4f}", bound_by=by,
        **({"tc_bound_ms": f"{tc:.4f}"} if layout == "narrow" else {}),
        tolerance="loss rel 1e-5; grads 1e-4*max|plain|+1e-6; padded "
                  "grads 0; 3 runs bitwise")
    return dict(shape=f"{nb} x SIREN {padded} (true {list(true_widths)}), "
                      f"N={n} per block", layout=layout, tile=p["block"],
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_padded_ms=b_pad, bound_by=by, padded=padded,
                **({"tc_bound_ms": tc} if layout == "narrow" else {}))


def run_config(config: str, out_dir: str, steps: int, data_path=None,
               fused_train: bool = True, phi=None, project=None,
               ratio=None, compress=None, decompress=None):
    """The CLI on `config` cut to `steps` steps with one checkpoint, no
    MIPs (and the fused train kernel off unless `fused_train`; Module.phi
    updated with `phi`, the run named `project`, Compress.param's
    filesize_ratio set to `ratio`, Compress and Decompress merged with the
    dicts `compress` and `decompress`); returns (summary, run dir, the
    yaml's config)."""
    from brief_pytorch_tpu_torch.cli import main as cli
    from brief_pytorch_tpu_torch.core import config as cfglib
    opt = cfglib.load(config)
    if data_path is not None:
        opt.Dataset.data_path = data_path
    opt.Log.outputs_dir = out_dir
    opt.Log.tensorboard = False
    opt.Log.time = False
    c = opt.CompressFramework
    c.Compress.max_steps = steps
    c.Compress.checkpoints = "none"
    c.Decompress.mip = False
    if not fused_train:
        c.Compress.fused_train = False
        opt.Log.project_name += "_autograd"
    for k, v in (phi or {}).items():
        c.Module.phi[k] = v
    if ratio is not None:
        c.Compress.param.filesize_ratio = ratio
    if compress or decompress:
        c.Compress = cfglib.merge(c.Compress, compress or {})
        c.Decompress = cfglib.merge(c.Decompress, decompress or {})
    if project is not None:
        opt.Log.project_name = project
    yaml_path = os.path.join(out_dir, f"{opt.Log.project_name}_"
                             + os.path.basename(config))
    cfglib.save(opt, yaml_path)
    summary = cli.main(["-p", yaml_path, "-g", "0"])
    return summary, os.path.join(out_dir, opt.Log.project_name), opt


def last_psnr(run_dir: str) -> float:
    with open(os.path.join(run_dir, "performance.csv")) as f:
        return float(list(csv.DictReader(f))[-1]["psnr"])


def chunk_dirs(run_dir: str, steps: int, prefix: str = "weight-"):
    module = os.path.join(run_dir, f"steps{steps}", "compressed", "module")
    names = sorted(os.listdir(module))
    for name in names:
        if not any(f.startswith(prefix) for f in
                   os.listdir(os.path.join(module, name, "module"))):
            fail(f"{module}/{name}: no {prefix}* written")
    return names


def float64_chain(layers, acts, pre=None):
    """The chain with each layer's products and sums in float64, its
    pre-activation rounded once to float32 and activated as the plain
    version does: coords -> float64 outputs (after `pre`, SIRENPos's
    warp in float32, where given)."""
    from brief_pytorch_tpu_torch.ops import fused_siren
    layers64 = [{k: t.double() for k, t in layer.items()}
                for layer in layers]

    def apply(coords):
        h = (pre(coords) if pre is not None else coords).double()
        for layer, (act, w0) in zip(layers64, acts):
            z = (h @ layer["w"] + layer["b"]).float()
            h = fused_siren._act(z, act, w0).double()
        return h
    return apply


def f64_check(what: str, out, plain, truth, ratio: float,
              d: dict = None) -> dict:
    """Fails the run unless out's max and mean distance from truth are at
    most `ratio` times plain's; returns the four distances.  Where the
    distances `d` are given (f64_distances), out, plain and truth are
    not read."""
    if d is None:
        d = {}
        for name, x in (("", out), ("plain_", plain)):
            e = np.abs(np.asarray(x, np.float64) - truth)
            d[f"{name}max_err_vs_float64"] = float(e.max())
            d[f"{name}mean_err_vs_float64"] = float(e.mean())
    for k in ("max", "mean"):
        if not d[f"{k}_err_vs_float64"] <= \
                ratio * d[f"plain_{k}_err_vs_float64"]:
            fail(f"{what}: {k} distance from float64 "
                 f"{d[f'{k}_err_vs_float64']:.3e}, more than {ratio} x the "
                 f"plain version's {d[f'plain_{k}_err_vs_float64']:.3e}")
    return d


def siren_check(dev, label: str, cfg: dict, n: int) -> dict:
    """The batch-major forward kernel on one family at n coordinates:
    against its plain version (forward within SIREN_TOL; gradients of
    (out^2).mean() for every w, b and for coords against autograd through
    model.apply on the first GRAD_N coordinates), two runs bitwise equal,
    and against a float64 evaluation within F64_RATIO of the plain
    version's distance; then timed beside the plain version and both
    bounds (float32 and
    tensor-core: the products in 3xTF32, the sines on the CUDA cores).
    Fails the run on any disagreement; returns the case's row."""
    import torch
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.ops import fused_siren
    from brief_pytorch_tpu_torch.ops.chain import (chain_layer_specs,
                                                   make_pre_encode)
    model = init_phi({**SIREN_BASE, **cfg})
    params = model.init(torch.Generator().manual_seed(2), dev)
    layers = params["layers"]
    acts = chain_layer_specs(model.spec)
    widths = fused_siren.chain_widths(model.spec)
    plan = fused_siren.kernel_plan(widths)
    if not fused_siren.supports(model):
        fail(f"fused_siren does not support {cfg}")
    rng = np.random.default_rng(n)
    coords = torch.from_numpy(
        rng.uniform(-1, 1, (n, widths[0])).astype(np.float32)).to(dev)
    fused = fused_siren.make_fused_apply(model)
    pre = make_pre_encode(model.spec)

    def k():
        return fused(params, coords)

    def plain():
        return fused_siren.fused_chain_apply_reference(layers, pre(coords),
                                                       acts)

    before = fused_siren.launches
    out_k, out_p, again = k(), plain(), k()
    torch.cuda.synchronize()
    what = f"fused_siren {label} {widths} N={n}"
    if fused_siren.launches != before + 2:
        fail(f"{what}: {fused_siren.launches - before} launches for 2 calls")
    if out_k.shape != (n, widths[-1]) or not torch.isfinite(out_k).all():
        fail(f"{what}: shape {tuple(out_k.shape)} or non-finite values")
    err = float((out_k - out_p).abs().max())
    scale = float(out_p.abs().max())
    tol_abs, tol_rel = SIREN_TOL.get(label, (2e-6, 2e-6))
    if not err <= tol_abs + tol_rel * scale:
        fail(f"{what}: max abs err {err} (max |plain| {scale})")
    if not torch.equal(out_k, again):
        fail(f"{what}: two runs differ bitwise")
    truth = float64_chain(layers, acts, pre)(coords).cpu().numpy()
    f64 = f64_check(what, out_k.cpu().numpy(), out_p.cpu().numpy(), truth,
                    F64_RATIO["phase9"])
    del out_k, out_p, again, truth
    # gradients: the kernel's autograd.Function against plain autograd
    sub = coords[:GRAD_N].clone().requires_grad_(True)
    leaves = [t.requires_grad_(True) for l in layers for t in l.values()]
    g_k = torch.autograd.grad((fused(params, sub) ** 2).mean(),
                              leaves + [sub])
    g_p = torch.autograd.grad((model.apply(params, sub) ** 2).mean(),
                              leaves + [sub])
    for t in leaves:
        t.requires_grad_(False)
    gerr = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))
    if not gerr <= 1e-6:
        fail(f"{what}: gradient max abs err {gerr}")
    with torch.no_grad():
        ms = time_ms(k)
        plain_ms = time_ms(plain, reps=10)
    sine = sum(w for w, (a, _) in zip(widths[1:], acts) if a == "sine")
    if model.spec.encoder == "sirenpos":
        sine += widths[0]            # the warp ahead of the kernel
    products = n * 2 * chain_macs(widths)
    n_bytes = 4 * (n * (widths[0] + widths[-1])
                   + sum(l["w"].numel() + l["b"].numel() for l in layers))
    b, by = bound_ms(n_bytes, products + n * SIN_FLOPS * sine)
    tc = tc_bound_ms(n_bytes, products, n * SIN_FLOPS * sine)
    form = dict(layout=plan["layout"], inst=plan["inst"], tile=plan["tile"],
                warps_per_sm=plan["warps_per_sm"])
    say("9-fused_siren", case=label, family=cfg["name"], widths=widths, n=n,
        **form, max_abs_err=f"{err:.3e}", grad_max_abs_err=f"{gerr:.3e}",
        **{k: f"{v:.3e}" for k, v in f64.items()},
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b:.4f}",
        bound_by=by, tc_bound_ms=f"{tc:.4f}",
        mcoords_per_s=f"{n / ms / 1e3:.1f}",
        tolerance=f"{tol_abs:g}+{tol_rel:g}*max|plain|; grads 1e-6; "
                  f"2 runs bitwise; float64 {F64_RATIO['phase9']:g}x plain")
    return dict(shape=f"{cfg['name']} {widths}, N={n}", **form,
                max_abs_err=err, grad_max_abs_err=gerr, **f64, ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, tc_bound_ms=tc)


def load_archive(dev, cf, comp: str):
    """(model, params on dev, sideinfos) of the SingleTask archive under
    `comp` (module/, sideinfos.yaml) of a run with the config node cf."""
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.io.modelsave import load_phi_module
    from brief_pytorch_tpu_torch.models.phi import (init_phi,
                                                    params_from_numpy)
    side = cfglib.load(os.path.join(comp, "sideinfos.yaml"))
    phi = dict(cf.Module.phi)
    phi.update(features=side["phi_features"], name=side["phi_name"])
    model = init_phi(phi)
    params = params_from_numpy(
        load_phi_module(model, os.path.join(comp, "module")), dev)
    return model, params, side


def batch_major_decode(dev, cf, comp: str) -> dict:
    """Phase 10 on the archive under `comp` (module/, sideinfos.yaml) of a
    SingleTask run with the config node `cf`."""
    import torch
    from brief_pytorch_tpu_torch.core.normalize import invnormalize_data
    from brief_pytorch_tpu_torch.ops import fused_decode, fused_siren
    from brief_pytorch_tpu_torch.ops.chain import (chain_layer_specs,
                                                   make_pre_encode)
    from brief_pytorch_tpu_torch.post.preprocess import preprocess
    from brief_pytorch_tpu_torch.train.decode import (fused_apply_or,
                                                      reconstruct_flattened)
    model, params, side = load_archive(dev, cf, comp)
    shape = list(side["data_shape"])
    pop = int(np.prod(shape[:-1]))
    sample_size = int(cf.Decompress.sample_size)
    slab = max(128, -(-min(sample_size, pop) // 128) * 128)
    mode = cf.Compress.coords_mode
    chain64 = float64_chain(params["layers"],
                            chain_layer_specs(model.spec),
                            make_pre_encode(model.spec))

    def apply64(_, coords):
        return chain64(coords)

    apply_k = fused_apply_or(model, model.apply)
    if apply_k == model.apply:
        fail("fused_apply_or returned the default apply on the card")

    def route(apply_fn):
        return reconstruct_flattened(model, params, shape, sample_size, mode,
                                     apply_fn=apply_fn)

    fused_siren.launches = 0
    fused_decode.launches = 0
    out_k = route(apply_k)
    launches = {"fused_siren": fused_siren.launches,
                "fused_decode": fused_decode.launches}
    want = -(-pop // slab)
    if launches != {"fused_siren": want, "fused_decode": 0}:
        fail(f"batch-major decode: launches {launches}, want {want} of the "
             f"forward kernel and 0 of the grid kernel")
    out_p = route(model.apply)
    out_t = route(apply64)
    out_g = route(None)
    if fused_decode.launches != 1:
        fail("the default decode did not take the grid kernel")
    if out_k.shape != tuple(shape) or not np.isfinite(out_k).all():
        fail(f"batch-major decode: shape {out_k.shape} or non-finite values")
    err = float(np.abs(out_k - out_p).max())
    scale = float(np.abs(out_p).max())      # normalized values reach 100
    # the route against float64 beside model.apply's route: float32's
    # accuracy (model.apply's own distance, ~2e-4 of 100, exceeds
    # 2e-6 * max|value|, so no other float32 order of sums can be held
    # to model.apply that closely)
    f64 = f64_check("batch-major decode", out_k, out_p,
                    np.asarray(out_t, np.float64), F64_RATIO["phase10"])

    def volume(dec):
        post = cf.Decompress.postprocess
        return preprocess(invnormalize_data(dec, dict(side), **cf.Normalize),
                          post.denoise.level, post.denoise.close, post.clip)

    diff = np.abs(volume(out_k).astype(np.int64)
                  - volume(out_g).astype(np.int64))
    within = float((diff <= 1).mean())
    if within < 0.999:
        fail(f"batch-major decode: {within:.6f} of voxels within 1 LSB of "
             "the grid kernel's decode")

    def wall_ms(apply_fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            route(apply_fn)        # ends in the copy to the host: a sync
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    ms_k, ms_p, ms_g = wall_ms(apply_k), wall_ms(model.apply), wall_ms(None)
    say("10-batch-major-decode", grid="64^3", slab=slab,
        launches=json.dumps(launches), max_abs_err_vs_apply=f"{err:.3e}",
        **{k.replace("plain_", "apply_"): f"{v:.3e}" for k, v in f64.items()},
        max_abs_apply=f"{scale:.3f}",
        tolerance=f"float64 {F64_RATIO['phase10']:g}x model.apply's route",
        within_1lsb_of_grid_kernel=f"{within:.6f}", max_lsb=int(diff.max()),
        wall_ms_forward_kernel=f"{ms_k:.3f}",
        wall_ms_model_apply=f"{ms_p:.3f}", wall_ms_grid_kernel=f"{ms_g:.3f}",
        mvox_per_s_forward_kernel=f"{pop / ms_k / 1e3:.1f}",
        mvox_per_s_model_apply=f"{pop / ms_p / 1e3:.1f}",
        mvox_per_s_grid_kernel=f"{pop / ms_g / 1e3:.1f}")
    return dict(launches=launches["fused_siren"], slab=slab,
                max_abs_err_vs_apply=err,
                **{k.replace("plain_", "apply_"): v for k, v in f64.items()},
                route_wall_ms=ms_k, apply_route_wall_ms=ms_p,
                grid_route_wall_ms=ms_g, within_1lsb=within)


def family_run(dev, out_dir: str, name: str, keys: dict, on_kernels: bool,
               floor: float) -> None:
    """Phase 11 for one family: the SingleTask command on the fixture."""
    import torch
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.io.modelsave import load_phi_module
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.core.tree import tree_leaves
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.ops import (fused_decode, fused_siren,
                                             fused_train)
    from brief_pytorch_tpu_torch.train.fit import NFGR
    project = name + ("_res" if keys.get("res") else "")
    fused_train.launches = fused_decode.launches = fused_siren.launches = 0
    t0 = time.perf_counter()
    summary, run_dir, opt = run_config(CONFIG, out_dir, FAMILY_STEPS, FIXTURE,
                                       phi={"name": name, **keys},
                                       project=project)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_train": fused_train.launches,
                "fused_decode": fused_decode.launches,
                "fused_siren": fused_siren.launches}
    want = {"fused_train": FAMILY_STEPS if on_kernels else 0,
            "fused_decode": 1 if on_kernels else 0, "fused_siren": 0}
    if launches != want:
        fail(f"{project}: launches {launches}, want {want}")
    cf = opt.CompressFramework
    comp = os.path.join(run_dir, f"steps{FAMILY_STEPS}", "compressed")
    module = os.path.join(comp, "module")
    files = sorted(os.listdir(module))
    if name.startswith("MFN"):
        kind_ok = files == ["params.npz"]
    else:
        kind_ok = any(f.startswith("weight-") for f in files) and \
            ("encoder.npz" in files) == (name == "FFN") and \
            "params.npz" not in files
    if not kind_ok:
        fail(f"{project}: module files {files}")
    side = cfglib.load(os.path.join(comp, "sideinfos.yaml"))
    if side["phi_name"] != name:
        fail(f"{project}: sized as {side['phi_name']}")
    model = init_phi({**dict(cf.Module.phi), "name": name,
                      "features": side["phi_features"]})
    like = model.init(torch.Generator().manual_seed(0), "cpu")
    count = sum(int(np.asarray(a).size) for a in
                tree_leaves(load_phi_module(model, module, like)))
    ideal = os.path.getsize(FIXTURE) / cf.Compress.param.filesize_ratio
    off = (4 * count - ideal) / ideal
    if abs(off) > 0.05:
        fail(f"{project}: {count} parameters, {off:+.3f} off the budget")
    dec = NFGR.decompress(cf, module, os.path.join(comp, "sideinfos.yaml"),
                          device=dev)
    ck = read_img(os.path.join(
        run_dir, f"steps{FAMILY_STEPS}", "decompressed",
        os.path.basename(FIXTURE).replace(".tif", "_decompressed.tif")))
    if dec.shape != ck.shape or not np.array_equal(dec, ck):
        fail(f"{project}: standalone decompress differs from the "
             "checkpoint's decode")
    psnr = last_psnr(run_dir)
    say("11-family", family=project, features=side["phi_features"],
        params=count, budget_off=f"{off:+.4f}", files=files[:1] + files[-1:],
        launches=json.dumps(launches), psnr=f"{psnr:.3f}", psnr_floor=floor,
        ssim=f"{float(summary['ssim']):.4f}",
        train_s=f"{summary['train_s']:.3f}",
        steps_per_s=f"{FAMILY_STEPS / summary['train_s']:.1f}",
        checkpoint_s=f"{summary['checkpoint_s']:.3f}", wall_s=f"{wall:.3f}")
    if not math.isfinite(psnr) or psnr < floor:
        fail(f"{project}: PSNR {psnr} below the floor {floor}")


def divide_family_run(dev, out_dir: str, name: str, keys: dict, solo: int
                      ) -> None:
    """Phase 11's DivideTask runs: brain64.yaml with another family."""
    import torch
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.ops import fused_decode, fused_train
    from brief_pytorch_tpu_torch.train.fit import NFGR
    fused_train.launches = fused_decode.launches = 0
    t0 = time.perf_counter()
    summary, run_dir, opt = run_config(
        os.path.join(DIVIDE, "brain64.yaml"), out_dir, FIXTURE_STEPS,
        phi={"name": name, **keys}, project=f"brain64_{name}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if fused_train.launches or any(summary["fused"]) or \
            len(summary["solo"]) != solo or \
            len(summary["fleet"]) != (0 if solo else 1):
        fail(f"brain64 {name}: {fused_train.launches} train launches, fused "
             f"{summary['fused']}, solo {summary['solo']}, buckets "
             f"{summary['fleet']}")
    names = chunk_dirs(run_dir, FIXTURE_STEPS,
                       "params.npz" if solo else "weight-")
    comp = os.path.join(run_dir, f"steps{FIXTURE_STEPS}", "compressed")
    dec = NFGR.decompress_divide(
        opt.CompressFramework, os.path.join(comp, "sideinfos.yaml"),
        os.path.join(comp, "module"), os.path.join(comp, "sideinfos"),
        device=dev)
    ck = read_img(os.path.join(
        run_dir, f"steps{FIXTURE_STEPS}", "decompressed",
        os.path.basename(FIXTURE).replace(".tif", "_decompressed.tif")))
    diff = np.abs(dec.astype(np.int64) - ck.astype(np.int64))
    psnr = last_psnr(run_dir)
    if dec.shape != ck.shape or int(diff.max()) > 1 or \
            fused_decode.launches or not math.isfinite(psnr):
        fail(f"brain64 {name}: decompress_divide shape {dec.shape} vs "
             f"{ck.shape}, max {int(diff.max())} LSB, "
             f"{fused_decode.launches} grid-kernel launches, PSNR {psnr}")
    say("11-divide-family", family=name, steps=FIXTURE_STEPS,
        chunks=len(names), solo=len(summary["solo"]),
        buckets=len(summary["fleet"]), max_lsb=int(diff.max()),
        psnr=f"{psnr:.3f}", train_s=f"{summary['train_s']:.3f}",
        checkpoint_s=f"{summary['checkpoint_s']:.3f}", wall_s=f"{wall:.3f}")


def demo_run(dev, out_dir: str, ratio: int, steps: int, features: int
             ) -> dict:
    """Phase 12 at one filesize_ratio: opt/SingleTask/default.yaml on the
    HiP-CT demo volume through the command, on the kernels and through
    autograd.  Fails the run on any miss; returns the run's numbers."""
    import torch
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.ops import fused_decode, fused_train
    from brief_pytorch_tpu_torch.train.fit import NFGR
    project = f"demo_{ratio}x"
    fused_train.launches = fused_decode.launches = 0
    t0 = time.perf_counter()
    summary, run_dir, opt = run_config(CONFIG, out_dir, steps, HIPCT,
                                       project=project, ratio=ratio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_train": fused_train.launches,
                "fused_decode": fused_decode.launches}
    cf = opt.CompressFramework
    comp = os.path.join(run_dir, f"steps{steps}", "compressed")
    side = cfglib.load(os.path.join(comp, "sideinfos.yaml"))
    with np.load(os.path.join(run_dir, "trainstate.npz")) as z:
        fp = json.loads(bytes(z["fingerprint"]).decode())
    widths = [3] + [features] * 4 + [1]
    if launches["fused_train"] != steps or launches["fused_decode"] < 1 or \
            side["phi_features"] != features or not fp["fused"] or \
            "RandomPointSampler" not in fp["sampler"] or \
            int(cf.Compress.sampler.sample_size) != DEMO_N or \
            fused_train.choose_plan(widths)["layout"] != "wide" or \
            fused_decode.choose_plan(widths)["layout"] != "wide":
        fail(f"{project}: launches {launches}, features "
             f"{side['phi_features']} (want {features}), fingerprint {fp}")
    fused_decode.launches = 0
    dec = NFGR.decompress(cf, os.path.join(comp, "module"),
                          os.path.join(comp, "sideinfos.yaml"), device=dev)
    decompress_launches = fused_decode.launches
    ck = read_img(os.path.join(
        run_dir, f"steps{steps}", "decompressed",
        os.path.basename(HIPCT).replace(".tif", "_decompressed.tif")))
    if decompress_launches < 1 or dec.shape != (64, 512, 512, 1) or \
            not np.array_equal(dec, ck):
        fail(f"{project}: standalone decompress ({decompress_launches} "
             "decode launches) differs from the checkpoint's decode")
    psnr = last_psnr(run_dir)
    fused_train.launches = 0
    summary_a, run_dir_a, _ = run_config(CONFIG, out_dir, steps, HIPCT,
                                         fused_train=False, ratio=ratio,
                                         project=project + "_autograd")
    psnr_a = last_psnr(run_dir_a)
    if fused_train.launches:
        fail(f"{project} autograd run: {fused_train.launches} kernel "
             "launches")
    train_s = summary["train_s"]
    say("12-demo-singletask", ratio=ratio, steps=steps, widths=widths,
        sampler=f"randompoint {DEMO_N}", launches=json.dumps(launches),
        decompress_decode_launches=decompress_launches,
        psnr=f"{psnr:.3f}", psnr_autograd=f"{psnr_a:.3f}",
        psnr_autograd_margin=DEMO_AUTOGRAD_DB,
        ssim=f"{float(summary['ssim']):.4f}",
        ssim_autograd=f"{float(summary_a['ssim']):.4f}",
        train_s=f"{train_s:.3f}", steps_per_s=f"{steps / train_s:.2f}",
        steps_per_s_autograd=f"{steps / summary_a['train_s']:.2f}",
        checkpoint_s=f"{summary['checkpoint_s']:.3f}", wall_s=f"{wall:.3f}")
    if not math.isfinite(psnr) or not abs(psnr - psnr_a) <= DEMO_AUTOGRAD_DB:
        fail(f"{project}: PSNR {psnr} on the kernels, {psnr_a} through "
             f"autograd: more than {DEMO_AUTOGRAD_DB} dB apart")
    return dict(launches=launches, decompress_decode_launches=
                decompress_launches, psnr=psnr, psnr_autograd=psnr_a,
                steps_per_s=steps / train_s, train_s=train_s,
                checkpoint_s=summary["checkpoint_s"], wall_s=wall)


class Preempted(Exception):
    """Raised right after a run wrote a training state: a preemption."""


def tree_bytes(root: str) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def resume_run(dev, out_dir: str, label: str, config: str, steps: int,
               data_path: str, per_step: float = 1.0) -> dict:
    """Phase 13 on one config: A, the run preempted right after it wrote
    its training state at steps // 2 (the state writer raises Preempted
    after writing); B, the same run uninterrupted; C, A's command plus
    -resume <A's run dir>.  C's weight binaries at `steps` must equal B's
    byte for byte, C must launch the train kernel steps // 2 times and
    skip A's checkpoint; then C once more with another lr_phi must raise
    ValueError (the fingerprint).  per_step: train launches a fleet step
    (1.5 with a solo block at half the fleet's max_steps).  Fails the run
    on any miss; returns the numbers."""
    import torch
    from brief_pytorch_tpu_torch.cli import main as cli
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.ops import fused_train
    from brief_pytorch_tpu_torch.parallel.block_trainer import \
        BlockFleetTrainer
    from brief_pytorch_tpu_torch.train import fit
    half = steps // 2
    opt = cfglib.load(config)
    opt.Dataset.data_path = data_path
    opt.Log.update(outputs_dir=out_dir, stdlog=False, tensorboard=False,
                   time=False)
    c = opt.CompressFramework
    c.Compress.max_steps = steps
    c.Compress.checkpoints = f"every_{half}"
    c.Decompress.mip = False
    divide = c.Compress.divide.divide_type != "none"
    paths = {}
    for tag in ("A", "B", "C", "lr"):
        opt.Log.project_name = f"{label}_{tag}"
        if tag == "lr":
            c.Compress.lr_phi = float(c.Compress.lr_phi) * 2
        paths[tag] = os.path.join(out_dir, f"{label}_{tag}.yaml")
        cfglib.save(opt, paths[tag])
    run_dir = {t: os.path.join(out_dir, f"{label}_{t}") for t in paths}

    def preempting(write):
        def wrapper(*a, **kw):
            write(*a, **kw)
            if a[-2] == half:      # (..., step, fingerprint)
                raise Preempted
        return wrapper

    owner, name = (BlockFleetTrainer, "_save_state") if divide else \
        (fit, "save_trainstate")
    write = getattr(owner, name)
    setattr(owner, name, preempting(write))
    launches = {}
    try:
        fused_train.launches = 0
        try:
            cli.main(["-p", paths["A"], "-g", "0"])
            fail(f"{label}: run A was not preempted at step {half}")
        except Preempted:
            pass
    finally:
        setattr(owner, name, write)
    launches["A"] = fused_train.launches
    t0 = time.perf_counter()
    for tag, extra in (("B", []), ("C", ["-resume", run_dir["A"]])):
        fused_train.launches = 0
        cli.main(["-p", paths[tag], "-g", "0"] + extra)
        torch.cuda.synchronize()
        launches[tag] = fused_train.launches
    wall = time.perf_counter() - t0
    module = os.path.join(f"steps{steps}", "compressed", "module")
    b = tree_bytes(os.path.join(run_dir["B"], module))
    got = tree_bytes(os.path.join(run_dir["C"], module))
    state = "trainstate_fleet.npz" if divide else "trainstate.npz"
    with np.load(os.path.join(run_dir["C"], state)) as z:
        stored = int(z["step"])
    want = {"A": round(half * per_step), "B": round(steps * per_step),
            "C": round(half * per_step)}
    if not b or got != b or launches != want \
            or os.path.isdir(os.path.join(run_dir["C"], f"steps{half}")) \
            or stored != steps:
        fail(f"{label}: resumed weights equal the uninterrupted run's: "
             f"{got == b} ({len(got)} vs {len(b)} files), launches "
             f"{launches}, C's state at step {stored}")
    try:
        cli.main(["-p", paths["lr"], "-g", "0", "-resume", run_dir["A"]])
        fail(f"{label}: a state of another lr_phi was resumed")
    except ValueError as e:
        if "different" not in str(e):
            raise
    say("13-resume", config=os.path.basename(config), label=label,
        steps=steps, preempted_at=half, launches=json.dumps(launches),
        files=len(b), bitwise_equal=True,
        fingerprint_mismatch="ValueError", wall_s_b_and_c=f"{wall:.3f}")
    return dict(launches=launches, files=len(b))


def deblock_check(step_dir: str, data_path: str) -> dict:
    """`python -m brief_pytorch_tpu_torch.post.deblock -stp <step_dir>`
    on a DivideTask checkpoint: the output TIFF has the merged volume's
    shape and dtype and differs from it only within 3 voxels of the
    blocks' boundary planes (the h and w extents of the chunk names).
    Fails the run on any miss; returns the numbers."""
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.partition.divide import parse_chunk_name
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m",
                        "brief_pytorch_tpu_torch.post.deblock", "-stp",
                        step_dir], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    wall = time.perf_counter() - t0
    stem = os.path.basename(data_path).replace(".tif", "_decompressed")
    out_path = os.path.join(step_dir, "deblock",
                            stem + "_deblocked_python.tif")
    if p.returncode != 0 or not os.path.exists(out_path):
        fail(f"deblock -stp {step_dir}: exit {p.returncode}, "
             f"{p.stderr[-1500:]}")
    src = read_img(os.path.join(step_dir, "decompressed", stem + ".tif"))
    out = read_img(out_path)
    if out.shape != src.shape or out.dtype != src.dtype:
        fail(f"deblock: {out.shape} {out.dtype}, input {src.shape} "
             f"{src.dtype}")
    near = np.zeros(src.shape[1:3], bool)
    for name in os.listdir(os.path.join(step_dir, "compressed", "module")):
        ext = parse_chunk_name(name)
        for axis, key in ((0, "h"), (1, "w")):
            for edge in ext[key]:
                lo, hi = max(0, edge - 3), edge + 4
                if axis == 0:
                    near[lo:hi, :] = True
                else:
                    near[:, lo:hi] = True
    changed = out != src
    outside = int((changed & ~near[None, :, :, None]).sum())
    n_changed = int(changed.sum())
    if outside or not n_changed:
        fail(f"deblock: {n_changed} voxels changed, {outside} of them "
             "further than 3 voxels from a block boundary")
    say("7-deblock", step_dir=os.path.basename(step_dir),
        shape=list(out.shape), dtype=str(out.dtype), changed=n_changed,
        changed_share=f"{n_changed / out.size:.6f}",
        max_change=int(np.abs(out.astype(np.int64)
                              - src.astype(np.int64)).max()),
        outside_3_voxels=outside, wall_s=f"{wall:.3f}")
    return dict(changed=n_changed)


def multitask_run(dev, out_dir: str) -> dict:
    """Phase 14: opt/MultiTask/default.yaml copied into out_dir with only
    Log.outputs_dir and the data path (made absolute) changed, through
    the MultiTask command in this process: both experiments finish, each
    writes a performance.csv of a finite PSNR, the train kernel launches
    once a step of each, the grid kernel at SingleTask's checkpoint, and
    temp_opt_* is gone.  Fails the run on any miss."""
    import torch
    from brief_pytorch_tpu_torch.cli import multitask
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.ops import fused_decode, fused_train
    opt = cfglib.load(MULTITASK)
    opt.Static.Log.outputs_dir = os.path.join(out_dir, "outputs")
    opt.Static.Dataset.data_path = FIXTURE
    grid = opt.Dynamic[0].PRODUCT
    grid[0].CONCAT[0]["Dataset.data_path"] = FIXTURE
    steps = int(grid[0].CONCAT[0]["CompressFramework.Compress.max_steps"])
    projects = [e["Log.project_name"] for e in grid[1].CONCAT]
    path = os.path.join(out_dir, "default.yaml")
    cfglib.save(opt, path)
    fused_train.launches = fused_decode.launches = 0
    t0 = time.perf_counter()
    queue = multitask.main(["-p", path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_train": fused_train.launches,
                "fused_decode": fused_decode.launches}
    runs = sorted(os.listdir(os.path.join(out_dir, "outputs")))
    # Log.time: true appends the start time to each run dir's name
    psnr = {p: last_psnr(os.path.join(out_dir, "outputs", d))
            for p in projects for d in runs if d.startswith(p + "_")}
    left = [d for d in os.listdir(out_dir) if d.startswith("temp_opt_")]
    if [t.status for t in queue.task_list] != ["finish"] * 2 or left or \
            launches["fused_train"] != 2 * steps or \
            launches["fused_decode"] < 1 or len(psnr) != len(projects) or \
            not all(math.isfinite(v) for v in psnr.values()):
        fail(f"multitask: statuses {[t.status for t in queue.task_list]}, "
             f"launches {launches} ({steps} steps each), PSNR {psnr}, "
             f"left {left}")
    say("14-multitask", experiments=len(projects), steps=steps,
        launches=json.dumps(launches),
        **{f"psnr_{p}": f"{v:.3f}" for p, v in psnr.items()},
        temp_opt_left=len(left), wall_s=f"{wall:.3f}")
    return dict(launches=launches, psnr=psnr, wall_s=wall)


def sizing_width(phi: dict, budget: float) -> int:
    """The SIREN width models/sizing gives `phi` at `budget` bytes."""
    from brief_pytorch_tpu_torch.models import sizing
    return int(sizing.estimate_module_size(budget, {"name": "SIREN", **phi},
                                           False)[0])


def media_files(out_dir: str) -> dict:
    """Phase 15's inputs, written by the port's save_img into out_dir: a
    2048 x 2048 uint16 PNG, the 4 x 4 mosaic of planes 0, 4, ..., 60 of
    the HiP-CT demo volume; and 64 frames of 512 x 512 x 3 uint8 (B, G, R:
    the top bytes of HiP-CT plane z, vessel plane z and HiP-CT plane
    63 - z) as MP4.  Returns their paths and raw (uncompressed) bytes."""
    from brief_pytorch_tpu_torch.io.image import read_img, save_img
    hip = read_img(HIPCT)[..., 0]
    ves = read_img(VESSEL)[..., 0]
    tiles = [hip[4 * k] for k in range(16)]
    mosaic = np.block([tiles[4 * i:4 * i + 4] for i in range(4)])[..., None]
    png = os.path.join(out_dir, "hipct-mosaic-2048.png")
    save_img(png, mosaic)
    top = lambda a: (a >> 8).astype(np.uint8)
    frames = np.stack([top(hip), top(ves), top(hip[::-1])], axis=-1)
    mp4 = os.path.join(out_dir, "hipct-vessel-64.mp4")
    save_img(mp4, frames)
    back = read_img(mp4)
    if back.shape != frames.shape or back.dtype != np.uint8:
        fail(f"mp4: wrote {frames.shape}, read back {back.shape} "
             f"{back.dtype}")
    if not np.array_equal(read_img(png), mosaic):
        fail("png: the mosaic does not read back equal")
    return {"png": png, "png_raw": mosaic.nbytes, "mp4": mp4,
            "mp4_raw": frames.nbytes}


def media_config(kind: str) -> dict:
    """Phase 15's overrides of opt/SingleTask/default.yaml: two
    coordinates (PNG) or three channels of uint8 (MP4); the budget is 80x
    of the raw pixels (given_size), since the files are compressed."""
    if kind == "png":
        return {"phi": {"coords_channel": 2},
                "compress": {"sampler": {"cube_len": [10000000] * 2},
                             "preprocess": {"denoise": {"close": [2, 2]}}},
                "decompress": {"postprocess": {"denoise": {"close": [2, 2]}}}}
    return {"phi": {"data_channel": 3},
            "compress": {"preprocess": {"clip": [0, 255]},
                         "loss": {"weight": ["value_255_255_1"],
                                  "weight_thres": 255}},
            "decompress": {"postprocess": {"clip": [0, 255]}}}


def media_run(dev, out_dir: str, kind: str, path: str, raw_bytes: int,
              steps: int) -> dict:
    """Phase 15 (a) or (c): the SingleTask command on the PNG or the MP4,
    on the kernels and through autograd: one train launch a step, the
    decode kernel (its own count) in the checkpoint and in the standalone
    NFGR.decompress, whose image equals the checkpoint's, PSNR within
    DEMO_AUTOGRAD_DB of autograd's, cal_ms_ssim on the card within 2e-4 of
    its value on the CPU.  Fails the run on any miss."""
    import torch
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.eval.metrics import cal_ms_ssim
    from brief_pytorch_tpu_torch.io.image import read_img, save_img
    from brief_pytorch_tpu_torch.ops import fused_decode, fused_train
    from brief_pytorch_tpu_torch.train.fit import NFGR
    mc = media_config(kind)
    comp_over = {**mc["compress"], "param": {"filesize_ratio": 0,
                                             "given_size": raw_bytes / 80}}
    runs = {}
    for fused in (True, False):
        fused_train.launches = 0
        k0 = fused_decode.kernels_launched()
        t0 = time.perf_counter()
        summary, run_dir, opt = run_config(
            CONFIG, out_dir, steps, path, fused_train=fused, phi=mc["phi"],
            project=f"media_{kind}" + ("" if fused else "_autograd"),
            compress=comp_over,
            decompress=mc["decompress"])
        torch.cuda.synchronize()
        runs[fused] = dict(summary=summary, run_dir=run_dir, opt=opt,
                           wall=time.perf_counter() - t0,
                           train_launches=fused_train.launches,
                           decode_kernels=fused_decode.kernels_launched()
                           - k0)
    r = runs[True]
    cf = r["opt"].CompressFramework
    with np.load(os.path.join(r["run_dir"], "trainstate.npz")) as z:
        sampler = json.loads(bytes(z["fingerprint"]).decode())["sampler"]
    comp = os.path.join(r["run_dir"], f"steps{steps}", "compressed")
    side = cfglib.load(os.path.join(comp, "sideinfos.yaml"))
    k0 = fused_decode.kernels_launched()
    dec = NFGR.decompress(cf, os.path.join(comp, "module"),
                          os.path.join(comp, "sideinfos.yaml"), device=dev)
    standalone_kernels = fused_decode.kernels_launched() - k0
    ext = os.path.splitext(path)[1]
    stem = os.path.basename(path)[:-len(ext)]
    ck_path = os.path.join(r["run_dir"], f"steps{steps}", "decompressed",
                           f"{stem}_decompressed{ext}")
    if ext == ".mp4":    # a lossy file: compare the same codec's output
        mine = os.path.join(out_dir, f"standalone{ext}")
        save_img(mine, dec)
        same = np.array_equal(read_img(mine), read_img(ck_path))
    else:
        same = np.array_equal(dec, read_img(ck_path))
    orig = read_img(path)
    drange = float(np.iinfo(orig.dtype).max)
    t0 = time.perf_counter()
    ms_card = cal_ms_ssim(orig, dec, drange, device=dev)
    ms_card_s = time.perf_counter() - t0
    ms_cpu = cal_ms_ssim(orig, dec, drange, device="cpu")
    psnr, psnr_a = last_psnr(r["run_dir"]), last_psnr(runs[False]["run_dir"])
    widths = [int(cf.Module.phi.coords_channel)] + \
        [int(side["phi_features"])] * 4 + [int(cf.Module.phi.data_channel)]
    train_s = r["summary"]["train_s"]
    say(f"15-media-{kind}", shape=list(orig.shape), dtype=str(orig.dtype),
        steps=steps, widths=widths,
        sampler=repr(sampler), train_launches=r["train_launches"],
        train_launches_autograd=runs[False]["train_launches"],
        decode_kernels_checkpoint=r["decode_kernels"],
        decode_kernels_standalone=standalone_kernels,
        standalone_equals_checkpoint=same, psnr=f"{psnr:.3f}",
        psnr_autograd=f"{psnr_a:.3f}",
        ssim=f"{float(r['summary']['ssim']):.4f}",
        ms_ssim_card=f"{ms_card:.6f}", ms_ssim_cpu=f"{ms_cpu:.6f}",
        ms_ssim_card_s=f"{ms_card_s:.3f}",
        train_s=f"{train_s:.3f}", steps_per_s=f"{steps / train_s:.2f}",
        steps_per_s_autograd=f"{steps / runs[False]['summary']['train_s']:.2f}",
        checkpoint_s=f"{r['summary']['checkpoint_s']:.3f}",
        wall_s=f"{r['wall']:.3f}")
    if r["train_launches"] != steps or runs[False]["train_launches"] or \
            r["decode_kernels"] < 1 or standalone_kernels < 1 or not same:
        fail(f"media {kind}: launches {r['train_launches']} / "
             f"{runs[False]['train_launches']} (want {steps} / 0), decode "
             f"kernels {r['decode_kernels']} / {standalone_kernels}, "
             f"standalone equal {same}")
    if not math.isfinite(psnr) or not abs(psnr - psnr_a) <= DEMO_AUTOGRAD_DB:
        fail(f"media {kind}: PSNR {psnr} on the kernels, {psnr_a} through "
             f"autograd: more than {DEMO_AUTOGRAD_DB} dB apart")
    if not abs(ms_card - ms_cpu) <= 2e-4:
        fail(f"media {kind}: MS-SSIM {ms_card} on the card, {ms_cpu} on "
             "the CPU")
    return dict(widths=widths, psnr=psnr, psnr_autograd=psnr_a,
                ms_ssim=ms_card, ms_ssim_cpu=ms_cpu,
                train_launches=r["train_launches"],
                decode_kernels=r["decode_kernels"] + standalone_kernels,
                steps_per_s=steps / train_s, wall_s=r["wall"])


def within_1lsb(dec, ck) -> tuple:
    """(share of voxels within 1 LSB, the largest difference)."""
    diff = np.abs(dec.astype(np.int64) - ck.astype(np.int64))
    return float((diff <= 1).mean()), int(diff.max())


def divide_decompress(dev, cf, run_dir: str, steps: int, data_path: str):
    """NFGR.decompress_divide of a DivideTask checkpoint against its merged
    decode: (share within 1 LSB, max LSB, decode kernels launched)."""
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.ops import fused_decode
    from brief_pytorch_tpu_torch.train.fit import NFGR
    comp = os.path.join(run_dir, f"steps{steps}", "compressed")
    k0 = fused_decode.kernels_launched()
    dec = NFGR.decompress_divide(
        cf, os.path.join(comp, "sideinfos.yaml"),
        os.path.join(comp, "module"), os.path.join(comp, "sideinfos"),
        device=dev)
    kernels = fused_decode.kernels_launched() - k0
    ext = os.path.splitext(data_path)[1]
    ck = read_img(os.path.join(
        run_dir, f"steps{steps}", "decompressed",
        os.path.basename(data_path)[:-len(ext)] + "_decompressed" + ext))
    if dec.shape != ck.shape:
        fail(f"decompress_divide {run_dir}: {dec.shape} vs {ck.shape}")
    return (*within_1lsb(dec, ck), kernels)


def media_divide_run(dev, out_dir: str, path: str, raw_bytes: int,
                     steps: int) -> dict:
    """Phase 15 (b): the PNG with divide_type total_1_2_2: a fleet of 4
    blocks of 1024^2 on kernel 1's fleet form (one launch a step), the
    four h_*-w_* chunks, decompress_divide within 1 LSB of the merged
    checkpoint on >= 99.9% of pixels."""
    import torch
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.ops import fused_train
    mc = media_config("png")
    comp_over = {**mc["compress"], "divide": {"divide_type": "total_1_2_2"},
                 "param": {"filesize_ratio": 0, "given_size": raw_bytes / 80}}
    fused_train.launches = 0
    t0 = time.perf_counter()
    summary, run_dir, opt = run_config(
        CONFIG, out_dir, steps, path, phi=mc["phi"], project="media_divide",
        compress=comp_over, decompress=mc["decompress"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_train.launches
    names = chunk_dirs(run_dir, steps)
    within, max_lsb, kernels = divide_decompress(
        dev, opt.CompressFramework, run_dir, steps, path)
    want = ["h_0_1023-w_0_1023", "h_0_1023-w_1024_2047",
            "h_1024_2047-w_0_1023", "h_1024_2047-w_1024_2047"]
    psnr = last_psnr(run_dir)
    say("15-media-divide", steps=steps, chunks=names,
        buckets=summary["fleet"], launches=launches,
        decompress_decode_kernels=kernels, within_1lsb=f"{within:.6f}",
        max_lsb=max_lsb, psnr=f"{psnr:.3f}",
        train_s=f"{summary['train_s']:.3f}",
        steps_per_s=f"{steps / summary['train_s']:.2f}", wall_s=f"{wall:.3f}")
    if names != want or summary["fused"] != [True] or launches != steps or \
            within < 0.999 or kernels != 4 or not math.isfinite(psnr):
        fail(f"media divide: chunks {names}, fused {summary['fused']}, "
             f"launches {launches}, {within} within 1 LSB, {kernels} "
             "decode kernels")
    return dict(widths=summary["fleet"][0]["widths"], launches=launches,
                psnr=psnr, within_1lsb=within,
                steps_per_s=steps / summary["train_s"])


def half_run(dev, out_dir: str) -> dict:
    """Phase 16: `half` (bf16 products, float32 sums and parameters).  The
    SingleTask default on the 64^3 fixture, HALF_STEPS steps: neither
    kernel launched, the width of the 2-byte sizing, PSNR within HALF_DB
    of the same steps and the same network in float32 through autograd
    (filesize_ratio 40 at 4 bytes a parameter: half's parameter count, so
    that only the products' precision differs).  Then brain64.yaml,
    HALF_DIVIDE_STEPS steps: finite PSNR, no kernel, decompress_divide
    within 1 LSB of the merged checkpoint on >= 99.9% of voxels."""
    import torch
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.models import sizing
    from brief_pytorch_tpu_torch.ops import fused_decode, fused_train
    out = {}
    for half in (True, False):
        fused_train.launches = 0
        k0 = fused_decode.kernels_launched()
        summary, run_dir, opt = run_config(
            CONFIG, out_dir, HALF_STEPS, FIXTURE, fused_train=half,
            project="half" if half else "float32",
            compress={"half": half}, ratio=80 if half else 40)
        torch.cuda.synchronize()
        comp = os.path.join(run_dir, f"steps{HALF_STEPS}", "compressed")
        out[half] = dict(summary=summary, psnr=last_psnr(run_dir),
                         train=fused_train.launches,
                         decode=fused_decode.kernels_launched() - k0,
                         width=int(cfglib.load(os.path.join(
                             comp, "sideinfos.yaml"))["phi_features"]))
    phi = dict(opt.CompressFramework.Module.phi)
    want = sizing.estimate_module_size(os.path.getsize(FIXTURE) / 80, phi,
                                       True)[0]
    h, f = out[True], out[False]
    fused_train.launches = 0
    k0 = fused_decode.kernels_launched()
    summary_d, run_dir_d, opt_d = run_config(
        os.path.join(DIVIDE, "brain64.yaml"), out_dir, HALF_DIVIDE_STEPS,
        compress={"half": True}, project="half_brain64")
    divide_kernels = (fused_train.launches,
                      fused_decode.kernels_launched() - k0)
    psnr_d = last_psnr(run_dir_d)
    within, max_lsb, _ = divide_decompress(
        dev, opt_d.CompressFramework, run_dir_d, HALF_DIVIDE_STEPS, FIXTURE)
    say("16-half", steps=HALF_STEPS, width=h["width"], width_float32=f["width"],
        train_launches=h["train"], decode_kernels=h["decode"],
        psnr=f"{h['psnr']:.3f}", psnr_float32_autograd=f"{f['psnr']:.3f}",
        gap_db=f"{h['psnr'] - f['psnr']:.3f}", half_db=HALF_DB,
        steps_per_s=f"{HALF_STEPS / h['summary']['train_s']:.2f}",
        steps_per_s_float32_autograd=
        f"{HALF_STEPS / f['summary']['train_s']:.2f}",
        brain64_steps=HALF_DIVIDE_STEPS, brain64_psnr=f"{psnr_d:.3f}",
        brain64_kernels=list(divide_kernels),
        brain64_within_1lsb=f"{within:.6f}", brain64_max_lsb=max_lsb)
    if h["train"] or h["decode"] or h["width"] != want or f["train"] or \
            f["width"] != want or any(divide_kernels):
        fail(f"half: launches {h['train']} / {h['decode']} (want 0 / 0), "
             f"width {h['width']} (want {want}), float32 autograd "
             f"{f['train']}, brain64 {divide_kernels}")
    if not abs(h["psnr"] - f["psnr"]) <= HALF_DB:
        fail(f"half: PSNR {h['psnr']} in bf16, {f['psnr']} in float32: "
             f"more than {HALF_DB} dB apart")
    if not math.isfinite(psnr_d) or within < 0.999:
        fail(f"half brain64: PSNR {psnr_d}, {within} within 1 LSB")
    return dict(width=h["width"], psnr=h["psnr"], psnr_float32=f["psnr"],
                brain64_psnr=psnr_d, brain64_within_1lsb=within)


def exception_config(out_dir: str) -> tuple:
    """hipct.yaml with an exception for the block by_var gives 66
    features: lr_phi 0.0005 and half of max_steps.  Returns (yaml path,
    the block's name)."""
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.parallel.divide_runner import (
        param_budget, plan_blocks)
    from brief_pytorch_tpu_torch.post.preprocess import preprocess
    opt = cfglib.load(os.path.join(DIVIDE, "hipct.yaml"))
    c = opt.CompressFramework
    pre = c.Compress.preprocess
    data = preprocess(read_img(HIPCT), pre.denoise.level, pre.denoise.close,
                      pre.clip)
    _, blocks, _ = plan_blocks(c, data, param_budget(c.Compress, HIPCT))
    name = [b["name"] for b in blocks
            if b["sideinfos"]["phi_features"] == max(FLEET_WIDTHS)][0]
    c.Compress.divide.exception = {name: {"Compress": {
        "lr_phi": 0.0005, "max_steps": EXCEPTION_STEPS // 2}}}
    path = os.path.join(out_dir, "hipct_exception.yaml")
    cfglib.save(opt, path)
    return path, name


def exception_run(dev, out_dir: str) -> dict:
    """Phase 17 (a): hipct.yaml with exception_config's step-level
    exception, EXCEPTION_STEPS steps: the exception's block trains solo on
    kernel 1's one-chain form (NFGR._fused_step), the other three on the
    tiled fleet layout (one launch a step each); the solo block's steps at
    the checkpoint are the proportional target; decompress_divide within
    1 LSB on >= 99.9% of voxels; preempted at half and resumed, the weight
    binaries equal the uninterrupted run's byte for byte (resume_run)."""
    import torch
    from brief_pytorch_tpu_torch.ops import fused_train
    from brief_pytorch_tpu_torch.train.fit import NFGR
    path, name = exception_config(out_dir)
    solo_calls = [0]
    step = NFGR._fused_step

    def counted(*a, **kw):
        solo_calls[0] += 1
        return step(*a, **kw)

    NFGR._fused_step = staticmethod(counted)
    try:
        fused_train.launches = 0
        t0 = time.perf_counter()
        summary, run_dir, opt = run_config(path, out_dir, EXCEPTION_STEPS,
                                           HIPCT, project="exception")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fleet": fused_train.launches - solo_calls[0],
                    "solo": solo_calls[0]}
    finally:
        NFGR._fused_step = staticmethod(step)
    with np.load(os.path.join(run_dir, "trainstate_fleet.npz")) as z:
        solo_done = int(z["s0done"])
        fp = json.loads(bytes(z["fingerprint"]).decode())
    within, max_lsb, kernels = divide_decompress(
        dev, opt.CompressFramework, run_dir, EXCEPTION_STEPS, HIPCT)
    target = round(EXCEPTION_STEPS * (EXCEPTION_STEPS // 2) / EXCEPTION_STEPS)
    psnr = last_psnr(run_dir)
    say("17-exception", block=name, steps=EXCEPTION_STEPS,
        buckets=summary["fleet"], solo=summary["solo"],
        launches=json.dumps(launches), solo_steps=solo_done,
        solo_target=target, solo_fused=fp["solo_fused"],
        within_1lsb=f"{within:.6f}", max_lsb=max_lsb,
        decompress_decode_kernels=kernels, psnr=f"{psnr:.3f}",
        train_s=f"{summary['train_s']:.3f}", wall_s=f"{wall:.3f}")
    if launches != {"fleet": EXCEPTION_STEPS, "solo": target} or \
            solo_done != target or summary["fused"] != [True] or \
            fp["solo_fused"] != [True] or len(summary["solo"]) != 1 or \
            summary["fleet"][0]["blocks"] != 3 or within < 0.999 or \
            not math.isfinite(psnr):
        fail(f"exception: launches {launches}, solo at {solo_done} (want "
             f"{target}), fused {summary['fused']} / {fp['solo_fused']}, "
             f"{within} within 1 LSB")
    resumed = resume_run(dev, out_dir, "exception", path, EXCEPTION_STEPS,
                         HIPCT, per_step=1.5)
    return dict(launches=launches, solo_steps=solo_done, psnr=psnr,
                within_1lsb=within, resume=resumed)


def gather_run(dev, out_dir: str, label: str, compress: dict, psnr7: float,
               steps_per_s7: float, bytes7: int) -> dict:
    """Phase 17 (b) or (c): hipct.yaml verbatim but for `compress`,
    HIPCT_STEPS steps on the fleet kernel: PSNR within HIPCT_AUTOGRAD_DB
    of phase 7's run; steps/s and the stack's resident bytes beside
    phase 7's."""
    import torch
    from brief_pytorch_tpu_torch.ops import fused_train
    fused_train.launches = 0
    t0 = time.perf_counter()
    summary, run_dir, _ = run_config(
        os.path.join(DIVIDE, "hipct.yaml"), out_dir, HIPCT_STEPS, HIPCT,
        project=label, compress=compress)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    psnr = last_psnr(run_dir)
    bucket = summary["fleet"][0]
    sps = HIPCT_STEPS / summary["train_s"]
    say(f"17-{label}", steps=HIPCT_STEPS, launches=fused_train.launches,
        data_dtype=bucket["data_dtype"], data_bytes=bucket["data_bytes"],
        data_bytes_phase7=bytes7, vector_len=bucket["vector_len"],
        psnr=f"{psnr:.3f}", psnr_phase7=f"{psnr7:.3f}",
        steps_per_s=f"{sps:.2f}", steps_per_s_phase7=f"{steps_per_s7:.2f}",
        wall_s=f"{wall:.3f}")
    if fused_train.launches != HIPCT_STEPS or summary["fused"] != [True] or \
            not abs(psnr - psnr7) <= HIPCT_AUTOGRAD_DB:
        fail(f"{label}: launches {fused_train.launches}, fused "
             f"{summary['fused']}, PSNR {psnr} vs phase 7's {psnr7}")
    return dict(psnr=psnr, steps_per_s=sps, data_dtype=bucket["data_dtype"],
                data_bytes=bucket["data_bytes"],
                vector_len=bucket["vector_len"])


def short_kernel(name: str) -> str:
    """A CUDA kernel's name without its namespace and launch wrapper,
    keeping the functor that tells torch's elementwise kernels apart."""
    for prefix in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(prefix, "")
    return name[:160]


def nflr_point(dev, out_dir: str, variant: str, steps: int,
               sga_steps: int) -> tuple:
    """One NFLR RD point on the fixture at the RD script's widths:
    (framework, row).  Fails unless the decode from memory equals the
    decode from the file and the PSNR is finite."""
    from brief_pytorch_tpu_torch.nflr.framework import init_compressframework
    from brief_pytorch_tpu_torch.nflr.rd import (rd_opt, rd_point,
                                                 train_on_volume)
    opt = rd_opt(variant, steps=steps, sga_steps=sga_steps,
                 Lambda=NFLR_LAMBDA)
    fw = init_compressframework(opt, device=dev)
    t0 = time.perf_counter()
    timing, losses = train_on_volume(fw, FIXTURE, steps, log=None)
    t1 = time.perf_counter()
    point = rd_point(fw, FIXTURE, os.path.join(out_dir, variant + ".zip"))
    compress_s = time.perf_counter() - t1
    if not point["bits_roundtrip_equal"] or \
            not math.isfinite(point["psnr_uint16"]):
        fail(f"nflr {variant}: decode from memory equals the file's: "
             f"{point['bits_roundtrip_equal']}, PSNR {point['psnr_uint16']}")
    row = {k: point[k] for k in ("file_bytes", "bits_per_voxel",
                                 "psnr_uint16")}
    row.update(steps=steps, sga_steps=sga_steps, train_s=t1 - t0,
               compress_s=compress_s, first_loss=losses[0][1],
               last_loss=losses[-1][1], path=os.path.join(
                   out_dir, variant + ".zip"),
               **{k: v for k, v in timing.items()
                  if k not in ("steps", "wall_s")})
    return fw, point, row


def cpu_decode(fw, comp: str) -> dict:
    """The card's archive decoded by a CPU framework on the same weights:
    are the latents the same, and how far is the volume.  A hyperprior
    archive's CPU decode may not decode at all (gy's scales on the CPU
    can pick another table than on the card): that ValueError is
    reported as `error`, a measurement; callers that need the decode
    check `same_latents`."""
    from brief_pytorch_tpu_torch.nflr.framework import init_compressframework
    cpu = init_compressframework(fw.opt, device="cpu")
    cpu._load_state_dict(fw._state_dict())
    y_card, _ = fw.decompressing_data(comp, None)
    try:
        y_cpu, _ = cpu.decompressing_data(comp, None)
    except ValueError as e:
        return {"same_latents": False, "error": str(e)[:100]}
    same = bool(np.array_equal(y_card, y_cpu))
    within, max_lsb = within_1lsb(cpu.decompress(compressed_data_path=comp),
                                  fw.decompress(compressed_data_path=comp))
    return {"same_latents": same,
            "latents_equal_share": float((y_card == y_cpu).mean()),
            "latents_max_abs_diff": float(np.abs(y_card - y_cpu).max()),
            "within_1lsb": within, "max_lsb": max_lsb}


def rans_check(fw, compressed: dict) -> dict:
    """18a's streams (z: factorized, y: Gaussian) decoded to their symbols,
    re-encoded by the native backend and by the pure-Python codec: the
    same bytes as the streams, and the same symbols back from both."""
    import struct
    from brief_pytorch_tpu_torch.nflr import entropy as em
    from brief_pytorch_tpu_torch.nflr import rans
    side = compressed["sideinfos"]
    z_tables = em.factorized_build_tables(fw.params["emz"])
    spatial = int(np.prod(side["z_shape"]))
    z_ch = np.repeat(np.arange(len(z_tables["cdfs"])), spatial)
    z = em.factorized_decompress(fw.params["emz"], z_tables,
                                 compressed["z_strings"], side["z_shape"])
    scales, _ = fw._scales_means(z)
    g = fw._gaussian_tables()
    y_idx = em.build_indexes(scales, g.scale_table)[0].ravel()
    n_sym = 0
    t_py = t_native = 0.0
    for data, cdfs, ch in ((compressed["z_strings"][0], z_tables["cdfs"],
                            z_ch),
                           (compressed["y_strings"][0], g.cdfs, y_idx)):
        (n,) = struct.unpack("<I", data[:4])
        blob = data[4:4 + n]
        sym = rans.decode_per_channel(blob, cdfs, ch)
        t0 = time.perf_counter()
        py = rans._encode_per_channel_py(sym, cdfs, ch)
        t1 = time.perf_counter()
        native = rans._native_encode(sym, cdfs, ch)
        t2 = time.perf_counter()
        t_py += t1 - t0
        t_native += t2 - t1
        back = rans._decode_per_channel_py(blob, cdfs, ch)
        if py != blob or native != blob or not np.array_equal(back, sym):
            fail(f"rANS: native and pure-Python bytes differ on 18a's "
                 f"symbols ({len(sym)} symbols)")
        n_sym += len(sym)
    return {"backend": rans.backend(), "symbols": n_sym,
            "python_encode_s": t_py, "native_encode_s": t_native}


def nflr_resume(dev, out_dir: str) -> dict:
    """18c: the Hyper auto-decoder through train(), NFLR_RESUME_STEPS steps
    with a state every half: A preempted right after its state at half, B
    uninterrupted, C = A resumed.  C's trained module and trainstate.npz
    must equal B's byte for byte."""
    import torch
    from brief_pytorch_tpu_torch.nflr.framework import init_compressframework
    from brief_pytorch_tpu_torch.nflr.rd import rd_opt
    from brief_pytorch_tpu_torch.train import checkpoint as ckpt
    steps, half = NFLR_RESUME_STEPS, NFLR_RESUME_STEPS // 2
    data = os.path.join(out_dir, "resume_data")
    os.makedirs(data, exist_ok=True)
    shutil.copy(FIXTURE, data)

    def opt(resume=None):
        o = rd_opt("NFLR_Coding_Hyper_AutoDecoder", steps=steps,
                   sga_steps=NFLR_SHORT["sga"], Lambda=NFLR_LAMBDA)
        o.Train.update(train_data_dir=data, val_data_dir=data,
                       state_every_n_step=half)
        if resume:
            o.Train.resume = resume
        return o

    runs = {t: os.path.join(out_dir, f"resume_{t}") for t in "ABC"}
    write = ckpt.atomic_savez

    def preempting(path, arrs):
        write(path, arrs)
        raise Preempted

    ckpt.atomic_savez = preempting
    try:
        init_compressframework(opt(), device=dev).train(runs["A"])
        fail(f"nflr resume: run A was not preempted at step {half}")
    except Preempted:
        pass
    finally:
        ckpt.atomic_savez = write
    t0 = time.perf_counter()
    init_compressframework(opt(), device=dev).train(runs["B"])
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    init_compressframework(opt(runs["A"]), device=dev).train(runs["A"])
    module = os.path.join("trained_module", f"epoch_{steps - 1}_step_"
                          f"{steps}.pt")
    with open(os.path.join(runs["A"], module), "rb") as f, \
            open(os.path.join(runs["B"], module), "rb") as g:
        same_module = f.read() == g.read()
    with np.load(os.path.join(runs["A"], "trainstate.npz")) as za, \
            np.load(os.path.join(runs["B"], "trainstate.npz")) as zb:
        differ = sorted(k for k in za.files
                        if k not in zb.files or not np.array_equal(za[k],
                                                                   zb[k]))
        same_state = sorted(za.files) == sorted(zb.files) and not differ
        stored = int(za["step"])
    if not (same_module and same_state and stored == steps):
        fail(f"nflr resume: module equal {same_module}, state equal "
             f"{same_state} (leaves differing: {differ[:12]}), stored step "
             f"{stored}")
    return {"steps": steps, "preempted_at": half, "bitwise_equal": True,
            "uninterrupted_wall_s": wall_b, "leaves": len(za.files)}


def nflr_phase(dev, out_dir: str) -> dict:
    """Phase 18: 18a, 18b, 18c, 18d (see the module docstring)."""
    import torch
    from brief_pytorch_tpu_torch.eval.metrics import cal_ssim
    from brief_pytorch_tpu_torch.ops import (fused_decode, fused_siren,
                                             fused_train)
    fused_train.launches = fused_decode.launches = fused_siren.launches = 0
    rows = {}
    fw, point, row = nflr_point(dev, out_dir, "NFLR_Coding_Hyper_AutoDecoder",
                                NFLR_STEPS["train"], NFLR_STEPS["sga"])
    row["ssim"] = cal_ssim(point["orig"], np.moveaxis(point["decoded"][0],
                                                       0, -1), 65535,
                           device=dev)
    rows["NFLR_Coding_Hyper_AutoDecoder"] = row
    say("18a-nflr", variant="NFLR_Coding_Hyper_AutoDecoder",
        **{k: (f"{v:.6g}" if isinstance(v, float) else v)
           for k, v in row.items() if k not in ("kernels", "path")},
        psnr_floor=NFLR_PSNR_FLOOR,
        top_kernels=json.dumps({short_kernel(k): round(v, 4) for k, v in
                                row.get("kernels", {}).items()}))
    if not row["last_loss"] < row["first_loss"]:
        fail(f"nflr 18a: the loss did not fall: {row['first_loss']} -> "
             f"{row['last_loss']}")
    if not row["psnr_uint16"] > NFLR_PSNR_FLOOR:
        fail(f"nflr 18a: PSNR {row['psnr_uint16']} not above the floor "
             f"{NFLR_PSNR_FLOOR}")
    row["cpu_decode"] = cpu_decode(fw, row["path"])
    say("18a-nflr-cpu-decode", **row["cpu_decode"])
    rans_row = rans_check(fw, point["compressed"])
    say("18d-rans", **rans_row, bytes_equal=True)
    del fw, point
    for variant in ("NFLR_AutoDecoder", "NFLR_AutoEncoder",
                    "NFLR_Coding_AutoDecoder", "NFLR_Coding_AutoEncoder",
                    "NFLR_Coding_Hyper_AutoEncoder"):
        fw, point, row = nflr_point(dev, out_dir, variant,
                                    NFLR_SHORT["train"], NFLR_SHORT["sga"])
        say("18b-nflr", variant=variant,
            **{k: (f"{v:.6g}" if isinstance(v, float) else v)
               for k, v in row.items() if k not in ("kernels", "path")})
        if "Coding" in variant:
            row["cpu_decode"] = cpu_decode(fw, row["path"])
        if variant == "NFLR_Coding_AutoDecoder":
            cd = row["cpu_decode"]
            if not cd["same_latents"] or cd.get("within_1lsb", 0) < 0.999:
                fail(f"nflr 18b: the card's factorized archive decoded on "
                     f"the CPU: {cd}")
        rows[variant] = row
        if "cpu_decode" in row:
            say("18b-nflr-cpu-decode", variant=variant, **row["cpu_decode"])
        del fw, point
    resume = nflr_resume(dev, out_dir)
    say("18c-nflr-resume", **resume)
    torch.cuda.synchronize()
    launched = {"fused_train": fused_train.launches,
                "fused_decode": fused_decode.launches,
                "fused_siren": fused_siren.launches}
    if any(launched.values()):
        fail(f"phase 18 launched kernels 1-3: {launched}")
    return {"rows": rows, "resume": resume, "rans": rans_row,
            "kernel_launches": launched}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL torch.cuda.is_available() is false", flush=True)
        return 2
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.ops import (build, fused_decode, fused_siren,
                                             fused_train)
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
    flops1 = train_flops(widths, acts, n)
    bytes1 = 4 * (n * (3 + 1 + 1) + 2 * (sum(l["w"].numel() + l["b"].numel()
                                             for l in layers) + 1))
    b1, by1 = bound_ms(bytes1, flops1)
    tc1 = train_tc_bound_ms(widths, acts, n, bytes1)
    layout1 = fused_train.choose_plan(widths)["layout"]
    if layout1 != "narrow":
        fail(f"fused_train {widths}: layout {layout1}, not narrow")
    say("3-fused_train", case="default", n=n, widths=widths, layout=layout1,
        max_abs_err=f"{err1:.3e}", ms=f"{ms1:.4f}", plain_ms=f"{plain1:.4f}",
        bound_ms=f"{b1:.4f}", bound_by=by1, tc_bound_ms=f"{tc1:.4f}",
        tolerance="loss rel 1e-5; grads 1e-4*max|plain|+1e-6")
    train_rows = {label: chain_check(dev, label, cfg3, n, layout3, kw)
                  for label, cfg3, layout3 in TRAIN_CASES}

    # ---- 4. kernel 2: grid decode, 64^3 (main path) and 256^3 at 5 x 22,
    # the widest HiP-CT chunk of phase 7, and the wide form on the demo
    # volumes' 64x512x512 grid at phase 12's widths ----
    dec_cases = [(64, "narrow", (64, 64, 64), layers, acts),
                 (256, "narrow", (256, 256, 256), layers, acts)]
    hmodel = init_phi({**phi, "features": max(FLEET_WIDTHS), "layers": 7,
                       "w0": 10})
    dec_cases.append(("hipct", "narrow", (64, 256, 256), hmodel.init(
        torch.Generator().manual_seed(4), dev)["layers"],
                      chain_layer_specs(hmodel.spec)))
    for _, _, f in DEMO_RUNS:
        dmodel = init_phi({**phi, "features": f})
        dec_cases.append((f, "wide", (64, 512, 512), dmodel.init(
            torch.Generator().manual_seed(3), dev)["layers"],
                          chain_layer_specs(dmodel.spec)))
    dec_rows = {}
    for key, form, spatial, dlayers, dacts in dec_cases:
        wide_case = form == "wide"
        dec_rows[key] = decode_check(dev, str(key), spatial, dlayers, dacts,
                                     reps=10 if wide_case else 25,
                                     plain_reps=3 if wide_case else 20)
        if dec_rows[key]["layout"] != form:
            fail(f"fused_decode {key}: layout {dec_rows[key]['layout']}, "
                 f"not {form}")

    # ---- 5. the SingleTask command on the 64^3 fixture ----
    from brief_pytorch_tpu_torch.cli import main as cli
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.train.fit import NFGR

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    archive5 = tempfile.mkdtemp(prefix="chip_smoke_archive_")   # for phase 10
    atexit.register(shutil.rmtree, archive5, ignore_errors=True)
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
        shutil.copytree(comp, os.path.join(archive5, "compressed"))
        cf5 = c
        # kernel 2 on the trained chain of this run (phase 4's checks)
        model5, params5, _ = load_archive(dev, c, comp)
        dec_rows["trained"] = decode_check(
            dev, "trained", (64, 64, 64), params5["layers"],
            chain_layer_specs(model5.spec), c.Compress.coords_mode)
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

    # ---- 6. kernel 1, fleet form, at the fleets' shapes of phases 7, 8 ----
    hip_row = fleet_check(dev, rng, FLEET_WIDTHS, 7, 10.0, FLEET_N,
                          [60.0, -math.inf, 40.0, -math.inf], "tiled")
    b64_row = fleet_check(dev, rng, BRAIN64_WIDTHS, 5, 20.0, BRAIN64_N,
                          [60.0, -math.inf] * 4, "narrow")
    wfleet_row = fleet_check(dev, rng, WIDE_FLEET_WIDTHS, 7, 10.0,
                             WIDE_FLEET_N, [60.0, -math.inf, 40.0, -math.inf],
                             "wide")

    # the wide one-chain layout at phase 12's chains: the SingleTask
    # default on the demo volumes at 80x and 50x, default.yaml's N
    wide_rows = {}
    wrng = np.random.default_rng(12)
    to_dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    wc = to_dev(wrng.uniform(-1, 1, (3, DEMO_N)))
    wv = to_dev(wrng.uniform(0, 100, (1, DEMO_N)))
    ww = to_dev(wrng.uniform(1, 2, (1, DEMO_N)))
    for _, _, f in DEMO_RUNS:
        wmodel = init_phi({**phi, "features": f})
        wlayers = wmodel.init(torch.Generator().manual_seed(1),
                              dev)["layers"]
        wacts = chain_layer_specs(wmodel.spec)
        wwidths = [3] + [int(l["w"].shape[1]) for l in wlayers]
        wplan = fused_train.choose_plan(wwidths)
        if wplan is None or wplan["layout"] != "wide" or \
                not fused_train.supports_training(wmodel, "datal2"):
            fail(f"chain {wwidths}: no wide-layout plan ({wplan})")

        def kwide():
            return fused_train.fused_train_grads(wlayers, wc, wv, ww, wacts,
                                                 **kw)

        def pwide():
            return fused_train.fused_train_grads_reference(
                wlayers, wc, wv, ww, wacts, **kw)

        (lk, gk), (lp, gp) = kwide(), pwide()
        torch.cuda.synchronize()
        errw = compare_grads(lk[None], [{k: v[None] for k, v in g.items()}
                                        for g in gk["layers"]], lp[None],
                             [{k: v[None] for k, v in g.items()}
                              for g in gp["layers"]], f"wide chain {wwidths}")
        for lr, gr in [kwide() for _ in range(2)]:
            if not torch.equal(lr, lk) or not all(
                    torch.equal(x[k], y[k]) for x, y in
                    zip(gr["layers"], gk["layers"]) for k in ("w", "b")):
                fail(f"wide chain {wwidths}: runs differ bitwise")
        del gk, gp
        msw = time_ms(kwide)
        plainw = time_ms(pwide, reps=5)
        bw, byw = bound_ms(4 * (DEMO_N * 5 + 2 * sum(
            l["w"].numel() + l["b"].numel() for l in wlayers) + 1),
            train_flops(wwidths, wacts, DEMO_N))
        wide_rows[f] = dict(shape=f"SIREN {wwidths}, N={DEMO_N}",
                            layout="wide", tile=wplan["block"],
                            max_abs_err=errw, ms=msw, plain_ms=plainw,
                            bound_ms=bw, bound_by=byw)
        say("6-fused_train_wide", widths=wwidths, n=DEMO_N,
            tile=wplan["block"], smem_bytes=wplan["smem_bytes"],
            max_abs_err=f"{errw:.3e}", ms=f"{msw:.4f}",
            plain_ms=f"{plainw:.4f}", bound_ms=f"{bw:.4f}", bound_by=byw,
            tolerance="loss rel 1e-5; grads 1e-4*max|plain|+1e-6; 3 runs "
                      "bitwise")

    # ---- 7. the DivideTask command on the HiP-CT config ----
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_divide_")
    try:
        data_path = HIPCT
        fused_train.launches = 0
        fused_decode.launches = 0
        t0 = time.perf_counter()
        summary7, run_dir, opt7 = run_config(
            os.path.join(DIVIDE, "hipct.yaml"), out_dir, HIPCT_STEPS,
            data_path)
        torch.cuda.synchronize()
        wall7 = time.perf_counter() - t0
        launches7 = {"fused_train": fused_train.launches,
                     "fused_decode": fused_decode.launches}
        padded7 = summary7["fleet"][0]["widths"]
        if launches7["fused_train"] != HIPCT_STEPS or \
                summary7["fused"] != [True] or padded7 != hip_row["padded"]:
            fail(f"hipct: launches {launches7}, fused buckets "
                 f"{summary7['fused']}, widths {padded7} (want "
                 f"{HIPCT_STEPS}, [True], {hip_row['padded']})")
        names = chunk_dirs(run_dir, HIPCT_STEPS)
        comp = os.path.join(run_dir, f"steps{HIPCT_STEPS}", "compressed")
        feats = [int(cfglib.load(os.path.join(
            comp, "sideinfos", nm, "sideinfos.yaml"))["phi_features"])
            for nm in names]
        if sorted(feats) != sorted(FLEET_WIDTHS):
            fail(f"hipct: chunks {names} with widths {feats}, not phase "
                 f"6's {FLEET_WIDTHS}")
        fused_decode.launches = 0
        dec = NFGR.decompress_divide(
            opt7.CompressFramework, os.path.join(comp, "sideinfos.yaml"),
            os.path.join(comp, "module"), os.path.join(comp, "sideinfos"),
            device=dev)
        decode_launches7 = fused_decode.launches
        ck = read_img(os.path.join(run_dir, f"steps{HIPCT_STEPS}",
                                   "decompressed", os.path.basename(
                                       data_path).replace(".tif",
                                                          "_decompressed.tif")))
        diff = np.abs(dec.astype(np.int64) - ck.astype(np.int64))
        within = float((diff <= 1).mean())
        if decode_launches7 != len(names) or dec.shape != ck.shape or \
                within < 0.999:
            fail(f"hipct decompress_divide: {decode_launches7} decode "
                 f"launches for {len(names)} chunks, shape {dec.shape} vs "
                 f"{ck.shape}, {within:.6f} of voxels within 1 LSB")
        psnr7 = last_psnr(run_dir)
        train7 = summary7["train_s"]
        # the same run through autograd (stacked_apply), the same draws
        fused_train.launches = 0
        summary7a, run_dir7a, _ = run_config(
            os.path.join(DIVIDE, "hipct.yaml"), out_dir, HIPCT_STEPS,
            data_path, fused_train=False)
        psnr7a = last_psnr(run_dir7a)
        if summary7a["fused"] != [False] or fused_train.launches:
            fail(f"hipct autograd run: fused {summary7a['fused']}, "
                 f"{fused_train.launches} kernel launches")
        say("7-divide-hipct", steps=HIPCT_STEPS, chunks=len(names),
            widths=feats, padded=padded7,
            launches=json.dumps(launches7),
            decompress_decode_launches=decode_launches7,
            within_1lsb=f"{within:.6f}", max_lsb=int(diff.max()),
            psnr=f"{psnr7:.3f}", psnr_floor=HIPCT_PSNR_FLOOR,
            psnr_autograd=f"{psnr7a:.3f}",
            psnr_autograd_margin=HIPCT_AUTOGRAD_DB,
            ssim=f"{float(summary7['ssim']):.4f}",
            ssim_autograd=f"{float(summary7a['ssim']):.4f}",
            train_s=f"{train7:.3f}",
            steps_per_s=f"{HIPCT_STEPS / train7:.2f}",
            steps_per_s_autograd=f"{HIPCT_STEPS / summary7a['train_s']:.2f}",
            coords_per_s=f"{HIPCT_STEPS * len(names) * FLEET_N / train7:.4g}",
            checkpoint_s=f"{summary7['checkpoint_s']:.3f}",
            wall_s=f"{wall7:.3f}")
        if not math.isfinite(psnr7) or psnr7 < HIPCT_PSNR_FLOOR:
            fail(f"hipct PSNR {psnr7} below the floor {HIPCT_PSNR_FLOOR}")
        if not abs(psnr7 - psnr7a) <= HIPCT_AUTOGRAD_DB:
            fail(f"hipct PSNR {psnr7} on the kernel, {psnr7a} through "
                 f"autograd: more than {HIPCT_AUTOGRAD_DB} dB apart")
        deblock_check(os.path.join(run_dir, f"steps{HIPCT_STEPS}"),
                      data_path)

        # ---- 8. the bundled fixture: brain64 (kernel), default (autograd)
        for name, fused_want in (("brain64.yaml", [True]),
                                 ("default.yaml", None)):
            fused_train.launches = 0
            t0 = time.perf_counter()
            summary8, run_dir8, _ = run_config(
                os.path.join(DIVIDE, name), out_dir, FIXTURE_STEPS)
            torch.cuda.synchronize()
            wall8 = time.perf_counter() - t0
            fleet8 = fused_train.launches
            samplers = [b["sampler"] for b in summary8["fleet"]]
            if fused_want is not None and (
                    summary8["fused"] != fused_want or
                    fleet8 != FIXTURE_STEPS or
                    summary8["fleet"][0]["widths"] != b64_row["padded"] or
                    summary8["fleet"][0]["blocks"] != len(BRAIN64_WIDTHS)):
                fail(f"{name}: fused {summary8['fused']}, fleet launches "
                     f"{fleet8}, buckets {summary8['fleet']} (phase 6: "
                     f"{len(BRAIN64_WIDTHS)} x {b64_row['padded']})")
            if fused_want is not None:
                b64_row["launches"] = fleet8
            if fused_want is None and (any(summary8["fused"]) or fleet8 or
                                       set(samplers) != {"fullbatch"}):
                fail(f"{name}: fused {summary8['fused']}, samplers "
                     f"{samplers}, fleet launches {fleet8}")
            names8 = chunk_dirs(run_dir8, FIXTURE_STEPS)
            psnr8 = last_psnr(run_dir8)
            if not math.isfinite(psnr8):
                fail(f"{name}: PSNR {psnr8}")
            say("8-divide-fixture", config=name, steps=FIXTURE_STEPS,
                chunks=len(names8), buckets=len(summary8["fleet"]),
                samplers=samplers, fused=summary8["fused"],
                launches=fleet8, psnr=f"{psnr8:.3f}",
                train_s=f"{summary8['train_s']:.3f}",
                checkpoint_s=f"{summary8['checkpoint_s']:.3f}",
                wall_s=f"{wall8:.3f}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # ---- 9. kernel 3: the batch-major fused forward ----
    siren_rows = {}
    for label, cfg9, n9, key in SIREN_CASES:
        row = siren_check(dev, label, cfg9, n9)
        if key is not None:
            siren_rows[key] = row

    # ---- 10. the batch-major decode route on phase 5's archive ----
    route10 = batch_major_decode(dev, cf5,
                                 os.path.join(archive5, "compressed"))

    # ---- 11. every other family through the commands ----
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_families_")
    try:
        for name, keys, on_kernels, floor in FAMILIES:
            family_run(dev, out_dir, name, keys, on_kernels, floor)
        for name, keys, solo in DIVIDE_FAMILIES:
            divide_family_run(dev, out_dir, name, keys, solo)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if fused_siren.launches:
        fail(f"phase 11 launched the forward kernel {fused_siren.launches} "
             "times: it is off every default path")

    # ---- 12. SingleTask on the demo volume: the wide layouts ----
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_demo_")
    try:
        demo_rows = {f: demo_run(dev, out_dir, ratio, steps, f)
                     for ratio, steps, f in DEMO_RUNS}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # ---- 13. resume at full width: SingleTask 5 x 22, the HiP-CT fleet
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        resume_rows = {
            "single": resume_run(dev, out_dir, "single", CONFIG,
                                 RESUME_STEPS["single"], FIXTURE),
            "hipct": resume_run(dev, out_dir, "hipct",
                                os.path.join(DIVIDE, "hipct.yaml"),
                                RESUME_STEPS["hipct"], HIPCT)}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # ---- 14. MultiTask: opt/MultiTask/default.yaml's two experiments
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_multitask_")
    try:
        multitask_row = multitask_run(dev, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # ---- 15. media at full width: a 2048^2 PNG (SingleTask, a 2-D
    # fleet) and 64 frames of 512^2 BGR video ----
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_media_")
    try:
        files = media_files(out_dir)
        media_rows = {}
        for kind, cin, cout, spatial in (("png", 2, 1, (2048, 2048)),
                                         ("mp4", 3, 3, (64, 512, 512))):
            raw = files[f"{kind}_raw"]
            mphi = {**SIREN_BASE, "name": "SIREN", "coords_channel": cin,
                    "data_channel": cout}
            f = sizing_width(mphi, raw / 80)
            mmodel = init_phi({**mphi, "features": f})
            mwidths = fused_train.chain_widths(mmodel.spec)
            media_rows[kind] = {
                "train": chain_check(
                    dev, kind, {**mphi, "features": f}, MEDIA_N,
                    fused_train.choose_plan(mwidths)["layout"], kw,
                    phase="15-fused_train"),
                "decode": decode_check(
                    dev, kind, spatial, mmodel.init(
                        torch.Generator().manual_seed(5), dev)["layers"],
                    chain_layer_specs(mmodel.spec), reps=10, plain_reps=3,
                    phase="15-fused_decode")}
            run = media_run(dev, out_dir, kind, files[kind], raw,
                            MEDIA_STEPS[kind])
            if run["widths"] != mwidths:
                fail(f"media {kind}: trained {run['widths']}, checked "
                     f"{mwidths}")
            media_rows[kind]["run"] = run
        mdiv = media_divide_run(dev, out_dir, files["png"], files["png_raw"],
                                MEDIA_DIVIDE_STEPS)
        true2 = tuple(int(cfglib.load(os.path.join(
            out_dir, "media_divide", f"steps{MEDIA_DIVIDE_STEPS}",
            "compressed", "sideinfos", nm, "sideinfos.yaml"))["phi_features"])
            for nm in sorted(os.listdir(os.path.join(
                out_dir, "media_divide", f"steps{MEDIA_DIVIDE_STEPS}",
                "compressed", "sideinfos"))))
        fleet2d_row = fleet_check(
            dev, rng, true2, 5, 20.0, MEDIA_N,
            [60.0, -math.inf, 40.0, -math.inf],
            fused_train.choose_plan([2] + mdiv["widths"][1:])["layout"],
            cin=2, phase="15-fused_train_fleet")
        if fleet2d_row["padded"] != mdiv["widths"]:
            fail(f"media divide: trained {mdiv['widths']}, checked "
                 f"{fleet2d_row['padded']}")
        fleet2d_row["launches"] = mdiv["launches"]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # ---- 16. half: bf16 products, no kernel ----
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_half_")
    try:
        half_row = half_run(dev, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # ---- 17. hipct.yaml: a step-level exception, raw_gather, vector_len
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_hipct_options_")
    try:
        solo_row = chain_check(dev, "hipct-solo",
                               {"name": "SIREN", "layers": 7, "w0": 10,
                                "features": max(FLEET_WIDTHS)}, FLEET_N,
                               "tiled", kw,
                               phase="17-fused_train")
        exc = exception_run(dev, out_dir)
        solo_row["launches"] = exc["launches"]["solo"]
        steps_per_s7 = HIPCT_STEPS / train7
        bytes7 = summary7["fleet"][0]["data_bytes"]
        gather_rows = {
            label: gather_run(dev, out_dir, label, over, psnr7,
                              steps_per_s7, bytes7)
            for label, over in (("raw_gather", {"raw_gather": True}),
                                ("vector_len", {"sampler":
                                                {"vector_len": 8}}))}
        gather_rows["phase7"] = dict(psnr=psnr7, steps_per_s=steps_per_s7,
                                     data_bytes=bytes7)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # ---- 18. NFLR at the RD script's widths ----
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_nflr_")
    try:
        nflr_phase(dev, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    kernels = [
        {"name": "fused_train_grads", "route": "cuda",
         "source": "brief_pytorch_tpu_torch/ops/csrc/fused_train.cu",
         "replaces": "brief_pytorch_tpu/ops/pallas_train.py:281",
         "launches": launches["fused_train"], "max_abs_err": err1,
         "ms": ms1, "plain_ms": plain1, "bound_ms": b1, "bound_by": by1,
         "tc_bound_ms": tc1, "library_ms": None, "layout": layout1,
         "shape": f"SIREN {widths}, N={n}", **train_rows,
         "media_2d": {**media_rows["png"]["train"],
                      "launches": media_rows["png"]["run"]["train_launches"]},
         "hipct_solo": solo_row, "phase16_half": half_row},
        {"name": "fused_train_grads_fleet", "route": "cuda",
         "source": "brief_pytorch_tpu_torch/ops/csrc/fused_train.cu",
         "replaces": "brief_pytorch_tpu/ops/pallas_train.py:281",
         "launches": launches7["fused_train"], "library_ms": None,
         **{k: v for k, v in hip_row.items() if k != "padded"},
         "narrow": {k: v for k, v in b64_row.items() if k != "padded"},
         "wide": {k: v for k, v in wfleet_row.items() if k != "padded"},
         "media_2d_fleet": fleet2d_row, "phase17": {
             "exception": exc, **gather_rows}},
        {"name": "fused_decode_grid", "route": "cuda",
         "source": "brief_pytorch_tpu_torch/ops/csrc/fused_decode.cu "
                   "(+ csrc/chain_tc.cuh, csrc/tf32.cuh)",
         "replaces": "brief_pytorch_tpu/ops/pallas_decode.py:172",
         "launches": launches["fused_decode"] + decode_launches7,
         "max_abs_err": dec_rows[64]["max_abs_err"], "ms": dec_rows[64]["ms"],
         "plain_ms": dec_rows[64]["plain_ms"],
         "bound_ms": dec_rows[64]["bound_ms"],
         "bound_by": dec_rows[64]["bound_by"], "library_ms": None,
         **{k: dec_rows[64][k] for k in ("tc_bound_ms", "layout", "tile",
                                         "inst", "warps_per_sm", "shape")},
         "at_256": {k: v for k, v in dec_rows[256].items() if k != "shape"},
         "hipct_chunk": {**dec_rows["hipct"], "launches": decode_launches7},
         "trained_5x22": dec_rows["trained"],
         "media_2d": {**media_rows["png"]["decode"], "launches":
                      media_rows["png"]["run"]["decode_kernels"]},
         "phase13": resume_rows, "phase14": multitask_row},
        {"name": "fused_train_grads_wide", "route": "cuda",
         "source": "brief_pytorch_tpu_torch/ops/csrc/fused_train.cu "
                   "(+ csrc/wide.cuh)",
         "replaces": "brief_pytorch_tpu/ops/pallas_train.py:281",
         "launches": demo_rows[191]["launches"]["fused_train"],
         "library_ms": None, **wide_rows[191],
         "at_242": {**wide_rows[242], "launches":
                    demo_rows[242]["launches"]["fused_train"]},
         "phase12": demo_rows,
         "video_c3": {**media_rows["mp4"]["train"], "launches":
                      media_rows["mp4"]["run"]["train_launches"]}},
        {"name": "fused_decode_grid_wide", "route": "cuda",
         "source": "brief_pytorch_tpu_torch/ops/csrc/fused_decode.cu "
                   "(+ csrc/chain_tc.cuh, csrc/tf32.cuh)",
         "replaces": "brief_pytorch_tpu/ops/pallas_decode.py:172",
         "launches": demo_rows[191]["launches"]["fused_decode"]
         + demo_rows[191]["decompress_decode_launches"],
         "library_ms": None, **dec_rows[191],
         "at_242": {**dec_rows[242], "launches":
                    demo_rows[242]["launches"]["fused_decode"]
                    + demo_rows[242]["decompress_decode_launches"]},
         "video_c3": {**media_rows["mp4"]["decode"], "launches":
                      media_rows["mp4"]["run"]["decode_kernels"]}},
        {"name": "fused_chain_apply", "route": "cuda",
         "source": "brief_pytorch_tpu_torch/ops/csrc/fused_siren.cu "
                   "(+ csrc/chain_tc.cuh, csrc/tf32.cuh)",
         "replaces": "brief_pytorch_tpu/ops/pallas_siren.py:116",
         "launches": route10["launches"], "library_ms": None,
         **siren_rows["main"],
         **{k: v for k, v in siren_rows.items() if k != "main"},
         "decode_route": route10},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
