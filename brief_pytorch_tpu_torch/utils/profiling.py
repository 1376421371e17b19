"""Where the training loop's time goes, on the card; and `trace`, the
CLI's -profile.

    python -m brief_pytorch_tpu_torch.utils.profiling [-p yaml] [--steps N]
        [--data volume]

Runs the config's training (Compress.max_steps = N, no checkpoint
artifacts) twice: once plain, for the host-clock step time, and once
under torch.profiler, for the device time of every CUDA kernel.  A
SingleTask config trains through NFGR.compress; a DivideTask config
(divide_type other than none) trains its block fleet
(parallel/block_trainer.py) on the blocks compress_divide would make.
--data replaces Dataset.data_path.  Prints one JSON line:
  wall_ms_per_step    host clock over the training loop (ends in a sync)
  device_ms_per_step  summed kernel time / N (the set-up's few kernels
                      included)
  device_idle_share   1 - device_ms_per_step / wall_ms_per_step
  kernels             the ten kernels with the most device time, ms/step
  device, power_limit the card
Needs a CUDA card.

`timed_loop(step, n)` runs a training loop's step function n times and
reads the same numbers of it from inside one run (the NFLR RD script and
chip_smoke.py's phase 18 use it).

`trace(logdir)` (JAX utils/profiling.py:24, there a jax.profiler trace) is
a torch.profiler trace of whatever runs inside it, written as
<logdir>/trace.json (Chrome trace format: chrome://tracing, Perfetto):
host ops, and the card's kernels where a card is present.  Beside it,
<logdir>/kernels.json counts the trace's device kernels by name.  A trace
that holds no device kernel (the CPU, a card whose CUPTI another tracer
holds, or a process whose earlier session held some 300,000 device
events: scripts/profiler_after_cost.py) is said so in a warning on
standard error and in the run's log, not written silently.

`annotate(name)` (JAX :34, there a TraceAnnotation) names a range of the
trace: torch.profiler's record_function, a span named `name` in
trace.json.  `ThroughputMeter` (JAX :41-79) adds up coordinates and
seconds over measured segments: coords/s and coords/s per card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from collections import Counter
from dataclasses import dataclass
from typing import Dict

import torch

from brief_pytorch_tpu_torch.core import config as cfglib


def device_kernels(prof) -> Counter:
    """Launches of each device kernel in a stopped profiler's trace."""
    cuda = torch.autograd.DeviceType.CUDA
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda)


@contextlib.contextmanager
def trace(logdir: str, log_path: str = None):
    """torch.profiler over the block; the trace goes to
    <logdir>/trace.json and its device kernels by name to
    <logdir>/kernels.json when it ends.  Without a device kernel in the
    trace, a warning goes to standard error and is appended to log_path
    (the run's log) where one is given."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        kernels = device_kernels(prof)
        with open(os.path.join(logdir, "kernels.json"), "w") as f:
            json.dump(dict(kernels.most_common()), f, indent=1)
        if kernels:
            msg = (f"profile: {sum(kernels.values())} device kernel "
                   f"launches of {len(kernels)} kernels in {logdir}")
        else:
            msg = (f"WARNING profile: the trace in {logdir} holds no device "
                   "kernel (" + ("no CUDA card" if len(activities) == 1 else
                                 "CUPTI gave the profiler no kernel events; "
                                 "is another tracer holding it, or did an "
                                 "earlier session of this process hold "
                                 "some 300,000 device events?") + ")")
        print(msg, file=sys.stderr, flush=True)
        if log_path is not None and not kernels:
            with open(log_path, "a") as f:
                f.write(msg + "\n")


@contextlib.contextmanager
def annotate(name: str):
    """Named range inside a trace (torch.profiler.record_function)."""
    with torch.profiler.record_function(name):
        yield


@dataclass
class ThroughputMeter:
    """coords/s (/card) accounting for training / decode loops.

    Usage:
        meter = ThroughputMeter(n_chips=torch.cuda.device_count())
        with meter.measure(coords=n_steps * batch):
            for _ in range(n_steps):
                step()
        meter.coords_per_sec, meter.coords_per_sec_per_chip

    measure() synchronises the card at both ends where CUDA is
    initialised, so that a segment of queued launches is timed to its end
    and not by its launch time alone."""
    n_chips: int = 1
    total_coords: int = 0
    total_seconds: float = 0.0
    segments: int = 0

    @contextlib.contextmanager
    def measure(self, coords: int):
        sync = torch.cuda.is_initialized()
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.total_coords += int(coords)
        self.total_seconds += dt
        self.segments += 1

    @property
    def coords_per_sec(self) -> float:
        return self.total_coords / max(self.total_seconds, 1e-12)

    @property
    def coords_per_sec_per_chip(self) -> float:
        return self.coords_per_sec / max(self.n_chips, 1)

    def report(self) -> Dict[str, float]:
        return {
            "coords_per_sec": self.coords_per_sec,
            "coords_per_sec_per_chip": self.coords_per_sec_per_chip,
            "segments": self.segments,
            "seconds": self.total_seconds,
        }


def kernel_ms(prof) -> dict:
    """Device time (ms) of each CUDA kernel in a stopped profiler."""
    kernels = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0)
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + t / 1e3
    return kernels


def timed_loop(step, n: int, warmup: int = 10, window: int = 20,
               device=None) -> dict:
    """Call step(i) for i in range(n) and time it.

    On a CUDA device: `warmup` calls, then `window` calls under
    torch.profiler (the summed kernel time per call), then the rest timed
    by the host clock and by CUDA events on the current stream, ending in
    a sync.  Returns wall_ms_per_step and event_ms_per_step (over the
    rest), kernel_ms_per_step (the window), device_idle_share = 1 -
    kernel / wall, steps_per_s, the five kernels with the most time, and
    wall_s over all n calls.  On the CPU only the host clock is read."""
    cuda = device is not None and torch.device(device).type == "cuda"
    t_all = time.perf_counter()
    if not cuda or n < warmup + window + 10:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"steps": n, "wall_s": wall, "wall_ms_per_step":
                1e3 * wall / max(n, 1), "steps_per_s": n / wall}
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(warmup, warmup + window):
            step(i)
        torch.cuda.synchronize()
    kernels = kernel_ms(prof)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rest = n - warmup - window
    t0 = time.perf_counter()
    start.record()
    for i in range(warmup + window, n):
        step(i)
    end.record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / rest
    kern = sum(kernels.values()) / window
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"steps": n, "wall_s": time.perf_counter() - t_all,
            "wall_ms_per_step": wall_ms,
            "event_ms_per_step": start.elapsed_time(end) / rest,
            "kernel_ms_per_step": kern,
            "device_idle_share": 1.0 - kern / wall_ms,
            "steps_per_s": 1e3 / wall_ms,
            "kernels": {k: v / window for k, v in top}}


def _run(opt, steps: int) -> dict:
    c = opt.CompressFramework
    c.Compress.max_steps = steps
    c.Compress.checkpoints = "none"
    seed = int(opt.Reproduc.seed)
    path = opt.Dataset.data_path
    if c.Compress.divide.divide_type != "none":
        from brief_pytorch_tpu_torch.io.image import read_img
        from brief_pytorch_tpu_torch.parallel.block_trainer import \
            BlockFleetTrainer
        from brief_pytorch_tpu_torch.parallel.divide_runner import (
            param_budget, plan_blocks)
        from brief_pytorch_tpu_torch.post.preprocess import preprocess
        pre = c.Compress.preprocess
        data = preprocess(read_img(path), pre.denoise.level,
                          pre.denoise.close, pre.clip)
        _, blocks, _ = plan_blocks(c, data, param_budget(c.Compress, path))
        trainer = BlockFleetTrainer(seed=seed, device="cuda")
        trainer.train(blocks, c.Compress, steps)
        summary = {"train_s": trainer.train_s,
                   "fleet": trainer.fleet_stats()}
    else:
        from brief_pytorch_tpu_torch.train.fit import NFGR
        nfgr = NFGR(c, logger=None, seed=seed, device="cuda")
        summary = nfgr.compress(path)
    torch.cuda.synchronize()
    return summary


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-p", default="opt/SingleTask/default.yaml")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--data", default=None,
                        help="a volume in place of Dataset.data_path")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA card")
    from brief_pytorch_tpu_torch.ops import build
    build.build()     # else a cold start's nvcc runs inside the timed loop

    def load():
        opt = cfglib.load(args.p)
        if args.data:
            opt.Dataset.data_path = args.data
        return opt

    plain = _run(load(), args.steps)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run(load(), args.steps)
    kernels = kernel_ms(prof)
    device_ms = sum(kernels.values()) / args.steps
    wall_ms = plain["train_s"] * 1e3 / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"steps": args.steps, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms,
           "device_idle_share": 1.0 - device_ms / wall_ms,
           "kernels": {k: v / args.steps for k, v in top},
           "fleet": plain.get("fleet"),
           "device": torch.cuda.get_device_name(0), "power_limit": smi}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
