#!/usr/bin/env python3
"""What a torch.profiler session with CUDA activity leaves behind: the
host's cost of a launch before and after one utils/profiling.trace in the
same process.

    python3 scripts/profiler_after_cost.py            # both variants
    python3 scripts/profiler_after_cost.py --child    # one variant

Each variant is a fresh interpreter (--child): it times LAUNCHES launches
of a small elementwise torch op and of fast_sincos_device (a kernel of
ops/csrc launched through ctypes) on the host clock, each loop ending in
a sync, twice; then runs one trace around a few launches inside
utils/profiling.annotate; then times both loops twice again.  Then it
counts the device kernels each later profiler session of the process
sees around the same launches, in turns: a `with profile(...)` block
read through key_averages (as utils/profiling.timed_loop reads it) and
a utils/profiling.trace.  Last, sessions of growing size: a `with
profile(...)` block around SIZES launches, then a small trace, each
counting the device kernel launches it saw.  The variants: the environment as it is, and TEARDOWN_CUPTI=1 (kineto then
finalizes CUPTI when the trace stops).  Prints one JSON line a variant,
microseconds a launch, and the card's name and power limit.  Needs a
CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHES = 20_000
SIZES = (1_000, 10_000, 100_000, 300_000)


def child() -> dict:
    sys.path.insert(0, ROOT)
    import torch
    from brief_pytorch_tpu_torch.ops.fast_math import fast_sincos_device
    from torch.profiler import ProfilerActivity, profile
    from brief_pytorch_tpu_torch.utils.profiling import (
        annotate, device_kernels, kernel_ms, trace)
    dev = torch.device("cuda", 0)
    x = torch.zeros(1024, device=dev)
    fast_sincos_device(x)
    torch.cuda.synchronize()

    def us(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(LAUNCHES):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / LAUNCHES

    loops = {"torch_add": lambda: x.add_(1.0),
             "ctypes_kernel": lambda: fast_sincos_device(x)}
    out = {k: [us(f), us(f)] for k, f in loops.items()}
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir):
            with annotate("profiler_after_cost"):
                for f in loops.values():
                    for _ in range(3):
                        f()
                torch.cuda.synchronize()
    for k, f in loops.items():
        out[k] += [us(f), us(f)]
    sessions = []
    for kind in ("context", "trace", "context", "trace"):
        if kind == "trace":
            with tempfile.TemporaryDirectory() as logdir:
                with trace(logdir):
                    for f in loops.values():
                        f()
                    torch.cuda.synchronize()
                with open(os.path.join(logdir, "kernels.json")) as fh:
                    n = sum(json.load(fh).values())
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for f in loops.values():
                    f()
                torch.cuda.synchronize()
            n = len(kernel_ms(prof))
        sessions.append((kind, n))
    sizes = []
    for size in SIZES:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(size):
                loops["torch_add"]()
            torch.cuda.synchronize()
        seen = sum(device_kernels(prof).values())
        with tempfile.TemporaryDirectory() as logdir:
            with trace(logdir):
                loops["torch_add"]()
                torch.cuda.synchronize()
            with open(os.path.join(logdir, "kernels.json")) as fh:
                after = sum(json.load(fh).values())
        sizes.append({"launches": size, "seen": seen,
                      "next_trace_seen": after})
    return {"us_per_launch_before_before_after_after": out,
            "later_sessions_kernels": sessions,
            "sessions_by_size": sizes,
            "env": {k: os.environ[k] for k in ("TEARDOWN_CUPTI",)
                    if k in os.environ}}


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child()), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for extra in ({}, {"TEARDOWN_CUPTI": "1"}):
        env = {**os.environ, **extra}
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child"], env=env, capture_output=True,
                             text=True)
        sys.stderr.write(res.stderr[-2000:])
        print(res.stdout.strip().splitlines()[-1] if res.returncode == 0
              else json.dumps({"failed": res.returncode, "env": extra}),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
