"""Single-task / divide-task CLI, accepting the reference's opt/*.yaml schema.

Usage (mirrors reference main.py:680-706):
    python -m brief_pytorch_tpu_torch.cli.main -p opt/SingleTask/default.yaml
    python -m brief_pytorch_tpu_torch.cli.main -p <yaml> -g cpu
    python -m brief_pytorch_tpu_torch.cli.main -p <yaml> -resume <run dir>
-g picks the device: a card number (default 0) or `cpu`.  Without a card
the run raises unless `-g cpu` is given.  A config whose
Compress.divide.divide_type is not `none` runs DivideTask
(parallel/divide_runner.compress_divide), as in JAX cli/main.py:46-52.

More than one rank (parallel/mesh.py; one process each, rank 0 writes
every file and its summary is returned):
  * `Compress.data_shards: N` (N > 1), SingleTask: N local ranks on the
    first N cards of -g (`-g 0,1,2,3`), or cards 0..N-1 when -g names
    one; N above them raises ValueError.  With `-g cpu` the N ranks run
    on the host over gloo;
  * DivideTask with -g listing K > 1 devices: K local ranks, the fleet
    spread over them (the JAX package's mesh over all its devices);
  * -coordinator host:port -nprocs K -procid r (JAX cli/main.py:80-104):
    this process is rank r of K, on the one device -g names; run the same
    command on every rank;
  * under torchrun (WORLD_SIZE set) the group comes from its environment,
    the rank's device from -g's LOCAL_RANK-th entry.
The local ranks re-run this command with the three flags; the kernels are
built once before they start.  Cards use NCCL, the host gloo.

Every flag of the JAX CLI parses.  -resume <run dir | .npz> continues a
stopped run from its training state (overrides Compress.resume;
train/checkpoint.py).  -profile writes a torch.profiler trace under the
run dir (utils/profiling.py trace).  -gc -cc -t -m -dropslice -debug
-substore are accepted for compatibility and change nothing, as in JAX
(the reference's scheduler knobs and scratch dirs).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import pickle
import random
import shutil
import subprocess
import sys
import tempfile
from typing import List

import numpy as np
import torch

from brief_pytorch_tpu_torch.core import config as cfglib
from brief_pytorch_tpu_torch.core.device import resolve_device
from brief_pytorch_tpu_torch.parallel import mesh
from brief_pytorch_tpu_torch.utils.logger import MyLogger

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def reproduc(opt) -> None:
    """Seed host RNGs (reference main.py:653-661); the trainer's
    generators are seeded from the same seed."""
    random.seed(opt.seed)
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)


def run(opt_path: str, args=None) -> dict:
    """One rank's run on the one device args.g names; rank 0 alone keeps
    the run's logger (its directory, the yaml copy, the trace)."""
    opt = cfglib.load(opt_path)
    if getattr(args, "resume", None):
        opt.CompressFramework.Compress.resume = args.resume
    device = resolve_device(getattr(args, "g", None) or "0")
    seed = int(opt.Reproduc.seed)
    log = None
    if mesh.is_main():
        log = MyLogger(**opt.Log.to_plain())
        shutil.copy(opt_path, log.script_dir)
    reproduc(opt.Reproduc)
    profile_ctx = contextlib.nullcontext()
    if getattr(args, "profile", False) and log is not None:
        from brief_pytorch_tpu_torch.utils.profiling import trace
        profile_ctx = trace(os.path.join(log.logdir, "profile"),
                            os.path.join(log.logdir, "stderr.log"))
    with profile_ctx:
        if opt.CompressFramework.Compress.divide.divide_type != "none":
            from brief_pytorch_tpu_torch.parallel.divide_runner import \
                compress_divide
            return compress_divide(opt, log, device=device)
        from brief_pytorch_tpu_torch.train.fit import NFGR
        cf = NFGR(opt.CompressFramework, logger=log, seed=seed,
                  device=device)
        return cf.compress(opt.Dataset.data_path,
                           stepstore=getattr(args, "stepstore", False))


def local_ranks(opt_path: str, devices: List[str]) -> List[str]:
    """The device of each local rank this command starts (one entry: no
    ranks to start): data_shards N (SingleTask) or the devices -g lists
    (DivideTask)."""
    opt = cfglib.load(opt_path)
    cc = opt.CompressFramework.Compress
    if cc.divide.divide_type != "none":
        n = len(devices)
    else:
        n = int(cc.get("data_shards", 1) or 1)
    if n == 1:
        return devices[:1]
    if set(devices) == {"cpu"}:
        return ["cpu"] * n
    if "cpu" in devices:
        raise ValueError(f"-g {','.join(devices)} mixes the host and cards")
    if len(devices) == 1:
        devices = [str(i) for i in range(torch.cuda.device_count())]
    if n > len(devices):
        raise ValueError(f"Compress.data_shards={n} but only "
                         f"{len(devices)} cards are visible or listed (-g)")
    devices = devices[:n]
    if len(set(devices)) != n:
        raise ValueError(f"-g {','.join(devices)} lists a card twice (NCCL "
                         "takes one rank a card)")
    return devices


def launch(args, devices: List[str]) -> dict:
    """Start one rank of this command per device, wait for all, and
    return rank 0's summary; a rank that fails stops the others."""
    if any(d != "cpu" for d in devices):
        from brief_pytorch_tpu_torch.ops import build
        build.build()           # once, before the ranks look for it
    cmd = [sys.executable, "-m", "brief_pytorch_tpu_torch.cli.main",
           "-p", args.p, "-coordinator", f"127.0.0.1:{mesh.free_port()}",
           "-nprocs", str(len(devices))]
    if args.resume:
        cmd += ["-resume", args.resume]
    if not args.stepstore:
        cmd.append("-stepstore")
    if args.profile:
        cmd.append("-profile")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    # ranks on one host share its cores (as torchrun sets it): threads
    # past them make the host's kernels crawl
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // len(devices))))
    with tempfile.TemporaryDirectory(prefix="brief_ranks_") as tmp:
        out = os.path.join(tmp, "summary.pkl")
        procs = [subprocess.Popen(
            cmd + ["-procid", str(r), "-g", dev]
            + (["-summary", out] if r == 0 else []), env=env)
            for r, dev in enumerate(devices)]
        mesh.wait_ranks(procs)
        with open(out, "rb") as f:
            return pickle.load(f)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="single task for datacompress")
    p.add_argument("-p", type=str,
                   default=os.path.join("opt", "SingleTask", "default.yaml"))
    p.add_argument("-g", default="0",
                   help="device: a CUDA card number or cpu; a comma list "
                        "(0,1,2,3) gives the cards of local ranks")
    # the reference's scheduler knobs (main.py:686-692): accepted, unused
    p.add_argument("-gc", type=int, default=8000)
    p.add_argument("-cc", type=int, default=3000)
    p.add_argument("-t", type=float, default=2)
    p.add_argument("-m", type=int, default=33)
    # vestigial in the reference (parsed at main.py:692, never read), and
    # the child scratch dirs -substore keeps are never made in-process
    p.add_argument("-dropslice", action="store_true")
    p.add_argument("-debug", action="store_true")
    p.add_argument("-substore", action="store_true")
    p.add_argument("-stepstore", action="store_false",
                   help="keep non-final step dirs (single task)")
    p.add_argument("-profile", action="store_true",
                   help="write a torch.profiler trace under the run dir")
    p.add_argument("-coordinator", type=str, default=None,
                   help="host:port of rank 0 for a run across processes "
                        "or hosts (with -nprocs and -procid)")
    p.add_argument("-nprocs", type=int, default=None,
                   help="the number of ranks (with -coordinator)")
    p.add_argument("-procid", type=int, default=None,
                   help="this process's rank in [0, nprocs) "
                        "(with -coordinator)")
    p.add_argument("-resume", type=str, default=None,
                   help="continue a stopped run from its training state "
                        "(a run dir or the .npz itself); overrides "
                        "Compress.resume")
    # where rank 0 leaves its summary for the local launcher
    p.add_argument("-summary", type=str, default=None,
                   help=argparse.SUPPRESS)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    devices = args.g.split(",")
    flags = (args.coordinator, args.nprocs, args.procid)
    joined = False
    if any(v is not None for v in flags):
        if any(v is None for v in flags):
            raise ValueError("-coordinator, -nprocs and -procid go together")
        if len(devices) != 1:
            raise ValueError("with -coordinator, -g names this rank's one "
                             f"device, not {args.g}")
        joined = mesh.multihost_init(args.coordinator, args.nprocs,
                                     args.procid,
                                     device=resolve_device(args.g))
    elif mesh.world() > 1 or "WORLD_SIZE" in os.environ:
        # a group the caller set up, or torchrun's environment: this
        # rank's device is -g's entry at its local rank
        if len(devices) > 1:
            args.g = devices[int(os.environ.get("LOCAL_RANK", mesh.rank()))]
        joined = mesh.world() == 1 and \
            mesh.multihost_init(device=resolve_device(args.g))
    else:
        ranks = local_ranks(args.p, devices)
        if len(ranks) > 1:
            return launch(args, ranks)
        args.g = ranks[0]
    try:
        summary = run(args.p, args)
        if args.summary:
            with open(args.summary, "wb") as f:
                pickle.dump(summary, f)
        return summary
    finally:
        if joined:
            mesh.shutdown()


if __name__ == "__main__":
    main()
