"""Single-task / divide-task CLI, accepting the reference's opt/*.yaml schema.

Usage (mirrors reference main.py:680-706):
    python -m brief_pytorch_tpu_torch.cli.main -p opt/SingleTask/default.yaml
    python -m brief_pytorch_tpu_torch.cli.main -p <yaml> -g cpu
    python -m brief_pytorch_tpu_torch.cli.main -p <yaml> -resume <run dir>
-g picks the device: a card number (default 0) or `cpu`.  Without a card
the run raises unless `-g cpu` is given.  A config whose
Compress.divide.divide_type is not `none` runs DivideTask
(parallel/divide_runner.compress_divide), as in JAX cli/main.py:46-52.

Every flag of the JAX CLI parses.  -resume <run dir | .npz> continues a
stopped run from its training state (overrides Compress.resume;
train/checkpoint.py).  -profile writes a torch.profiler trace under the
run dir (utils/profiling.py trace).  -gc -cc -t -m -dropslice -debug
-substore are accepted for compatibility and change nothing, as in JAX
(the reference's scheduler knobs and scratch dirs).  -coordinator -nprocs
-procid (a run across hosts) raise NotImplementedError: data parallelism
and more than one card are not ported (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import random
import shutil

import numpy as np
import torch

from brief_pytorch_tpu_torch.core import config as cfglib
from brief_pytorch_tpu_torch.core.device import resolve_device
from brief_pytorch_tpu_torch.utils.logger import MyLogger

MULTIHOST = "-coordinator / -nprocs / -procid (a run across hosts)"


def reproduc(opt) -> None:
    """Seed host RNGs (reference main.py:653-661); the trainer's
    generators are seeded from the same seed."""
    random.seed(opt.seed)
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)


def run(opt_path: str, args=None) -> dict:
    opt = cfglib.load(opt_path)
    if getattr(args, "resume", None):
        opt.CompressFramework.Compress.resume = args.resume
    device = resolve_device(getattr(args, "g", None) or "0")
    seed = int(opt.Reproduc.seed)
    log = MyLogger(**opt.Log.to_plain())
    shutil.copy(opt_path, log.script_dir)
    reproduc(opt.Reproduc)
    profile_ctx = contextlib.nullcontext()
    if getattr(args, "profile", False):
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


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="single task for datacompress")
    p.add_argument("-p", type=str,
                   default=os.path.join("opt", "SingleTask", "default.yaml"))
    p.add_argument("-g", default="0",
                   help="device: a CUDA card number, or cpu")
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
                   help="not ported: raises (ROADMAP.md Queue 1 item 7)")
    p.add_argument("-nprocs", type=int, default=None,
                   help="not ported: raises (ROADMAP.md Queue 1 item 7)")
    p.add_argument("-procid", type=int, default=None,
                   help="not ported: raises (ROADMAP.md Queue 1 item 7)")
    p.add_argument("-resume", type=str, default=None,
                   help="continue a stopped run from its training state "
                        "(a run dir or the .npz itself); overrides "
                        "Compress.resume")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if any(v is not None for v in (args.coordinator, args.nprocs,
                                   args.procid)):
        raise NotImplementedError(
            f"{MULTIHOST}: data parallelism and more than one card are not "
            "ported yet (ROADMAP.md Queue 1 item 7, data parallelism)")
    return run(args.p, args)


if __name__ == "__main__":
    main()
