"""Single-task CLI, accepting the reference's opt/*.yaml schema.

Usage (mirrors reference main.py:680-706):
    python -m brief_pytorch_tpu_torch.cli.main -p opt/SingleTask/default.yaml
    python -m brief_pytorch_tpu_torch.cli.main -p <yaml> -g cpu
-g picks the device: a card number (default 0) or `cpu`.  Without a card
the run raises unless `-g cpu` is given.  A config whose
Compress.divide.divide_type is not `none` runs DivideTask
(parallel/divide_runner.compress_divide), as in JAX cli/main.py:46-52.
"""
from __future__ import annotations

import argparse
import os
import random
import shutil

import numpy as np
import torch

from brief_pytorch_tpu_torch.core import config as cfglib
from brief_pytorch_tpu_torch.core.device import resolve_device
from brief_pytorch_tpu_torch.utils.logger import MyLogger


def reproduc(opt) -> None:
    """Seed host RNGs (reference main.py:653-661); the trainer's
    generators are seeded from the same seed."""
    random.seed(opt.seed)
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)


def run(opt_path: str, args=None) -> dict:
    opt = cfglib.load(opt_path)
    if getattr(args, "resume", None):
        raise NotImplementedError("-resume is not ported yet (ROADMAP.md)")
    device = resolve_device(getattr(args, "g", None) or "0")
    seed = int(opt.Reproduc.seed)
    log = MyLogger(**opt.Log.to_plain())
    shutil.copy(opt_path, log.script_dir)
    reproduc(opt.Reproduc)
    if opt.CompressFramework.Compress.divide.divide_type != "none":
        from brief_pytorch_tpu_torch.parallel.divide_runner import \
            compress_divide
        return compress_divide(opt, log, device=device)
    from brief_pytorch_tpu_torch.train.fit import NFGR
    cf = NFGR(opt.CompressFramework, logger=log, seed=seed, device=device)
    return cf.compress(opt.Dataset.data_path,
                       stepstore=getattr(args, "stepstore", False))


def main(argv=None):
    parser = argparse.ArgumentParser(description="single task for datacompress")
    parser.add_argument("-p", type=str,
                        default=os.path.join("opt", "SingleTask", "default.yaml"))
    parser.add_argument("-g", default="0",
                        help="device: a CUDA card number, or cpu")
    parser.add_argument("-stepstore", action="store_false",
                        help="keep non-final step dirs")
    parser.add_argument("-resume", type=str, default=None,
                        help="not ported yet")
    args = parser.parse_args(argv)
    return run(args.p, args)


if __name__ == "__main__":
    main()
