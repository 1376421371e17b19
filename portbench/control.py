"""The readings that the limits in portbench/limits/ are set from.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it drives the cell's own loop through the part that the
comparison judges, at the cell's own size, and prints one JSON line: the
numbers the sound program gives ("program"), those of the control, the
reference computed with TF32 products in the program's place ("tf32"),
and those of the faults a cell can have ("half_batch": the mean over half
of each batch; "unchanged": parameters that never move).

A train cell's comparison needs no measured window: the program takes its
first four steps through the cell's loop (the fleet trainer, or
NFGR.compress) and the reference follows them.  Needs a CUDA card, as
run.py does, unless --device says otherwise.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def train_readings(r, seed: int):
    """{mode: numbers} for one seed of a train cell."""
    from brief_pytorch_tpu_torch.parallel.block_trainer import \
        BlockFleetTrainer
    from brief_pytorch_tpu_torch.train.fit import NFGR
    from portbench.harness import capture, train_check
    from portbench.loops import train
    cfg = r.config()
    task = r.cell.config["task"]
    cap = capture.FirstSteps()
    if task == "divide":
        cc = cfg.CompressFramework.Compress
        with cap.fleet():
            BlockFleetTrainer(seed=seed, device=r.device).train(
                train._fleet_blocks(cfg), cc, 4, checkpoints=[4])
    else:
        with cap.single():
            NFGR(train._single_opt(cfg, 4), None, seed, r.device).compress(
                cfg.Dataset.data_path)
    st = train_check.setting(task, cfg.to_plain())
    return {mode or "program": train_check.check(cap, st, task == "divide",
                                                 r.device, control=mode)
            for mode in (None, "tf32", "half_batch", "unchanged")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    a = p.parse_args(argv)
    import torch
    from portbench.harness import manifest
    from portbench.harness.run_state import Run
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(a.workload)
    r = Run(cell=cell, seed=a.seeds[0], seconds=0.0, trace=False,
            device=torch.device(a.device), t_start=time.perf_counter())
    for seed in a.seeds:
        t0 = time.perf_counter()
        out = train_readings(r, seed)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
