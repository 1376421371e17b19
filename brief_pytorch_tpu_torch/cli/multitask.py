"""MultiTask CLI (reference MultiTask.py:94-125 flag surface; copy of
brief_pytorch_tpu/cli/multitask.py).

    python -m brief_pytorch_tpu_torch.cli.multitask -p opt/MultiTask/default.yaml
    python -m brief_pytorch_tpu_torch.cli.multitask -p <yaml> -g cpu
    python -m brief_pytorch_tpu_torch.cli.multitask -p <yaml> -subprocess -g 0,1 -m 2

Experiments run in-process, one at a time, on the first device of -g (a
card number or cpu), or with -subprocess as child processes of this
package's CLI (or of the script -stp names), up to -m at once, each
pinned to a device of -g (sched/tasks.py).  Prints the status table.
"""
from __future__ import annotations

import argparse

from brief_pytorch_tpu_torch.sched.multitask import run_multitask


def main(argv=None):
    parser = argparse.ArgumentParser(description="Batch Compress")
    parser.add_argument("-stp", type=str, default="",
                        help="singletask script path (subprocess mode only; "
                             "default this package's CLI)")
    parser.add_argument("-p", type=str, default="opt/MultiTask/default.yaml")
    parser.add_argument("-g", default="0",
                        help="device list: card numbers or cpu, "
                             "comma-separated")
    parser.add_argument("-t", type=float, default=0)
    parser.add_argument("-m", type=int, default=1)
    parser.add_argument("-debug", action="store_true")
    parser.add_argument("-log", action="store_true")
    parser.add_argument("-onebyone", action="store_true")
    parser.add_argument("-subprocess", action="store_true",
                        help="run experiments as OS subprocesses")
    args = parser.parse_args(argv)
    max_task = 1 if args.onebyone else args.m
    # -onebyone also pins to the single listed device, like the reference
    # (MultiTask.py:114-118); subprocess mode pins via the Queue's slots
    devices = [d for d in str(args.g).split(",") if d != ""]
    if args.onebyone:
        devices = devices[:1]
    queue = run_multitask(args.p, args.stp, use_subprocess=args.subprocess,
                          time_interval=args.t, max_task=max_task,
                          debug=args.debug,
                          device_list=devices if args.subprocess else None,
                          device=devices[0] if devices else "0")
    print(queue.status_table())
    return queue


if __name__ == "__main__":
    main()
