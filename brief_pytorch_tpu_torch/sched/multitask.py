"""MultiTask: combinatorial experiment-grid expansion + fleet execution.

Copy of brief_pytorch_tpu/sched/multitask.py (reference MultiTask.py:
27-93): a `Dynamic:` config tree with nested PRODUCT/CONCAT combinators
expands into per-experiment dotlists merged over `Static:`; each combo
becomes a Task, its yaml written under temp_opt_<project>/ beside the
MultiTask yaml and removed when the queue is done (also when a task
raises).  Tasks run in-process through this package's cli.main.run, one
at a time (the kernels' launch counters, the run logger's stderr
redirect and the card are the process's), or as subprocesses with
`use_subprocess=True`, up to `max_task` at once, each pinned to a slot of
`device_list` (sched/tasks.py).
"""
from __future__ import annotations

import logging
import os
import shutil
import sys
from itertools import product
from os.path import join as opj
from types import SimpleNamespace
from typing import Dict, List, Tuple

from brief_pytorch_tpu_torch.core import config as cfglib
from brief_pytorch_tpu_torch.sched.tasks import Queue, Task


def dict2dotlist_list(optdict: Dict) -> List[List[str]]:
    """(reference MultiTask.py:27-37)"""
    if "PRODUCT" in optdict:
        return PRODUCT(optdict["PRODUCT"])
    if "CONCAT" in optdict:
        return CONCAT(optdict["CONCAT"])
    return [[f"{k}={v}" for k, v in optdict.items()]]


def PRODUCT(optlist) -> List[List[str]]:
    """Cartesian product of sub-expansions (reference MultiTask.py:39-50)."""
    expanded = [dict2dotlist_list(opt) for opt in optlist]
    out = []
    for combo in product(*expanded):
        dotlist: List[str] = []
        for dl in combo:
            dotlist.extend(dl)
        out.append(dotlist)
    return out


def CONCAT(optlist) -> List[List[str]]:
    """Concatenation of sub-expansions (reference MultiTask.py:52-56)."""
    out: List[List[str]] = []
    for opt in optlist:
        out.extend(dict2dotlist_list(opt))
    return out


def gen_task_list(yaml_path: str, main_script_path: str = "",
                  use_subprocess: bool = False, device: str = "0"
                  ) -> Tuple[List[Task], str]:
    """Expand a MultiTask yaml into Tasks (reference MultiTask.py:63-84).

    In-process tasks call this package's cli.main.run on the generated
    per-experiment yaml (on card 0, or on the device `device` names);
    subprocess tasks shell out like the reference, to main_script_path
    (default: this package's CLI, `-m brief_pytorch_tpu_torch.cli.main`).
    """
    opt = cfglib.load(yaml_path)
    temp_dir = _temp_dir(yaml_path, opt)
    os.makedirs(temp_dir, exist_ok=True)
    static = cfglib.to_dotlist(opt.Static)
    dynamic_list = CONCAT(opt.Dynamic)
    tasks: List[Task] = []
    for idx, dynamic in enumerate(dynamic_list):
        task_opt = cfglib.from_dotlist(static + dynamic)
        source = task_opt.pop("Source", cfglib.Config({"gpucost": 0,
                                                       "cpucost": 0}))
        task_name = f"exp_{idx:03d}"
        yaml_out = opj(temp_dir, task_name + ".yaml")
        cfglib.save(task_opt, yaml_out)
        if use_subprocess:
            script = main_script_path or "-m brief_pytorch_tpu_torch.cli.main"
            command = f"{sys.executable} {script} -p {yaml_out}"
        else:
            command = _make_runner(yaml_out, device)
        tasks.append(Task(command, task_name, source.get("gpucost", 0),
                          source.get("cpucost", 0)))
    return tasks, temp_dir


def _temp_dir(yaml_path: str, opt) -> str:
    return opj(os.path.dirname(yaml_path) or ".",
               "temp_opt_" + str(opt.Static.Log.project_name))


def _make_runner(yaml_path: str, device: str):
    def runner():
        # run's defaults but the device, as JAX's runner calls run(yaml)
        from brief_pytorch_tpu_torch.cli.main import run
        return run(yaml_path, SimpleNamespace(g=str(device)))
    return runner


def run_multitask(yaml_path: str, main_script_path: str = "",
                  use_subprocess: bool = False, time_interval: float = 0,
                  max_task: int = 1, debug: bool = False,
                  device_list=None, device: str = "0") -> Queue:
    """device_list: explicit device slots for subprocess pinning (the
    reference passes its gpu_list into the Queue, MultiTask.py:86-90);
    None leaves commands untouched.  device: where in-process tasks run
    (a card number or cpu); they run one at a time whatever max_task
    says."""
    if not use_subprocess and max_task > 1:
        logging.warning("in-process experiments run one at a time; "
                        "max_task=%d applies to -subprocess", max_task)
        max_task = 1
    temp_dir = _temp_dir(yaml_path, cfglib.load(yaml_path))
    try:
        tasks, _ = gen_task_list(yaml_path, main_script_path,
                                 use_subprocess, device)
        queue = Queue(tasks, device_list=device_list)
        queue.init_sharecost_dict()
        queue.start(time_interval=time_interval, max_task=max_task,
                    debug=debug)
    finally:
        shutil.rmtree(temp_dir, ignore_errors=True)
    return queue
