"""Task fleet scheduling.

Copy of brief_pytorch_tpu/sched/tasks.py, the replacement for the
reference's process scheduler (utils/TasksManager.py:21-311).  The
reference packs `python main.py` subprocesses onto GPUs by polling
nvidia-smi for free memory, learning per-cost-group footprints, and
re-queueing failures forever.  Here:

  * Task/Queue keep the same public API (command-or-callable, name,
    gpucost/cpucost, retry on error up to `max_retries`, status table)
    for MultiTask;
  * tasks run one at a time by default, or `max_task` at once in a
    thread pool (subprocess or host-bound tasks; sched/multitask.py keeps
    in-process experiments one at a time);
  * subprocess commands take a device slot from `device_list` while they
    run, a slot counter instead of nvidia-smi, and an optional wall-clock
    timeout that kills the child's process group.

Device pinning, one way: a slot is a device of the parent's numbering,
passed to the child as `-g <slot>` (the CLI's device flag: a card number
or cpu) and as BRIEF_DEVICE for commands that are not the CLI.
CUDA_VISIBLE_DEVICES is inherited unchanged, so the child numbers the
cards as the parent does.
"""
from __future__ import annotations

import logging
import os
import signal
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Union


@dataclass
class Task:
    """One unit of work: a shell command or a Python callable.

    Mirrors reference Task (TasksManager.py:21-52): name, resource costs
    (kept for API compat; used only as scheduling hints), retry counter,
    status in {'pending','running','finish','error'}.
    """
    command: Union[str, Callable[[], object]]
    name: str
    gpucost: float = 0.0
    cpucost: float = 0.0
    cost_variable: str = "none"
    status: str = "pending"
    # error counter: written only by the single worker thread that owns the
    # task during run(); the Queue reads it under its lock in settle()
    ets: int = 0
    result: object = None
    returncode: Optional[int] = None
    # wall-clock bound for SUBPROCESS commands (a hung device stalls a
    # child forever without erroring, so the retry loop never fires).
    # On expiry the child's whole process group is killed (exact pgid, no
    # pattern matching) and the task errors with returncode 124, entering
    # the normal retry path.  Callable tasks run in this thread and cannot
    # be bounded this way.
    timeout_s: Optional[float] = None

    device: object = None            # device assigned by the Queue, if any

    def run(self, debug: bool = False) -> None:
        try:
            if callable(self.command):
                self.result = self.command()
                self.returncode = 0
            else:
                kwargs = {} if debug else {
                    "stdout": subprocess.DEVNULL, "stderr": subprocess.DEVNULL}
                cmd = self.command
                env = None
                if self.device is not None:
                    # pin the child to its slot the way the reference
                    # Worker appends `-g <gpu>` (TasksManager.py:64); the
                    # card numbering stays the parent's (module docstring)
                    dev = str(self.device)
                    cmd = f"{cmd} -g {dev}"
                    env = {**os.environ, "BRIEF_DEVICE": dev}
                if self.timeout_s is None:
                    proc = subprocess.run(cmd, shell=True, env=env, **kwargs)
                    self.returncode = proc.returncode
                else:
                    # own session so the WHOLE tree (sh -c + grandchildren)
                    # can be killed by its exact pgid on expiry
                    child = subprocess.Popen(cmd, shell=True, env=env,
                                             start_new_session=True,
                                             **kwargs)
                    try:
                        self.returncode = child.wait(timeout=self.timeout_s)
                    except subprocess.TimeoutExpired:
                        logging.error(
                            "task %s exceeded %.0fs; killing its process "
                            "group", self.name, self.timeout_s)
                        try:
                            os.killpg(os.getpgid(child.pid), signal.SIGKILL)
                        except (ProcessLookupError, PermissionError):
                            pass
                        child.wait()
                        self.returncode = 124
            self.status = "finish" if self.returncode == 0 else "error"
        except Exception:
            logging.exception("task %s raised", self.name)
            self.returncode = 1
            self.status = "error"
        if self.status == "error":
            self.ets += 1


class Queue:
    """Run a task list with retry-forever semantics
    (reference Queue, TasksManager.py:116-311).

    `max_retries` bounds the reference's infinite retry loop
    (repending_error_list, TasksManager.py:213-221) so a deterministic bug
    cannot hang a batch run; set None for reference-faithful infinity.
    """

    def __init__(self, task_list: List[Task], device_list: Optional[List] = None,
                 max_retries: Optional[int] = 3):
        self.task_list = list(task_list)
        # device pinning (-g <dev> appended to subprocess commands, like the
        # reference Worker, TasksManager.py:64) only happens when a device
        # list is explicitly provided — generic shell commands must not grow
        # an unexpected flag
        self.pin_devices = device_list is not None
        self.device_list = device_list or [0]
        self.max_retries = max_retries
        self.finish_list: List[Task] = []
        self.error_list: List[Task] = []

    def init_sharecost_dict(self):  # API compat (TasksManager.py:127-138)
        pass

    def status_table(self) -> str:
        # finish_list/error_list hold the same Task objects as task_list
        rows = ["name        status   retries"]
        for t in self.task_list:
            rows.append(f"{t.name:<12}{t.status:<9}{t.ets}")
        return "\n".join(rows)

    def start(self, time_interval: float = 0.0, max_task: int = 1,
              log: bool = False, remind: bool = False, debug: bool = False,
              autogpu: bool = True) -> None:
        """max_task > 1 runs tasks concurrently in a thread pool (for
        subprocess or host-bound tasks; sched/multitask.py runs in-process
        experiments one at a time)."""
        pending = list(self.task_list)
        lock = threading.Lock()
        # round-robin device slot pool: each running task holds one device
        # from device_list for its lifetime (the reference Worker pins each
        # child to a GPU, TasksManager.py:64).  Never run more concurrent
        # tasks than device slots — a worker without a slot would fall to
        # the default device and silently oversubscribe it.
        free_devices = list(self.device_list) if self.pin_devices else []
        if self.pin_devices and max_task > len(self.device_list):
            logging.warning(
                "max_task=%d exceeds the %d device slots; clamping "
                "concurrency to the slot count", max_task,
                len(self.device_list))
            max_task = len(self.device_list)

        def next_task():
            # status/ets are written under the lock so a concurrent
            # status_table render never sees a torn update
            with lock:
                if not pending:
                    return None
                task = pending.pop(0)
                task.status = "running"
                if free_devices:
                    task.device = free_devices.pop(0)
                return task

        def settle(task):
            with lock:
                if task.device is not None:
                    free_devices.append(task.device)
                    task.device = None
                if task.status == "finish":
                    self.finish_list.append(task)
                elif self.max_retries is None or task.ets <= self.max_retries:
                    logging.warning("task %s failed (attempt %d); re-queueing",
                                    task.name, task.ets)
                    pending.append(task)  # retry (reference retries forever)
                else:
                    logging.error("task %s failed permanently", task.name)
                    self.error_list.append(task)

        def worker():
            while True:
                task = next_task()
                if task is None:
                    return
                if log:
                    logging.info("running %s", task.name)
                task.run(debug=debug)
                settle(task)
                if time_interval:
                    time.sleep(time_interval)

        if max_task <= 1:
            worker()
            return
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max_task)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
