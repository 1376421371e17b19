"""Run logger: collision-avoiding run dirs, optional tensorboard scalars,
stderr redirect, script provenance copy, CSV metric rows.

Capability parity: reference utils/Logger.py:11-67 (MyLogger) plus the
performance.csv writer from main.py:444-450.
"""
from __future__ import annotations

import csv
import os
import sys
import time
from os.path import join as opj
from typing import Dict

_TIMESTAMP = time.strftime("_%Y_%m%d_%H%M%S")


class MyLogger:
    def __init__(self, project_name: str, stdlog: bool = True,
                 tensorboard: bool = True, outputs_dir: str = "outputs",
                 time: bool = False):
        self.project_dir = opj(outputs_dir, project_name)
        if time:
            self.project_dir += _TIMESTAMP
        temp = self.project_dir
        i = 0
        while os.path.exists(temp):   # unbounded: never reuse a run dir
            temp = self.project_dir + "-" + str(i)
            i += 1
        self.project_dir = temp
        self.logdir = self.project_dir
        self.tb = None
        os.makedirs(self.logdir, exist_ok=True)
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(self.logdir, flush_secs=30)
            except Exception:
                self.tb = None
        # scope the stderr redirect to this run and restore it in close():
        # the reference reassigns sys.stderr and never restores it
        # (Logger.py:34-36), so in MultiTask later tracebacks land in an
        # earlier run's stderr.log — improve, don't replicate
        self._stderr_file = None
        self._prev_stderr = None
        if stdlog:
            self._prev_stderr = sys.stderr
            self._stderr_file = open(opj(self.logdir, "stderr.log"), "w")
            sys.stderr = self._stderr_file
        self.script_dir = opj(self.project_dir, "script")
        os.makedirs(self.script_dir, exist_ok=True)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, v, step)

    def append_csv_row(self, csv_path: str, row: Dict[str, float]) -> None:
        """performance.csv rows (header written once)."""
        new = not os.path.exists(csv_path)
        with open(csv_path, "a", newline="") as f:
            writer = csv.writer(f, dialect="excel")
            if new:
                writer.writerow(row.keys())
            writer.writerow(row.values())

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
        if self._stderr_file is not None:
            if sys.stderr is self._stderr_file:
                sys.stderr = self._prev_stderr
                self._stderr_file.close()
            # else: somebody re-redirected after us and may still hold our
            # file as THEIR _prev_stderr (out-of-order close) — leave both
            # the redirect and the file alone so a later restore never
            # lands on a closed file
            self._stderr_file = None
