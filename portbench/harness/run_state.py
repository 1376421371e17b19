"""The state a run hands between the harness and a traffic loop."""
from __future__ import annotations

import copy
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench.harness.manifest import Cell
from portbench.harness.trace import TraceSummary


class WindowClosed(Exception):
    """Raised from a progress hook to end the program's loop at the end of
    the measured window."""


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object                      # torch.device
    t_start: float                      # perf_counter at process start
    data_path: Optional[str] = None     # tests: another volume
    overrides: Dict = field(default_factory=dict)  # tests: dotted config keys

    def config(self):
        """The configuration as run: a fresh Config of the cell's file."""
        from brief_pytorch_tpu_torch.core.config import Config
        cfg = Config(copy.deepcopy(self.cell.config["config"]))
        if self.data_path:
            cfg.Dataset.data_path = self.data_path
        for k, v in self.overrides.items():
            cfg.set_path(k, v)
        return cfg

    def say(self, text: str) -> None:
        print(text, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    """What a traffic loop measured and checked."""
    end_to_end: Dict[str, float]
    unit: str
    units_per_s: float
    attempted: int
    failed: int
    checks: Dict[str, float]
    memory_peak_bytes: int
    work: Dict[str, Tuple[float, float]]
    trace: Optional[TraceSummary] = None
    notes: List[str] = field(default_factory=list)


class SmiSampler:
    """nvidia-smi's clocks and power, read just before the window opens and
    just after it closes, never inside it, where its process would take
    host time from the loop."""

    QUERY = "name,power.limit,clocks.sm,clocks.mem,power.draw,temperature.gpu"

    def __init__(self):
        self.samples: List[Tuple[str, str]] = []

    def sample(self, when: str) -> None:
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20).stdout.strip().splitlines()
        except (OSError, subprocess.SubprocessError) as e:
            out = [f"nvidia-smi failed: {e}"]
        self.samples.append((when, out[0] if out else ""))
