"""What a per-layer metric's reader is given: the clean window's rate, the
traced sub-window's summary, and the work a unit needs by the counts."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from portbench import counts
from portbench.harness.trace import TraceSummary


@dataclass
class Readings:
    unit: str                             # what a loop counts: "step"
    units_per_s: float                    # the clean window's rate
    trace: TraceSummary                   # the traced sub-window
    work: Dict[str, Tuple[float, float]]  # layer -> (flops, bytes) a unit
    peaks: Dict[str, float]

    def kernel_s_per_unit(self, layer: str) -> float:
        t = self.trace.range_kernel_s.get(layer)
        return t / self.trace.units if t else 0.0

    def roofline(self, layer: str) -> Optional[float]:
        """The least time for a unit's products and bytes over the device
        time of the kernels launched inside the layer's ranges, in %."""
        t = self.kernel_s_per_unit(layer)
        if not t or layer not in self.work:
            return None
        flops, nbytes = self.work[layer]
        return 100.0 * counts.least_seconds(flops, nbytes, self.peaks) / t

    def mfu(self, layer: str) -> Optional[float]:
        """A unit's product operations times the clean window's units a
        second, over the TF32 peak, in %."""
        if layer not in self.work:
            return None
        return 100.0 * self.work[layer][0] * self.units_per_s \
            / self.peaks["tf32_flops_per_s"]

    def launches_per_unit(self) -> Optional[float]:
        if not self.trace.launches:
            return None
        return self.trace.launches / self.trace.units

    def idle_share(self) -> float:
        """1 - busy seconds a unit (traced) x units a second (clean), in %."""
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.units
                        * self.units_per_s)
