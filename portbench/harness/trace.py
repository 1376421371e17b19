"""The traced sub-window: a torch.profiler session around a short stretch of
the cell's own work, and the reduction of its Chrome trace to what the
per-layer metrics read.

From the trace it takes, per unit of work (a training step, a decompress):
the union of the intervals in which the device ran anything (kernels,
copies, memsets), the device time of the kernels launched inside each
`portbench.<layer>` range (capture.ranges), and the host's launch calls;
and for the result line the device operations that took most time and the
longest idle gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                    r"GraphLaunch|Memcpy|Memset)")
RANGE_PREFIX = "portbench."


@dataclass
class TraceSummary:
    """What one traced sub-window holds, per unit of work."""
    units: int
    window_s: float                    # host time of the sub-window
    busy_s: float                      # union of device intervals
    launches: int                      # host launch calls
    range_kernel_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    device_events: int = 0


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (same unit)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: List[Dict], units: int, window_s: float,
              top: int = 10) -> TraceSummary:
    """Reduce Chrome-trace events (microsecond ts/dur) to a TraceSummary."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    busy_us = union_seconds(spans)

    launches = [e for e in host if LAUNCH.match(e.get("name", ""))]

    # kernels by the range their launch call lies in (same host thread)
    corr_of_range: Dict[str, set] = defaultdict(set)
    ranges_by_tid: Dict[object, List[Tuple[float, float, str]]] = \
        defaultdict(list)
    for e in xs:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and \
                name.startswith(RANGE_PREFIX):
            ranges_by_tid[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 name[len(RANGE_PREFIX):]))
    for rs in ranges_by_tid.values():
        rs.sort()
    starts_by_tid = {tid: [r[0] for r in rs]
                     for tid, rs in ranges_by_tid.items()}
    for e in launches:
        rs = ranges_by_tid.get(e.get("tid"))
        if not rs:
            continue
        t = float(e["ts"])
        i = bisect.bisect_right(starts_by_tid[e.get("tid")], t)
        # ranges nest at most a few deep: the open ones start just before t
        for s, end, layer in rs[max(0, i - 4):i]:
            if s <= t <= end:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    corr_of_range[layer].add(c)
    range_kernel_s = {}
    for layer, corrs in corr_of_range.items():
        mine = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in dev
                if (e.get("args") or {}).get("correlation") in corrs]
        range_kernel_s[layer] = union_seconds(mine) * 1e-6

    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e.get("name", "?")] += float(e["dur"]) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    idle_gaps = _idle_gaps(merged(spans), xs, top)
    return TraceSummary(units=units, window_s=window_s,
                        busy_s=busy_us * 1e-6, launches=len(launches),
                        range_kernel_s=range_kernel_s, device_ops=device_ops,
                        idle_gaps=idle_gaps, device_events=len(dev))


def _idle_gaps(busy: List[Tuple[float, float]], xs: List[Dict], top: int
               ) -> List[Tuple[str, float]]:
    """The gaps between device busy intervals, summed by the innermost host
    event (an op, a range or a runtime call) open at each gap's start."""
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "?")) for e in xs
                   if e.get("cat") not in DEVICE_CATS
                   and e.get("cat") != "gpu_user_annotation"),
                  key=lambda h: h[0])
    starts = [h[0] for h in host]
    by_name: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        i = bisect.bisect_right(starts, e0)
        name = "host"
        # the latest-starting event still open at e0 is the innermost
        for s, e, n in reversed(host[max(0, i - 5000):i]):
            if e0 < e:
                name = n
                break
        by_name[name] += gap * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


class Profiled:
    """A profiler session over a sub-window: start(), the work, stop(units).
    The trace goes to a temporary file under TMPDIR and is deleted once
    read."""

    def __init__(self):
        self.prof = None
        self.t0 = 0.0
        self.summary: Optional[TraceSummary] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, units: int) -> TraceSummary:
        import torch
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self.prof = None
        self.summary = summarize(events, units, window_s)
        return self.summary
