"""Reduction of a torch.profiler Chrome trace: the device's busy time
over the traced window, device time under named host ranges, the
longest idle gaps by what the host was doing, and the operations that
took most time.

A kernel belongs to a host range when the runtime call that launched it
(the same `correlation` id) started inside the range, on the range's
thread."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "portbench.traced_window"


@dataclass
class Trace:
    window: Tuple[float, float]                 # µs, the traced window
    main_tid: object                            # thread of the window range
    device: List[tuple] = field(default_factory=list)   # (ts, end, name, corr)
    launches: Dict[int, tuple] = field(default_factory=dict)  # corr -> (tid, ts)
    ranges: List[tuple] = field(default_factory=list)   # (ts, end, name, tid)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def load(path: str) -> Trace:
    with open(path) as f:
        return reduce_events(json.load(f)["traceEvents"])


def reduce_events(events) -> Trace:
    win, dev, launches, ranges = None, [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"],
                        e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat in HOST_CATS:
            if e["name"] == WINDOW and cat == "user_annotation":
                win = (ts, ts + dur, e.get("tid"))
            ranges.append((ts, ts + dur, e["name"], e.get("tid")))
    if win is None:
        raise ValueError(f"the trace holds no {WINDOW} range")
    dev.sort()
    return Trace((win[0], win[1]), win[2], dev, launches, ranges)


def busy_intervals(tr: Trace) -> List[Tuple[float, float]]:
    """The union of device-operation intervals, clipped to the window."""
    lo, hi = tr.window
    out = []
    for ts, end, _, _ in tr.device:
        ts, end = max(ts, lo), min(end, hi)
        if end <= ts:
            continue
        if out and ts <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((ts, end))
    return out


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) * 1e-6


def device_s_under(tr: Trace, names) -> float:
    """Seconds of device operations in the window launched from inside a
    host range whose name is in `names`."""
    names = set(names)
    by_tid = defaultdict(list)
    for ts, end, name, tid in tr.ranges:
        if name in names:
            by_tid[tid].append((ts, end))
    for v in by_tid.values():
        v.sort()
    lo, hi = tr.window
    total = 0.0
    for ts, end, _, corr in tr.device:
        if corr not in tr.launches or end <= lo or ts >= hi:
            continue
        tid, t_launch = tr.launches[corr]
        spans = by_tid.get(tid, ())
        i = bisect.bisect_right(spans, (t_launch, float("inf"))) - 1
        # ranges on one thread nest or follow each other: look back over
        # those that started before the launch
        while i >= 0:
            a, b = spans[i]
            if a <= t_launch <= b:
                total += min(end, hi) - max(ts, lo)
                break
            i -= 1
    return total * 1e-6


def top_device_ops(tr: Trace, n: int = 10):
    lo, hi = tr.window
    acc = defaultdict(float)
    for ts, end, name, _ in tr.device:
        if end > lo and ts < hi:
            acc[name] += (min(end, hi) - max(ts, lo)) * 1e-6
    return sorted(([k, v] for k, v in acc.items()), key=lambda r: -r[1])[:n]


def idle_gaps(tr: Trace, n: int = 10):
    """Idle time in the window, summed by the innermost host range open on
    the window's thread at each gap's start ("python" where none is)."""
    lo, hi = tr.window
    gaps, t = [], lo
    for a, b in busy_intervals(tr):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    main = sorted((ts, end, name) for ts, end, name, tid in tr.ranges
                  if tid == tr.main_tid and name != WINDOW)
    acc, stack, i = defaultdict(float), [], 0
    for a, b in gaps:                  # a sweep: ranges nest on one thread
        while i < len(main) and main[i][0] <= a:
            while stack and stack[-1][0] <= main[i][0]:
                stack.pop()
            stack.append((main[i][1], main[i][2]))
            i += 1
        while stack and stack[-1][0] <= a:
            stack.pop()
        acc[stack[-1][1] if stack else "python"] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in acc.items()), key=lambda r: -r[1])[:n]
