"""Reduce a ``torch.profiler`` trace of a steady window to the numbers
the per-layer metrics and the result's ``device`` and ``breakdown`` read.

The trace is PyTorch's Chrome-trace export.  Device activity is every
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` event; busy time is the
union of their intervals inside the window (sums of self times count
overlapping work twice).  The window is the ``bench.window``
annotation the harness opens around the traced solves.  Idle gaps are
the stretches of the window with no device activity, each named by the
innermost host event (an ATen op or a CUDA runtime call) running at its
midpoint, or ``host (untraced)`` where none runs.
"""
from __future__ import annotations

import heapq
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW_ANNOTATION = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
COMM_PREFIXES = ("nccl",)
TOP = 10

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The sorted, disjoint union of ``(start, end)`` intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def gaps(busy: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of ``[lo, hi]`` that ``busy`` (disjoint, sorted)
    leaves uncovered."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def name_gaps(gap_list: List[Interval],
              host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle time by the innermost host event covering each gap's
    midpoint (events ``(start, end, name)``)."""
    by_name: Dict[str, float] = defaultdict(float)
    mids = sorted(((a + b) / 2, b - a) for a, b in gap_list)
    events = sorted(host)
    active: List[Tuple[float, float, float, str]] = []   # (-start, ...)
    i = 0
    for mid, length in mids:
        while i < len(events) and events[i][0] <= mid:
            a, b, name = events[i]
            heapq.heappush(active, (-a, a, b, name))
            i += 1
        # innermost = latest-starting event still running at ``mid``
        found = None
        popped = []
        while active:
            item = heapq.heappop(active)
            if item[2] >= mid:
                found = item
                popped.append(item)
                break
        for item in popped:
            heapq.heappush(active, item)
        by_name[found[3] if found else "host (untraced)"] += length
    return by_name


def reduce_events(events: List[dict]) -> Optional[dict]:
    """``busy_s``, ``window_s``, ``comm_s``, ``device_ops`` and
    ``idle_gaps`` of one trace's events (Chrome-trace dicts, times in
    microseconds); ``None`` where the trace holds no window."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_ANNOTATION
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    lo = min(float(e["ts"]) for e in win)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in win)
    dev, comm, host = [], [], []
    op_time: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((a, b))
            name = str(e.get("name", ""))
            if b > lo and a < hi:
                op_time[name] += min(b, hi) - max(a, lo)
            if name.lower().startswith(COMM_PREFIXES):
                comm.append((a, b))
        elif cat in HOST_CATS:
            host.append((a, b, str(e.get("name", ""))))
    busy = _clip(union(dev), lo, hi)
    idle = name_gaps(gaps(busy, lo, hi), host)
    us = 1e-6
    return {
        "window_s": (hi - lo) * us,
        "busy_s": _length(busy) * us,
        "comm_s": _length(_clip(union(comm), lo, hi)) * us,
        "device_events": len(dev),
        "device_ops": [[n[:160], t * us] for n, t in sorted(
            op_time.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n[:160], t * us] for n, t in sorted(
            idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def reduce_file(path) -> Optional[dict]:
    """:func:`reduce_events` of an exported Chrome trace."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return reduce_events(events)
