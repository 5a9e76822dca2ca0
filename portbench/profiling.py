"""The traced slice: a few whole solves under ``torch.profiler`` (CPU and,
on a card, CUDA activity through CUPTI), reduced to what the per-layer
metrics read.

* device activity: every kernel, memcpy and memset on the card, with its
  start and end (ns, the profiler's clock);
* host activity: every CPU-side operator and runtime call;
  (the slice's own annotation, which the profiler mirrors on the device's
  timeline, is neither)
* the slice: the ``portbench.slice`` annotation around the solves, which
  ends after a synchronise, so its length is the traced window.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType

SLICE = "portbench.slice"


def profile_slice(solve_next: Callable[[], object], min_seconds: float,
                  on_card: bool) -> dict:
    """Whole solves under the profiler until ``min_seconds`` have passed.
    ``solve_next()`` runs the next solve of the stream and returns its
    :class:`SolveResult`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    solves = iterations = 0
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            t0 = time.perf_counter()
            while not solves or time.perf_counter() - t0 < min_seconds:
                iterations += solve_next().iterations
                solves += 1
            if on_card:
                torch.cuda.synchronize()
    dev, host, lo, hi = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        on_device = e.device_type() != DeviceType.CPU
        if name == SLICE:
            if not on_device:  # the annotation's host range is the slice
                lo, hi = start, end
        elif on_device:
            dev.append((name, start, end))
        else:
            host.append((name, start, end))
    if lo is None:
        raise RuntimeError("the profiler trace holds no slice annotation")
    dev = [d for d in dev if d[2] > lo and d[1] < hi]
    return {"lo_ns": lo, "hi_ns": hi, "window_s": (hi - lo) * 1e-9,
            "device": dev, "host": host, "iterations": iterations,
            "solves": solves}


def _union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_seconds(tr: dict) -> float:
    """Seconds in which some operation ran on the device, inside the slice."""
    lo, hi = tr["lo_ns"], tr["hi_ns"]
    spans = _union([(max(s, lo), min(e, hi)) for _, s, e in tr["device"]])
    return sum(e - s for s, e in spans) * 1e-9


def kernel_seconds(tr: dict, patterns: Sequence[str]) -> float:
    """Device seconds of the kernels whose name matches any pattern."""
    rx = re.compile("|".join(f"(?:{p})" for p in patterns))
    return sum(e - s for n, s, e in tr["device"] if rx.search(n)) * 1e-9


def kernel_launches(tr: dict) -> int:
    """Kernels that ran in the slice (copies and fills are not launches)."""
    return sum(1 for n, _, _ in tr["device"]
               if not n.startswith(("Memcpy", "Memset")))


def _short(name: str, width: int = 100) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def device_ops(tr: dict, top: int = 10) -> List[list]:
    """The device operations that took most time: ``[[name, seconds], ...]``."""
    by: Dict[str, float] = {}
    for n, s, e in tr["device"]:
        by[_short(n)] = by.get(_short(n), 0.0) + (e - s) * 1e-9
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(tr: dict, top: int = 10) -> List[list]:
    """The device's idle time in the slice, by the innermost host call
    running at each gap's middle: ``[[host call, seconds], ...]``."""
    lo, hi = tr["lo_ns"], tr["hi_ns"]
    busy = _union([(max(s, lo), min(e, hi)) for _, s, e in tr["device"]])
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    if not gaps:
        return []
    host = sorted(tr["host"], key=lambda h: h[1])
    starts = np.array([h[1] for h in host], dtype=np.int64)
    ends = np.array([h[2] for h in host], dtype=np.int64)
    by: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        k = int(np.searchsorted(starts, mid, side="right"))
        name = "host: Python between traced calls"
        # the latest-starting call that still runs at the middle
        for j in range(k - 1, max(-1, k - 400), -1):
            if ends[j] >= mid:
                name = _short(host[j][0])
                break
        by[name] = by.get(name, 0.0) + (g1 - g0) * 1e-9
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def breakdown(tr: Optional[dict]) -> Optional[dict]:
    if tr is None or not tr["device"]:
        return None
    return {"device_ops": device_ops(tr), "idle_gaps": idle_gaps(tr)}
