"""The traced window of a ``--trace 1`` run: a ``torch.profiler`` trace of
the device, reduced to busy time, kernel time, the device operations that
took most time and the idle gaps.

The window is marked by a ``record_function`` range that the harness's
main thread holds open while it lasts; its start on the trace's clock and
on the host's (``time.perf_counter``) ties the harness's own spans to the
trace, so an idle gap can be labelled by the span that was open.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

WINDOW_MARK = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each breakdown list
NAME_CHARS = 64  # a device op's name as the breakdown gives it


def start(torch, cuda: bool):
    """A started profiler of the host's ops and, with ``cuda``, the card's."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities, record_shapes=False, with_stack=False)
    prof.start()
    return prof


def _events(prof) -> List[dict]:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def reduce(events: List[dict]) -> Optional[Dict]:
    """The window's device activity, on the trace's clock in microseconds,
    or None when the trace holds no window mark or no device activity."""
    marks = [e for e in events if e.get("name") == WINDOW_MARK and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    ws = float(marks[0]["ts"])
    we = ws + float(marks[0]["dur"])
    spans, kernel_us, by_name = [], 0.0, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        lo, hi = max(ws, float(e["ts"])), min(we, float(e["ts"]) + float(e.get("dur", 0.0)))
        if hi <= lo:
            continue
        spans.append((lo, hi))
        if e["cat"] == "kernel":
            kernel_us += hi - lo
        name = str(e.get("name", "?"))[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (hi - lo)
    if not spans:
        return None
    busy = _union(spans)
    edges = [ws] + [x for span in busy for x in span] + [we]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return {
        "start_us": ws,
        "window_s": (we - ws) * 1e-6,
        "busy_s": sum(hi - lo for lo, hi in busy) * 1e-6,
        "kernel_s": kernel_us * 1e-6,
        "ops": sorted(((name, us * 1e-6) for name, us in by_name.items()), key=lambda x: -x[1]),
        "gaps_us": gaps,
    }


def read(prof) -> Optional[Dict]:
    return reduce(_events(prof))


def _open_at(spans: List[Tuple[float, float]], starts: List[float], t: float) -> bool:
    """Whether one of ``spans`` (sorted by start, ``starts`` their starts)
    holds the host time ``t``."""
    i = bisect.bisect_right(starts, t)
    return any(lo <= t <= hi for lo, hi in spans[max(0, i - 256) : i])


def label_gaps(device: Dict, host_start: float, spans: Dict[str, List[Tuple[float, float]]],
               order: Tuple[str, ...]) -> List[List]:
    """The ``TOP`` longest idle gaps, ``[label, seconds]``: the first span
    name in ``order`` that was open at the gap's middle (host clock), else
    ``"none"``.  ``host_start`` is the host time at the window mark's start."""
    offset = device["start_us"] * 1e-6 - host_start
    sorted_spans = {name: sorted(spans.get(name, [])) for name in order}
    starts = {name: [lo for lo, _ in s] for name, s in sorted_spans.items()}
    out = []
    for lo, hi in sorted(device["gaps_us"], key=lambda g: g[0] - g[1])[:TOP]:
        mid = (lo + hi) * 0.5e-6 - offset
        label = next((n for n in order if _open_at(sorted_spans[n], starts[n], mid)), "none")
        out.append([label, (hi - lo) * 1e-6])
    return out
