"""What the readers of the program's own spans share: the spans that
``photo_search_engine_tpu_torch/tracing.py`` recorded while the profiler
ran, on the harness's clock (``time.perf_counter`` seconds; the program
stamps ``perf_counter_ns``, the same clock), and the device's activity
mapped onto that clock."""

from portbench.metrics._window import inside
from portbench.trace import _union


def recorded(run):
    """Every span the program recorded, by name, each as ``(start s, end s,
    id, parent, req, batch, attrs)``; None where the program records none
    (a checkout without the tracer, or a run with no traced window)."""
    if run.traced is None:
        return None
    try:
        from photo_search_engine_tpu_torch import tracing
    except ImportError:
        return None
    by_name = {}
    for name, sid, parent, req, batch, t0, t1, attrs in tracing.spans():
        by_name.setdefault(name, []).append((t0 * 1e-9, t1 * 1e-9, sid, parent, req, batch, attrs))
    return by_name or None


def in_window(run, name):
    """The spans ``name`` that lie wholly in the traced window."""
    spans = recorded(run)
    return inside(run, spans.get(name, [])) if spans else []


def device_on_host(run):
    """The device's idle gaps and busy intervals in the traced window, each
    a sorted list of ``(start s, end s)`` on the host's clock: the trace's
    times less the window mark's offset (its start on the trace's clock
    less its start on the host's).  None without a device trace."""
    device = run.traced.device if run.traced is not None else None
    if device is None or device["window_s"] <= 0:
        return None
    offset = device["start_us"] * 1e-6 - run.traced.host_start
    gaps = sorted((lo * 1e-6 - offset, hi * 1e-6 - offset) for lo, hi in device["gaps_us"])
    edges = [run.traced.host_start] + [t for gap in gaps for t in gap] + [run.traced.host_start + device["window_s"]]
    busy = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return gaps, busy


def mean(values):
    return sum(values) / len(values) if values else None


def overlap_s(a, b):
    """Seconds that two lists of intervals share (each list merged first)."""
    a, b = _union(a), _union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
