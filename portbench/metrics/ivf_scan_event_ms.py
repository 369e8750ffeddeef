"""``ivf_scan_event_ms`` (ms): mean device time of one IVF scan in the
traced window: from the first to the last device activity
(``torch.profiler``) inside each of the program's ``ivf.scan`` spans,
which hold the probe, kernel 7 with its work list and gather, the merge,
the copies and the launch gaps between them, mapped onto the host's clock
by the window mark, as ``scan_event_ms`` maps ``embedding_store.scan``.
None where the program records no such span."""

import bisect

from portbench.metrics._program import device_on_host, in_window, mean


def read(run):
    device = device_on_host(run)
    scans = in_window(run, "ivf.scan")
    if device is None or not scans:
        return None
    busy = device[1]
    starts = [lo for lo, _ in busy]
    times = []
    for s in scans:
        first = last = None
        j = max(0, bisect.bisect_right(starts, s[0]) - 1)
        while j < len(busy) and busy[j][0] < s[1]:
            lo, hi = max(busy[j][0], s[0]), min(busy[j][1], s[1])
            if hi > lo:
                first = lo if first is None else first
                last = hi
            j += 1
        if first is not None:
            times.append(1e3 * (last - first))
    return mean(times)
