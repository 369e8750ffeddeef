"""``scan_roofline`` (%): the least time the store calls of the traced
window need, summed over the calls that lie wholly in it (each call's
bytes and operations from the configuration's ``portbench/work/`` file,
against ``portbench/peaks.py``), over the device time of every kernel in
the window (``torch.profiler``).  A call's kernels run inside its host
span, so the calls counted are no more than the kernels timed."""

from portbench.metrics._window import inside


def read(run):
    device = run.traced.device
    calls = inside(run, run.store_calls)
    if device is None or not calls or device["kernel_s"] <= 0:
        return None
    return 100.0 * sum(run.least_seconds(b, k) for _, _, b, k in calls) / device["kernel_s"]
