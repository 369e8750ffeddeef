"""``handoff_ms`` (ms): mean per request of the traced window of the time
spent handing work between threads: its batch's ``batcher.dispatch`` (the
collector's cut to the batch running on its executor thread: the wait for a
free pipeline slot and the thread's start) plus its own ``batcher.wake``
(the results set to the caller running again).  Program spans."""

from portbench.metrics._program import in_window, mean, recorded


def read(run):
    spans = recorded(run)
    if not spans:
        return None
    dispatch = {s[5]: s[1] - s[0] for s in spans.get("batcher.dispatch", [])}
    return mean([1e3 * (dispatch[s[5]] + s[1] - s[0]) for s in in_window(run, "batcher.wake") if s[5] in dispatch])
