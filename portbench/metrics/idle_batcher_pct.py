"""``idle_batcher_pct`` (%): the share of the traced window in which the
card runs nothing while some request is between its enqueue in the
micro-batcher (its ``batcher.queue`` span's start) and its batch's start on
an executor thread (the batch's ``batcher.dispatch`` span's end): the
device's idle gaps (``torch.profiler``) intersected with those intervals,
mapped onto the host's clock by the window mark."""

from portbench.metrics._program import device_on_host, overlap_s, recorded


def read(run):
    device = device_on_host(run)
    spans = recorded(run)
    if device is None or not spans:
        return None
    started = {s[5]: s[1] for s in spans.get("batcher.dispatch", [])}
    waiting = [(s[0], started[s[5]]) for s in spans.get("batcher.queue", []) if s[5] in started]
    if not waiting:
        return None
    return 100.0 * overlap_s(device[0], waiting) / run.traced.device["window_s"]
