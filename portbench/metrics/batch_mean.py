"""``batch_mean`` (req/batch): requests served over batches run by the
micro-batcher in the traced window (its own counters)."""


def read(run):
    t = run.traced
    return t.requests / t.batches if t.batches else None
