"""``inline_pct`` (%): the share of the micro-batcher's batches in the
traced window that ran inline, on their caller's thread, because the
request found the batcher idle (nothing queued, no batch in flight): the
``batcher.execute`` spans whose ``inline`` attribute is True, over those
that carry the attribute.  None where the program records no such
attribute (a micro-batcher without the idle path).  Program spans."""

from portbench.metrics._program import in_window


def read(run):
    flags = [s[6]["inline"] for s in in_window(run, "batcher.execute") if "inline" in s[6]]
    return 100.0 * sum(flags) / len(flags) if flags else None
