"""``queue_wait_ms`` (ms): mean time a request of the traced window waits in
the micro-batcher's queue, from its enqueue to the collector taking it into
a batch, the linger included (the program's ``batcher.queue`` span)."""

from portbench.metrics._program import in_window
from portbench.metrics._window import mean_ms


def read(run):
    return mean_ms(in_window(run, "batcher.queue"))
