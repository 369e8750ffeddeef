"""``store_call_ms`` (ms): mean time of one batched ``EmbeddingStore.search``
call in the traced window, host to host (a harness span wrapped at run time
around the live store's search: upload, search op, results to the host)."""

from portbench.metrics._window import inside, mean_ms


def read(run):
    return mean_ms(inside(run, run.store_calls))
