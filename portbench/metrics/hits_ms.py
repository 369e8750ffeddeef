"""``hits_ms`` (ms): mean time of building a request's hits, the metadata
dicts of its k rows, in the traced window (the program's
``vector_index.hits`` span)."""

from portbench.metrics._program import in_window
from portbench.metrics._window import mean_ms


def read(run):
    return mean_ms(in_window(run, "vector_index.hits"))
