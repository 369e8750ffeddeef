"""``reconstruct_ms`` (ms): mean time of a ``get_embedding_by_photo_path``
call in the traced window (a harness span around it, host clock).  The
one-row read waits on the default stream behind any scan in flight."""

from portbench.metrics._window import inside, mean_ms


def read(run):
    return mean_ms(inside(run, run.spans["reconstruct"]))
