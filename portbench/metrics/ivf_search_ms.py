"""``ivf_search_ms`` (ms): mean time of one ``IVFIndex.search`` call in the
traced window, host to host (the program's ``ivf.search`` span: the
query upload, the probe, kernel 7, the merge, the download and the slots
mapped to rows).  None where the program records no such span."""

from portbench.metrics._program import in_window
from portbench.metrics._window import mean_ms


def read(run):
    return mean_ms(in_window(run, "ivf.search"))
