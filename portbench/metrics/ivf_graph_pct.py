"""``ivf_graph_pct`` (%): the share of the unfiltered IVF scans in the
traced window that replayed a CUDA graph of the scan (``IVFIndex.search``
on a card, with no filter and a few queries): the program's ``ivf.scan``
spans whose ``graph`` attribute is True, over the unfiltered ones that
carry the attribute.  None where no span carries it (a program without the
graph path).  Program spans."""

from portbench.metrics._program import in_window


def read(run):
    flags = [s[6]["graph"] for s in in_window(run, "ivf.scan") if "graph" in s[6] and not s[6].get("masked", True)]
    return 100.0 * sum(flags) / len(flags) if flags else None
