"""``setup_s`` (s): from the process's start to the first timed request:
imports, the kernels' build where the checkout has none, the rows made on
the card, the metadata and the index, the warm-up."""


def read(run):
    return run.setup_s
