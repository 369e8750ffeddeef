"""What kernel 7 must do for one scan of a bfloat16 IVF layout, whatever
implements it, from the attributes of the program's ``ivf.scan`` span:
the live rows of the distinct probed lists read once (``list_rows``), one
``row_valid`` byte for each slot of those lists (``lists`` · ``lrows``),
the queries read once and the k results written once; 2 operations a
dimension for each row scored over the (query, list) pairs
(``pair_rows``) on the bf16 tensor cores.  The padding slots, the partials
of each (query, list) pair and the rows of a list probed twice are the
program's choice and are not counted, so a share of this bound cannot
pass 100 %.  ``rows`` (the corpus) is taken for the shared signature and
not used: the probes, not the corpus, set the work."""


def work(batch: int, k: int, rows: int, dim: int, *, list_rows: int, pair_rows: int, lists: int,
         lrows: int) -> dict:
    return {
        "moved_bytes": list_rows * dim * 2 + lists * lrows + batch * dim * 2 + batch * k * 8,
        "ops": 2 * pair_rows * dim,
        "unit": "bf16",
    }
