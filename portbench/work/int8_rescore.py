"""What one search call of the int8 tier with exact rescore needs, whatever
implements it: the int8 rows and their float32 scales read once, the
queries (int8 with a scale each, and bf16 for the rescore), the bf16 rows
of the k results it returns, and the k results written; 2·B·N·D int8
operations.  The rescore pool beyond the k results is the program's choice
and is not counted, so a change to the pool shows in the share."""


def work(batch: int, k: int, rows: int, dim: int) -> dict:
    return {
        "moved_bytes": rows * dim + rows * 4 + batch * (dim + 4 + dim * 2) + batch * k * (dim * 2 + 8),
        "ops": 2 * batch * rows * dim,
        "unit": "int8",
    }
