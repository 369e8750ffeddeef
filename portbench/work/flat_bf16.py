"""What one exact search call over a bfloat16 corpus needs, whatever
implements it: the corpus read once, the queries read once, the k results
(a float32 distance and an int32 row id each) written once; 2·B·N·D
operations on the bf16 tensor cores."""


def work(batch: int, k: int, rows: int, dim: int) -> dict:
    return {
        "moved_bytes": rows * dim * 2 + batch * dim * 2 + batch * k * 8,
        "ops": 2 * batch * rows * dim,
        "unit": "bf16",
    }
