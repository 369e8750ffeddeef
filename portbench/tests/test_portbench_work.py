"""The work files count what one search call needs, by hand at small shapes,
and the least time follows the larger of its two bounds."""

import pytest

from portbench import manifest, peaks


def test_flat_bf16_by_hand():
    w = manifest.work("flat_bf16").work(batch=2, k=3, rows=10, dim=4)
    # corpus 10·4·2 + queries 2·4·2 + results 2·3·(4 + 4)
    assert w == {"moved_bytes": 80 + 16 + 48, "ops": 2 * 2 * 10 * 4, "unit": "bf16"}


def test_int8_rescore_by_hand():
    w = manifest.work("int8_rescore").work(batch=2, k=3, rows=10, dim=4)
    # int8 rows 40 + scales 40 + queries 2·(4 + 4 + 8) + result rows 2·3·8 + results 2·3·8
    assert w == {"moved_bytes": 40 + 40 + 32 + 48 + 48, "ops": 2 * 2 * 10 * 4, "unit": "int8"}


@pytest.mark.parametrize("name, batch, bound", [
    ("flat_bf16", 1, "bytes"), ("flat_bf16", 64, "bytes"), ("int8_rescore", 1, "bytes"),
])
def test_least_time_at_the_cells_shapes(name, batch, bound):
    w = manifest.work(name).work(batch=batch, k=50, rows=5_000_000, dim=1536)
    by_bytes = w["moved_bytes"] / peaks.HBM_BYTES_PER_S
    by_ops = w["ops"] / peaks.PEAK_OPS_PER_S[w["unit"]]
    assert peaks.least_seconds(**w) == max(by_bytes, by_ops)
    assert (by_bytes >= by_ops) == (bound == "bytes")


def test_flat_5m_corpus_read_takes_4_6_ms():
    w = manifest.work("flat_bf16").work(batch=1, k=50, rows=5_000_000, dim=1536)
    assert 4.58e-3 < peaks.least_seconds(**w) < 4.59e-3
