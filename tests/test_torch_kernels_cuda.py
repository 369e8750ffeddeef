"""The CUDA kernels against their plain PyTorch versions, on the card:
kernel 1 (block_topk), kernel 2 (int8_block_topk), their grouped
variants, kernel 5 (grouped_block_topk) and kernel 6
(int8_grouped_block_topk), and kernel 7 (ivf_block_topk, the IVF scan).

A CUDA kernel has no CPU mode, so these tests need a card and skip
without one; the plain versions they are held to run on the CPU in
``test_torch_topk.py``, ``test_torch_grouped_mask.py``,
``test_torch_quantized.py`` and ``test_torch_ivf.py``.  On a machine
with a card and without jax (this file imports none), run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: kernels 1, 5 and 7 (float layouts) values within 1e-5 of the
plain float32 product (summation order only, unit rows); kernels 2 and 6,
and kernel 7 on an int8 layout, identical (exact int32 dot, the same
float32 scaling)."""

import pytest
import torch

from photo_search_engine_tpu_torch.ops import grouped_mask as go
from photo_search_engine_tpu_torch.ops import ivf_scan as io
from photo_search_engine_tpu_torch.ops import quantized as qo
from photo_search_engine_tpu_torch.ops import topk as to
from tests.torch_parity import assert_topk_match

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _unit(n, d, gen, dtype=torch.float32):
    x = torch.randn((n, d), generator=gen, device="cuda")
    return (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("k,q", [(1, 3), (10, 40), (64, 9)])
def test_block_topk_matches_plain(gen, dtype, metric, k, q):
    corpus, queries = _unit(3000, 256, gen, dtype), _unit(q, 256, gen, dtype)
    mask = (torch.rand(3000, generator=gen, device="cuda") < 0.5).to(torch.int8)
    kw = dict(count=2900, metric=metric, mask=mask, cnorms=to.row_sq_norms(corpus), block_n=1024)
    before = to.block_topk.launches
    got_v, got_i = to.block_topk(corpus, queries, k, **kw)
    torch.cuda.synchronize()
    assert to.block_topk.launches == before + 1
    ref_v, ref_i = to.exact_block_topk_plain(corpus, queries, k + 1, **kw)
    assert_topk_match(got_v, got_i, ref_v[..., :k], ref_i[..., :k], tol=1e-5, cut=ref_v[..., k])


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("k,q", [(10, 3), (50, 20)])
def test_int8_block_topk_identical_to_plain(gen, metric, k, q):
    ref_rows = _unit(5000, 256, gen, torch.bfloat16)
    c8, cs = qo.quantize_rows(ref_rows)
    q8, qs = qo.quantize_rows(_unit(q, 256, gen))
    mask = (torch.rand(5000, generator=gen, device="cuda") < 0.7).to(torch.int8)
    kw = dict(count=4800, metric=metric, mask=mask, cnorms=to.row_sq_norms(ref_rows), block_n=2048)
    got = qo.int8_block_topk(c8, cs, q8, qs, k, **kw)
    ref = qo.int8_block_topk_plain(c8, cs, q8, qs, k, **kw)
    assert_topk_match(*got, *ref, tol=0.0, exact=True)


def test_wrappers_check_their_inputs(gen):
    corpus = _unit(100, 64, gen)
    with pytest.raises(ValueError):
        to.block_topk(corpus, corpus.to(torch.bfloat16), 5, count=100)
    with pytest.raises(ValueError):
        to.block_topk(corpus, corpus[:, :32].contiguous(), 5, count=100)
    with pytest.raises(ValueError):
        to.block_topk(corpus, corpus, 65, count=100)
    with pytest.raises(ValueError):
        to.block_topk(corpus, corpus, 5, count=100, metric="l2")  # no cnorms
    with pytest.raises(ValueError):
        to.block_topk(corpus, corpus, 5, count=100, mask=torch.ones(100, dtype=torch.int8))  # mask on the host
    c8, cs = qo.quantize_rows(_unit(100, 66, gen))
    with pytest.raises(ValueError):
        qo.int8_block_topk(c8, cs, c8, cs, 5, count=100)  # D % 4 != 0
    # a score tile past the shared memory of one SM: the C entry returns the error
    with pytest.raises(RuntimeError, match="cudaError"):
        to.block_topk(corpus, corpus, 5, count=100, block_n=65536)
    c8, cs = qo.quantize_rows(corpus)
    with pytest.raises(RuntimeError, match="cudaError"):
        qo.int8_block_topk(c8, cs, c8, cs, 5, count=100, block_n=65536)
    # the error is not left behind for the next launch to report
    to.block_topk(corpus, corpus, 5, count=100)
    qo.int8_block_topk(c8, cs, c8, cs, 5, count=100)


def _predicates(gen, m, n, q):
    """A random [m, n] table with an empty row 1 (m > 1) and ids that
    include one past the table (q > 1) and one below it (q >= 9)."""
    table = (torch.rand((m, n), generator=gen, device="cuda") < 0.5).to(torch.int8)
    if m > 1:
        table[1] = 0
    ids = torch.randint(0, m, (q,), generator=gen, device="cuda", dtype=torch.int32)
    if q > 1:
        ids[-1] = m
    if q >= 9:
        ids[q // 2] = -1
    return table, ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 50, 64])
@pytest.mark.parametrize("m,q", [(1, 1), (3, 9), (8, 33), (3, 128)])
def test_grouped_block_topk_matches_plain(gen, dtype, k, m, q):
    corpus, queries = _unit(3000, 256, gen, dtype), _unit(q, 256, gen, dtype)
    table, ids = _predicates(gen, m, 3000, q)
    kw = dict(count=2900, block_n=1024)
    before = go.grouped_block_topk.launches
    got_v, got_i = go.grouped_block_topk(corpus, queries, table, ids, k, **kw)
    torch.cuda.synchronize()
    assert go.grouped_block_topk.launches == before + 1
    ref_v, ref_i = go.grouped_block_topk_plain(corpus, queries, table, ids, k + 1, **kw)
    assert_topk_match(got_v, got_i, ref_v[..., :k], ref_i[..., :k], tol=1e-5, cut=ref_v[..., k])


@pytest.mark.parametrize("k", [1, 10, 50, 64])
@pytest.mark.parametrize("m,q", [(1, 1), (3, 9), (8, 33), (3, 128)])
def test_int8_grouped_block_topk_identical_to_plain(gen, k, m, q):
    c8, cs = qo.quantize_rows(_unit(5000, 256, gen, torch.bfloat16))
    q8, qs = qo.quantize_rows(_unit(q, 256, gen))
    table, ids = _predicates(gen, m, 5000, q)
    kw = dict(count=4800, block_n=2048)
    before = qo.int8_grouped_block_topk.launches
    got = qo.int8_grouped_block_topk(c8, cs, q8, qs, table, ids, k, **kw)
    torch.cuda.synchronize()
    assert qo.int8_grouped_block_topk.launches == before + 1
    ref = qo.int8_grouped_block_topk_plain(c8, cs, q8, qs, table, ids, k, **kw)
    assert_topk_match(*got, *ref, tol=0.0, exact=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_search_duplicate_rows_and_edge_ids(gen, dtype):
    """Duplicates of the query row across a block edge come out at the
    smallest rows, each under its own predicate; an empty predicate and ids
    outside the table give empty slots."""
    corpus = _unit(3000, 256, gen, dtype)
    dups = list(range(1000, 1030)) + [2990]
    corpus[dups] = corpus[7].clone()
    table = torch.zeros((3, 3000), dtype=torch.int8, device="cuda")
    table[0] = 1
    table[2, ::2] = 1  # row 1 stays empty
    ids = torch.tensor([0, 1, 2, 3, -1, 2, 0, 1, 0], dtype=torch.int32, device="cuda")
    queries = corpus[7:8].repeat(9, 1)
    _, idx = go.grouped_mask_search(corpus, queries, table, ids, 10)
    _, ref = go.grouped_mask_plain(corpus, queries, table, ids, 10)
    assert torch.equal(idx, ref)
    assert idx[0].tolist() == [7] + dups[:9]
    assert idx[2].tolist() == [1000 + 2 * i for i in range(10)]
    assert (idx[[1, 3, 4, 7]] == -1).all()
    c8, cs = qo.quantize_rows(corpus)
    q8, qs = qo.quantize_rows(queries)
    got = qo.int8_grouped_block_topk(c8, cs, q8, qs, table, ids, 10, count=3000, block_n=2048)
    want = qo.int8_grouped_block_topk_plain(c8, cs, q8, qs, table, ids, 10, count=3000, block_n=2048)
    assert_topk_match(*got, *want, tol=0.0, exact=True)


def test_grouped_wrappers_check_their_inputs(gen):
    corpus = _unit(100, 64, gen)
    table = torch.ones((2, 100), dtype=torch.int8, device="cuda")
    ids = torch.zeros(100, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        go.grouped_block_topk(corpus, corpus, table.bool(), ids, 5, count=100)
    with pytest.raises(ValueError):
        go.grouped_block_topk(corpus, corpus, table, ids.long(), 5, count=100)
    with pytest.raises(ValueError):
        go.grouped_block_topk(corpus, corpus, table[:, :99].contiguous(), ids, 5, count=100)
    with pytest.raises(ValueError):
        go.grouped_block_topk(corpus, corpus, table, ids, 65, count=100)
    c8, cs = qo.quantize_rows(corpus)
    with pytest.raises(ValueError):
        qo.int8_grouped_block_topk(c8, cs, c8, cs, table.cpu(), ids, 5, count=100)
    with pytest.raises(RuntimeError, match="cudaError"):
        go.grouped_block_topk(corpus, corpus, table, ids, 5, count=100, block_n=65536)
    go.grouped_block_topk(corpus, corpus, table, ids, 5, count=100)
    qo.int8_grouped_block_topk(c8, cs, c8, cs, table, ids, 5, count=100)


def _ivf_inputs(gen, nlist, lrows, d, q, nprobe, dtype):
    """A cluster-major layout with padding slots and duplicate rows, and
    each query's distinct probed clusters, sorted."""
    corpus = _unit(nlist * lrows, d, gen, dtype)
    corpus[lrows + 5 : lrows + 40] = corpus[7].clone()  # ties across clusters 0 and 1
    row_valid = (torch.rand(nlist * lrows, generator=gen, device="cuda") < 0.85).to(torch.int8)
    row_valid[7] = 1
    probes = torch.stack([torch.randperm(nlist, generator=gen, device="cuda")[:nprobe] for _ in range(q)])
    probes = torch.sort(probes, dim=1).values.to(torch.int32).contiguous()
    queries = _unit(q, d, gen, dtype)
    queries[0] = corpus[7]
    return corpus, queries, probes, row_valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("k,q,nprobe", [(1, 1, 1), (10, 9, 8), (64, 33, 8), (50, 128, 24), (500, 9, 8)])
def test_ivf_block_topk_matches_plain(gen, dtype, metric, k, q, nprobe):
    lrows = 384  # a ragged last tile of 128 slots
    corpus, queries, probes, row_valid = _ivf_inputs(gen, 24, lrows, 256, q, nprobe, dtype)
    cnorms = to.row_sq_norms(corpus)
    kw = dict(lrows=lrows, metric=metric, cnorms=cnorms)
    before = io.ivf_block_topk.launches
    got_v, got_i = io.ivf_block_topk(corpus, queries, probes, row_valid, k, **kw)
    torch.cuda.synchronize()
    assert io.ivf_block_topk.launches == before + 1
    ref_v, ref_i = io.ivf_block_topk_plain(corpus, queries, probes, row_valid, k, **kw)
    assert_topk_match(got_v, got_i, ref_v, ref_i, tol=1e-5)
    # merged over probes and tiles, the whole scan: the same
    assert_topk_match(*to.merge_partials(got_v, got_i, k), *to.merge_partials(ref_v, ref_i, k), tol=1e-5)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("k,q,nprobe", [(20, 1, 8), (64, 33, 8), (30, 128, 24)])
def test_ivf_block_topk_int8_identical_to_plain(gen, metric, k, q, nprobe):
    lrows = 384
    corpus, queries, probes, row_valid = _ivf_inputs(gen, 24, lrows, 256, q, nprobe, torch.bfloat16)
    c8, cs = qo.quantize_rows(corpus)
    q8, qs = io.quantize_ivf_queries(queries)
    kw = dict(lrows=lrows, metric=metric, cnorms=to.row_sq_norms(corpus), qscales=qs, cscales=cs)
    got = io.ivf_block_topk(c8, q8, probes, row_valid, k, **kw)
    assert_topk_match(*got, *io.ivf_block_topk_plain(c8, q8, probes, row_valid, k, **kw), tol=0.0, exact=True)


def test_ivf_block_topk_masked_out_probes_and_ties(gen):
    """A query whose probed clusters are all masked out gets empty slots;
    duplicate rows come out at the smallest slots, across clusters."""
    lrows = 256
    corpus, queries, probes, row_valid = _ivf_inputs(gen, 8, lrows, 128, 2, 2, torch.float32)
    row_valid[:] = 1
    row_valid[4 * lrows : 6 * lrows] = 0
    probes = torch.tensor([[0, 1], [4, 5]], dtype=torch.int32, device="cuda")
    vals, slots = to.merge_partials(*io.ivf_block_topk(corpus, queries, probes, row_valid, 40, lrows=lrows), 40)
    assert slots[0].tolist()[:36] == [7] + list(range(lrows + 5, lrows + 40))
    assert torch.isneginf(vals[1]).all() and (slots[1] == torch.iinfo(torch.int32).max).all()


def test_ivf_wrapper_checks_its_inputs(gen):
    corpus, queries, probes, row_valid = _ivf_inputs(gen, 4, 128, 64, 3, 2, torch.float32)
    kw = dict(lrows=128)
    with pytest.raises(ValueError):
        io.ivf_block_topk(corpus, queries.to(torch.bfloat16), probes, row_valid, 5, **kw)
    with pytest.raises(ValueError):
        io.ivf_block_topk(corpus, queries, probes.long(), row_valid, 5, **kw)
    with pytest.raises(ValueError):
        io.ivf_block_topk(corpus, queries, probes, row_valid.bool(), 5, **kw)
    with pytest.raises(ValueError):
        io.ivf_block_topk(corpus, queries, probes, row_valid, 5, lrows=100)
    with pytest.raises(ValueError):
        io.ivf_block_topk(corpus, queries, probes, row_valid, 5, metric="l2", **kw)  # no cnorms
    with pytest.raises(ValueError):
        io.ivf_block_topk(corpus, queries, probes + 4, row_valid, 5, **kw)  # a cluster past nlist
    # a score tile past the shared memory of one SM: the C entry returns the error
    with pytest.raises(RuntimeError, match="cudaError"):
        io.ivf_block_topk(corpus, queries, probes, row_valid, 5, lrows=128, block_n=65536)
    io.ivf_block_topk(corpus, queries, probes, row_valid, 5, **kw)
