"""The CUDA kernels against their plain PyTorch versions, on the card:
kernel 1 (block_topk), kernel 2 (int8_block_topk), their grouped
variants, kernel 5 (grouped_block_topk) and kernel 6
(int8_grouped_block_topk), kernel 7 (ivf_block_topk, the IVF scan),
kernel 3 (fast_block_topk and fast_grouped_block_topk, the packed-key
scans) and kernel 4 (fused_topk, the fused running top-k); float32 on
the ring (fmaf consumers) bit for bit against the FMA loop.

A CUDA kernel has no CPU mode, so these tests need a card and skip
without one; the plain versions they are held to run on the CPU in
``test_torch_topk.py``, ``test_torch_grouped_mask.py``,
``test_torch_quantized.py`` and ``test_torch_ivf.py``.  On a machine
with a card and without jax (this file imports none), run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: kernels 1, 4, 5 and 7 (float layouts) values within 1e-5 of
the plain float32 product (summation order only, unit rows); kernel 4
identical to kernel 1 followed by merge_partials, range partials and
result (the same scoring loop, so the same sums, and exact selections);
kernels 2 and 6, and kernel 7 on an int8 layout, identical (exact int32
dot, the same float32 scaling); kernel 3's searches values within 1e-5,
and an id may differ from the plain version's only where both scores lie
inside the 2^-12 relative window of the k-th score (score ulps can move a
packed-key window); kernel 3's partials identical to the plain version's
where the products are exact."""

import pytest
import torch

from photo_search_engine_tpu_torch.ops import grouped_mask as go
from photo_search_engine_tpu_torch.ops import ivf_scan as io
from photo_search_engine_tpu_torch.ops import quantized as qo
from photo_search_engine_tpu_torch.ops import topk as to
from tests.torch_parity import (assert_same_bits, assert_topk_match, assert_window_match, fma_loop, launch_once,
                                plain_scan)

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
    got_v, got_i = launch_once(to.block_topk, lambda: to.block_topk(corpus, queries, k, **kw))
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
    # a score tile past the shared memory of one SM (the FMA loop's grows
    # with block_n; the f32 ring's does not): the C entry returns the error
    with fma_loop(), pytest.raises(RuntimeError, match="cudaError"):
        to.block_topk(corpus, corpus, 5, count=100, block_n=65536)
    to.block_topk(corpus, corpus, 5, count=100, block_n=65536)
    # (int8: the __dp4a loop's score tile grows with block_n; the tensor
    # cores' tile does not)
    c8, cs = qo.quantize_rows(_unit(100, 68, gen))
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
    got_v, got_i = launch_once(go.grouped_block_topk, lambda: go.grouped_block_topk(corpus, queries, table, ids, k,
                                                                                  **kw))
    ref_v, ref_i = go.grouped_block_topk_plain(corpus, queries, table, ids, k + 1, **kw)
    assert_topk_match(got_v, got_i, ref_v[..., :k], ref_i[..., :k], tol=1e-5, cut=ref_v[..., k])


@pytest.mark.parametrize("k", [1, 10, 50, 64])
@pytest.mark.parametrize("m,q", [(1, 1), (3, 9), (8, 33), (3, 128)])
def test_int8_grouped_block_topk_identical_to_plain(gen, k, m, q):
    c8, cs = qo.quantize_rows(_unit(5000, 256, gen, torch.bfloat16))
    q8, qs = qo.quantize_rows(_unit(q, 256, gen))
    table, ids = _predicates(gen, m, 5000, q)
    kw = dict(count=4800, block_n=2048)
    got = launch_once(qo.int8_grouped_block_topk, lambda: qo.int8_grouped_block_topk(c8, cs, q8, qs, table, ids, k,
                                                                                     **kw))
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
    with fma_loop(), pytest.raises(RuntimeError, match="cudaError"):  # the FMA loop's score tile: past one SM
        go.grouped_block_topk(corpus, corpus, table, ids, 5, count=100, block_n=65536)
    go.grouped_block_topk(corpus, corpus, table, ids, 5, count=100, block_n=65536)  # the ring's: no growth
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
    got_v, got_i = launch_once(io.ivf_block_topk, lambda: io.ivf_block_topk(corpus, queries, probes, row_valid, k,
                                                                            **kw))
    tile = io.ivf_launch(corpus, probes, lrows, k)[1]  # the kernel's tile, for the plain version's partials
    ref_v, ref_i = io.ivf_block_topk_plain(corpus, queries, probes, row_valid, k, block_n=tile, **kw)
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
    tile = io.ivf_launch(c8, probes, lrows, k)[1]
    assert_topk_match(*got, *io.ivf_block_topk_plain(c8, q8, probes, row_valid, k, block_n=tile, **kw),
                      tol=0.0, exact=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_ivf_block_topk_masked_out_probes_and_ties(gen, dtype):
    """A query whose probed clusters are all masked out gets empty slots;
    duplicate rows come out at the smallest slots, across clusters (bf16
    and int8 on the tensor cores, f32 on its ring)."""
    lrows = 256
    corpus, queries, probes, row_valid = _ivf_inputs(gen, 8, lrows, 128, 2, 2, torch.float32)
    row_valid[:] = 1
    row_valid[4 * lrows : 6 * lrows] = 0
    probes = torch.tensor([[0, 1], [4, 5]], dtype=torch.int32, device="cuda")
    kw = dict(lrows=lrows)
    if dtype == torch.int8:
        queries, qs = io.quantize_ivf_queries(corpus[[7, 7]])
        corpus, cs = qo.quantize_rows(corpus)
        kw.update(qscales=qs, cscales=cs)
    else:
        corpus, queries = corpus.to(dtype), queries.to(dtype)
    loop = "fma_ring" if dtype == torch.float32 else "tensor_core"
    assert io.ivf_scoring_loop(corpus, 40) == loop
    part = launch_once(io.ivf_block_topk, lambda: io.ivf_block_topk(corpus, queries, probes, row_valid, 40, **kw))
    vals, slots = to.merge_partials(*part, 40)
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
        io.ivf_block_topk(corpus, queries, probes, row_valid, 5, bq=16, **kw)  # no such group size
    # clusters past nlist and below 0 match no slot, on both loops: empty partials
    outside = torch.stack([probes[:, 0] + 4, probes[:, 1] - 9], 1).to(torch.int32).contiguous()
    for rows in (corpus, corpus.to(torch.bfloat16)):
        vals, slots = io.ivf_block_topk(rows, queries.to(rows.dtype), outside, row_valid, 5, **kw)
        assert torch.isneginf(vals).all() and (slots == torch.iinfo(torch.int32).max).all()
    # a score tile past the shared memory of one SM (the FMA loop's): the C entry returns the error
    with fma_loop(), pytest.raises(RuntimeError, match="cudaError"):
        io.ivf_block_topk(corpus, queries, probes, row_valid, 5, lrows=128, block_n=65536)
    io.ivf_block_topk(corpus, queries, probes, row_valid, 5, **kw)


# ---------------------------------------------------------------------------
# kernel 7 on the tensor cores (block_score_tc.cuh with IvfWork) and its work list
# ---------------------------------------------------------------------------


def _ivf_pair(gen, tier, metric, k, q, nprobe, *, lrows=1100, nlist=24, d=256, masked=False, **kw):
    """Kernel 7 (tensor cores, each launch checked on its loop) and its
    plain version on the same bf16 or int8 layout; 1100 slots a cluster:
    whole-cluster tiles end in a ragged pass of 76 rows."""
    corpus, queries, probes, row_valid = _ivf_inputs(gen, nlist, lrows, d, q, nprobe, torch.bfloat16)
    if masked:
        row_valid &= (torch.rand(row_valid.shape, generator=gen, device="cuda") < 0.3).to(torch.int8)
    kw.update(lrows=lrows, metric=metric, cnorms=to.row_sq_norms(corpus))
    if tier == "int8":
        corpus, cs = qo.quantize_rows(corpus)
        queries, qs = io.quantize_ivf_queries(queries.float())
        kw.update(qscales=qs, cscales=cs)
    assert io.ivf_scoring_loop(corpus, k) == "tensor_core"
    got = launch_once(io.ivf_block_topk, lambda: io.ivf_block_topk(corpus, queries, probes, row_valid, k, **kw))
    kw["block_n"] = io.ivf_launch(corpus, probes, lrows, k, kw.get("block_n"), kw.pop("bq", None))[1]
    return got, io.ivf_block_topk_plain(corpus, queries, probes, row_valid, k, **kw)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("q", [1, 9, 33, 128])
@pytest.mark.parametrize("nprobe", [1, 8, 24])
@pytest.mark.parametrize("k", [1, 10, 50, 64])
def test_ivf_tensor_cores_match_plain(gen, tier, q, nprobe, k):
    """bf16 within 1e-5 of the plain version, int8 identical; ip and l2,
    masked or not, by turns; the geometry's own tile (three tiles a cluster
    at the fewest groups, whole clusters above)."""
    turn = q + nprobe + k
    got, ref = _ivf_pair(gen, tier, ("ip", "l2")[turn % 2], k, q, nprobe, masked=turn % 3 == 0)
    assert_topk_match(*got, *ref, tol=1e-5, exact=tier == "int8")
    assert_topk_match(*to.merge_partials(*got, k), *to.merge_partials(*ref, k), tol=1e-5, exact=tier == "int8")


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("block_n,bq", [(512, 8), (768, 32), (1100, 8), (1100, 32), (300, 32)])
def test_ivf_tensor_cores_at_every_tile_and_group_size(gen, tier, block_n, bq):
    """Any tile and group size gives the plain version's partials at that
    tile: the sweep's geometries, and a tile that is not whole passes."""
    got, ref = _ivf_pair(gen, tier, "ip", 50, 40, 8, block_n=block_n, bq=bq)
    assert got[0].shape[2] == -(-1100 // block_n)
    assert_topk_match(*got, *ref, tol=1e-5, exact=tier == "int8")


@pytest.mark.parametrize("case", ["f32", "f32 D 1002", "f32 k 100", "bf16 D 1001", "int8 D 1000", "bf16 k 100",
                                  "bf16", "int8"])
def test_ivf_launches_by_loop(gen, case):
    """The loop rule (``ivf_scoring_loop``): bf16 rows TMA cannot stride,
    f32 rows it cannot stride (D % 4 != 0), int8 with D % 16 != 0 and kk >
    64 take the FMA / __dp4a loop; bf16 and int8 with k <= 64 the tensor
    cores, f32 with k <= 64 its ring.  Each is right."""
    d = {"bf16 D 1001": 1001, "int8 D 1000": 1000, "f32 D 1002": 1002}.get(case, 256)
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    corpus, queries, probes, row_valid = _ivf_inputs(gen, 6, 384, d, 5, 3, dtype)
    k = 100 if "k 100" in case else 20
    kw = dict(lrows=384)
    if case.startswith("int8"):
        corpus, cs = qo.quantize_rows(corpus)
        queries, qs = io.quantize_ivf_queries(queries.float())
        kw.update(qscales=qs, cscales=cs)
    loop = {"bf16": "tensor_core", "int8": "tensor_core", "f32": "fma_ring"}.get(case, "fma")
    assert io.ivf_scoring_loop(corpus, k) == loop
    got = launch_once(io.ivf_block_topk, lambda: io.ivf_block_topk(corpus, queries, probes, row_valid, k, **kw))
    ref = io.ivf_block_topk_plain(corpus, queries, probes, row_valid, k,
                                  block_n=io.ivf_launch(corpus, probes, 384, k)[1], **kw)
    assert_topk_match(*got, *ref, tol=1e-5, exact=case.startswith("int8"))


def test_ivf_wrapper_reads_nothing_back(gen):
    """Under ``set_sync_debug_mode("error")`` a host sync raises: the work
    list, the gather and the scan, on both loops, run without one."""
    corpus, queries, probes, row_valid = _ivf_inputs(gen, 24, 384, 256, 33, 8, torch.bfloat16)
    c8, cs = qo.quantize_rows(corpus)
    q8, qs = io.quantize_ivf_queries(queries.float())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        io.ivf_block_topk(corpus, queries, probes, row_valid, 50, lrows=384)
        io.ivf_block_topk(c8, q8, probes, row_valid, 50, lrows=384, qscales=qs, cscales=cs)
        io.ivf_block_topk(corpus, queries, probes, row_valid, 100, lrows=384)
        io.ivf_work_list(probes, 24, 32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("bq", [8, 32])
@pytest.mark.parametrize("q,nprobe,nlist", [(1, 64, 1024), (128, 64, 1024), (700, 3, 4), (40, 8, 24)])
def test_ivf_work_list_on_the_card_is_the_plain_one(gen, bq, q, nprobe, nlist):
    """The work list the card builds equals the plain version's, groups and
    order, with ids past nlist and below 0 in no group."""
    probes = torch.stack([torch.randperm(nlist, generator=gen, device="cuda")[:nprobe] for _ in range(q)])
    probes = torch.sort(probes, dim=1).values.to(torch.int32)
    probes[0, 0], probes[-1, -1] = -3, nlist + 2
    probes = probes.contiguous()
    got = io.ivf_work_list(probes, nlist, bq)
    want = io.ivf_work_list_plain(probes.cpu(), nlist, bq)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_ivf_tensor_core_kernels_run_wgmma_and_tma():
    """The SASS of every kernel 7 instantiation on the tensor cores (bf16
    and int8, groups of 8 and 32) holds wgmma (HGMMA bf16, IGMMA int8) and
    TMA loads (UTMALDG)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the CUDA toolkit: the kernels are built there")
    from photo_search_engine_tpu_torch.ops import _cuda

    counts = _cuda.sass_counts("tc_ivf_topk_kernel")
    assert len(counts) == 4, counts
    for name, c in counts.items():
        assert c["IGMMA" if "S8" in name else "HGMMA"] > 0 and c["UTMALDG"] > 0, counts


def _search_pair(module, name, search, sign=1.0):
    """``search()`` through the kernel ``module.name`` and through its plain
    version, in kernel space (higher is better)."""
    got = launch_once(getattr(module, name), search)
    with plain_scan(module, name):
        ref = search()
    return (sign * got[0], got[1]), (sign * ref[0], ref[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["ip", "l2", "masked", "empty"])
@pytest.mark.parametrize("k,q", [(1, 1), (10, 9), (64, 40)])
def test_fast_search_matches_plain(gen, dtype, variant, k, q):
    corpus, queries = _unit(3000, 256, gen, dtype), _unit(q, 256, gen, dtype)
    metric = "l2" if variant == "l2" else "ip"
    frac = {"masked": 0.5, "empty": 0.0}.get(variant, 1.0)
    mask = (torch.rand(3000, generator=gen, device="cuda") < frac).to(torch.int8)
    kw = dict(count=2900, metric=metric, mask=mask, impl="pallas_fast", block_n=1024)
    got, ref = _search_pair(to, "fast_block_topk", lambda: to.exact_search(corpus, queries, k, **kw),
                            -1.0 if metric == "l2" else 1.0)
    assert_window_match(*got, *ref, tol=1e-5)
    if variant == "empty":
        assert (got[1] == -1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [10, 64])
@pytest.mark.parametrize("m,q", [(1, 1), (3, 9), (8, 128)])
def test_fast_grouped_search_matches_plain(gen, dtype, k, m, q):
    corpus, queries = _unit(3000, 256, gen, dtype), _unit(q, 256, gen, dtype)
    table, ids = _predicates(gen, m, 3000, q)
    got, ref = _search_pair(go, "fast_grouped_block_topk", lambda: go.grouped_mask_search(
        corpus, queries, table, ids, k, count=2900, impl="pallas_fast", block_n=1024))
    assert_window_match(*got, *ref, tol=1e-5)


def test_fast_partials_are_the_plain_quantized_partials(gen):
    """Where the scores agree bit for bit (an exact product: rows and the
    query with one nonzero lane), kernel 3's quantized partials are the
    plain version's, -inf slots and their decoded ids included."""
    corpus = torch.zeros((3000, 64), device="cuda")
    corpus[torch.arange(3000), torch.arange(3000) % 64] = torch.rand(3000, generator=gen, device="cuda")
    corpus[::7] = 0.0
    queries = torch.zeros((3, 64), device="cuda")
    queries[:, :3] = torch.eye(3, device="cuda")
    kw = dict(count=2900, block_n=1024)
    got = to.fast_block_topk(corpus, queries, 64, **kw)
    ref = to.fast_block_topk_plain(corpus, queries, 64, **kw)
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32)) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("q", [3, 40])
def test_bf16_fast_partials_are_the_plain_quantized_partials(gen, metric, q):
    """bf16 kernel 3 on the tensor cores, flat and grouped, on exact
    products (rows with one nonzero bf16 lane, queries with one 1.0 lane;
    many equal scores): its quantized partials are the plain version's bit
    for bit, with masked rows, a live count, and a last block of 40 rows,
    shorter than k = 64, whose slots past its rows hold its -inf lanes."""
    n, k = 2 * 1024 + 40, 64
    corpus = torch.zeros((n, 64), device="cuda")
    corpus[torch.arange(n), torch.arange(n) % 64] = torch.rand(n, generator=gen, device="cuda")
    corpus[::7] = 0.0
    corpus = corpus.to(torch.bfloat16)
    queries = torch.zeros((q, 64), device="cuda")
    queries[torch.arange(q), torch.arange(q) % 3] = 1.0
    queries = queries.to(torch.bfloat16)
    mask = (torch.rand(n, generator=gen, device="cuda") < 0.8).to(torch.int8)
    kw = dict(count=n - 10, metric=metric, mask=mask, cnorms=to.row_sq_norms(corpus), block_n=1024)
    assert to.scoring_loop(corpus) == go.scoring_loop(corpus) == "tensor_core"
    got = launch_once(to.fast_block_topk, lambda: to.fast_block_topk(corpus, queries, k, **kw))
    assert_same_bits("", got, to.fast_block_topk_plain(corpus, queries, k, **kw))
    assert (got[1][:, 2, 40:] == 2048 + torch.arange(40, 64, device="cuda", dtype=torch.int32)).all()
    assert torch.isneginf(got[0][:, 2, 40:]).all()
    table, ids = _predicates(gen, 3, n, q)
    kw = dict(count=n - 10, block_n=1024)
    got = launch_once(go.fast_grouped_block_topk, lambda: go.fast_grouped_block_topk(corpus, queries, table, ids, k,
                                                                                     **kw))
    assert_same_bits("", got, go.fast_grouped_block_topk_plain(corpus, queries, table, ids, k, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["ip", "l2", "masked", "empty"])
@pytest.mark.parametrize("k,q,per", [(1, 1, 1), (10, 9, 2), (64, 40, 3), (50, 128, None)])
def test_fused_topk_matches_plain_and_kernel1(gen, dtype, variant, k, q, per):
    corpus, queries = _unit(5000, 256, gen, dtype), _unit(q, 256, gen, dtype)
    metric = "l2" if variant == "l2" else "ip"
    frac = {"masked": 0.5, "empty": 0.0}.get(variant, 1.0)
    mask = (torch.rand(5000, generator=gen, device="cuda") < frac).to(torch.int8)
    kw = dict(count=4900, metric=metric, mask=mask, cnorms=to.row_sq_norms(corpus), block_n=1024)
    vals, idx, part_v, part_i = launch_once(to.fused_topk, lambda: to.fused_topk(
        corpus, queries, k, blocks_per_range=per, **kw))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per = per or to.fused_ranges(q, 5, sms, loop=to.scoring_loop(corpus))[1]
    ref = to.fused_topk_plain(corpus, queries, k + 1, blocks_per_range=per, **kw)
    assert_topk_match(part_v, part_i, ref[2][..., :k], ref[3][..., :k], tol=1e-5, cut=ref[2][..., k])
    assert_topk_match(vals, idx, ref[0][..., :k], ref[1][..., :k], tol=1e-5, cut=ref[0][..., k])
    # kernel 4 scores as kernel 1 does (bf16: the tensor cores, f32: its ring) and
    # selects exactly: kernel 1's partials merged range by range, bit for bit
    k1 = to.block_topk(corpus, queries, k, **kw)
    assert_same_bits("", (part_v, part_i), to.range_partials(*k1, per, k))
    assert_same_bits("", (vals, idx), to.merge_partials(*k1, k))


@pytest.mark.parametrize("impl", ["pallas_fast", "pallas_fused"])
def test_duplicate_rows_tie_to_the_smallest_row(gen, impl):
    corpus = _unit(5000, 256, gen, torch.bfloat16)
    dups = list(range(1000, 1062)) + [3000, 4990]
    corpus[dups] = corpus[7].clone()
    _, idx = to.exact_search(corpus, corpus[7:8].clone(), 64, metric="ip", impl=impl)
    assert idx[0].tolist() == ([7] + dups)[:64]


def test_fast_and_fused_wrappers_check_their_inputs(gen):
    corpus = _unit(100, 64, gen)
    with pytest.raises(ValueError):
        to.fast_block_topk(corpus, corpus, 5, count=100, block_n=4096)  # past the packed keys' 2048
    with pytest.raises(ValueError):
        to.fused_topk(corpus, corpus, 65, count=100)
    with pytest.raises(ValueError):
        to.fused_topk(corpus, corpus.to(torch.bfloat16), 5, count=100)
    with fma_loop(), pytest.raises(RuntimeError, match="cudaError"):  # the FMA loop's score tile: past one SM
        to.fused_topk(corpus, corpus, 5, count=100, block_n=65536)
    to.fused_topk(corpus, corpus, 5, count=100)  # the error is not left behind


# ---------------------------------------------------------------------------
# bf16 kernels 1 and 5 on the tensor cores (csrc/block_score_tc.cuh)
# ---------------------------------------------------------------------------

_TC_Q = [1, 8, 9, 32, 33, 128, 256]  # across both query tiles (8 and 32) and their edges


@pytest.mark.parametrize("q", _TC_Q)
@pytest.mark.parametrize("d", [1536, 1000, 1001])
@pytest.mark.parametrize("k", [1, 50, 64])
def test_bf16_block_topk_across_tiles_and_widths(gen, q, d, k):
    """Ragged last block, count below n, and by turns ip, l2 and masked;
    D = 1001 (rows TMA cannot stride) takes the FMA loop."""
    n, count = 2500, 2400
    corpus, queries = _unit(n, d, gen, torch.bfloat16), _unit(q, d, gen, torch.bfloat16)
    variant = ("ip", "l2", "masked")[(_TC_Q.index(q) + k) % 3]
    mask = (torch.rand(n, generator=gen, device="cuda") < 0.5).to(torch.int8) if variant == "masked" else None
    kw = dict(count=count, metric="l2" if variant == "l2" else "ip", mask=mask, cnorms=to.row_sq_norms(corpus),
              block_n=1024)
    loop = "tensor_core" if d % 8 == 0 else "fma"
    assert to.scoring_loop(corpus) == loop
    got_v, got_i = launch_once(to.block_topk, lambda: to.block_topk(corpus, queries, k, **kw))
    ref_v, ref_i = to.exact_block_topk_plain(corpus, queries, k + 1, **kw)
    assert_topk_match(got_v, got_i, ref_v[..., :k], ref_i[..., :k], tol=1e-5, cut=ref_v[..., k])


@pytest.mark.parametrize("q", _TC_Q)
@pytest.mark.parametrize("d", [1536, 1000, 1001])
@pytest.mark.parametrize("k", [1, 50, 64])
def test_bf16_grouped_block_topk_across_tiles_and_widths(gen, q, d, k):
    """Kernel 5 with an empty predicate row and ids outside [0, M)."""
    n, count = 2500, 2400
    corpus, queries = _unit(n, d, gen, torch.bfloat16), _unit(q, d, gen, torch.bfloat16)
    table, ids = _predicates(gen, 3, n, q)
    kw = dict(count=count, block_n=1024)
    assert go.scoring_loop(corpus) == ("tensor_core" if d % 8 == 0 else "fma")
    got_v, got_i = launch_once(go.grouped_block_topk, lambda: go.grouped_block_topk(corpus, queries, table, ids, k,
                                                                                  **kw))
    ref_v, ref_i = go.grouped_block_topk_plain(corpus, queries, table, ids, k + 1, **kw)
    assert_topk_match(got_v, got_i, ref_v[..., :k], ref_i[..., :k], tol=1e-5, cut=ref_v[..., k])


@pytest.mark.parametrize("q", [3, 40])
def test_bf16_all_masked_block_gives_empty_slots(gen, q):
    corpus, queries = _unit(3000, 1536, gen, torch.bfloat16), _unit(q, 1536, gen, torch.bfloat16)
    mask = torch.ones(3000, dtype=torch.int8, device="cuda")
    mask[1024:2048] = 0
    got_v, got_i = to.block_topk(corpus, queries, 50, count=3000, mask=mask, block_n=1024)
    ref_v, ref_i = to.exact_block_topk_plain(corpus, queries, 51, count=3000, mask=mask, block_n=1024)
    assert_topk_match(got_v, got_i, ref_v[..., :50], ref_i[..., :50], tol=1e-5, cut=ref_v[..., 50])
    assert torch.isneginf(got_v[:, 1]).all() and (got_i[:, 1] == torch.iinfo(torch.int32).max).all()


@pytest.mark.parametrize("d", [1536, 1000])
@pytest.mark.parametrize("q", [1, 33])
def test_bf16_duplicate_rows_across_a_block_edge_tie_exactly(gen, d, q):
    """Copies of the query row on both sides of a block edge and in the
    ragged block score the same bits on the tensor cores, so the smallest
    rows win, in both kernels."""
    corpus = _unit(5000, d, gen, torch.bfloat16)
    dups = list(range(1000, 1062)) + [3000, 4990]
    corpus[dups] = corpus[7].clone()
    queries = corpus[7:8].repeat(q, 1)
    _, idx = to.exact_search(corpus, queries, 64, metric="ip")
    assert (idx == torch.tensor(([7] + dups)[:64], device="cuda", dtype=idx.dtype)).all()
    table = torch.ones((1, 5000), dtype=torch.int8, device="cuda")
    ids = torch.zeros(q, dtype=torch.int32, device="cuda")
    _, idx = go.grouped_mask_search(corpus, queries, table, ids, 64)
    assert (idx == torch.tensor(([7] + dups)[:64], device="cuda", dtype=idx.dtype)).all()
    part_v, part_i = to.block_topk(corpus, queries, 64, count=5000, block_n=1024)
    assert (part_v[:, 0, 0] == part_v[:, 1, 0]).all()  # the copies in blocks 0 and 1: the same bits


@pytest.mark.parametrize("q", [1, 40])
def test_bf16_many_equal_scores_take_the_rounds_and_tie_exactly(gen, q):
    """A block whose 700 rows all score the same has more candidates at the
    threshold than a warp's buffer holds: its selection takes the k rounds,
    and the smallest rows still win, in both passes of the block."""
    corpus = _unit(3000, 256, gen, torch.bfloat16)
    corpus[1024:1724] = corpus[5].clone()
    queries = corpus[5:6].repeat(q, 1)
    got_v, got_i = to.block_topk(corpus, queries, 64, count=3000, block_n=1024)
    ref_v, ref_i = to.exact_block_topk_plain(corpus, queries, 64, count=3000, block_n=1024)
    assert got_i[:, 1].tolist() == [list(range(1024, 1088))] * q
    assert torch.equal(got_v[:, 1], got_v[:, 1, :1].expand(q, 64))  # the copies score the same bits
    assert_topk_match(got_v[:, 1], got_i[:, 1], ref_v[:, 1], ref_i[:, 1], tol=1e-5)


def test_bf16_wrappers_refuse_misaligned_rows(gen):
    corpus = _unit(101, 64, gen, torch.bfloat16)
    shifted = corpus.view(-1)[4:4 + 6400].view(100, 64)  # contiguous, 8 bytes past an aligned base
    shifted_q = corpus.view(-1)[4:4 + 192].view(3, 64)
    table = torch.ones((1, 100), dtype=torch.int8, device="cuda")
    ids = torch.zeros(3, dtype=torch.int32, device="cuda")
    for call in (lambda: to.block_topk(shifted, corpus[:3], 5, count=100),
                 lambda: to.fast_block_topk(shifted, corpus[:3], 5, count=100),
                 lambda: to.fast_block_topk(corpus[:100], shifted_q, 5, count=100),
                 lambda: to.fused_topk(shifted, corpus[:3], 5, count=100),
                 lambda: to.fused_topk(corpus[:100], shifted_q, 5, count=100),
                 lambda: go.grouped_block_topk(corpus[:100], shifted_q, table, ids, 5, count=100),
                 lambda: go.fast_grouped_block_topk(shifted, corpus[:3], table, ids, 5, count=100)):
        with pytest.raises(ValueError, match="16-byte"):
            call()


@pytest.mark.parametrize("q", _TC_Q)
@pytest.mark.parametrize("d", [1536, 1000, 1001])
@pytest.mark.parametrize("k", [1, 50, 64])
def test_bf16_fast_and_fused_across_tiles_and_widths(gen, q, d, k):
    """Kernels 3 (flat and grouped) and 4 on bf16 rows, each launch counted
    on its loop (D = 1001: the FMA loop): kernel 3's searches against the
    same searches on its plain version, kernel 4 bit for bit against kernel
    1 followed by merge_partials; a ragged last block, count below n, ip or
    l2 or masked by turns."""
    n, count = 2500, 2400
    corpus, queries = _unit(n, d, gen, torch.bfloat16), _unit(q, d, gen, torch.bfloat16)
    variant = ("ip", "l2", "masked")[(_TC_Q.index(q) + k) % 3]
    metric = "l2" if variant == "l2" else "ip"
    mask = (torch.rand(n, generator=gen, device="cuda") < 0.5).to(torch.int8) if variant == "masked" else None
    loop = "tensor_core" if d % 8 == 0 else "fma"
    assert to.scoring_loop(corpus) == go.scoring_loop(corpus) == loop
    sign = -1.0 if metric == "l2" else 1.0
    kw = dict(count=count, metric=metric, mask=mask, impl="pallas_fast", block_n=1024)
    got = launch_once(to.fast_block_topk, lambda: to.exact_search(corpus, queries, k, **kw))
    with plain_scan(to, "fast_block_topk"):
        ref = to.exact_search(corpus, queries, k, **kw)
    assert_window_match(sign * got[0], got[1], sign * ref[0], ref[1], tol=1e-5)
    table, ids = _predicates(gen, 3, n, q)
    search = lambda: go.grouped_mask_search(corpus, queries, table, ids, k, count=count, impl="pallas_fast")  # noqa: E731
    got = launch_once(go.fast_grouped_block_topk, search)
    with plain_scan(go, "fast_grouped_block_topk"):
        ref = search()
    assert_window_match(*got, *ref, tol=1e-5)
    scan = dict(count=count, metric=metric, mask=mask, cnorms=to.row_sq_norms(corpus), block_n=1024)
    vals, idx, part_v, part_i = launch_once(to.fused_topk, lambda: to.fused_topk(corpus, queries, k, **scan))
    k1 = to.block_topk(corpus, queries, k, **scan)
    per = to.fused_ranges(q, 3, torch.cuda.get_device_properties(0).multi_processor_count, loop=loop)[1]
    assert_same_bits("", (part_v, part_i), to.range_partials(*k1, per, k))
    assert_same_bits("", (vals, idx), to.merge_partials(*k1, k))


# ---------------------------------------------------------------------------
# int8 kernels 2 and 6 on the tensor cores (s8 wgmma, block_score_tc.cuh)
# ---------------------------------------------------------------------------


def _int8_inputs(gen, n, d, q):
    ref_rows = _unit(n, d, gen, torch.bfloat16)
    c8, cs = qo.quantize_rows(ref_rows)
    q8, qs = qo.quantize_rows(_unit(q, d, gen))
    return ref_rows, c8, cs, q8, qs


@pytest.mark.parametrize("q", _TC_Q)
@pytest.mark.parametrize("d", [1536, 1008, 1000])
@pytest.mark.parametrize("k", [1, 50, 64])
def test_int8_block_topk_across_tiles_and_widths(gen, q, d, k):
    """Identical to the plain version: blocks of 2048 and a ragged one,
    count below n, by turns ip, l2 and masked; D = 1008 ends in a ragged
    128-byte chunk, D = 1000 (rows TMA cannot stride) takes the __dp4a loop."""
    n, count = 5000, 4900
    ref_rows, c8, cs, q8, qs = _int8_inputs(gen, n, d, q)
    variant = ("ip", "l2", "masked")[(_TC_Q.index(q) + k) % 3]
    mask = (torch.rand(n, generator=gen, device="cuda") < 0.5).to(torch.int8) if variant == "masked" else None
    kw = dict(count=count, metric="l2" if variant == "l2" else "ip", mask=mask,
              cnorms=to.row_sq_norms(ref_rows), block_n=2048)
    loop = qo.int8_scoring_loop(d)
    assert loop == ("tensor_core" if d % 16 == 0 else "dp4a")
    got = launch_once(qo.int8_block_topk, lambda: qo.int8_block_topk(c8, cs, q8, qs, k, **kw))
    assert_topk_match(*got, *qo.int8_block_topk_plain(c8, cs, q8, qs, k, **kw), tol=0.0, exact=True)


@pytest.mark.parametrize("q", _TC_Q)
@pytest.mark.parametrize("d", [1536, 1008, 1000])
@pytest.mark.parametrize("k", [1, 50, 64])
def test_int8_grouped_block_topk_across_tiles_and_widths(gen, q, d, k):
    """Kernel 6 with an empty predicate row and ids outside [0, M)."""
    n, count = 5000, 4900
    _, c8, cs, q8, qs = _int8_inputs(gen, n, d, q)
    table, ids = _predicates(gen, 3, n, q)
    kw = dict(count=count, block_n=2048)
    got = launch_once(qo.int8_grouped_block_topk, lambda: qo.int8_grouped_block_topk(c8, cs, q8, qs, table, ids, k,
                                                                                     **kw))
    ref = qo.int8_grouped_block_topk_plain(c8, cs, q8, qs, table, ids, k, **kw)
    assert_topk_match(*got, *ref, tol=0.0, exact=True)


@pytest.mark.parametrize("q", [3, 40])
def test_int8_all_masked_block_gives_empty_slots(gen, q):
    _, c8, cs, q8, qs = _int8_inputs(gen, 5000, 1536, q)
    mask = torch.ones(5000, dtype=torch.int8, device="cuda")
    mask[2048:4096] = 0
    got_v, got_i = qo.int8_block_topk(c8, cs, q8, qs, 50, count=5000, mask=mask, block_n=2048)
    ref = qo.int8_block_topk_plain(c8, cs, q8, qs, 50, count=5000, mask=mask, block_n=2048)
    assert_topk_match(got_v, got_i, *ref, tol=0.0, exact=True)
    assert torch.isneginf(got_v[:, 1]).all() and (got_i[:, 1] == torch.iinfo(torch.int32).max).all()


@pytest.mark.parametrize("d", [1536, 1008])
@pytest.mark.parametrize("q", [1, 33])
def test_int8_duplicate_rows_across_a_block_edge_tie_exactly(gen, d, q):
    """Copies of the query row on both sides of the block edge at 2048 and
    in the ragged block score the same bits (an exact int32 sum), so the
    smallest rows win, in both kernels."""
    ref_rows = _unit(5000, d, gen, torch.bfloat16)
    dups = list(range(2016, 2077)) + [4100, 4990]  # with row 7, 64 rows
    ref_rows[dups] = ref_rows[7].clone()
    c8, cs = qo.quantize_rows(ref_rows)
    q8, qs = qo.quantize_rows(ref_rows[7:8].float().repeat(q, 1))
    want = torch.tensor([7] + dups, device="cuda", dtype=torch.int32)
    got = qo.int8_block_topk(c8, cs, q8, qs, 64, count=5000, block_n=2048)
    assert_topk_match(*got, *qo.int8_block_topk_plain(c8, cs, q8, qs, 64, count=5000, block_n=2048),
                      tol=0.0, exact=True)
    assert (to.merge_partials(*got, 64)[1] == want).all()
    assert (got[0][:, 0, 0] == got[0][:, 1, 0]).all()  # the copies in blocks 0 and 1: the same bits
    table = torch.ones((1, 5000), dtype=torch.int8, device="cuda")
    ids = torch.zeros(q, dtype=torch.int32, device="cuda")
    got = qo.int8_grouped_block_topk(c8, cs, q8, qs, table, ids, 64, count=5000, block_n=2048)
    assert (to.merge_partials(*got, 64)[1] == want).all()


def test_int8_wrappers_refuse_misaligned_rows_and_other_widths(gen):
    c8, cs = qo.quantize_rows(_unit(101, 64, gen))
    shifted = c8.view(-1)[8:8 + 6400].view(100, 64)  # contiguous, 8 bytes past an aligned base
    with pytest.raises(ValueError, match="16-byte"):
        qo.int8_block_topk(shifted, cs[:100], c8[:3], cs[:3], 5, count=100)
    table = torch.ones((1, 100), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        qo.int8_grouped_block_topk(c8[:100], cs[:100], c8.view(-1)[8:8 + 192].view(3, 64), cs[:3], table,
                                   torch.zeros(3, dtype=torch.int32, device="cuda"), 5, count=100)
    c8, cs = qo.quantize_rows(_unit(100, 1001, gen))
    with pytest.raises(ValueError, match="multiple of 4"):
        qo.int8_block_topk(c8, cs, c8, cs, 5, count=100)


def test_int8_tensor_core_kernels_run_igmma_and_tma():
    """The SASS of every int8 kernel 2 and 6 instantiation on the tensor
    cores holds int8 wgmma (IGMMA) and TMA loads (UTMALDG)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the CUDA toolkit: the kernels are built there")
    from photo_search_engine_tpu_torch.ops import _cuda

    counts = _cuda.sass_counts("tc_int8_block_topk_kernel")
    assert len(counts) >= 4, counts  # kernels 2 and 6 at BQ 8 and 32
    assert all(c["IGMMA"] > 0 and c["UTMALDG"] > 0 for c in counts.values()), counts


def test_tensor_core_kernels_run_wgmma_and_tma():
    """The SASS of every bf16 kernel 1, 3 and 5 instantiation on the tensor
    cores holds wgmma (HGMMA) and TMA loads (UTMALDG); bf16 kernel 4
    launches kernel 1's over its ranges (fused_topk.cu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the CUDA toolkit: the kernels are built there")
    import re

    from photo_search_engine_tpu_torch.ops import _cuda

    counts = _cuda.sass_counts("tc_block_topk_kernel")
    # <BQ, stages, grouped, threshold, keys>: kernels 1 and 5, and kernel 3
    # through each (keys), at BQ 8 and 32
    found = {re.search(r"ILi(\d+)ELi4ELb([01])ELb1ELb([01])E", name).groups() for name in counts
             if re.search(r"ILi(\d+)ELi4ELb([01])ELb1ELb([01])E", name)}
    assert found == {(bq, g, keys) for bq in ("8", "32") for g in "01" for keys in "01"}, counts
    assert all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in counts.values()), counts


# ---------------------------------------------------------------------------
# float32 on the ring (fmaf consumers): the FMA loop's bits
# ---------------------------------------------------------------------------


def _same(got, want):
    assert_same_bits("", got, want)


@pytest.mark.parametrize("q", _TC_Q)
@pytest.mark.parametrize("d", [1536, 1000])
@pytest.mark.parametrize("k", [1, 50, 64])
def test_f32_ring_is_the_fma_loop_bit_for_bit(gen, q, d, k):
    """Kernels 1, 3, 4 and 5 on float32 rows with D % 4 == 0 run on the
    ring and give the FMA loop's partials bit for bit on the same inputs:
    each output sums fmaf over D in the FMA loop's order, from +0.0."""
    corpus, queries = _unit(2500, d, gen), _unit(q, d, gen)
    mask = (torch.rand(2500, generator=gen, device="cuda") < 0.6).to(torch.int8)
    table, ids = _predicates(gen, 3, 2500, q)
    assert to.scoring_loop(corpus) == go.scoring_loop(corpus) == "fma_ring"
    with fma_loop():
        assert to.scoring_loop(corpus) == go.scoring_loop(corpus) == "fma"
    for metric in ("ip", "l2"):
        kw = dict(count=2400, metric=metric, mask=mask, cnorms=to.row_sq_norms(corpus), block_n=1024)
        calls = ((to.block_topk, lambda: to.block_topk(corpus, queries, k, **kw)),
                 (to.fast_block_topk, lambda: to.fast_block_topk(corpus, queries, k, **kw)),
                 (to.fused_topk, lambda: to.fused_topk(corpus, queries, k, blocks_per_range=2, **kw)),
                 (go.grouped_block_topk, lambda: go.grouped_block_topk(corpus, queries, table, ids, k,
                                                                       count=2400, block_n=1024)))
        ring = [launch_once(wrapper, call) for wrapper, call in calls]
        with fma_loop():
            fma = [launch_once(wrapper, call) for wrapper, call in calls]
        for got, want in zip(ring, fma):
            _same(got[:2], want[:2])
        _same(ring[2][2:], fma[2][2:])  # kernel 4's range partials


@pytest.mark.parametrize("block_n,bq", [(367, 8), (367, 32), (1100, 8), (1100, 32), (300, 32), (256, 8)])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_f32_ring_ivf_is_the_fma_loop_bit_for_bit(gen, block_n, bq, metric):
    """Kernel 7 on float32 rows with k <= 64 runs on the ring and gives the
    FMA loop's partials bit for bit at the same tile and group size,
    passes of fewer than four row tiles included (367 and 1100 slots)."""
    corpus, queries, probes, row_valid = _ivf_inputs(gen, 24, 1100, 256, 33, 8, torch.float32)
    kw = dict(lrows=1100, metric=metric, cnorms=to.row_sq_norms(corpus), block_n=block_n, bq=bq)
    for k in (1, 64):
        call = lambda: io.ivf_block_topk(corpus, queries, probes, row_valid, k, **kw)  # noqa: E731
        assert io.ivf_scoring_loop(corpus, k) == "fma_ring"
        ring = launch_once(io.ivf_block_topk, call)
        with fma_loop():
            assert io.ivf_scoring_loop(corpus, k) == "fma"
            _same(ring, launch_once(io.ivf_block_topk, call))


def test_f32_ring_refuses_what_it_cannot_stride(gen):
    """The fma_loop hook sends float32 to the FMA loop and leaves bf16 on
    its own; the ring refuses rows off a 16-byte-aligned base, and a
    float32 width TMA cannot stride takes the FMA loop by the rule."""
    f32, bf16 = _unit(100, 64, gen), _unit(100, 64, gen, torch.bfloat16)
    with fma_loop():
        assert to.scoring_loop(f32) == "fma" and to.scoring_loop(bf16) == "tensor_core"
        launch_once(to.block_topk, lambda: to.block_topk(bf16, bf16[:2].contiguous(), 5, count=100))
    wide = _unit(100, 66, gen)
    assert to.scoring_loop(wide) == "fma"
    launch_once(to.block_topk, lambda: to.block_topk(wide, _unit(2, 66, gen), 5, count=100))
    with pytest.raises(ValueError, match="16-byte"):
        to.block_topk(_unit(101, 64, gen).reshape(-1)[1:6401].view(100, 64), f32[:2].contiguous(), 5, count=100)


def test_f32_ring_kernels_run_ffma_and_tma():
    """The SASS of every f32 ring instantiation (kernels 1, 3, 3 grouped
    and 5 at BQ 8 and 32, kernel 7 at both) holds TMA loads (UTMALDG) and
    fmaf (FFMA), and no wgmma."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the CUDA toolkit: the kernels are built there")
    import re

    from photo_search_engine_tpu_torch.ops import _cuda

    counts = _cuda.sass_counts("fma_ring_", ("HGMMA", "FFMA", "UTMALDG"))
    found = {re.search(r"fma_ring_block_topk_kernelILi(\d+)ELb([01])ELb([01])E", name).groups()
             for name in counts if "block_topk" in name}
    assert {(bq, g, keys) for bq in ("8", "32") for g in "01" for keys in "01"} == found, counts
    assert sum("ivf_topk" in name for name in counts) == 2, counts
    assert all(c["FFMA"] > 0 and c["UTMALDG"] > 0 and c["HGMMA"] == 0 for c in counts.values()), counts
