"""Built-in keyword index: BM25 inverted index + EXIF filter fields.

Self-contained replacement for the reference's Elasticsearch dependency
(reference utils/keyword_store.py) with the same observable contract:

* Field boosts ``retrieval_text^3.0, description^2.0,
  inner_content_summary^1.8, outer_scene_summary^1.2, ocr_text^1.5,
  file_name^0.8``, best-fields combination, ``minimum_should_match`` 60%,
  plus a phrase bonus on ``retrieval_text^1.4``
  (keyword_store.py:105-139 _build_text_query).
* ``search`` normalizes BM25 by the max score to 0-1 and drops raw scores
  below 0.12 (keyword_store.py:240-284).
* ``search_with_filters`` combines the text query with exact-term filters
  (year/month/day/hour/season/time_period/weekday/camera) and a datetime
  range; filter-only hits score 0.5, match-all hits 1.0
  (keyword_store.py:286-392).
* ``get_filtered_paths`` (keyword_store.py:394) and ``clear`` (420).

Tokenization: lowercase ASCII word tokens + CJK unigrams and bigrams
(approximating the ES standard/IK analyzers, keyword_store.py:56-82).
BM25 uses Lucene parameters k1=1.2, b=0.75.

Scale design (the ES-server replacement must hold at 100k+ docs, not 77):

* Documents are dense integer **rows** internally (tombstoned on
  overwrite/delete); doc-id strings only appear at the API boundary.
* **Columnar filters**: every exact-match field is a categorical int32
  code column and the datetime is an epoch-seconds int64 column, so
  ``search_with_filters`` evaluates its clauses as vectorized NumPy
  compares over all rows instead of a per-document Python loop
  (replaces ES's filter clauses at keyword_store.py:315-345).
* **Indexed phrase matching**: retrieval_text token streams are stored as
  int32 vocab-id arrays; the phrase pass runs only over docs that already
  BM25-matched and uses a vectorized sliding-window compare.
* **Postings persistence**: ``save`` writes a binary sidecar
  (``<path>.postings.npz``) with the COO postings, per-doc lengths,
  filter columns, and streams; ``load`` restores from it without
  re-tokenizing the corpus (C++ bulk import on the native path).  The
  documents JSON stays the source of truth — a stale/missing sidecar
  falls back to re-tokenization.
* BM25 scoring itself goes through the C++ postings core
  (native/src/bm25.cc) when the toolchain is available; the pure-Python
  fallback produces identical scores (asserted in tests).

The hybrid-fusion caller treats this exactly like the ES-backed store, so
the no-keyword-store degradation path (searcher.py:1194-1196) is
preserved when this component is disabled.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import json
import math
import os
import re
import threading
from datetime import datetime
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

_K1 = 1.2
_B = 0.75
_MIN_SCORE = 0.12
_MIN_SHOULD_MATCH = 0.6
_PHRASE_BOOST = 1.4

TEXT_FIELD_BOOSTS: Dict[str, float] = {
    "retrieval_text": 3.0,
    "description": 2.0,
    "inner_content_summary": 1.8,
    "outer_scene_summary": 1.2,
    "ocr_text": 1.5,
    "file_name": 0.8,
}

FILTER_EXACT_FIELDS = (
    "year",
    "month",
    "day",
    "hour",
    "season",
    "time_period",
    "weekday",
    "camera",
)

_ASCII_WORD = re.compile(r"[a-z0-9_]+")

_EPOCH = datetime(1970, 1, 1)
_NO_DT = -(2**62)  # sentinel for missing/unparseable datetimes
# v4: doc_digest hashes the documents FILE BYTES (one pass over what is
# written/read) instead of a second sort_keys json.dumps of the payload —
# the double serialization was ~40% of save AND load time at 1M docs
_SIDECAR_VERSION = 4


_SIDECAR_SUFFIX = ".postings.npz"


class _RWLock:
    """Reentrant FIFO readers-writer lock for index-while-serve consistency.

    The C++ core has its own shared_mutex, but the Python-side state
    (_row_doc/_docs/_cols_np/_vocab) is a compound structure a reader
    walks in several steps — a concurrent add can otherwise hand the
    native scorer a row the cached row→doc array does not know yet
    (IndexError → HTTP 500 while indexing-while-serving).  Readers run
    concurrently (BM25 scoring releases the GIL in the C++ core);
    mutations are exclusive.  Write-reentrant because load() drives
    clear()/add_document() internally.

    Admission is FIFO over a queue of waiters (consecutive readers
    coalesce into one batch): a hot closed search loop cannot starve the
    indexer, and a tight indexing loop cannot starve searches — plain
    writer-preference livelocked on single-core hosts (the releasing
    writer re-queued before notified readers were scheduled)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        # FIFO of waiter entries: ["R", n_waiting, admitted] reader
        # batches / ["W", thread_ident] writers
        self._queue: List[list] = []
        self._readers = 0  # active readers
        self._writer: Optional[int] = None  # owning thread ident
        self._writer_depth = 0

    def _admit_head(self) -> None:
        """Called whenever the lock frees up: open the head reader batch
        (writers admit themselves via their wait predicate)."""
        if self._queue and self._queue[0][0] == "R":
            self._queue[0][2] = True
        self._cond.notify_all()

    def acquire_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:  # read nested in own write: exclusive already
                self._writer_depth += 1
                return
            if not self._queue and self._writer is None:
                self._readers += 1  # fast path: no waiters, join running readers
                return
            if self._queue and self._queue[-1][0] == "R":
                batch = self._queue[-1]
            else:
                batch = ["R", 0, False]
                self._queue.append(batch)
            batch[1] += 1
            while not (batch[2] and self._writer is None):
                self._cond.wait()
            batch[1] -= 1
            self._readers += 1
            if not batch[1]:  # batch fully admitted — unblock the next writer
                self._queue.remove(batch)
                self._cond.notify_all()

    def release_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._writer_depth -= 1
                return
            self._readers -= 1
            if not self._readers:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._writer_depth += 1
                return
            entry = ["W", me]
            self._queue.append(entry)
            while not (
                self._queue[0] is entry
                and self._writer is None
                and not self._readers
            ):
                self._cond.wait()
            self._queue.pop(0)
            self._writer = me
            self._writer_depth = 1
            self._admit_head()  # pre-open the next reader batch: they still
            # wait on writer None, but wake as soon as this writer releases

    def release_write(self) -> None:
        with self._cond:
            self._writer_depth -= 1
            if not self._writer_depth:
                self._writer = None
                self._admit_head()


def _reads(method):
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        self._rw.acquire_read()
        try:
            return method(self, *args, **kwargs)
        finally:
            self._rw.release_read()

    return wrapper


def _writes(method):
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        self._rw.acquire_write()
        try:
            return method(self, *args, **kwargs)
        finally:
            self._rw.release_write()

    return wrapper


def _gated_reads(method):
    """Read lock + whole-query admission gate for the scoring entry
    points.  The gate is taken OUTSIDE the read lock so a queued query
    holds nothing — writers stay unblocked by the waiting line.  See
    _score_concurrency_limit for the measured rationale (1-core host:
    p50 172.6 → 20.6 ms at 8 threads, QPS 34.9 → 47.0 vs gating only
    the native call)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with _QUERY_GATE:
            self._rw.acquire_read()
            try:
                return method(self, *args, **kwargs)
            finally:
                self._rw.release_read()

    return wrapper


def _is_cjk(char: str) -> bool:
    code = ord(char)
    return (
        0x4E00 <= code <= 0x9FFF
        or 0x3400 <= code <= 0x4DBF
        or 0xF900 <= code <= 0xFAFF
    )


def tokenize(text: Any) -> List[str]:
    """Lowercased ASCII words + CJK unigrams and bigrams, in order."""
    if text is None:
        return []
    text = str(text).lower()
    tokens: List[str] = []
    cjk_run: List[str] = []

    def flush_cjk() -> None:
        if not cjk_run:
            return
        tokens.extend(cjk_run)
        for a, b in zip(cjk_run, cjk_run[1:]):
            tokens.append(a + b)
        cjk_run.clear()

    buffer = []
    for char in text:
        if _is_cjk(char):
            if buffer:
                tokens.extend(_ASCII_WORD.findall("".join(buffer)))
                buffer.clear()
            cjk_run.append(char)
        else:
            flush_cjk()
            buffer.append(char)
    flush_cjk()
    if buffer:
        tokens.extend(_ASCII_WORD.findall("".join(buffer)))
    return tokens


def _parse_dt(value: Optional[str], *, end_of_day: bool = False) -> Optional[datetime]:
    """Multi-format date parse; date-only end bounds extend to 23:59:59
    (mirrors searcher-side boundary handling, reference searcher.py:1963-2001)."""
    if not value or not isinstance(value, str):
        return None
    cleaned = value.strip().rstrip("\x00")
    date_only = ("%Y-%m-%d", "%Y/%m/%d", "%Y%m%d")
    formats = (
        "%Y-%m-%d",
        "%Y-%m-%dT%H:%M:%S",
        "%Y-%m-%d %H:%M:%S",
        "%Y:%m:%d %H:%M:%S",
        "%Y/%m/%d %H:%M:%S",
        "%Y/%m/%d",
        "%Y%m%d",
    )
    for fmt in formats:
        try:
            parsed = datetime.strptime(cleaned, fmt)
        except ValueError:
            continue
        if end_of_day and fmt in date_only:
            return parsed.replace(hour=23, minute=59, second=59)
        return parsed
    try:
        return datetime.fromisoformat(cleaned)
    except Exception:
        return None


def _epoch_seconds(dt: datetime) -> int:
    # naive arithmetic on naive datetimes — no timezone dependence, and the
    # same conversion is applied to document values and query bounds
    return int((dt - _EPOCH).total_seconds())


def _score_concurrency_limit() -> int:
    """Concurrent scoring queries admitted process-wide: one per
    available core (env-overridable via PSE_BM25_MAX_CONCURRENCY).

    The C++ shared_mutex admits ANY number of concurrent scorers, so
    correctness never depends on this — it is a throughput governor.
    Admitting more scoring queries than cores just timeshares the cores
    among N cold ~12 MB scratch sets and GIL-convoys the Python fusion
    half of each query.  Measured at 1M docs on a 1-core host, 8 closed-
    loop threads: unbounded → 0.6–41 QPS, p50 156–3483 ms (native call
    wall inflates 16 → 763 ms under the convoy); whole-query admissions
    bounded to the core count → 45–49 QPS, p50 20.6 ms ≈ the 22.6 ms
    serial latency.  Gating only the native C call (not the whole query)
    still left the Python half convoying: p50 173 ms median, 3.4× worse
    QPS.  Multicore hosts overlap fully up to one query per core."""
    override = os.getenv("PSE_BM25_MAX_CONCURRENCY")
    if override:
        try:
            return max(1, int(override))
        except ValueError:
            pass
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:  # non-Linux
        return max(1, os.cpu_count() or 1)


class _LazyQueryGate:
    """Process-wide FIFO scoring-query admission gate, sized on first
    use so tests can set PSE_BM25_MAX_CONCURRENCY before any search.

    FIFO matters: with a plain threading.Semaphore the releasing thread
    barges — it re-acquires before the woken waiter is scheduled, and a
    closed-loop client can monopolize the gate for the whole window
    (measured 1M/8 threads/1 core: per-thread completions [167,1,1,1,
    1,1,1,1], i.e. 7 clients starved for the full 5 s window, AND
    aggregate QPS *below* serial at 31.6).  Handing each released
    permit directly to the oldest waiter bounds every client's wait to
    (queue length × per-query latency) and restores serial-rate
    aggregate throughput."""

    def __init__(self):
        self._lock = threading.Lock()
        self._waiters: "collections.deque[threading.Event]" = (
            collections.deque()
        )
        self._permits: Optional[int] = None  # sized lazily

    def __enter__(self):
        with self._lock:
            if self._permits is None:
                self._permits = _score_concurrency_limit()
            if self._permits > 0 and not self._waiters:
                self._permits -= 1
                return self
            ev = threading.Event()
            self._waiters.append(ev)
        try:
            ev.wait()
        except BaseException:
            # interrupted while queued (e.g. KeyboardInterrupt in a CLI
            # bench): the 'with' body never runs, so __exit__ will not
            # return this permit — undo the enqueue, or, if a releasing
            # thread already handed us the permit (our Event left the
            # queue), forward it on so it is not lost (review round 4)
            with self._lock:
                try:
                    self._waiters.remove(ev)
                except ValueError:
                    if self._waiters:
                        self._waiters.popleft().set()
                    else:
                        self._permits += 1
            raise
        return self

    def __exit__(self, *exc):
        with self._lock:
            if self._waiters:
                # Hand the permit straight to the oldest waiter; the
                # permit count is unchanged (ownership transfers).
                self._waiters.popleft().set()
            else:
                self._permits += 1
        return False


_QUERY_GATE = _LazyQueryGate()


class _NativeBM25:
    """ctypes adapter over native/src/bm25.cc — packed postings + BM25
    scoring in C++ (the keyword channel's hot path at large corpus
    sizes).  Pure integer interface: the owner maps tokens/doc-ids to
    dense vocab ids / rows."""

    def __init__(self) -> None:
        from photo_search_engine_tpu_torch.native import get_library

        self._lib = get_library()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._n_fields = len(TEXT_FIELD_BOOSTS)
        self._handle = self._lib.pse_bm25_new(self._n_fields)

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            if getattr(self, "_handle", None):
                self._lib.pse_bm25_free(self._handle)
        except Exception:
            pass

    @staticmethod
    def _ptr(arr: np.ndarray, ctype):
        import ctypes

        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    def add_doc(self, row: int, field_index: int, tids: np.ndarray) -> None:
        import ctypes

        ids = np.ascontiguousarray(tids, np.int64)
        self._lib.pse_bm25_add_doc(
            self._handle, row, field_index,
            self._ptr(ids, ctypes.c_int64), len(ids),
        )

    def remove_doc(self, row: int) -> None:
        self._lib.pse_bm25_remove_doc(self._handle, row)

    def score_field(
        self,
        field_index: int,
        tids: Iterable[int],
        min_required: int,
        allowed: Optional[np.ndarray] = None,  # uint8 per-row filter mask
    ):
        """(rows, scores, matched) arrays for docs matching >= min_required
        distinct terms; ``allowed`` pushes a row filter INTO the postings
        walk (selective EXIF filters cut the scoring work by their
        selectivity)."""
        import ctypes

        term_arr = np.asarray(list(tids), np.int64)
        if term_arr.size == 0:
            empty = np.empty(0, np.int64)
            return empty, np.empty(0, np.float64), empty
        capacity = max(
            1024, int(self._lib.pse_bm25_field_doc_count(self._handle, field_index))
        )
        out_docs = np.empty(capacity, np.int64)
        out_scores = np.empty(capacity, np.float64)
        out_matched = np.empty(capacity, np.int64)
        allowed_ptr = None
        allowed_len = 0
        allowed_arr = None  # keep the buffer alive across the C call
        if allowed is not None:
            allowed_arr = np.ascontiguousarray(allowed, np.uint8)
            allowed_ptr = self._ptr(allowed_arr, ctypes.c_uint8)
            allowed_len = len(allowed_arr)
        written = self._lib.pse_bm25_score_field_masked(
            self._handle,
            field_index,
            self._ptr(term_arr, ctypes.c_int64),
            len(term_arr),
            min_required,
            allowed_ptr,
            allowed_len,
            self._ptr(out_docs, ctypes.c_int64),
            self._ptr(out_scores, ctypes.c_double),
            self._ptr(out_matched, ctypes.c_int64),
            capacity,
        )
        if written > capacity:
            # the C core returns the REQUIRED size on overflow and writes
            # nothing; capacity = field_doc_count makes this unreachable
            # today, but a silent clamp would drop matching docs if that
            # invariant ever broke — fail loudly instead
            raise RuntimeError(
                f"native BM25 buffer overflow: need {written} > {capacity}"
            )
        return out_docs[:written], out_scores[:written], out_matched[:written]

    def phrase_hits(
        self,
        flat: np.ndarray,
        starts: np.ndarray,
        lens: np.ndarray,
        cand: np.ndarray,
        pattern: np.ndarray,
    ) -> np.ndarray:
        """Candidate rows whose packed stream contains ``pattern``
        contiguously (stateless C walk over the caller-owned buffers —
        the numpy path gathered every candidate stream into one giant
        temp; see bm25.cc pse_phrase_hits)."""
        import ctypes

        flat = np.ascontiguousarray(flat, np.int32)
        starts = np.ascontiguousarray(starts, np.int64)
        lens = np.ascontiguousarray(lens, np.int64)
        cand = np.ascontiguousarray(cand, np.int64)
        pattern = np.ascontiguousarray(pattern, np.int32)
        out = np.empty(max(len(cand), 1), np.int64)
        n = self._lib.pse_phrase_hits(
            self._ptr(flat, ctypes.c_int32), len(flat),
            self._ptr(starts, ctypes.c_int64),
            self._ptr(lens, ctypes.c_int64), len(starts),
            self._ptr(cand, ctypes.c_int64), len(cand),
            self._ptr(pattern, ctypes.c_int32), len(pattern),
            self._ptr(out, ctypes.c_int64),
        )
        return out[:n]

    def phrase_hits_mask(
        self,
        flat: np.ndarray,
        starts: np.ndarray,
        lens: np.ndarray,
        cand: np.ndarray,
        pattern: np.ndarray,
    ) -> np.ndarray:
        """Per-candidate boolean phrase-hit mask (candidate order).  The
        positional form lets the fused scorer apply the phrase bonus with
        one fancy-index — no id-set intersection (bm25.cc
        pse_phrase_hits_mask)."""
        import ctypes

        flat = np.ascontiguousarray(flat, np.int32)
        starts = np.ascontiguousarray(starts, np.int64)
        lens = np.ascontiguousarray(lens, np.int64)
        cand = np.ascontiguousarray(cand, np.int64)
        pattern = np.ascontiguousarray(pattern, np.int32)
        mask = np.zeros(max(len(cand), 1), np.uint8)
        self._lib.pse_phrase_hits_mask(
            self._ptr(flat, ctypes.c_int32), len(flat),
            self._ptr(starts, ctypes.c_int64),
            self._ptr(lens, ctypes.c_int64), len(starts),
            self._ptr(cand, ctypes.c_int64), len(cand),
            self._ptr(pattern, ctypes.c_int32), len(pattern),
            self._ptr(mask, ctypes.c_uint8),
        )
        return mask[: len(cand)].view(np.bool_)

    def score_query(
        self,
        tids: Iterable[int],
        min_required: int,
        boosts: np.ndarray,           # [n_fields] f64, field order
        rt_field: int,                # phrase-candidate field index (-1 off)
        full_match: int,
        allowed: Optional[np.ndarray] = None,
        total_rows: int = 0,
    ):
        """Fused best_fields scorer: one C call for all fields.  Returns
        (rows, fused_scores, cand_pos, cand_rt) — cand_pos indexes into
        rows for the retrieval_text full-match (phrase candidate) set."""
        import ctypes

        term_arr = np.asarray(list(tids), np.int64)
        empty_i = np.empty(0, np.int64)
        empty_f = np.empty(0, np.float64)
        if term_arr.size == 0:
            return empty_i, empty_f, empty_i, empty_f
        capacity = max(1024, int(total_rows))
        out_rows = np.empty(capacity, np.int64)
        out_scores = np.empty(capacity, np.float64)
        out_cand_pos = np.empty(capacity, np.int64)
        out_cand_rt = np.empty(capacity, np.float64)
        n_cands = np.zeros(1, np.int64)
        boosts = np.ascontiguousarray(boosts, np.float64)
        allowed_ptr = None
        allowed_len = 0
        allowed_arr = None  # keep the buffer alive across the C call
        if allowed is not None:
            allowed_arr = np.ascontiguousarray(allowed, np.uint8)
            allowed_ptr = self._ptr(allowed_arr, ctypes.c_uint8)
            allowed_len = len(allowed_arr)
        written = self._lib.pse_bm25_score_query(
            self._handle,
            self._ptr(term_arr, ctypes.c_int64),
            len(term_arr),
            min_required,
            self._ptr(boosts, ctypes.c_double),
            rt_field,
            full_match,
            allowed_ptr,
            allowed_len,
            self._ptr(out_rows, ctypes.c_int64),
            self._ptr(out_scores, ctypes.c_double),
            capacity,
            self._ptr(out_cand_pos, ctypes.c_int64),
            self._ptr(out_cand_rt, ctypes.c_double),
            capacity,
            self._ptr(n_cands, ctypes.c_int64),
        )
        if written > capacity:
            # capacity = live row count makes this unreachable (see
            # score_field) — fail loudly rather than dropping matches
            raise RuntimeError(
                f"native BM25 buffer overflow: need {written} > {capacity}"
            )
        c = int(n_cands[0])
        return (
            out_rows[:written],
            out_scores[:written],
            out_cand_pos[:c],
            out_cand_rt[:c],
        )

    def export_field(self, field_index: int):
        """COO postings + per-doc lengths of one field (for persistence)."""
        import ctypes

        nnz = int(self._lib.pse_bm25_field_nnz(self._handle, field_index))
        tids = np.empty(nnz, np.int64)
        rows = np.empty(nnz, np.int64)
        tfs = np.empty(nnz, np.int32)
        if nnz:
            exported = self._lib.pse_bm25_export_field(
                self._handle, field_index,
                self._ptr(tids, ctypes.c_int64),
                self._ptr(rows, ctypes.c_int64),
                self._ptr(tfs, ctypes.c_int32),
                nnz,
            )
            if exported != nnz:
                # persisting np.empty garbage into the sidecar would be a
                # silent corruption — fail loudly (load re-tokenizes)
                raise RuntimeError(
                    f"native BM25 export mismatch: {exported} != {nnz}"
                )
        n_docs = int(self._lib.pse_bm25_field_doc_count(self._handle, field_index))
        len_rows = np.empty(n_docs, np.int64)
        lens = np.empty(n_docs, np.int64)
        if n_docs:
            self._lib.pse_bm25_export_doc_lens(
                self._handle, field_index,
                self._ptr(len_rows, ctypes.c_int64),
                self._ptr(lens, ctypes.c_int64),
                n_docs,
            )
        return tids, rows, tfs, len_rows, lens

    def load_field(self, field_index, tids, rows, tfs, len_rows, lens) -> None:
        """Bulk import one field (fresh index only)."""
        import ctypes

        tids = np.ascontiguousarray(tids, np.int64)
        rows = np.ascontiguousarray(rows, np.int64)
        tfs = np.ascontiguousarray(tfs, np.int32)
        len_rows = np.ascontiguousarray(len_rows, np.int64)
        lens = np.ascontiguousarray(lens, np.int64)
        self._lib.pse_bm25_load_field(
            self._handle, field_index,
            self._ptr(tids, ctypes.c_int64),
            self._ptr(rows, ctypes.c_int64),
            self._ptr(tfs, ctypes.c_int32),
            len(tids),
            self._ptr(len_rows, ctypes.c_int64),
            self._ptr(lens, ctypes.c_int64),
            len(len_rows),
        )


class KeywordIndex:
    """BM25 + filters over photo documents (keyed by doc id).

    ``native="auto"`` (default) scores with the C++ postings core when the
    toolchain is available; ``native=False`` forces the pure-Python path.
    Both produce identical scores (asserted in tests)."""

    def __init__(self, index_path: Optional[str] = None, native: Any = "auto") -> None:
        self.index_path = index_path
        self._native: Optional[_NativeBM25] = None
        self._want_native = native == "auto" or native is True
        self._rw = _RWLock()
        self._reset_state()

    def _reset_state(self) -> None:
        # rows covered by the last sidecar write (per-batch saves throttle
        # the sidecar export — see save())
        self._sidecar_rows_written: int = -(1 << 30)
        self._docs: Dict[str, Dict[str, Any]] = {}
        self._vocab: Dict[str, int] = {}
        self._vocab_list: List[str] = []
        self._doc_row: Dict[str, int] = {}
        self._row_doc: List[str] = []
        # the cached numpy view of _row_doc (and its doc-id rank twin) is
        # keyed only on length — drop both explicitly so a reload of a
        # same-sized corpus cannot serve stale doc ids (round-3 advisor)
        self._row_doc_arr: Optional[np.ndarray] = None
        self._row_rank_arr: Optional[np.ndarray] = None
        # corpus length observed by the previous search — gates the rank
        # rebuild so index-while-serve interleaves never pay it (_tie_key)
        self._rank_len_seen: int = -1
        self._alive: List[bool] = []
        # columnar filter state
        self._col_codes: Dict[str, List[int]] = {f: [] for f in FILTER_EXACT_FIELDS}
        self._cats: Dict[str, Dict[Any, int]] = {f: {} for f in FILTER_EXACT_FIELDS}
        self._cat_values: Dict[str, List[Any]] = {f: [] for f in FILTER_EXACT_FIELDS}
        self._dt_col: List[int] = []
        self._cols_np: Optional[Dict[str, np.ndarray]] = None
        # retrieval_text id streams (phrase matching), row-indexed
        self._streams: List[Optional[np.ndarray]] = []
        # packed stream cache for the vectorized phrase pass:
        # (flat int32 buffer with a -1 after every stream, starts, lens)
        self._stream_pack: Optional[tuple] = None
        # pure-Python postings fallback: field -> tid -> {row: tf}
        self._postings: Dict[str, Dict[int, Dict[int, int]]] = {
            field: {} for field in TEXT_FIELD_BOOSTS
        }
        self._doc_len: Dict[str, Dict[int, int]] = {
            field: {} for field in TEXT_FIELD_BOOSTS
        }
        self._total_len: Dict[str, int] = {field: 0 for field in TEXT_FIELD_BOOSTS}
        self._row_tids: Dict[str, Dict[int, np.ndarray]] = {
            field: {} for field in TEXT_FIELD_BOOSTS
        }
        self._native = None
        if self._want_native:
            try:
                self._native = _NativeBM25()
            except Exception:
                self._native = None

    # ------------------------------------------------------------------
    @property
    def count(self) -> int:
        return len(self._docs)

    def _tid(self, token: str, create: bool) -> Optional[int]:
        tid = self._vocab.get(token)
        if tid is None and create:
            tid = len(self._vocab_list)
            self._vocab[token] = tid
            self._vocab_list.append(token)
        return tid

    def _cat_code(self, field: str, value: Any) -> int:
        """Categorical code for a document value (creates on first sight);
        unhashable values are treated as missing."""
        try:
            code = self._cats[field].get(value)
        except TypeError:
            return -1
        if code is None:
            code = len(self._cat_values[field])
            self._cats[field][value] = code
            self._cat_values[field].append(value)
        return code

    @_writes
    def add_document(self, doc_id: str, document: Dict[str, Any]) -> None:
        """Insert or overwrite a document (reference keyword_store.py:216-238)."""
        if "photo_path" not in document or "description" not in document:
            raise ValueError("document requires photo_path and description fields")
        if doc_id in self._docs:
            self._remove(doc_id)
        row = len(self._row_doc)
        self._row_doc.append(doc_id)
        self._alive.append(True)
        self._doc_row[doc_id] = row
        self._docs[doc_id] = dict(document)

        for field in FILTER_EXACT_FIELDS:
            value = document.get(field)
            code = -1 if value is None else self._cat_code(field, value)
            self._col_codes[field].append(code)
        doc_dt = _parse_dt(document.get("datetime"))
        self._dt_col.append(_epoch_seconds(doc_dt) if doc_dt else _NO_DT)
        self._cols_np = None

        # Tokenize and finish EVERY Python-side structure (streams, cache
        # invalidations) BEFORE the row enters the scorer: the C++ core
        # scores concurrently with this mutator (index-while-serve), and a
        # scorer that sees the new row must never index past a stale
        # packed-stream / column snapshot.
        field_tids: List[Tuple[int, str, np.ndarray, int]] = []
        stream: Optional[np.ndarray] = None
        for field_index, field in enumerate(TEXT_FIELD_BOOSTS):
            tokens = tokenize(document.get(field))
            tids = np.asarray(
                [self._tid(t, create=True) for t in tokens], np.int32
            )
            if field == "retrieval_text":
                stream = tids
            field_tids.append((field_index, field, tids, len(tokens)))
        self._streams.append(stream)
        self._stream_pack = None
        for field_index, field, tids, n_tokens in field_tids:
            if self._native is not None:
                self._native.add_doc(row, field_index, tids)
            else:
                if tids.size:
                    uniq, counts = np.unique(tids, return_counts=True)
                else:
                    uniq = np.empty(0, np.int32)
                    counts = uniq
                postings = self._postings[field]
                for tid, tf in zip(uniq.tolist(), counts.tolist()):
                    postings.setdefault(tid, {})[row] = tf
                self._row_tids[field][row] = uniq
                self._doc_len[field][row] = n_tokens
                self._total_len[field] += n_tokens

    def _remove(self, doc_id: str) -> None:
        row = self._doc_row.pop(doc_id, None)
        self._docs.pop(doc_id, None)
        if row is None:
            return
        self._alive[row] = False
        self._streams[row] = None
        self._stream_pack = None
        self._cols_np = None
        if self._native is not None:
            self._native.remove_doc(row)
            return
        for field in TEXT_FIELD_BOOSTS:
            tids = self._row_tids[field].pop(row, None)
            if tids is not None:
                postings = self._postings[field]
                for tid in tids.tolist():
                    entry = postings.get(tid)
                    if entry is not None:
                        entry.pop(row, None)
                        if not entry:
                            postings.pop(tid)
            length = self._doc_len[field].pop(row, None)
            if length:
                self._total_len[field] -= length

    @_writes
    def delete_document(self, doc_id: str) -> None:
        self._remove(doc_id)

    @_writes
    def clear(self) -> None:
        """Drop everything (reference keyword_store.py:420 delete+recreate)."""
        self._reset_state()

    # ------------------------------------------------------------------
    def _field_scores(
        self,
        field: str,
        tids: List[int],
        required: int,
        allowed: Optional[np.ndarray] = None,
    ):
        """Per-row BM25 for one field as (rows, scores, matched) arrays,
        honoring minimum_should_match.  ``allowed`` (uint8 per-row mask)
        pushes the EXIF-filter candidate set INTO the postings walk."""
        if self._native is not None:
            field_index = list(TEXT_FIELD_BOOSTS).index(field)
            return self._native.score_field(field_index, tids, required, allowed)
        n_docs = max(1, len(self._docs))
        lengths = self._doc_len[field]
        avg_len = (self._total_len[field] / len(lengths)) if lengths else 0.0

        scores: Dict[int, float] = {}
        matched: Dict[int, int] = {}
        for tid in tids:
            postings = self._postings[field].get(tid)
            if not postings:
                continue
            df = len(postings)
            idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
            for row, tf in postings.items():
                # rows >= len(allowed) appeared after the caller built its
                # mask (index-while-serve): filtered out, same as native
                if allowed is not None and (
                    row >= len(allowed) or not allowed[row]
                ):
                    continue
                dl = lengths.get(row, 0)
                denom = tf + _K1 * (1.0 - _B + (_B * dl / avg_len if avg_len else 0.0))
                scores[row] = scores.get(row, 0.0) + idf * (tf * (_K1 + 1.0) / denom)
                matched[row] = matched.get(row, 0) + 1
        keep = [row for row, m in matched.items() if m >= required]
        rows = np.asarray(keep, np.int64)
        svals = np.asarray([scores[row] for row in keep], np.float64)
        mvals = np.asarray([matched[row] for row in keep], np.int64)
        return rows, svals, mvals

    def _packed_streams(self):
        """All retrieval_text streams packed into ONE -1-separated int32
        buffer + per-row (start, len incl. separator) arrays, cached and
        invalidated on any mutation.  The phrase pass gathers candidate
        slices from this buffer fully vectorized — the per-candidate Python
        append loop was the phrase bottleneck at 1M docs."""
        if self._stream_pack is not None:
            return self._stream_pack
        n = len(self._streams)
        lens = np.zeros(n, np.int64)
        starts = np.full(n, -1, np.int64)
        parts: List[np.ndarray] = []
        sep = np.full(1, -1, np.int32)
        pos = 0
        for row, stream in enumerate(self._streams):
            if stream is None:
                continue
            starts[row] = pos
            lens[row] = len(stream) + 1
            parts.append(np.asarray(stream, np.int32))
            parts.append(sep)
            pos += len(stream) + 1
        flat = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        self._stream_pack = (flat, starts, lens)
        return self._stream_pack

    def _phrase_rows(
        self, pattern: np.ndarray, candidates: Iterable[int]
    ) -> np.ndarray:
        """Rows whose retrieval_text stream contains ``pattern`` as a
        contiguous subsequence (the match_phrase clause,
        keyword_store.py:128-135), as a sorted int64 array.  Candidate
        streams are gathered from the packed buffer (``_packed_streams``)
        and the pattern match is a single vectorized pass; the -1
        separators can never equal a vocab id, so matches cannot span
        documents."""
        plen = len(pattern)
        empty = np.empty(0, np.int64)
        flat, starts, lens = self._packed_streams()
        if isinstance(candidates, np.ndarray):
            cand = candidates.astype(np.int64, copy=False)
        else:
            cand = np.asarray(list(candidates), np.int64)
        if cand.size == 0:
            return empty
        # rows appended after this pack was built (index-while-serve) have
        # no stream here yet — conservatively no phrase bonus this query
        cand = cand[cand < starts.shape[0]]
        if cand.size == 0:
            return empty
        if self._native is not None:
            # stateless C walk (bm25.cc pse_phrase_hits): same row-validity
            # checks, same contiguous-match semantics, no giant gather temp
            return np.sort(
                self._native.phrase_hits(flat, starts, lens, cand, pattern)
            )
        ok = (starts[cand] >= 0) & (lens[cand] > plen)  # len incl. separator
        cand = cand[ok]
        if cand.size == 0:
            return empty
        lens_c = lens[cand]
        prefix = np.concatenate(([0], np.cumsum(lens_c)[:-1]))
        total = int(lens_c.sum())
        idx = np.repeat(starts[cand] - prefix, lens_c) + np.arange(
            total, dtype=np.int64
        )
        buf = flat[idx]
        n = len(buf) - plen + 1
        if n <= 0:
            return empty
        match = buf[:n] == pattern[0]
        for j in range(1, plen):
            match &= buf[j : j + n] == pattern[j]
        hit_pos = np.nonzero(match)[0]
        if not len(hit_pos):
            return empty
        i = np.searchsorted(prefix, hit_pos, side="right") - 1
        return np.sort(cand[np.unique(i)])

    def _text_scores(self, query: Optional[str], cand_mask: Optional[np.ndarray]):
        """best_fields multi_match + phrase bonus as a dense score vector;
        None when no query text.  Returns (rows, scores) arrays of rows with
        a positive combined score (candidate-filtered when ``cand_mask``,
        a per-row bool mask from ``_filter_rows``, is given)."""
        if not query or not str(query).strip():
            return None
        terms = tokenize(query)
        if not terms:
            # non-blank text that analyzes to zero tokens (emoji,
            # punctuation): ES's must multi_match matches NOTHING
            # (zero_terms_query=none) — mirror that instead of silently
            # degrading to the filter-only path, so the builtin and the
            # ES adapter return identical results for the same request
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        unique_terms = list(dict.fromkeys(terms))
        # unknown terms still count toward minimum_should_match
        required = max(1, int(_MIN_SHOULD_MATCH * len(unique_terms)))
        known_tids = [
            tid for tid in (self._vocab.get(t) for t in unique_terms)
            if tid is not None
        ]
        n_rows = len(self._row_doc)
        # candidate pushdown: the EXIF-filter mask rides INTO the
        # postings walk as a byte mask (native + python paths), so a
        # selective filter cuts BM25 work by its selectivity instead of
        # intersecting after scoring everything.  numpy bool is one byte,
        # so the view is zero-copy — at 1M docs the old
        # indices-then-scatter staging was ~1.5 ms/query of pure Python
        # time (round-5 profile).  Rows appended after the mask was built
        # (index-while-serve) are past its end and read as filtered-out
        # on both walk paths.
        allowed = None
        if cand_mask is not None:
            allowed = cand_mask.view(np.uint8)
        if self._native is not None:
            return self._text_scores_native(
                terms, known_tids, required, allowed, n_rows
            )
        best = np.zeros(n_rows, np.float64)
        rt_rows = rt_scores = rt_matched = None
        for field, boost in TEXT_FIELD_BOOSTS.items():
            rows, scores, matched = self._field_scores(
                field, known_tids, required, allowed
            )
            if field == "retrieval_text":
                rt_rows, rt_scores, rt_matched = rows, scores, matched
            if len(rows):
                # rows are unique within a field, so fancy-index max is safe
                best[rows] = np.maximum(best[rows], scores * boost)
        # A full contiguous match needs every pattern term in retrieval_text,
        # so phrase candidates are the matched == all-terms rows of the
        # retrieval_text pass — the sliding-window check runs on those only.
        # (rt_rows is already candidate-filtered by the pushdown.)
        pattern_tids = [self._vocab.get(t) for t in terms]
        if (
            len(terms) >= 2
            and all(t is not None for t in pattern_tids)
            and rt_rows is not None
            and len(rt_rows)
        ):
            full = rt_matched >= len(known_tids)
            check_rows = rt_rows[full]
            check_scores = rt_scores[full]
            pattern = np.asarray(pattern_tids, np.int32)
            hits = self._phrase_rows(pattern, check_rows)
            if len(hits):
                is_hit = np.isin(check_rows, hits, assume_unique=True)
                best[check_rows[is_hit]] += _PHRASE_BOOST * check_scores[is_hit]
        scored = np.nonzero(best > 0.0)[0]
        return scored, best[scored]

    def _text_scores_native(
        self,
        terms: List[str],
        known_tids: List[int],
        required: int,
        allowed: Optional[np.ndarray],
        n_rows: int,
    ):
        """Fused-native twin of the per-field loop above: ONE C call walks
        all fields, fuses best_fields max(boost × BM25) and returns the
        qualifying rows compactly — no dense [n_rows] staging, no per-field
        output buffers.  Scores are bit-identical to the fallback path
        (same walk order, same accumulation, exact max) — asserted by
        tests/test_keyword_index.py parity cases."""
        boosts = np.asarray(list(TEXT_FIELD_BOOSTS.values()), np.float64)
        # The phrase bonus only applies to multi-term queries whose every
        # term is in-vocabulary; when it can't apply, pass rt_field=-1 so
        # the C walk skips candidate collection entirely (a hot single-term
        # query otherwise parks every retrieval_text match for nothing).
        pattern_tids = [self._vocab.get(t) for t in terms]
        phrase_possible = len(terms) >= 2 and all(
            t is not None for t in pattern_tids
        )
        rt_index = (
            list(TEXT_FIELD_BOOSTS).index("retrieval_text")
            if phrase_possible
            else -1
        )
        rows, fused, cand_pos, cand_rt = self._native.score_query(
            known_tids,
            required,
            boosts,
            rt_index,
            max(len(known_tids), 1),
            allowed,
            n_rows,
        )
        if phrase_possible and len(cand_pos):
            check_rows = rows[cand_pos]
            pattern = np.asarray(pattern_tids, np.int32)
            # positional mask straight from the C walk: no id-set
            # intersection (np.isin sorted ~40k candidates for ~4 ms at
            # 1M docs).  Rows appended after the stream pack was built
            # (index-while-serve) read as no-hit, matching _phrase_rows.
            flat, starts, lens = self._packed_streams()
            is_hit = self._native.phrase_hits_mask(
                flat, starts, lens, check_rows, pattern
            )
            if is_hit.any():
                fused[cand_pos[is_hit]] += _PHRASE_BOOST * cand_rt[is_hit]
        return rows, fused

    # ------------------------------------------------------------------
    def _cols(self) -> Dict[str, np.ndarray]:
        if self._cols_np is None:
            cols: Dict[str, np.ndarray] = {
                "alive": np.asarray(self._alive, bool),
                "dt": np.asarray(self._dt_col, np.int64),
            }
            for field in FILTER_EXACT_FIELDS:
                cols[field] = np.asarray(self._col_codes[field], np.int32)
            self._cols_np = cols
        return self._cols_np

    def _filter_rows(self, filters: Dict[str, Any]) -> Optional[np.ndarray]:
        """Per-row bool mask of docs passing exact-term + datetime-range
        filters as one vectorized columnar pass; None when no filters are
        given (keyword_store.py:315-345).  Returned as a mask, not row
        indices: the text path feeds it straight into the postings walk
        (a zero-copy uint8 view), so the corpus-sized nonzero()/scatter
        round-trip the old index form paid per query never happens; the
        filter-only paths nonzero() it where they genuinely need rows."""
        clauses = []
        for field in FILTER_EXACT_FIELDS:
            value = filters.get(field)
            if value is not None:
                clauses.append((field, value))
        start = _parse_dt(filters.get("start_date"))
        end = _parse_dt(filters.get("end_date"), end_of_day=True)
        if not clauses and start is None and end is None:
            return None

        cols = self._cols()
        mask = cols["alive"].copy()
        for field, value in clauses:
            try:
                code = self._cats[field].get(value)
            except TypeError:
                code = None
            if code is None:
                return np.zeros(mask.shape[0], bool)
            mask &= cols[field] == code
        if start is not None or end is not None:
            dt = cols["dt"]
            mask &= dt != _NO_DT
            if start is not None:
                mask &= dt >= _epoch_seconds(start)
            if end is not None:
                mask &= dt <= _epoch_seconds(end)
        return mask

    # ------------------------------------------------------------------
    def _row_doc_np(self) -> np.ndarray:
        """Row → doc-id as a numpy unicode array (cached): the top-k
        tie-break sorts on it vectorized (numpy <U compare == Python str
        compare, so the (-score, doc_id) order is unchanged)."""
        cached = getattr(self, "_row_doc_arr", None)
        if cached is None or cached.shape[0] != len(self._row_doc):
            cached = self._row_doc_arr = np.asarray(self._row_doc)
        return cached

    def _row_rank_np(self) -> np.ndarray:
        """Row → dense rank of its doc-id in ascending string order
        (cached alongside _row_doc_np with the same length-keyed
        invalidation — rows are append-only, overwrites append a new
        row).  Doc ids are unique, so ranks are a total order and
        sorting by rank IS sorting by doc-id string — but the tie-break
        lexsort becomes all-numeric (unicode compares over a big
        boundary-tie set were ~2 ms/query at 1M docs with 41k exact
        score ties)."""
        cached = getattr(self, "_row_rank_arr", None)
        if cached is None or cached.shape[0] != len(self._row_doc):
            ids = self._row_doc_np()
            order = np.argsort(ids, kind="stable")
            rank = np.empty(len(ids), np.int64)
            rank[order] = np.arange(len(ids), dtype=np.int64)
            cached = self._row_rank_arr = rank
        return cached

    def _tie_key(self, rows: np.ndarray) -> np.ndarray:
        """Per-candidate tie-break key for the (-score, doc_id) lexsort.

        Serving a static corpus uses the cached dense-rank array (numeric
        compares).  While indexing interleaves with serving, the rank
        cache is invalidated on every append; rebuilding it per query is
        a full-corpus unicode argsort (seconds at 1M docs) to save the
        ~2 ms candidate-set string compare it replaces — so a stale cache
        falls back to the candidates' doc-id strings directly (bit-exact:
        rank order IS string order) and the full rebuild is deferred
        until the corpus length has been stable across two consecutive
        searches, i.e. indexing has gone quiescent."""
        n = len(self._row_doc)
        cached = self._row_rank_arr
        if cached is not None and cached.shape[0] == n:
            return cached[rows]
        if self._rank_len_seen == n:
            return self._row_rank_np()[rows]
        self._rank_len_seen = n
        row_doc = self._row_doc
        return np.asarray([row_doc[r] for r in rows.tolist()])

    def _hits_from_arrays(
        self, rows: np.ndarray, scores: np.ndarray, top_k: int
    ) -> List[Dict[str, Any]]:
        """Top-k hits ordered by (-score, doc_id): a numeric partition cuts
        the bulk, then a vectorized lexsort resolves the exact tie-break
        order (the per-row Python tuple heap was ~10 ms/query at 1M docs
        with heavy score ties)."""
        if top_k <= 0 or not len(rows):
            return []
        if len(rows) > 4 * top_k:
            cut = len(scores) - top_k
            kth = np.partition(scores, cut)[cut]
            sel = scores >= kth  # keeps boundary ties for exact ordering
            rows, scores = rows[sel], scores[sel]
        order = np.lexsort((self._tie_key(rows), -scores))[:top_k]
        row_doc = self._row_doc
        top_docs = [row_doc[r] for r in rows[order].tolist()]
        top_scores = scores[order].tolist()
        max_score = top_scores[0] or 1.0
        return [
            {
                "photo_path": self._docs[doc_id]["photo_path"],
                "score": (score / max_score) if score else 0.5,
            }
            for doc_id, score in zip(top_docs, top_scores)
        ]

    @_gated_reads
    def search(self, query: str, top_k: int = 50) -> List[Dict[str, Any]]:
        """BM25 search → [{photo_path, score∈(0,1]}] with raw min_score 0.12
        (reference keyword_store.py:240-284)."""
        scored = self._text_scores(query, None)
        if scored is None:
            return []
        rows, scores = scored
        keep = scores >= _MIN_SCORE
        return self._hits_from_arrays(rows[keep], scores[keep], top_k)

    @_gated_reads
    def search_with_filters(
        self,
        query: Optional[str],
        filters: Dict[str, Any],
        top_k: int = 50,
    ) -> List[Dict[str, Any]]:
        """Text + EXIF filter search (reference keyword_store.py:286-392)."""
        cand_mask = self._filter_rows(filters or {})
        scored = self._text_scores(query, cand_mask)
        if scored is not None:
            rows, scores = scored
            keep = scores >= _MIN_SCORE
            return self._hits_from_arrays(rows[keep], scores[keep], top_k)
        if cand_mask is None:
            # no text, no filters → match_all, score 1.0 each
            rows = np.fromiter(
                self._doc_row.values(), np.int64, len(self._doc_row)
            )
            return self._hits_from_arrays(rows, np.ones(len(rows)), top_k)
        # filter-only: ES gives _score 0 → normalized to the 0.5 sentinel
        cand_rows = np.nonzero(cand_mask)[0]
        return self._hits_from_arrays(
            cand_rows, np.zeros(len(cand_rows)), top_k
        )

    @_reads
    def get_filtered_paths(
        self, filters: Dict[str, Any], top_k: int = 1000
    ) -> List[str]:
        mask = self._filter_rows(filters or {})
        if mask is None:
            row_iter: Iterable[int] = self._doc_row.values()
        else:
            row_iter = np.nonzero(mask)[0].tolist()
        paths = sorted(
            self._docs[self._row_doc[row]]["photo_path"] for row in row_iter
        )
        return paths[:top_k]

    # ------------------------------------------------------------------
    def _export_postings(self, field: str, field_index: int):
        """(tids, rows, tfs, len_rows, lens) COO arrays for one field."""
        if self._native is not None:
            return self._native.export_field(field_index)
        postings = self._postings[field]
        nnz = sum(len(entry) for entry in postings.values())
        tids = np.empty(nnz, np.int64)
        rows = np.empty(nnz, np.int64)
        tfs = np.empty(nnz, np.int32)
        pos = 0
        for tid, entry in postings.items():
            for row, tf in entry.items():
                tids[pos] = tid
                rows[pos] = row
                tfs[pos] = tf
                pos += 1
        lengths = self._doc_len[field]
        len_rows = np.asarray(list(lengths.keys()), np.int64)
        lens = np.asarray(list(lengths.values()), np.int64)
        return tids, rows, tfs, len_rows, lens

    @_reads
    def save(self, path: Optional[str] = None, *, final: bool = True) -> None:
        """Persist raw documents (JSON, the source of truth) plus a binary
        postings sidecar so ``load`` skips re-tokenization.

        ``final=False`` (the indexer's per-batch durability saves) throttles
        the sidecar: exporting the whole postings structure every batch is
        O(N²/B) over a build, and a missing/stale sidecar merely costs a
        re-tokenize on load.  The documents JSON is always written."""
        target = path or self.index_path
        if not target:
            raise ValueError("no index path configured")
        directory = os.path.dirname(target)
        if directory:
            os.makedirs(directory, exist_ok=True)
        payload = json.dumps(
            {"documents": self._docs}, ensure_ascii=False
        ).encode("utf-8")
        with open(target, "wb") as f:
            f.write(payload)
        doc_digest = hashlib.sha256(payload).hexdigest()
        rows = len(self._row_doc)
        if not final and (
            rows - self._sidecar_rows_written < max(1024, rows // 10)
        ):
            # stale sidecars are rejected by the content digest on load, but
            # remove eagerly so a crash between now and the final save costs
            # only a re-tokenize, never a digest mismatch surprise
            try:
                os.remove(target + _SIDECAR_SUFFIX)
            except OSError:
                pass
            return
        try:
            self._save_sidecar(target, doc_digest)
            self._sidecar_rows_written = rows
        except Exception as exc:  # sidecar is an optimization, never fatal
            print(f"[WARN] keyword sidecar write failed ({exc}); "
                  "load will re-tokenize")
            try:
                os.remove(target + _SIDECAR_SUFFIX)
            except OSError:
                pass

    def _save_sidecar(self, target: str, doc_digest: str) -> None:
        n_rows = len(self._row_doc)
        meta = {
            "version": _SIDECAR_VERSION,
            "n_rows": n_rows,
            "doc_count": len(self._docs),
            # content digest of the documents FILE BYTES: a sidecar whose
            # ids match but whose document CONTENT is stale (crash between
            # the documents write and the sidecar replace) must not be
            # restored
            "doc_digest": doc_digest,
            "vocab": self._vocab_list,
            "row_doc": self._row_doc,
            "cats": self._cat_values,
        }
        # cats must survive a JSON round-trip with equality intact
        for values in self._cat_values.values():
            for value in values:
                if not isinstance(value, (str, int, float, bool)):
                    raise TypeError(f"non-primitive filter value {value!r}")
        arrays: Dict[str, np.ndarray] = {
            "meta": np.frombuffer(
                json.dumps(meta, ensure_ascii=False).encode("utf-8"), np.uint8
            ),
            "alive": np.asarray(self._alive, np.uint8),
            "dt": np.asarray(self._dt_col, np.int64),
        }
        for field in FILTER_EXACT_FIELDS:
            arrays[f"col_{field}"] = np.asarray(self._col_codes[field], np.int32)
        offsets = np.zeros(n_rows + 1, np.int64)
        chunks = []
        for row in range(n_rows):
            stream = self._streams[row]
            size = 0 if stream is None else len(stream)
            offsets[row + 1] = offsets[row] + size
            if size:
                chunks.append(stream)
        arrays["stream_offsets"] = offsets
        arrays["stream_data"] = (
            np.concatenate(chunks) if chunks else np.empty(0, np.int32)
        )
        for field_index, field in enumerate(TEXT_FIELD_BOOSTS):
            tids, rows, tfs, len_rows, lens = self._export_postings(
                field, field_index
            )
            arrays[f"post_{field_index}_tid"] = tids
            arrays[f"post_{field_index}_row"] = rows
            arrays[f"post_{field_index}_tf"] = tfs
            arrays[f"post_{field_index}_lrow"] = len_rows
            arrays[f"post_{field_index}_len"] = lens
        tmp = target + _SIDECAR_SUFFIX + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, target + _SIDECAR_SUFFIX)

    @_writes
    def load(self, path: Optional[str] = None) -> bool:
        target = path or self.index_path
        if not target or not os.path.exists(target):
            return False
        with open(target, "rb") as f:
            raw = f.read()
        payload = json.loads(raw)
        file_digest = hashlib.sha256(raw).hexdigest()
        del raw
        documents = payload.get("documents") or {}
        self.clear()
        sidecar_path = target + _SIDECAR_SUFFIX
        if os.path.exists(sidecar_path):
            try:
                with np.load(sidecar_path) as sidecar:
                    if self._restore_from_sidecar(
                        sidecar, documents, file_digest
                    ):
                        return True
            except Exception as exc:
                print(f"[WARN] keyword sidecar load failed ({exc}); re-tokenizing")
            self.clear()
        for doc_id, doc in documents.items():
            self.add_document(doc_id, doc)
        return True

    def _restore_from_sidecar(
        self,
        sidecar,
        documents: Dict[str, Dict[str, Any]],
        file_digest: str,
    ) -> bool:
        meta = json.loads(bytes(sidecar["meta"].tobytes()).decode("utf-8"))
        if meta.get("version") != _SIDECAR_VERSION:
            return False
        row_doc: List[str] = meta["row_doc"]
        alive = sidecar["alive"].astype(bool)
        if len(row_doc) != len(alive) or meta.get("doc_count") != len(documents):
            return False
        live_rows = np.nonzero(alive)[0]
        live_ids = {row_doc[row] for row in live_rows.tolist()}
        if live_ids != set(documents):
            return False  # stale sidecar — documents JSON wins
        if meta.get("doc_digest") != file_digest:
            return False  # same ids, stale content — documents JSON wins

        self._docs = {doc_id: dict(doc) for doc_id, doc in documents.items()}
        self._vocab_list = list(meta["vocab"])
        self._vocab = {token: tid for tid, token in enumerate(self._vocab_list)}
        self._row_doc = list(row_doc)
        self._row_doc_arr = None
        self._row_rank_arr = None
        self._rank_len_seen = -1
        self._alive = alive.tolist()
        self._doc_row = {row_doc[row]: int(row) for row in live_rows.tolist()}
        for field in FILTER_EXACT_FIELDS:
            values = list(meta["cats"][field])
            self._cat_values[field] = values
            self._cats[field] = {value: code for code, value in enumerate(values)}
            self._col_codes[field] = sidecar[f"col_{field}"].astype(np.int32).tolist()
        self._dt_col = sidecar["dt"].astype(np.int64).tolist()
        self._cols_np = None
        data = sidecar["stream_data"].astype(np.int32)
        offsets = sidecar["stream_offsets"].astype(np.int64)
        self._streams = []
        for row in range(len(row_doc)):
            lo, hi = int(offsets[row]), int(offsets[row + 1])
            if not alive[row]:
                self._streams.append(None)
            else:
                self._streams.append(data[lo:hi])
        self._stream_pack = None

        for field_index, field in enumerate(TEXT_FIELD_BOOSTS):
            tids = sidecar[f"post_{field_index}_tid"].astype(np.int64)
            rows = sidecar[f"post_{field_index}_row"].astype(np.int64)
            tfs = sidecar[f"post_{field_index}_tf"].astype(np.int32)
            len_rows = sidecar[f"post_{field_index}_lrow"].astype(np.int64)
            lens = sidecar[f"post_{field_index}_len"].astype(np.int64)
            if self._native is not None:
                self._native.load_field(field_index, tids, rows, tfs, len_rows, lens)
                continue
            postings = self._postings[field]
            if len(tids):
                order = np.lexsort((rows, tids))
                sorted_tids = tids[order]
                sorted_rows = rows[order]
                sorted_tfs = tfs[order]
                bounds = np.flatnonzero(np.diff(sorted_tids)) + 1
                starts = np.concatenate(([0], bounds))
                stops = np.concatenate((bounds, [len(sorted_tids)]))
                for lo, hi in zip(starts.tolist(), stops.tolist()):
                    postings[int(sorted_tids[lo])] = dict(
                        zip(sorted_rows[lo:hi].tolist(), sorted_tfs[lo:hi].tolist())
                    )
                # per-row unique tids (targeted removal back-pointers)
                order_r = np.lexsort((tids, rows))
                r_rows = rows[order_r]
                r_tids = tids[order_r]
                bounds_r = np.flatnonzero(np.diff(r_rows)) + 1
                starts_r = np.concatenate(([0], bounds_r))
                stops_r = np.concatenate((bounds_r, [len(r_rows)]))
                for lo, hi in zip(starts_r.tolist(), stops_r.tolist()):
                    self._row_tids[field][int(r_rows[lo])] = r_tids[lo:hi].astype(
                        np.int32
                    )
            self._doc_len[field] = dict(
                zip(len_rows.tolist(), lens.tolist())
            )
            self._total_len[field] = int(lens.sum())
        self._sidecar_rows_written = len(self._row_doc)
        return True
