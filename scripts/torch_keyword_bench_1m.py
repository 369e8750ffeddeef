"""Keyword channel at 1M docs: build, hybrid-query, persist, measure.

Round-2 verdict weak #3: "everything else in the repo is benchmarked at 1M
rows; _text_scores/_phrase_rows have no measured behavior at 1M-doc
scale."  This script builds a 1M synthetic-doc index shaped like the real
corpus (CJK retrieval_text with shared high-frequency tokens + long-tail
tokens, full EXIF filter columns) and measures:

* hybrid text+filter search latency (the searcher's per-query call,
  including the phrase pass) — target <50 ms/query;
* text-only and filter-only latencies;
* postings sidecar save/load wall time;
* resident memory (RSS) of the loaded index.

Usage: python scripts/keyword_bench_1m.py [N_DOCS] [--threads N]
       [--skip-persist]   (skip the save/load phase — it dominates wall
                           time at 1M when only query/concurrency
                           numbers are needed)
Prints one human table + one machine-readable JSON line.

--threads N adds a concurrent-throughput section: N threads issue the
hybrid text+filter query in a closed loop for a fixed window; reported
QPS measures the whole stack under concurrency (C++ scoring overlaps via
the shared-mutex scorer; Python-side fusion/top-k still serializes on
the GIL, so scaling is bounded by the GIL-held fraction × core count).
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


SEASONS = ["春天", "夏天", "秋天", "冬天"]
PERIODS = ["早晨", "中午", "下午", "晚上"]
SCENES = ["海边", "雪山", "城市", "公园", "森林", "沙滩", "湖泊", "街道"]
SUBJECTS = ["日落", "人像", "合影", "夜景", "建筑", "美食", "花朵", "宠物"]


def build(n_docs: int):
    from photo_search_engine_tpu_torch.core.keyword_index import KeywordIndex

    ki = KeywordIndex()
    t0 = time.perf_counter()
    for i in range(n_docs):
        scene = SCENES[i % len(SCENES)]
        subject = SUBJECTS[(i // 3) % len(SUBJECTS)]
        season = SEASONS[i % 4]
        ki.add_document(
            str(i),
            {
                "photo_path": f"/photos/{i}.jpg",
                "file_name": f"IMG_{i:07d}.jpg",
                "retrieval_text": f"{scene} {subject} tok{i % 5000} 照片",
                "description": f"{season}在{scene}拍摄的{subject}照片",
                "inner_content_summary": f"{subject} rare{i % 100_000}",
                "outer_scene_summary": scene,
                "ocr_text": "",
                "year": 2015 + (i % 10),
                "month": 1 + (i % 12),
                "day": 1 + (i % 28),
                "hour": i % 24,
                "season": season,
                "time_period": PERIODS[i % 4],
                "weekday": i % 7,
                "camera": f"cam{i % 5}",
                "datetime": (
                    f"{2015 + (i % 10)}-{1 + (i % 12):02d}-"
                    f"{1 + (i % 28):02d}T{i % 24:02d}:00:00"
                ),
            },
        )
    build_s = time.perf_counter() - t0
    return ki, build_s


def best_ms(fn, n=5, repeats=3):
    best = float("inf")
    for _ in range(repeats):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t) / n)
    return best * 1e3


def concurrent_qps(ki, n_threads: int, window_s: float = 5.0, repeats: int = 3):
    """Closed-loop concurrent hybrid throughput: N threads, fixed window,
    best of ``repeats`` windows.  Returns (qps, p50_ms, per-thread query
    counts of the best window, all per-window qps).

    Best-of mirrors ``best_ms`` for the serial section: this host has
    BURSTY hypervisor CPU steal (~5% average, concentrated in multi-
    second windows — /proc/stat st; measured identical runs spanning
    3.4-30 QPS), so a single window measures the neighbor, not the
    index.  The best window is the machine-capability number."""
    best = None
    all_qps = []
    for _ in range(max(1, repeats)):
        qps, p50, counts = _concurrent_window(ki, n_threads, window_s)
        all_qps.append(round(qps, 1))
        if best is None or qps > best[0]:
            best = (qps, p50, counts)
    return best[0], best[1], best[2], all_qps


def _concurrent_window(ki, n_threads: int, window_s: float):
    queries = [
        ("海边 日落", {"season": "夏天"}),
        ("雪山 人像", {"season": "冬天"}),
        ("城市 夜景", {"year": 2017}),
        ("公园 合影", {"time_period": "下午"}),
    ]
    stop = time.perf_counter() + window_s
    counts = [0] * n_threads
    lat: list = []
    lat_lock = threading.Lock()
    errors: list = []

    def worker(tid: int):
        local_lat = []
        try:
            i = tid
            while time.perf_counter() < stop:
                q, f = queries[i % len(queries)]
                t0 = time.perf_counter()
                ki.search_with_filters(q, f, top_k=50)
                local_lat.append(time.perf_counter() - t0)
                counts[tid] += 1
                i += 1
        except Exception as exc:  # noqa: BLE001
            errors.append(repr(exc))
        with lat_lock:
            lat.extend(local_lat)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t_start
    assert not errors, errors
    total = sum(counts)
    lat.sort()
    p50 = lat[len(lat) // 2] * 1e3 if lat else float("nan")
    return total / elapsed, p50, counts


def main() -> int:
    argv = sys.argv[1:]
    n_threads = 0
    if "--threads" in argv:
        at = argv.index("--threads")
        try:
            n_threads = int(argv[at + 1])
        except (IndexError, ValueError):
            print(
                "usage: keyword_bench_1m.py [N_DOCS] [--threads N] "
                "[--skip-persist]",
                file=sys.stderr,
            )
            return 2
        del argv[at : at + 2]
    skip_persist = "--skip-persist" in argv
    if skip_persist:
        argv.remove("--skip-persist")
    n_docs = int(argv[0]) if argv else 1_000_000
    rss_before = _rss_mb()
    ki, build_s = build(n_docs)
    rss_built = _rss_mb()
    print(f"build: {n_docs} docs in {build_s:.1f}s "
          f"({1e6 * build_s / n_docs:.1f} µs/doc), RSS {rss_built:.0f} MB "
          f"(+{rss_built - rss_before:.0f})")

    # warm the columnar caches once (first call pays the column build)
    ki.search_with_filters(None, {"year": 2017})

    hybrid = lambda: ki.search_with_filters(
        "海边 日落", {"season": "夏天"}, top_k=50
    )
    hybrid_range = lambda: ki.search_with_filters(
        "雪山 人像",
        {"start_date": "2018-01-01", "end_date": "2019-12-31"},
        top_k=50,
    )
    text_phrase = lambda: ki.search("海边 日落", top_k=50)
    text_rare = lambda: ki.search("rare42 日落", top_k=50)
    filter_only = lambda: ki.search_with_filters(
        None, {"year": 2017, "season": "夏天"}, top_k=50
    )

    sanity = hybrid()
    assert sanity, "hybrid query returned no hits"
    results = {
        "hybrid_text_filter_ms": best_ms(hybrid),
        "hybrid_date_range_ms": best_ms(hybrid_range),
        "text_phrase_ms": best_ms(text_phrase),
        "text_rare_term_ms": best_ms(text_rare),
        "filter_only_ms": best_ms(filter_only),
    }
    for name, ms in results.items():
        print(f"{name:28s} {ms:8.1f} ms")

    if n_threads:
        qps, p50, counts, all_qps = concurrent_qps(ki, n_threads)
        ncores = len(os.sched_getaffinity(0))
        print(
            f"concurrent hybrid: {n_threads} threads on {ncores} core(s) → "
            f"best {qps:.1f} QPS, p50 {p50:.1f} ms (per-thread {counts}; "
            f"windows {all_qps})"
        )
        results.update(
            {
                "concurrent_threads": n_threads,
                "concurrent_qps": round(qps, 1),
                "concurrent_p50_ms": round(p50, 1),
                "concurrent_qps_windows": all_qps,
                "cores": ncores,
            }
        )

    if skip_persist:
        results["n_docs"] = n_docs
        results["build_s"] = round(build_s, 1)
        print(json.dumps({k: (round(v, 2) if isinstance(v, float) else v)
                          for k, v in results.items()}))
        return 0

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "docs.json")
        ki.documents_path = path
        t0 = time.perf_counter()
        ki.save(path)
        save_s = time.perf_counter() - t0
        sidecar_mb = os.path.getsize(path + ".postings.npz") / 1e6
        from photo_search_engine_tpu_torch.core.keyword_index import KeywordIndex

        ki2 = KeywordIndex(path)
        t0 = time.perf_counter()
        ok = ki2.load()
        load_s = time.perf_counter() - t0
        assert ok and ki2.count == n_docs
        rss_loaded = _rss_mb()
        t0 = time.perf_counter()
        check = ki2.search_with_filters("海边 日落", {"season": "夏天"}, top_k=50)
        first_query_s = time.perf_counter() - t0
        assert [h["photo_path"] for h in check] == [
            h["photo_path"] for h in sanity
        ], "reloaded index disagrees with the built one"

    results.update(
        {
            "n_docs": n_docs,
            "build_s": round(build_s, 1),
            "save_s": round(save_s, 1),
            "load_s": round(load_s, 1),
            "first_query_after_load_s": round(first_query_s, 2),
            "sidecar_mb": round(sidecar_mb, 1),
            "rss_mb": round(rss_loaded, 0),
        }
    )
    print(f"save {save_s:.1f}s  load {load_s:.1f}s  "
          f"first query after load {first_query_s:.2f}s  "
          f"sidecar {sidecar_mb:.0f} MB  RSS {rss_loaded:.0f} MB")
    print(json.dumps({k: (round(v, 2) if isinstance(v, float) else v)
                      for k, v in results.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
