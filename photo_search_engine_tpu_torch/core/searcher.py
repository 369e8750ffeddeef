"""Searcher: hybrid retrieval brain (query planning → recall → fusion →
thresholding → confidence buckets → multi-round control).

Behavior-parity target: reference core/searcher.py —
* score mapping: cosine sigmoid-ish stretch / L2 exp decay (605-625)
* dataset-size-adaptive candidate_k with relaxation inflation (771-820)
* hybrid fusion: per-hit-channel weight renormalization (vector .8 /
  keyword .2), metadata boosts (+0.18 media, +0.12 identity),
  keyword-only ×0.65 penalty and weak-keyword-only drop (855-988)
* quartile/CV dynamic threshold (627-674)
* strict/broad score floors by relaxation level (820-826)
* confidence buckets 3/2/1 with media/identity demotion + fill-to-top-k
  backfill + round-quality stats (828-853, 1460-1565)
* multi-round controller: expansion rounds then reflection rounds with
  intent-signature dedup and no-progress stop (1219-1458)
* filter-only path via the keyword index or in-memory scan (1037-1129)
* EXIF-strict time post-filter (1884-1950) and multi-format date parse
  (1963-2001)
* image-path search reusing the stored embedding and excluding self
  (1751-1814); uploaded-image search embedding the upload's
  retrieval_text (1816-1882)
* LRU query-intent + embedding caches (109-110, 182-234)
* per-stage timings + full search plan in ``search_debug`` (113-180).

TPU-first notes: the vector channel is the fused device kernel
(ops/topk.py) behind VectorIndex; candidate-set fusion stays host-side
because candidate_k is small (≤500) and the logic is branch-heavy — the
device's job is recall, the host's job is policy.
"""

from __future__ import annotations

import functools
import os
import time
from datetime import datetime
from math import ceil
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from photo_search_engine_tpu_torch.services.analysis import build_match_summary
from photo_search_engine_tpu_torch.utils.path_utils import (
    normalize_local_path,
    path_normalization_is_state_free,
    same_file_path,
)

MIN_RESULT_SCORE = 0.4
_SEARCH_MODES = {"fast", "balanced", "high_recall"}
_STRICT_FILTER_FIELDS = (
    "year", "month", "day", "season", "time_period", "start_date", "end_date",
)

_DATE_ONLY_FORMATS = ("%Y-%m-%d", "%Y/%m/%d", "%Y%m%d")
_DATE_FORMATS = (
    "%Y-%m-%d",
    "%Y-%m-%dT%H:%M:%S",
    "%Y-%m-%d %H:%M:%S",
    "%Y:%m:%d %H:%M:%S",
    "%Y/%m/%d %H:%M:%S",
    "%Y/%m/%d",
    "%Y%m%d",
)


def parse_flexible_date(value: Any, is_end_date: bool = False) -> Optional[datetime]:
    """Multi-format date parse incl. EXIF colon format; date-only end
    bounds extend to 23:59:59 (reference searcher.py:1963-2001)."""
    if not value or not isinstance(value, str):
        return None
    cleaned = value.strip().rstrip("\x00")
    for fmt in _DATE_FORMATS:
        try:
            parsed = datetime.strptime(cleaned, fmt)
        except ValueError:
            continue
        if is_end_date and fmt in _DATE_ONLY_FORMATS:
            return parsed.replace(hour=23, minute=59, second=59)
        return parsed
    try:
        return datetime.fromisoformat(cleaned)
    except Exception:
        return None


def check_time_match(metadata: Dict[str, Any], constraints: Dict[str, Any]) -> bool:
    """EXIF-strict time matcher: photos without EXIF datetime never match
    a time-filtered query (reference searcher.py:1884-1950)."""
    time_info = metadata.get("time_info") or {}
    exif_datetime = (metadata.get("exif_data") or {}).get("datetime")

    for field in ("season", "time_period", "year", "month"):
        wanted = constraints.get(field)
        if wanted:
            if not exif_datetime:
                return False
            if time_info.get(field) != wanted:
                return False

    start_date = constraints.get("start_date")
    end_date = constraints.get("end_date")
    if start_date or end_date:
        stamp = time_info.get("datetime_str") or exif_datetime
        if not stamp:
            return False
        photo_date = parse_flexible_date(stamp)
        if photo_date is None:
            return False
        if start_date:
            start = parse_flexible_date(start_date)
            if start and photo_date < start:
                return False
        if end_date:
            end = parse_flexible_date(end_date, is_end_date=True)
            if end and photo_date > end:
                return False
    return True


class Searcher:
    """Hybrid photo retrieval with multi-round query planning."""

    def __init__(
        self,
        embedding: Any,
        time_parser: Any,
        vector_index: Any,
        keyword_index: Optional[Any] = None,
        query_formatter: Optional[Any] = None,
        data_dir: str = "./data",
        top_k: int = 10,
        vector_weight: float = 0.8,
        keyword_weight: float = 0.2,
        query_expansion_enabled: bool = True,
        query_expansion_max_alternatives: int = 2,
        query_multi_round_enabled: bool = False,
        query_reflection_enabled: bool = False,
        query_max_reflection_rounds: int = 2,
        query_dynamic_threshold_floor: float = 0.05,
        query_strict_floor_min: float = 0.22,
        query_broad_floor_min: float = 0.12,
        time_parse_strategy: str = "local_first",
        validate_file_exists: bool = False,
        query_cache_enabled: bool = True,
        query_cache_size: int = 2000,
        embedding_cache_enabled: bool = True,
        embedding_cache_size: int = 5000,
        default_search_mode: str = "balanced",
    ) -> None:
        if abs(vector_weight + keyword_weight - 1.0) > 0.001:
            raise ValueError("vector_weight + keyword_weight must equal 1.0")
        self.embedding_service = embedding
        self.time_parser = time_parser
        self.vector_index = vector_index
        self.keyword_index = keyword_index
        self.query_formatter = query_formatter
        self.data_dir = data_dir
        self.top_k = max(1, top_k)
        self.vector_weight = vector_weight
        self.keyword_weight = keyword_weight
        self.query_expansion_enabled = bool(query_expansion_enabled)
        self.query_expansion_max_alternatives = max(0, int(query_expansion_max_alternatives))
        self.query_multi_round_enabled = bool(query_multi_round_enabled)
        self.query_reflection_enabled = bool(query_reflection_enabled)
        self.query_max_reflection_rounds = max(0, int(query_max_reflection_rounds))
        self.query_dynamic_threshold_floor = min(1.0, max(0.0, float(query_dynamic_threshold_floor)))
        self.query_strict_floor_min = min(1.0, max(0.0, float(query_strict_floor_min)))
        self.query_broad_floor_min = min(1.0, max(0.0, float(query_broad_floor_min)))
        if self.query_broad_floor_min > self.query_strict_floor_min:
            self.query_broad_floor_min = self.query_strict_floor_min
        self.time_parse_strategy = str(time_parse_strategy or "local_first").strip().lower()
        self.validate_file_exists = bool(validate_file_exists)
        self.query_cache_enabled = bool(query_cache_enabled)
        self.query_cache_size = max(1, int(query_cache_size))
        self.embedding_cache_enabled = bool(embedding_cache_enabled)
        self.embedding_cache_size = max(1, int(embedding_cache_size))
        self.default_search_mode = self._normalize_search_mode(default_search_mode)
        self.index_loaded = False
        self.index_path = vector_index.index_path
        self.metadata_path = vector_index.metadata_path
        self.metric = getattr(vector_index, "metric", "cosine")
        self._metadata_by_path: Dict[str, Dict[str, Any]] = {}
        self._last_search_debug = self._empty_debug()
        self._last_round_quality: Dict[str, Any] = {}
        self._query_cache: Dict[Any, Any] = {}
        self._embedding_cache: Dict[str, List[float]] = {}
        self._refresh_metadata_cache()

    # ------------------------------------------------------------------
    # Small utilities
    # ------------------------------------------------------------------
    @staticmethod
    def _empty_debug() -> Dict[str, Any]:
        return {
            "mode": "text",
            "search_mode": "balanced",
            "base_intent": {},
            "expansion_triggered": False,
            "expansion_reason": "",
            "alternatives": [],
            "reflection_triggered": False,
            "reflection_reason": "",
            "reflection": {},
            "rounds": [],
            "timing": {},
        }

    @staticmethod
    def _normalize_search_mode(mode: Any) -> str:
        normalized = str(mode or "balanced").strip().lower()
        return normalized if normalized in _SEARCH_MODES else "balanced"

    @staticmethod
    def _path_key(photo_path: str) -> str:
        # cached: dedup/fusion/finalize normalize the same candidate paths
        # several times per request (~2k calls/request at candidate_k=500,
        # the hottest stack-profile entry at 1M rows).  Relative/~ paths
        # absolutize against the live CWD/HOME inside normalize_local_path,
        # so the process-global cache would pin the first call's CWD for
        # the process lifetime (review round 4) — they bypass the cache
        # (index metadata stores absolute paths, so the hot case caches)
        if path_normalization_is_state_free(photo_path or ""):
            return Searcher._path_key_cached(photo_path)
        return Searcher._path_key_impl(photo_path)

    @staticmethod
    @functools.lru_cache(maxsize=65536)
    def _path_key_cached(photo_path: str) -> str:
        return Searcher._path_key_impl(photo_path)

    @staticmethod
    def _path_key_impl(photo_path: str) -> str:
        normalized = normalize_local_path(photo_path) if photo_path else ""
        if not normalized and photo_path:
            normalized = str(photo_path).strip()
        return os.path.normcase(normalized)

    @staticmethod
    def _record_timing(debug: Dict[str, Any], key: str, started_at: float) -> None:
        debug.setdefault("timing", {})[key] = round(
            (time.perf_counter() - started_at) * 1000, 3
        )

    def get_last_search_debug(self) -> Dict[str, Any]:
        return dict(self._last_search_debug)

    # LRU caches -------------------------------------------------------
    @staticmethod
    def _cache_get(cache: Dict[Any, Any], key: Any) -> Any:
        value = cache.get(key)
        if value is None:
            return None
        cache.pop(key, None)
        cache[key] = value  # refresh recency
        return value

    @staticmethod
    def _cache_put(cache: Dict[Any, Any], key: Any, value: Any, capacity: int) -> None:
        cache.pop(key, None)
        cache[key] = value
        while len(cache) > capacity:
            cache.pop(next(iter(cache)))

    def _format_query(self, query: str) -> Dict[str, Any]:
        default = {
            "search_text": query,
            "retrieval_mode": "hybrid",
            "media_terms": [],
            "identity_terms": [],
            "strict_identity_filter": False,
            "intent_mode": "open",
            "intent_contract": {},
            "time_hint": None,
            "season": None,
            "time_period": None,
            "original_query": query,
        }
        if not self.query_formatter or not self.query_formatter.is_enabled():
            return default
        key = ("format_query", query)
        if self.query_cache_enabled:
            cached = self._cache_get(self._query_cache, key)
            if cached is not None:
                return dict(cached)
        result = self.query_formatter.format_query(query)
        if self.query_cache_enabled:
            self._cache_put(self._query_cache, key, dict(result), self.query_cache_size)
        return result

    def _generate_embedding(self, text: str) -> List[float]:
        normalized = str(text or "").strip()
        if not normalized:
            return self.embedding_service.generate_embedding(text)
        if self.embedding_cache_enabled:
            cached = self._cache_get(self._embedding_cache, normalized)
            if cached is not None:
                return list(cached)
        embedding = self.embedding_service.generate_embedding(text)
        if self.embedding_cache_enabled:
            self._cache_put(
                self._embedding_cache, normalized, list(embedding), self.embedding_cache_size
            )
        return embedding

    # ------------------------------------------------------------------
    # Index loading / metadata
    # ------------------------------------------------------------------
    def _refresh_metadata_cache(self) -> None:
        cache: Dict[str, Dict[str, Any]] = {}
        for item in self.vector_index.metadata or []:
            path = item.get("photo_path")
            if path:
                cache[path] = item
        self._metadata_by_path = cache
        # predicate-mask state is derived from metadata: rebuild lazily
        self._mask_cache: Dict[Any, Any] = {}
        self._time_columns = None

    def _refresh_time_columns(self) -> None:
        """Columnar time fields for vectorized predicate masks (one Python
        pass per index (re)load; predicates then evaluate in NumPy)."""
        metadata = self.vector_index.metadata or []
        n = len(metadata)
        season = np.empty(n, object)
        period = np.empty(n, object)
        year = np.full(n, -1, np.int32)
        month = np.full(n, -1, np.int32)
        epoch = np.full(n, np.nan, np.float64)
        has_exif = np.zeros(n, bool)
        for i, item in enumerate(metadata):
            time_info = item.get("time_info") or {}
            exif_dt = (item.get("exif_data") or {}).get("datetime")
            has_exif[i] = bool(exif_dt)
            season[i] = time_info.get("season")
            period[i] = time_info.get("time_period")
            if time_info.get("year") is not None:
                year[i] = int(time_info["year"])
            if time_info.get("month") is not None:
                month[i] = int(time_info["month"])
            stamp = time_info.get("datetime_str") or exif_dt
            if stamp:
                parsed = parse_flexible_date(stamp)
                if parsed is not None:
                    epoch[i] = parsed.timestamp()
        self._time_columns = {
            "season": season, "time_period": period, "year": year,
            "month": month, "epoch": epoch, "has_exif": has_exif,
        }

    def load_index(self) -> bool:
        if not self.vector_index.load():
            self.index_loaded = False
            return False
        expected = getattr(self.embedding_service, "dimension", None)
        if expected is not None and self.vector_index.dimension != expected:
            raise ValueError("向量维度不一致")
        if self.keyword_index is not None:
            try:
                if not self.keyword_index.load():
                    print("[WARN] keyword index not found; strict-filtered "
                          "hybrid searches depend on the keyword channel "
                          "(reference ES-filter semantics)")
            except Exception as exc:
                # fail-soft like the reference composition root, but LOUDLY:
                # an empty keyword channel silently zeroes every
                # strict-time-filtered hybrid query, which is miserable to
                # diagnose without this line
                print(f"[WARN] keyword index load failed: {exc}")
        self.index_loaded = True
        self._refresh_metadata_cache()
        return True

    def _metadata_for(self, photo_path: str) -> Optional[Dict[str, Any]]:
        if not self._metadata_by_path:
            self._refresh_metadata_cache()
        return self._metadata_by_path.get(photo_path)

    def get_index_stats(self) -> Dict[str, Any]:
        return {
            "total_items": self.vector_index.get_total_items() if self.index_loaded else 0,
            "vector_dimension": self.vector_index.dimension if self.index_loaded else None,
            "index_loaded": self.index_loaded,
            "index_path": self.index_path,
        }

    def validate_query(self, query: str) -> bool:
        """1-500 chars with at least one alnum/CJK char
        (reference searcher.py:381-394)."""
        if not isinstance(query, str):
            return False
        text = query.strip()
        if not 1 <= len(text) <= 500:
            return False
        if all(
            not ch.isalnum() and not ("一" <= ch <= "鿿") for ch in text
        ):
            return False
        if len(text) == 1 and text.isascii() and text.isalpha():
            return False
        return True

    # ------------------------------------------------------------------
    # Scores, thresholds, candidate_k
    # ------------------------------------------------------------------
    def _distance_to_score(self, distance: float) -> float:
        """cosine: [-1,1]→[0,1] with high-band stretch / low-band squeeze;
        l2: exp(-0.5 d) (reference searcher.py:605-625)."""
        if self.metric == "cosine":
            similarity = max(-1.0, min(1.0, distance))
            score = (similarity + 1.0) / 2.0
            if score > 0.7:
                score = 0.7 + (score - 0.7) * 1.3
            elif score < 0.3:
                score = score * 0.8
            return round(max(0.0, min(1.0, score)), 6)
        return round(float(np.exp(-0.5 * max(0.0, distance))), 6)

    def _calculate_dynamic_threshold(self, scores: List[float], top_k: int) -> float:
        """Quartile/CV adaptive threshold (reference searcher.py:627-674)."""
        if not scores:
            return 0.1
        n = len(scores)
        if n <= top_k * 2:
            return max(scores[-1] * 0.9, self.query_dynamic_threshold_floor)
        q25 = float(np.percentile(scores, 25))
        q75 = float(np.percentile(scores, 75))
        median = float(np.median(scores))
        cv = (q75 - q25) / median if median > 0 else 1.0
        if cv < 0.2:
            threshold = max(median * 0.85, q25 * 0.9)
        elif cv < 0.5:
            threshold = q25
        else:
            threshold = max(q25 * 0.7, median * 0.7)
        if n >= top_k:
            threshold = max(threshold, scores[top_k - 1] * 0.8)
        return round(max(threshold, self.query_dynamic_threshold_floor), 6)

    def _calculate_candidate_k(
        self, normalized_top_k: int, has_time_filter: bool, relaxation_level: int = 0
    ) -> int:
        """Dataset-size-adaptive candidate count (reference searcher.py:771-820)."""
        total = self.vector_index.get_total_items()
        base_multiplier = 10 if has_time_filter else 5
        if total <= 50:
            candidate_k = total
        elif total <= 500:
            candidate_k = normalized_top_k * base_multiplier
        elif total <= 5000:
            candidate_k = max(normalized_top_k * (base_multiplier - 2), 100)
        else:
            candidate_k = max(normalized_top_k * 3, min(int(total * 0.01), 500))
        if relaxation_level > 0:
            candidate_k = max(
                candidate_k, normalized_top_k * (base_multiplier + relaxation_level)
            )
            candidate_k = ceil(candidate_k * (1 + min(relaxation_level, 3) * 0.35))
        return min(candidate_k, total)

    def _round_score_floors(self, relaxation_level: int) -> Tuple[float, float]:
        """Floors relax 0.08/round until configured minimums
        (reference searcher.py:820-826)."""
        level = max(0, int(relaxation_level))
        strict = max(self.query_strict_floor_min, MIN_RESULT_SCORE - 0.08 * level)
        broad = max(self.query_broad_floor_min, strict - 0.12)
        return round(strict, 6), round(broad, 6)

    def _max_relaxation_rounds_until_floor(self, start_level: int = 1) -> int:
        level = max(0, int(start_level))
        rounds = 1
        while self._round_score_floors(level + 1) != self._round_score_floors(level):
            rounds += 1
            level += 1
        return rounds

    # ------------------------------------------------------------------
    # Metadata matchers / boosts
    # ------------------------------------------------------------------
    @staticmethod
    def _metadata_boost(
        metadata: Dict[str, Any], media_terms: List[str], identity_terms: List[str]
    ) -> float:
        """+0.18 media match, +0.12 identity match (reference 434-449)."""
        boost = 1.0
        meta_media = {
            str(v).strip().lower() for v in (metadata.get("media_types") or []) if str(v).strip()
        }
        meta_ids = {
            str(v).strip().lower() for v in (metadata.get("identity_names") or []) if str(v).strip()
        }
        want_media = {str(v).strip().lower() for v in media_terms if str(v).strip()}
        want_ids = {str(v).strip().lower() for v in identity_terms if str(v).strip()}
        if want_media and meta_media & want_media:
            boost += 0.18
        if want_ids and meta_ids & want_ids:
            boost += 0.12
        return boost

    @staticmethod
    def _matches_identity_terms(metadata: Dict[str, Any], identity_terms: List[str]) -> bool:
        if not identity_terms:
            return True
        wanted = {t.strip().lower() for t in identity_terms if t and t.strip()}
        if not wanted:
            return True
        names = {
            str(n).strip().lower() for n in (metadata.get("identity_names") or []) if str(n).strip()
        }
        if names & wanted:
            return True
        for candidate in metadata.get("identity_candidates") or []:
            if not isinstance(candidate, dict):
                continue
            aliases = [candidate.get("name")] + list(candidate.get("aliases") or [])
            if {str(a).strip().lower() for a in aliases if str(a).strip()} & wanted:
                return True
        return False

    @staticmethod
    def _matches_media_terms(metadata: Dict[str, Any], media_terms: List[str]) -> bool:
        if not media_terms:
            return True
        wanted = [t.strip().lower() for t in media_terms if t and t.strip()]
        if not wanted:
            return True
        have = [
            str(v).strip().lower() for v in (metadata.get("media_types") or []) if str(v).strip()
        ]
        if not have:
            return False
        for term in wanted:
            for value in have:
                if term == value or term in value or value in term:
                    return True
        return False

    # ------------------------------------------------------------------
    # Result shaping
    # ------------------------------------------------------------------
    def _should_validate_path(self, normalized_path: str) -> bool:
        return bool(self.validate_file_exists and normalized_path)

    def _deduplicate(self, results: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        best: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        for item in results:
            key = self._path_key(item.get("photo_path"))
            if not key:
                continue
            existing = best.get(key)
            if existing is None:
                best[key] = item
                order.append(key)
            elif float(item.get("score", 0.0)) > float(existing.get("score", 0.0)):
                best[key] = item
        return [best[key] for key in order]

    def _fill_to_top_k(
        self,
        primary: List[Dict[str, Any]],
        fallback: List[Dict[str, Any]],
        top_k: int,
    ) -> List[Dict[str, Any]]:
        filled: List[Dict[str, Any]] = []
        seen: Set[str] = set()
        for source in (primary, fallback):
            for item in source:
                key = self._path_key(item.get("photo_path"))
                if not key or key in seen:
                    continue
                filled.append(item)
                seen.add(key)
                if len(filled) >= top_k:
                    return filled
        return filled

    @staticmethod
    def _sort_for_merge(results: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return sorted(
            results,
            key=lambda item: (
                int(item.get("_confidence_bucket", 1)),
                float(item.get("score", 0.0)),
                -int(item.get("_relaxation_level", 0)),
            ),
            reverse=True,
        )

    @staticmethod
    def _sanitize(results: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        out = []
        for item in results:
            clean = {k: v for k, v in item.items() if not str(k).startswith("_")}
            clean.pop("metadata", None)
            out.append(clean)
        return out

    @staticmethod
    def _intent_signature(intent: Dict[str, Any]) -> Tuple[Any, ...]:
        def bag(values: Any) -> Tuple[str, ...]:
            return tuple(
                sorted(str(v).strip().lower() for v in (values or []) if str(v).strip())
            )

        return (
            str(intent.get("retrieval_mode") or "hybrid").strip().lower(),
            str(intent.get("search_text") or "").strip().lower(),
            bag(intent.get("media_terms")),
            bag(intent.get("identity_terms")),
            bool(intent.get("strict_identity_filter", False)),
        )

    def _results_signature(self, results: List[Dict[str, Any]]) -> Tuple[Any, ...]:
        return tuple(
            (self._path_key(item.get("photo_path", "")), round(float(item.get("score", 0.0)), 6))
            for item in results
        )

    @staticmethod
    def _intent_contract_is_satisfied(
        base_intent: Dict[str, Any], candidate_intent: Dict[str, Any]
    ) -> bool:
        base_mode = str(base_intent.get("intent_mode") or "open").strip().lower()
        if base_mode != "strict":
            return bool(candidate_intent.get("contract_satisfied", True))
        return candidate_intent.get("contract_satisfied") is not False

    @staticmethod
    def _build_query_text(
        search_text: str,
        media_terms: List[str],
        identity_terms: List[str],
        original_query: str,
    ) -> str:
        """Embedding query = visual text + media terms; identity names only
        when nothing else remains (reference searcher.py:396-419)."""
        parts: List[str] = []
        text = (search_text or "").strip()
        media = [t.strip() for t in media_terms if t and t.strip()]
        identities = [t.strip() for t in identity_terms if t and t.strip()]
        if text:
            parts.append(text)
        if media:
            parts.append(" ".join(media))
        if identities and not parts:
            parts.append(" ".join(identities))
        return " ".join(parts).strip() or original_query.strip()

    def _round_summary(
        self,
        *,
        round_name: str,
        intent: Dict[str, Any],
        results: List[Dict[str, Any]],
        reason: str = "",
    ) -> Dict[str, Any]:
        return {
            "round": round_name,
            "reason": reason,
            "intent": {
                "search_text": str(intent.get("search_text") or "").strip(),
                "retrieval_mode": str(intent.get("retrieval_mode") or "hybrid"),
                "media_terms": list(intent.get("media_terms") or []),
                "identity_terms": list(intent.get("identity_terms") or []),
                "strict_identity_filter": bool(intent.get("strict_identity_filter", False)),
                "intent_mode": str(intent.get("intent_mode") or "open"),
                "intent_contract": dict(intent.get("intent_contract") or {}),
                "time_hint": intent.get("time_hint"),
                "season": intent.get("season"),
                "time_period": intent.get("time_period"),
            },
            "result_count": len(results),
            "top_score": round(float(results[0].get("score", 0.0)), 6) if results else 0.0,
        }

    # ------------------------------------------------------------------
    # Recall channels
    # ------------------------------------------------------------------
    def _vector_results_to_combined(
        self, raw_results: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        combined = []
        for item in raw_results:
            metadata = item.get("metadata") or {}
            photo_path = metadata.get("photo_path")
            normalized = normalize_local_path(photo_path) if photo_path else ""
            if not photo_path or not normalized:
                continue
            if self._should_validate_path(normalized) and not os.path.exists(normalized):
                continue
            combined.append(
                {
                    "photo_path": photo_path,
                    "description": metadata.get("description"),
                    "retrieval_text": metadata.get("retrieval_text"),
                    "score": self._distance_to_score(float(item.get("distance", 0.0))),
                    "metadata": metadata,
                    # match_summary is attached at finalize time to the
                    # surviving top-k only — building it for all ~500
                    # candidates was a top stack-profile entry
                }
            )
        return self._deduplicate(combined)

    @staticmethod
    def _keyword_filters_from_constraints(constraints: Dict[str, Any]) -> Dict[str, Any]:
        filters: Dict[str, Any] = {}
        for field in ("year", "month", "day", "season", "time_period"):
            if constraints.get(field) is not None:
                filters[field] = constraints[field]
        for field in ("start_date", "end_date"):
            if constraints.get(field):
                filters[field] = constraints[field]
        return filters

    @staticmethod
    def _has_strict_filters(filters: Dict[str, Any]) -> bool:
        return any(filters.get(f) is not None for f in _STRICT_FILTER_FIELDS)

    def _hybrid_search(
        self,
        query: str,
        query_embedding: List[float],
        candidate_k: int,
        filters: Optional[Dict[str, Any]] = None,
        allow_keyword_only_results: bool = False,
        media_terms: Optional[List[str]] = None,
        identity_terms: Optional[List[str]] = None,
        strict_identity_filter: bool = False,
    ) -> List[Dict[str, Any]]:
        """Vector + keyword recall with channel-renormalized fusion
        (reference searcher.py:855-988)."""
        del strict_identity_filter  # bucket stage handles it
        media_terms = media_terms or []
        identity_terms = identity_terms or []

        vector_scores: Dict[str, float] = {}
        for item in self.vector_index.search(query_embedding, candidate_k):
            metadata = item.get("metadata") or {}
            path = metadata.get("photo_path", "")
            vector_scores[path] = self._distance_to_score(float(item.get("distance", 0.0)))

        keyword_scores: Dict[str, float] = {}
        filtered_paths: Optional[Set[str]] = None
        if self.keyword_index is not None:
            # constructor top_k (not the per-call one) sizes the keyword
            # channel — reference-faithful (searcher.py:904), including the
            # consequence that strict-filtered recall is capped by this set
            keyword_k = max(1, min(candidate_k, max(self.top_k * 3, 15)))
            keyword_filters = self._keyword_filters_from_constraints(filters) if filters else {}
            if keyword_filters:
                hits = self.keyword_index.search_with_filters(query, keyword_filters, keyword_k)
                filtered_paths = set()
                for hit in hits:
                    keyword_scores[hit["photo_path"]] = hit["score"]
                    filtered_paths.add(hit["photo_path"])
            else:
                for hit in self.keyword_index.search(query, keyword_k):
                    keyword_scores[hit["photo_path"]] = hit["score"]

        paths = set(vector_scores)
        if allow_keyword_only_results:
            paths |= set(keyword_scores)

        combined: List[Dict[str, Any]] = []
        for path in paths:
            if filtered_paths is not None and path not in filtered_paths:
                # keyword channel enforced a strict filter the vector hit fails
                if filters and self._has_strict_filters(filters):
                    continue
            metadata = self._metadata_for(path)
            if metadata is None:
                continue  # stale keyword docs must never surface (ES-ghost rule)
            normalized = normalize_local_path(path)
            if self._should_validate_path(normalized) and not os.path.exists(normalized):
                continue
            has_vector = path in vector_scores
            has_keyword = path in keyword_scores
            v_score = vector_scores.get(path, 0.0)
            k_score = keyword_scores.get(path, 0.0)
            # renormalize over the channels that actually fired
            weight = 0.0
            weighted = 0.0
            if has_vector:
                weight += self.vector_weight
                weighted += self.vector_weight * v_score
            if has_keyword:
                weight += self.keyword_weight
                weighted += self.keyword_weight * k_score
            if weight <= 0:
                continue
            score = (weighted / weight) * self._metadata_boost(
                metadata, media_terms, identity_terms
            )
            if has_keyword and not has_vector:
                score *= 0.65  # keyword-only candidates are weak evidence
                if filtered_paths is None and k_score < 0.45:
                    continue  # weak keyword-only noise drop
            combined.append(
                {
                    "photo_path": path,
                    "description": metadata.get("description", ""),
                    "score": round(score, 6),
                    "vector_score": round(v_score, 6),
                    "keyword_score": round(k_score, 6),
                    "rank": 0,
                    "metadata": metadata,
                    # match_summary deferred to finalize (top-k only)
                }
            )
        combined.sort(key=lambda item: item["score"], reverse=True)
        return combined

    # ------------------------------------------------------------------
    # Filter-only path
    # ------------------------------------------------------------------
    def _memory_filter_search(
        self, constraints: Dict[str, Any], top_k: int
    ) -> List[Dict[str, Any]]:
        """In-memory EXIF filtering when no keyword index exists
        (reference searcher.py:1093-1129)."""
        if not self.vector_index.metadata:
            return []
        matched = [
            {
                "photo_path": item.get("photo_path", ""),
                "description": item.get("description", ""),
                "score": 1.0,
                "rank": 0,
                "match_summary": build_match_summary(item),
            }
            for item in self.vector_index.metadata
            if check_time_match(item, constraints)
        ]
        matched.sort(key=lambda x: x["photo_path"], reverse=True)
        for rank, item in enumerate(matched[:top_k], start=1):
            item["rank"] = rank
        return matched[:top_k]

    def _filter_only_search(
        self, query: Optional[str], constraints: Dict[str, Any], top_k: int
    ) -> List[Dict[str, Any]]:
        """Pure filter query — no vector recall (reference 1037-1091)."""
        if self.keyword_index is None:
            return self._memory_filter_search(constraints, top_k)
        filters = self._keyword_filters_from_constraints(constraints)
        hits = self.keyword_index.search_with_filters(query, filters, top_k * 2)
        if not hits and self.vector_index.metadata:
            return self._memory_filter_search(constraints, top_k)
        results = []
        for rank, hit in enumerate(hits[:top_k], start=1):
            # ghosts (paths without vector metadata) pass through with an
            # empty description — reference-faithful for the filter-only
            # path (searcher.py:1080-1090), unlike the hybrid path's
            # ES-ghost drop
            metadata = self._metadata_for(hit["photo_path"]) or {}
            results.append(
                {
                    "photo_path": hit["photo_path"],
                    "description": metadata.get("description", ""),
                    "score": 1.0,
                    "rank": rank,
                    "match_summary": build_match_summary(metadata),
                }
            )
        return results

    # ------------------------------------------------------------------
    # Finalization (threshold → buckets → backfill)
    # ------------------------------------------------------------------
    def _assign_bucket(
        self,
        *,
        item: Dict[str, Any],
        strict_threshold: float,
        broad_threshold: float,
        media_terms: List[str],
        identity_terms: List[str],
        strict_identity_filter: bool,
    ) -> int:
        score = float(item.get("score", 0.0))
        if score >= strict_threshold:
            bucket = 3
        elif score >= broad_threshold:
            bucket = 2
        else:
            bucket = 1
        metadata = item.get("metadata") or {}
        if media_terms and not self._matches_media_terms(metadata, media_terms):
            bucket = max(1, bucket - 1)
        if identity_terms and not self._matches_identity_terms(metadata, identity_terms):
            bucket = max(1, bucket - (1 if strict_identity_filter else 0))
        return bucket

    def _split_identity_matches(
        self, results: List[Dict[str, Any]], identity_terms: List[str]
    ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
        matched, unmatched = [], []
        for item in results:
            if self._matches_identity_terms(item.get("metadata", {}), identity_terms):
                matched.append(item)
            else:
                unmatched.append(item)
        return matched, unmatched

    def _finalize_results(
        self,
        combined_results: List[Dict[str, Any]],
        normalized_top_k: int,
        has_filter: bool,
        constraints: Dict[str, Any],
        search_text: str = "",
        media_terms: Optional[List[str]] = None,
        identity_terms: Optional[List[str]] = None,
        strict_identity_filter: bool = False,
        relaxation_level: int = 0,
        strip_internal: bool = True,
    ) -> List[Dict[str, Any]]:
        """(reference searcher.py:1460-1565)"""
        media_terms = media_terms or []
        identity_terms = identity_terms or []
        filtered: List[Dict[str, Any]] = []
        for item in combined_results:
            if self.keyword_index is None and has_filter:
                if not check_time_match(item.get("metadata", {}), constraints):
                    continue
            filtered.append(dict(item))
        filtered = self._deduplicate(filtered)
        fallback_pool = filtered

        has_visual_grounding = bool(str(search_text or "").strip()) or bool(media_terms)
        if strict_identity_filter and identity_terms and not has_visual_grounding:
            matched, unmatched = self._split_identity_matches(filtered, identity_terms)
            if matched:
                filtered = matched + unmatched
                fallback_pool = filtered

        strict_floor, broad_floor = self._round_score_floors(relaxation_level)
        # NOTE: after the identity reorder above, `filtered` is no longer
        # sorted by score; the threshold math inherits that quirk from the
        # reference verbatim (searcher.py:1488-1500) — behavior-parity over
        # statistical neatness
        scores = [item["score"] for item in filtered]
        if scores:
            dynamic = self._calculate_dynamic_threshold(scores, normalized_top_k)
            strict_threshold = max(dynamic, strict_floor)
            broad_threshold = min(
                strict_threshold - 0.05, max(broad_floor, strict_threshold * 0.84)
            )
            broad_threshold = round(max(broad_floor, broad_threshold), 6)
        else:
            strict_threshold, broad_threshold = strict_floor, broad_floor

        reliable, generalized = [], []
        for item in filtered:
            bucket = self._assign_bucket(
                item=item,
                strict_threshold=strict_threshold,
                broad_threshold=broad_threshold,
                media_terms=media_terms,
                identity_terms=identity_terms,
                strict_identity_filter=strict_identity_filter,
            )
            item["_confidence_bucket"] = bucket
            item["_relaxation_level"] = max(0, int(relaxation_level))
            if bucket >= 3:
                reliable.append(item)
            elif bucket >= 2:
                generalized.append(item)

        prioritized = reliable + generalized
        final = self._fill_to_top_k(prioritized, fallback_pool, normalized_top_k)

        prioritized_keys = {
            self._path_key(i.get("photo_path", "")) for i in prioritized if i.get("photo_path")
        }
        fallback_used = sum(
            1
            for item in final
            if self._path_key(item.get("photo_path", "")) not in prioritized_keys
        )
        self._last_round_quality = {
            "raw_count": len(filtered),
            "returned_count": len(final),
            "reliable_count": len(reliable),
            # reference names this len(prioritized) (searcher.py:1554) —
            # i.e. reliable+generalized, kept verbatim for debug parity
            "generalized_count": len(prioritized),
            "fallback_used_count": fallback_used,
            "strict_threshold": round(strict_threshold, 6),
            "broad_threshold": round(broad_threshold, 6),
            "relaxation_level": max(0, int(relaxation_level)),
            "top_score": round(float(filtered[0].get("score", 0.0)), 6) if filtered else 0.0,
        }
        for rank, item in enumerate(final, start=1):
            item["rank"] = rank
            if "match_summary" not in item:
                item["match_summary"] = build_match_summary(
                    item.get("metadata") or {}
                )
        return self._sanitize(final) if strip_internal else final

    @staticmethod
    def _constraints_key(constraints: Dict[str, Any]) -> Tuple[Any, ...]:
        return tuple(
            (field, constraints.get(field))
            for field in ("year", "month", "day", "season", "time_period",
                          "start_date", "end_date")
        )

    _MASK_CACHE_CAPACITY = 64

    def _constraints_mask(self, constraints: Dict[str, Any]) -> np.ndarray:
        """Boolean row mask for a time-constraint predicate.

        Evaluated vectorized over columnar time fields (NumPy, not a
        per-row Python loop) and cached in a dedicated dict that
        _refresh_metadata_cache clears — index rebuilds can never serve a
        stale mask, even at unchanged row counts."""
        key = self._constraints_key(constraints)
        cached = self._mask_cache.get(key)
        if cached is not None:
            return cached
        if self._time_columns is None:
            self._refresh_time_columns()
        cols = self._time_columns
        n = len(self.vector_index.metadata or [])
        mask = np.ones(n, bool)
        for field in ("season", "time_period"):
            wanted = constraints.get(field)
            if wanted:
                mask &= cols["has_exif"] & (cols[field] == wanted)
        for field in ("year", "month"):
            wanted = constraints.get(field)
            if wanted:
                mask &= cols["has_exif"] & (cols[field] == int(wanted))
        start = parse_flexible_date(constraints.get("start_date"))
        end = parse_flexible_date(constraints.get("end_date"), is_end_date=True)
        if start is not None or end is not None:
            epoch = cols["epoch"]
            mask &= ~np.isnan(epoch)
            if start is not None:
                mask &= epoch >= start.timestamp()
            if end is not None:
                mask &= epoch <= end.timestamp()
        if len(self._mask_cache) >= self._MASK_CACHE_CAPACITY:
            self._mask_cache.pop(next(iter(self._mask_cache)))
        self._mask_cache[key] = mask
        return mask

    # ------------------------------------------------------------------
    # Round controller
    # ------------------------------------------------------------------
    def _run_single_search_round(
        self,
        *,
        query: str,
        intent: Dict[str, Any],
        embedding_query: str,
        media_terms: List[str],
        identity_terms: List[str],
        strict_identity_filter: bool,
        constraints: Dict[str, Any],
        normalized_top_k: int,
        has_filter: bool,
        relaxation_level: int = 0,
        debug: Optional[Dict[str, Any]] = None,
    ) -> List[Dict[str, Any]]:
        embed_started = time.perf_counter()
        query_embedding = self._generate_embedding(embedding_query)
        if debug is not None and "embedding_ms" not in debug.get("timing", {}):
            self._record_timing(debug, "embedding_ms", embed_started)
        candidate_k = self._calculate_candidate_k(
            normalized_top_k, has_filter, relaxation_level=relaxation_level
        )

        recall_started = time.perf_counter()
        if self.keyword_index is not None:
            combined = self._hybrid_search(
                query,
                query_embedding,
                candidate_k,
                filters=constraints,
                allow_keyword_only_results=True,
                media_terms=media_terms,
                identity_terms=identity_terms,
                strict_identity_filter=strict_identity_filter,
            )
        elif has_filter and hasattr(self.vector_index, "search_masked"):
            # TPU-first improvement over the reference's over-fetch
            # heuristic (searcher.py:814-817): ride the time filter as a
            # device mask inside the top-k scan, so highly selective
            # filters cannot starve the candidate set (SURVEY.md §7 hard
            # part 2).  check_time_match in finalize stays as a no-op
            # safety net (mask ⊆ time-match).
            mask = self._constraints_mask(constraints)
            combined = self._vector_results_to_combined(
                self.vector_index.search_masked(query_embedding, candidate_k, mask)
            )
        else:
            combined = self._vector_results_to_combined(
                self.vector_index.search(query_embedding, candidate_k)
            )
        if debug is not None:
            key = "hybrid_search_ms" if self.keyword_index is not None else "vector_search_ms"
            if key not in debug.get("timing", {}):
                self._record_timing(debug, key, recall_started)
            route = getattr(self.vector_index, "last_route", None)
            if route:
                # which device path served this round: exact | int8 | ivf
                # (± _masked), with nprobe and mesh size — net-new
                # observability (the reference's debug has no equivalent)
                debug["index_route"] = dict(route)

        finalize_started = time.perf_counter()
        results = self._finalize_results(
            combined_results=combined,
            normalized_top_k=normalized_top_k,
            has_filter=has_filter,
            constraints=constraints,
            search_text=str(intent.get("search_text") or ""),
            media_terms=media_terms,
            identity_terms=identity_terms,
            strict_identity_filter=strict_identity_filter,
            relaxation_level=relaxation_level,
            strip_internal=False,
        )
        if debug is not None and "merge_ms" not in debug.get("timing", {}):
            self._record_timing(debug, "merge_ms", finalize_started)
        return results

    @staticmethod
    def _should_expand_results(
        results: List[Dict[str, Any]],
        top_k: int,
        round_quality: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Weak-round heuristic (reference searcher.py:676-699)."""
        if not results:
            return True
        top_score = float(results[0].get("score", 0.0))
        if top_score < 0.55:
            return True
        if round_quality:
            if int(round_quality.get("fallback_used_count", 0)) > 0:
                return True
            if int(round_quality.get("reliable_count", len(results))) < len(results):
                return True
        elif any(float(i.get("score", 0.0)) < MIN_RESULT_SCORE for i in results):
            return True
        if len(results) < min(top_k, 3) and top_score < 0.72:
            return True
        return False

    @staticmethod
    def _should_expand_to_fill(results: List[Dict[str, Any]], top_k: int) -> bool:
        return len(results) < max(1, int(top_k))

    def _should_continue_multi_round(
        self, results: List[Dict[str, Any]], top_k: int
    ) -> bool:
        return self._should_expand_to_fill(results, top_k) or self._should_expand_results(
            results, top_k
        )

    def _get_last_round_quality(self) -> Dict[str, Any]:
        return dict(self._last_round_quality)

    def _merge_round_results(
        self,
        new_results: List[Dict[str, Any]],
        current_results: List[Dict[str, Any]],
        normalized_top_k: int,
    ) -> List[Dict[str, Any]]:
        merged = [dict(i) for i in new_results] + [dict(i) for i in current_results]
        merged = self._deduplicate(merged)
        merged = self._sort_for_merge(merged)
        final = self._fill_to_top_k(merged, current_results, normalized_top_k)
        for rank, item in enumerate(final, start=1):
            item["rank"] = rank
        return final

    def _maybe_reflect(
        self,
        *,
        query: str,
        base_intent: Dict[str, Any],
        current_results: List[Dict[str, Any]],
        normalized_top_k: int,
        constraints: Dict[str, Any],
        has_filter: bool,
        debug: Dict[str, Any],
        relaxation_level: int,
        seen_intent_signatures: Optional[Set[Tuple[Any, ...]]] = None,
    ) -> List[Dict[str, Any]]:
        """(reference searcher.py:1219-1298)"""
        if not self.query_formatter or not self.query_formatter.is_enabled():
            return current_results
        weak_quality = self._should_expand_results(current_results, normalized_top_k)
        short_count = self._should_expand_to_fill(current_results, normalized_top_k)
        if not weak_quality and not short_count:
            return current_results
        reflection = self.query_formatter.reflect_on_weak_results(
            user_query=query, base_intent=base_intent, weak_results=current_results
        )
        if not reflection:
            return current_results
        if not self._intent_contract_is_satisfied(base_intent, reflection):
            return current_results
        signature = self._intent_signature(reflection)
        if seen_intent_signatures is not None:
            if signature in seen_intent_signatures:
                return current_results
            seen_intent_signatures.add(signature)

        embedding_query = self._build_query_text(
            search_text=str(reflection.get("search_text") or ""),
            media_terms=list(reflection.get("media_terms") or []),
            identity_terms=list(reflection.get("identity_terms") or []),
            original_query=query,
        )
        reflected = self._run_single_search_round(
            query=query,
            intent=reflection,
            embedding_query=embedding_query,
            media_terms=list(reflection.get("media_terms") or []),
            identity_terms=list(reflection.get("identity_terms") or []),
            strict_identity_filter=bool(reflection.get("strict_identity_filter", False)),
            constraints=constraints,
            normalized_top_k=normalized_top_k,
            has_filter=has_filter,
            relaxation_level=relaxation_level,
        )
        if not reflected:
            return current_results
        debug["reflection_triggered"] = True
        debug["reflection_reason"] = str(reflection.get("reason") or "").strip()
        debug["reflection"] = dict(reflection)
        debug["rounds"].append(
            self._round_summary(
                round_name="reflection",
                intent=reflection,
                results=reflected,
                reason=str(reflection.get("reason") or "").strip(),
            )
        )
        return self._merge_round_results(reflected, current_results, normalized_top_k)

    def _continue_reflection_rounds(
        self,
        *,
        query: str,
        base_intent: Dict[str, Any],
        current_results: List[Dict[str, Any]],
        normalized_top_k: int,
        constraints: Dict[str, Any],
        has_filter: bool,
        debug: Dict[str, Any],
        start_relaxation_level: int = 2,
    ) -> List[Dict[str, Any]]:
        """(reference searcher.py:1300-1350)"""
        if not self.query_formatter or not self.query_formatter.is_enabled():
            return current_results
        if not self.query_reflection_enabled:
            return current_results
        reflection_round = max(2, int(start_relaxation_level))
        results = current_results
        seen: Set[Tuple[Any, ...]] = set()
        attempts = 0
        max_rounds = self.query_max_reflection_rounds
        if max_rounds == 0:  # 0 = iterate until floors bottom out
            max_rounds = self._max_relaxation_rounds_until_floor(reflection_round)
        while attempts < max_rounds and self._should_continue_multi_round(
            results, normalized_top_k
        ):
            before = self._results_signature(results)
            updated = self._maybe_reflect(
                query=query,
                base_intent=base_intent,
                current_results=results,
                normalized_top_k=normalized_top_k,
                constraints=constraints,
                has_filter=has_filter,
                debug=debug,
                relaxation_level=reflection_round,
                seen_intent_signatures=seen,
            )
            if self._results_signature(updated) == before:
                break
            results = updated
            reflection_round += 1
            attempts += 1
        return results

    def _maybe_expand(
        self,
        *,
        query: str,
        base_intent: Dict[str, Any],
        base_results: List[Dict[str, Any]],
        base_round_quality: Optional[Dict[str, Any]],
        normalized_top_k: int,
        constraints: Dict[str, Any],
        has_filter: bool,
        debug: Dict[str, Any],
    ) -> List[Dict[str, Any]]:
        """Expansion rounds then reflection (reference searcher.py:1352-1458)."""
        if not self.query_formatter or not self.query_formatter.is_enabled():
            return base_results
        if not self.query_expansion_enabled:
            return base_results
        max_rounds = self.query_expansion_max_alternatives
        if max_rounds == 0:
            max_rounds = self._max_relaxation_rounds_until_floor(1)
        if max_rounds < 0:
            return base_results
        expand_for_quality = self._should_expand_results(
            base_results, normalized_top_k, round_quality=base_round_quality
        )
        expand_for_count = self._should_expand_to_fill(base_results, normalized_top_k)
        if not expand_for_quality and not expand_for_count:
            return base_results

        alternatives = self.query_formatter.expand_query_intents(
            user_query=query, base_intent=base_intent, max_alternatives=max_rounds
        )
        merged = [dict(i) for i in base_results]
        final_results = base_results
        if alternatives:
            debug["expansion_triggered"] = True
            for alt_index, alt in enumerate(alternatives[:max_rounds], start=1):
                if not self._intent_contract_is_satisfied(base_intent, alt):
                    continue
                embedding_query = self._build_query_text(
                    search_text=str(alt.get("search_text") or ""),
                    media_terms=list(alt.get("media_terms") or []),
                    identity_terms=list(alt.get("identity_terms") or []),
                    original_query=query,
                )
                alt_results = self._run_single_search_round(
                    query=query,
                    intent=alt,
                    embedding_query=embedding_query,
                    media_terms=list(alt.get("media_terms") or []),
                    identity_terms=list(alt.get("identity_terms") or []),
                    strict_identity_filter=bool(alt.get("strict_identity_filter", False)),
                    constraints=constraints,
                    normalized_top_k=normalized_top_k,
                    has_filter=has_filter,
                    relaxation_level=alt_index,
                )
                debug["alternatives"].append(dict(alt))
                debug["rounds"].append(
                    self._round_summary(
                        round_name="expansion",
                        intent=alt,
                        results=alt_results,
                        reason=str(alt.get("reason") or "").strip(),
                    )
                )
                merged.extend(dict(i) for i in alt_results)
            merged = self._deduplicate(merged)
            merged = self._sort_for_merge(merged)
            final_results = self._fill_to_top_k(merged, base_results, normalized_top_k)
            for rank, item in enumerate(final_results, start=1):
                item["rank"] = rank

        if debug["alternatives"]:
            if expand_for_quality and expand_for_count:
                debug["expansion_reason"] = "第一轮结果偏弱且数量不足，尝试保守扩写查询意图"
            elif expand_for_quality:
                debug["expansion_reason"] = "第一轮结果偏弱，尝试保守扩写查询意图"
            else:
                debug["expansion_reason"] = "第一轮结果数量不足，尝试保守扩写查询意图"
        else:
            debug["expansion_reason"] = ""

        return self._continue_reflection_rounds(
            query=query,
            base_intent=base_intent,
            current_results=final_results,
            normalized_top_k=normalized_top_k,
            constraints=constraints,
            has_filter=has_filter,
            debug=debug,
            start_relaxation_level=max(2, len(debug["alternatives"]) + 1),
        )

    # ------------------------------------------------------------------
    # Time constraints
    # ------------------------------------------------------------------
    def _extract_time_constraints(self, query: str) -> Dict[str, Any]:
        """(reference searcher.py:528-571)"""
        result: Dict[str, Any] = {
            "start_date": None, "end_date": None,
            "year": None, "month": None, "day": None,
            "season": None, "time_period": None,
            "precision": "none",
        }
        try:
            constraints = self.time_parser.extract_time_constraints(
                query, strategy=self.time_parse_strategy
            )
            if not isinstance(constraints, dict):
                return result
            result["start_date"] = constraints.get("start_date")
            result["end_date"] = constraints.get("end_date")
            result["precision"] = constraints.get("precision", "none")
            if result["start_date"] and result["start_date"] == result["end_date"]:
                try:
                    moment = datetime.fromisoformat(result["start_date"])
                    result["year"] = moment.year
                    result["month"] = moment.month
                    result["day"] = moment.day
                except Exception:
                    pass
            return result
        except Exception:
            return result

    # ------------------------------------------------------------------
    # Public entry points
    # ------------------------------------------------------------------
    def search(
        self, query: str, top_k: int = 10, search_mode: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        """(reference searcher.py:1567-1749)"""
        if not self.validate_query(query):
            raise ValueError("查询内容不合法，请输入1-500字符的描述")
        if not self.index_loaded and not self.load_index():
            raise ValueError("索引未加载，请先初始化索引")

        search_mode = self._normalize_search_mode(search_mode or self.default_search_mode)
        normalized_top_k = max(1, min(int(top_k), 50))
        debug = self._empty_debug()
        debug["mode"] = "text"
        debug["search_mode"] = search_mode

        formatter_on = bool(self.query_formatter and self.query_formatter.is_enabled())
        formatted_query = query.strip()
        media_terms: List[str] = []
        identity_terms: List[str] = []
        strict_identity_filter = False
        retrieval_mode = "hybrid"
        time_hints: Dict[str, Any] = {}
        format_result: Dict[str, Any] = {"intent_mode": "open", "intent_contract": {}}
        if formatter_on:
            format_started = time.perf_counter()
            format_result = self._format_query(query)
            self._record_timing(debug, "query_formatter_ms", format_started)
            formatted_query = (format_result.get("search_text") or "").strip()
            media_terms = list(format_result.get("media_terms") or [])
            identity_terms = list(format_result.get("identity_terms") or [])
            strict_identity_filter = bool(format_result.get("strict_identity_filter", False))
            time_hints = {
                "time_hint": format_result.get("time_hint"),
                "season": format_result.get("season"),
                "time_period": format_result.get("time_period"),
            }
            retrieval_mode = str(format_result.get("retrieval_mode") or "").strip().lower()
            if retrieval_mode not in {"hybrid", "filter_only"}:
                retrieval_mode = (
                    "filter_only"
                    if (not formatted_query and any(time_hints.values()))
                    else "hybrid"
                )

        constraints: Dict[str, Any] = {
            "start_date": None, "end_date": None,
            "year": None, "month": None, "day": None,
            "season": None, "time_period": None,
            "precision": "none",
        }
        time_filter_requested = self.time_parser.detect_time_terms(
            query, strategy=self.time_parse_strategy
        )
        if time_filter_requested:
            parse_started = time.perf_counter()
            constraints = self._extract_time_constraints(query)
            self._record_timing(debug, "time_parse_ms", parse_started)
            # formatter season/time_period hints become EXIF filters only when
            # the query genuinely has time semantics (reference 1643-1647)
            if time_hints.get("season") and not constraints.get("season"):
                constraints["season"] = time_hints["season"]
            if time_hints.get("time_period") and not constraints.get("time_period"):
                constraints["time_period"] = time_hints["time_period"]

        if retrieval_mode == "filter_only" and not time_filter_requested:
            retrieval_mode = "hybrid"

        has_filter = any(
            constraints.get(f)
            for f in ("start_date", "end_date", "year", "month", "day", "season", "time_period")
        )

        if formatter_on and retrieval_mode == "filter_only" and has_filter:
            filter_intent = {
                "search_text": formatted_query,
                "retrieval_mode": retrieval_mode,
                "media_terms": list(media_terms),
                "identity_terms": list(identity_terms),
                "strict_identity_filter": strict_identity_filter,
                "time_hint": time_hints.get("time_hint"),
                "season": time_hints.get("season"),
                "time_period": time_hints.get("time_period"),
            }
            results = self._filter_only_search(None, constraints, normalized_top_k)
            debug["base_intent"] = dict(filter_intent)
            debug["rounds"].append(
                self._round_summary(
                    round_name="base",
                    intent=filter_intent,
                    results=results,
                    reason="纯时间过滤查询",
                )
            )
            self._last_search_debug = debug
            return results

        embedding_query = self._build_query_text(
            search_text=formatted_query,
            media_terms=media_terms,
            identity_terms=identity_terms,
            original_query=query,
        )
        base_intent = {
            "search_text": formatted_query,
            "retrieval_mode": retrieval_mode,
            "media_terms": list(media_terms),
            "identity_terms": list(identity_terms),
            "strict_identity_filter": strict_identity_filter,
            "intent_mode": str(format_result.get("intent_mode") or "open") if formatter_on else "open",
            "intent_contract": dict(format_result.get("intent_contract") or {}) if formatter_on else {},
            "time_hint": time_hints.get("time_hint"),
            "season": time_hints.get("season"),
            "time_period": time_hints.get("time_period"),
            "original_query": query,
        }
        debug["base_intent"] = dict(base_intent)
        first_round = self._run_single_search_round(
            query=query,
            intent=base_intent,
            embedding_query=embedding_query,
            media_terms=media_terms,
            identity_terms=identity_terms,
            strict_identity_filter=strict_identity_filter,
            constraints=constraints,
            normalized_top_k=normalized_top_k,
            has_filter=has_filter,
            relaxation_level=0,
            debug=debug,
        )
        base_quality = self._get_last_round_quality()
        debug["rounds"].append(
            self._round_summary(round_name="base", intent=base_intent, results=first_round)
        )
        final = first_round
        if search_mode == "high_recall" and self.query_multi_round_enabled:
            final = self._maybe_expand(
                query=query,
                base_intent=base_intent,
                base_results=first_round,
                base_round_quality=base_quality,
                normalized_top_k=normalized_top_k,
                constraints=constraints,
                has_filter=has_filter,
                debug=debug,
            )
        final = self._sanitize(final)
        self._last_search_debug = debug
        return final

    def search_by_image_path(self, image_path: str, top_k: int = 10) -> List[Dict[str, Any]]:
        """(reference searcher.py:1751-1814)"""
        if not self.index_loaded and not self.load_index():
            raise ValueError("索引未加载，请先初始化索引")
        normalized = normalize_local_path(image_path)
        if not normalized or not os.path.isabs(normalized):
            raise ValueError("图片路径必须为绝对路径")
        embedding = self.vector_index.get_embedding_by_photo_path(normalized)
        if embedding is None:
            for metadata in self.vector_index.metadata:
                candidate = metadata.get("photo_path")
                if candidate and same_file_path(candidate, normalized):
                    embedding = self.vector_index.get_embedding_by_photo_path(candidate)
                    normalized = candidate
                    break
        if embedding is None:
            raise ValueError("图片路径未建立索引，请先重建索引或确认路径存在于数据库中")

        normalized_top_k = max(1, min(int(top_k), 50))
        candidate_k = min(
            self.vector_index.get_total_items(),
            max(normalized_top_k + 1, normalized_top_k * 5),
        )
        combined = self._vector_results_to_combined(
            self.vector_index.search(embedding, candidate_k)
        )
        filtered = [
            item
            for item in combined
            if item.get("photo_path") and not same_file_path(item["photo_path"], normalized)
        ]
        filtered = self._deduplicate(filtered)
        results = filtered[:normalized_top_k]
        for rank, item in enumerate(results, start=1):
            item["rank"] = rank
            if "match_summary" not in item:
                item["match_summary"] = build_match_summary(
                    item.get("metadata") or {}
                )
            item.pop("metadata", None)
        self._last_search_debug = {
            "mode": "image_path",
            "base_intent": {"image_path": normalized},
            "expansion_triggered": False,
            "expansion_reason": "",
            "alternatives": [],
            "reflection_triggered": False,
            "reflection_reason": "",
            "reflection": {},
            "rounds": [
                {
                    "round": "base",
                    "reason": "按参考图 embedding 检索相似图片",
                    "intent": {"image_path": normalized},
                    "result_count": len(results),
                    "top_score": round(float(results[0].get("score", 0.0)), 6) if results else 0.0,
                }
            ],
        }
        return results

    def search_by_uploaded_image(
        self, image_path: str, analysis: Dict[str, Any], top_k: int = 10
    ) -> List[Dict[str, Any]]:
        """(reference searcher.py:1816-1882)"""
        if not self.index_loaded and not self.load_index():
            raise ValueError("索引未加载，请先初始化索引")
        normalized = normalize_local_path(image_path)
        if not normalized or not os.path.isabs(normalized):
            raise ValueError("上传图片路径必须为绝对路径")
        if not os.path.exists(normalized):
            raise ValueError("上传图片不存在")
        retrieval_text = str((analysis or {}).get("retrieval_text") or "").strip()
        if not retrieval_text:
            retrieval_text = str((analysis or {}).get("description") or "").strip()
        if not retrieval_text:
            raise ValueError("上传图片分析结果为空，无法进行相似图检索")

        embedding = self.embedding_service.generate_embedding(retrieval_text)
        normalized_top_k = max(1, min(int(top_k), 50))
        candidate_k = min(
            self.vector_index.get_total_items(),
            max(normalized_top_k * 5, normalized_top_k + 5),
        )
        combined = self._vector_results_to_combined(
            self.vector_index.search(embedding, candidate_k)
        )
        filtered = [
            item
            for item in combined
            if item.get("photo_path") and not same_file_path(item["photo_path"], normalized)
        ]
        filtered = self._deduplicate(filtered)
        results = filtered[:normalized_top_k]
        for rank, item in enumerate(results, start=1):
            item["rank"] = rank
            if "match_summary" not in item:
                item["match_summary"] = build_match_summary(
                    item.get("metadata") or {}
                )
            item.pop("metadata", None)
        self._last_search_debug = {
            "mode": "uploaded_image",
            "base_intent": {"image_path": normalized, "retrieval_text": retrieval_text},
            "expansion_triggered": False,
            "expansion_reason": "",
            "alternatives": [],
            "reflection_triggered": False,
            "reflection_reason": "",
            "reflection": {},
            "rounds": [
                {
                    "round": "base",
                    "reason": "按上传图片分析结果生成 embedding 检索相似图片",
                    "intent": {"retrieval_text": retrieval_text},
                    "result_count": len(results),
                    "top_score": round(float(results[0].get("score", 0.0)), 6) if results else 0.0,
                }
            ],
        }
        return results
