"""Optional Elasticsearch adapter for the keyword channel.

Drop-in implementation of the ``KeywordIndex`` interface backed by a real
Elasticsearch cluster, with behavioral parity to the reference's
``KeywordStore`` (reference utils/keyword_store.py:19-423):

* index mapping with text fields, keyword fields, EXIF integers and a
  ``datetime`` date field (keyword_store.py:141-214);
* IK Chinese-analyzer detection and index recreation when IK is available
  but the existing mapping predates it (keyword_store.py:56-82, 162-167);
* single-node replica self-heal to 0 so the index never sits yellow
  (keyword_store.py:84-103);
* the exact text query: best-fields multi_match with boosts
  ``retrieval_text^3.0 description^2.0 inner_content_summary^1.8
  outer_scene_summary^1.2 ocr_text^1.5 file_name^0.8``,
  ``minimum_should_match 60%``, plus a ``match_phrase`` should-clause on
  ``retrieval_text`` boosted 1.4 (keyword_store.py:105-139);
* score normalization by max_score with ``min_score: 0.12`` and the 0.5
  filter-only sentinel (keyword_store.py:240-284, 367-392);
* term/range filter clauses for the EXIF fields and date range
  (keyword_store.py:286-392); ``get_filtered_paths`` (394).

Selected with ``KEYWORD_BACKEND=elasticsearch``.  The ``elasticsearch``
client package is imported lazily and only when no pre-configured client
is injected, so the default builtin backend carries no new dependency;
construction failure degrades the keyword channel to None exactly like
the reference composition root (reference main.py:114-127).

Unlike the builtin ``KeywordIndex``, persistence lives in the ES cluster:
``save``/``load`` are no-ops kept for interface compatibility.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

TEXT_QUERY_FIELDS = [
    "retrieval_text^3.0",
    "description^2.0",
    "inner_content_summary^1.8",
    "outer_scene_summary^1.2",
    "ocr_text^1.5",
    "file_name^0.8",
]

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

_MIN_SCORE = 0.12


class ESApiError(Exception):
    """Non-2xx/404 response from the cluster (the urllib client's analogue
    of elasticsearch-py's ApiError)."""

    def __init__(self, status: int, body: str) -> None:
        super().__init__(f"HTTP {status}: {body[:200]}")
        self.status = status


class _HttpESIndices:
    """``client.indices.*`` namespace of :class:`HttpESClient`."""

    def __init__(self, client: "HttpESClient") -> None:
        self._c = client

    def exists(self, *, index: str) -> bool:
        status, _ = self._c._request("HEAD", f"/{index}", ok404=True)
        return status == 200

    def create(
        self,
        *,
        index: str,
        mappings: Optional[Dict[str, Any]] = None,
        settings: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        body: Dict[str, Any] = {}
        if mappings is not None:
            body["mappings"] = mappings
        if settings is not None:
            body["settings"] = settings
        return self._c._json("PUT", f"/{index}", body or None)

    def delete(self, *, index: str) -> Dict[str, Any]:
        return self._c._json("DELETE", f"/{index}")

    def get_mapping(self, *, index: str) -> Dict[str, Any]:
        return self._c._json("GET", f"/{index}/_mapping")

    def put_settings(
        self, *, index: str, settings: Dict[str, Any]
    ) -> Dict[str, Any]:
        return self._c._json("PUT", f"/{index}/_settings", settings)

    def analyze(self, *, analyzer: str, text: str) -> Dict[str, Any]:
        return self._c._json(
            "GET", "/_analyze", {"analyzer": analyzer, "text": text}
        )

    def refresh(self, *, index: str) -> Dict[str, Any]:
        return self._c._json("POST", f"/{index}/_refresh")


class HttpESClient:
    """SDK-free Elasticsearch client over urllib, exposing exactly the
    typed-kwargs surface :class:`ElasticsearchKeywordIndex` uses from
    elasticsearch-py 8.x/9.x (indices.*, index, delete, count, search).

    Twin of ``services.llm_compat.OpenAIHttpClient``: the adapter works
    against a real cluster with zero extra dependencies, and wire-level
    tests can pin the exact request shapes the reference client emits
    (reference utils/keyword_store.py:105-392) against a stdlib fake
    HTTP server (tests/test_es_wire.py)."""

    def __init__(
        self,
        base_url: str,
        basic_auth: Optional[tuple] = None,
        timeout: float = 10.0,
    ) -> None:
        self._base = base_url.rstrip("/")
        self._timeout = timeout
        self._auth_header: Optional[str] = None
        if basic_auth:
            token = base64.b64encode(
                f"{basic_auth[0]}:{basic_auth[1]}".encode()
            ).decode()
            self._auth_header = f"Basic {token}"
        self.indices = _HttpESIndices(self)

    # -- transport -----------------------------------------------------
    def _request(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
        ok404: bool = False,
    ) -> tuple:
        data = None
        headers = {"Accept": "application/json"}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        if self._auth_header:
            headers["Authorization"] = self._auth_header
        req = urllib.request.Request(
            self._base + path, data=data, headers=headers, method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                return resp.status, resp.read().decode("utf-8", "replace")
        except urllib.error.HTTPError as exc:
            payload = exc.read().decode("utf-8", "replace")
            if ok404 and exc.code == 404:
                return exc.code, payload
            raise ESApiError(exc.code, payload) from None

    def _json(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        _, payload = self._request(method, path, body)
        return json.loads(payload) if payload else {}

    # -- document + query API ------------------------------------------
    def index(
        self, *, index: str, id: str, document: Dict[str, Any]
    ) -> Dict[str, Any]:
        return self._json(
            "PUT", f"/{index}/_doc/{urllib.parse.quote(id, safe='')}", document
        )

    def delete(self, *, index: str, id: str) -> Dict[str, Any]:
        return self._json(
            "DELETE", f"/{index}/_doc/{urllib.parse.quote(id, safe='')}"
        )

    def count(self, *, index: str) -> Dict[str, Any]:
        return self._json("POST", f"/{index}/_count")

    def search(self, *, index: str, **body: Any) -> Dict[str, Any]:
        # elasticsearch-py folds typed kwargs (query/size/min_score) into
        # the _search request body verbatim
        return self._json("POST", f"/{index}/_search", dict(body))


class ElasticsearchKeywordIndex:
    """BM25 + EXIF filters over a real Elasticsearch index."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 9200,
        index_name: str = "photo_keywords",
        username: Optional[str] = None,
        password: Optional[str] = None,
        client: Any = None,
    ) -> None:
        self.index_name = index_name
        if client is not None:
            self.es_client = client
        else:
            url = f"http://{host}:{port}"
            auth = (username, password) if username and password else None
            try:
                from elasticsearch import Elasticsearch  # lazy optional dep

                if auth:
                    self.es_client = Elasticsearch(url, basic_auth=auth)
                else:
                    self.es_client = Elasticsearch(url)
            except ImportError:
                # SDK-free fallback: same typed-kwargs surface over urllib,
                # so KEYWORD_BACKEND=elasticsearch needs no pip install
                self.es_client = HttpESClient(url, basic_auth=auth)
        self._ensure_index()

    # ------------------------------------------------------------------
    # index lifecycle
    def _has_ik_analyzer(self) -> bool:
        """True when the cluster ships the IK Chinese analyzer
        (keyword_store.py:72-82)."""
        try:
            # typed kwargs work on elasticsearch-py 8.x and 9.x; body=
            # was removed in 9.x and would disable the channel at init
            response = self.es_client.indices.analyze(
                analyzer="ik_smart", text="照片搜索测试"
            )
            return bool(response.get("tokens"))
        except Exception:
            return False

    def _description_mapping_uses_ik(self) -> bool:
        """True when the existing index already maps description with IK
        (keyword_store.py:56-70)."""
        try:
            mapping = self.es_client.indices.get_mapping(index=self.index_name)
            properties = (
                mapping.get(self.index_name, {})
                .get("mappings", {})
                .get("properties", {})
            )
            description = properties.get("description", {})
            return (
                description.get("analyzer") == "ik_max_word"
                and description.get("search_analyzer") == "ik_smart"
            )
        except Exception:
            return False

    def _apply_runtime_settings(self) -> None:
        """Replica self-heal: single-node deployments must run with 0
        replicas or the index sits unassigned/yellow forever
        (keyword_store.py:84-103).  Failure is non-fatal."""
        try:
            self.es_client.indices.put_settings(
                index=self.index_name,
                settings={"index": {"number_of_replicas": 0}},
            )
        except Exception:
            pass

    def _ensure_index(self) -> None:
        """Create the index when missing; recreate it when IK became
        available after a non-IK index was built (keyword_store.py:141-214)."""
        if self.es_client.indices.exists(index=self.index_name):
            if self._has_ik_analyzer() and not self._description_mapping_uses_ik():
                self.es_client.indices.delete(index=self.index_name)
            else:
                self._apply_runtime_settings()
                return

        if not self.es_client.indices.exists(index=self.index_name):
            use_ik = self._has_ik_analyzer()
            description_mapping: Dict[str, Any] = {"type": "text"}
            if use_ik:
                description_mapping["analyzer"] = "ik_max_word"
                description_mapping["search_analyzer"] = "ik_smart"
            mapping = {
                "mappings": {
                    "properties": {
                        "photo_path": {"type": "keyword"},
                        "description": description_mapping,
                        "outer_scene_summary": {"type": "text"},
                        "inner_content_summary": {"type": "text"},
                        "retrieval_text": {"type": "text"},
                        "ocr_text": {"type": "text"},
                        "file_name": {"type": "text"},
                        "media_types": {"type": "keyword"},
                        "tags": {"type": "keyword"},
                        "identity_names": {"type": "keyword"},
                        "identity_evidence": {"type": "keyword"},
                        "year": {"type": "integer"},
                        "month": {"type": "integer"},
                        "day": {"type": "integer"},
                        "hour": {"type": "integer"},
                        "season": {"type": "keyword"},
                        "time_period": {"type": "keyword"},
                        "weekday": {"type": "keyword"},
                        "camera": {"type": "keyword"},
                        "datetime": {
                            "type": "date",
                            "format": "strict_date_optional_time||epoch_millis",
                            "ignore_malformed": True,
                        },
                    }
                },
                "settings": {
                    "index": {"number_of_shards": 1, "number_of_replicas": 0}
                },
            }
            self.es_client.indices.create(
                index=self.index_name,
                mappings=mapping["mappings"],
                settings=mapping["settings"],
            )
            self._apply_runtime_settings()

    # ------------------------------------------------------------------
    # document management
    @property
    def count(self) -> int:
        return self.get_document_count()

    def add_document(self, doc_id: str, document: Dict[str, Any]) -> None:
        """Insert or overwrite one document (keyword_store.py:216-238)."""
        if "photo_path" not in document or "description" not in document:
            raise ValueError("document requires photo_path and description fields")
        self.es_client.index(
            index=self.index_name, id=doc_id, document=document
        )

    def delete_document(self, doc_id: str) -> None:
        try:
            self.es_client.delete(index=self.index_name, id=doc_id)
        except Exception:
            pass  # absent docs are fine — parity with builtin delete

    def get_document_count(self) -> int:
        """Refreshed document count (keyword_store.py:413-418)."""
        try:
            if self.es_client.indices.exists(index=self.index_name):
                self.es_client.indices.refresh(index=self.index_name)
                return int(self.es_client.count(index=self.index_name)["count"])
        except Exception:
            pass
        return 0

    def delete_index(self) -> None:
        if self.es_client.indices.exists(index=self.index_name):
            self.es_client.indices.delete(index=self.index_name)

    def clear(self) -> None:
        """Delete + recreate (keyword_store.py:420-423)."""
        self.delete_index()
        self._ensure_index()

    # ES is its own persistence; these exist for KeywordIndex interface
    # compatibility with the indexer/searcher wiring.
    def save(self, path: Optional[str] = None, *, final: bool = True) -> None:
        del final  # persistence lives in the cluster
        return None

    def load(self, path: Optional[str] = None) -> bool:
        return True

    # ------------------------------------------------------------------
    # queries
    @staticmethod
    def _build_text_query(query: Optional[str]) -> Optional[Dict[str, Any]]:
        if not query or not str(query).strip():
            return None
        text = str(query).strip()
        return {
            "bool": {
                "should": [
                    {
                        "multi_match": {
                            "query": text,
                            "fields": list(TEXT_QUERY_FIELDS),
                            "type": "best_fields",
                            "minimum_should_match": "60%",
                        }
                    },
                    {
                        "match_phrase": {
                            "retrieval_text": {"query": text, "boost": 1.4}
                        }
                    },
                ],
                "minimum_should_match": 1,
            }
        }

    @staticmethod
    def _normalize_hits(response: Dict[str, Any]) -> List[Dict[str, Any]]:
        hits = response["hits"]["hits"]
        if not hits:
            return []
        max_score = response["hits"].get("max_score") or 1.0
        if max_score == 0:
            max_score = 1.0
        results = []
        for hit in hits:
            score = hit["_score"] / max_score if hit["_score"] else 0.5
            results.append(
                {"photo_path": hit["_source"]["photo_path"], "score": score}
            )
        return results

    def search(self, query: str, top_k: int = 50) -> List[Dict[str, Any]]:
        """BM25 text search normalized to (0, 1] (keyword_store.py:240-284)."""
        query_clause = self._build_text_query(query)
        if query_clause is None:
            return []
        try:
            response = self.es_client.search(
                index=self.index_name, query=query_clause, size=top_k,
                min_score=_MIN_SCORE,
            )
            return self._normalize_hits(response)
        except Exception as exc:
            print(f"[WARN] ES search failed: {exc}")
            return []

    def search_with_filters(
        self,
        query: Optional[str],
        filters: Dict[str, Any],
        top_k: int = 50,
    ) -> List[Dict[str, Any]]:
        """Text + EXIF-filter search (keyword_store.py:286-392): text as a
        bool-must, exact fields as term filters, dates as a range filter;
        filter-only hits carry the 0.5 sentinel score."""
        filters = filters or {}
        must_clauses = []
        filter_clauses = []

        text_query = self._build_text_query(query)
        if text_query is not None:
            must_clauses.append(text_query)

        for field in FILTER_EXACT_FIELDS:
            value = filters.get(field)
            if value is not None:
                filter_clauses.append({"term": {field: value}})

        start_date = filters.get("start_date")
        end_date = filters.get("end_date")
        if start_date or end_date:
            date_range: Dict[str, Any] = {}
            if start_date:
                date_range["gte"] = start_date
            if end_date:
                date_range["lte"] = end_date
            filter_clauses.append({"range": {"datetime": date_range}})

        if not must_clauses and not filter_clauses:
            body: Dict[str, Any] = {"query": {"match_all": {}}, "size": top_k}
        elif must_clauses and filter_clauses:
            body = {
                "query": {
                    "bool": {"must": must_clauses, "filter": filter_clauses}
                },
                "size": top_k,
            }
        elif must_clauses:
            body = {"query": {"bool": {"must": must_clauses}}, "size": top_k}
        else:
            body = {"query": {"bool": {"filter": filter_clauses}}, "size": top_k}

        try:
            if must_clauses:
                body["min_score"] = _MIN_SCORE
            response = self.es_client.search(index=self.index_name, **body)
            return self._normalize_hits(response)
        except Exception as exc:
            print(f"[WARN] ES search_with_filters failed: {exc}")
            return []

    def get_filtered_paths(
        self, filters: Dict[str, Any], top_k: int = 1000
    ) -> List[str]:
        results = self.search_with_filters(None, filters, top_k)
        return [r["photo_path"] for r in results]
