"""Migrate a reference-format index (FAISS binary + metadata.json) into
this framework's native format.

A user of the reference (shizhenneko/Photo_Search_Engine) can switch
WITHOUT re-running the expensive vision/embedding pipeline: this tool

* extracts the raw float vectors from a FAISS ``IndexFlatIP`` /
  ``IndexFlatL2`` / ``IndexHNSWFlat`` binary (the flat storage inside
  every one of those indexes keeps vectors as one contiguous
  ``std::vector<float>`` — located by its int64 length prefix, validated
  against count × dimension from the sidecars);
* repairs the reference's stringified metadata fields (its committed
  metadata.json serializes lists/dicts as their ``str()`` forms,
  e.g. ``"['自然风光']"``) back into structured values;
* writes this framework's artifacts: ``.npy`` vectors + meta sidecar +
  metadata.json (core/vector_index.py format) and a rebuilt keyword
  index with the EXIF filter fields (core/keyword_index.py).

Usage:
  python -m photo_search_engine_tpu.tools.migrate \
      --faiss-index data/photo_search.index \
      --metadata data/metadata.json \
      --out-dir ./data_tpu
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np

_STRUCTURED_FIELDS = (
    "media_types",
    "top_tags",
    "tags",
    "person_roles",
    "identity_candidates",
    "identity_names",
    "identity_evidence",
    "analysis_flags",
    "exif_data",
    "time_info",
)


def extract_faiss_vectors(
    index_path: str, count: int, dimension: int
) -> np.ndarray:
    """Locate the contiguous float vector block inside a FAISS flat-storage
    index binary via its int64 element-count prefix."""
    with open(index_path, "rb") as f:
        raw = f.read()
    needle = struct.pack("<q", count * dimension)
    offset = -1
    search_from = 0
    while True:
        candidate = raw.find(needle, search_from)
        if candidate < 0:
            break
        data_start = candidate + 8
        if data_start + count * dimension * 4 <= len(raw):
            vectors = np.frombuffer(
                raw, np.float32, count=count * dimension, offset=data_start
            ).reshape(count, dimension)
            if np.isfinite(vectors).all():
                offset = candidate
                break
        search_from = candidate + 1
    if offset < 0:
        raise ValueError(
            f"could not locate a {count}x{dimension} float block in {index_path}"
        )
    return np.array(vectors)


def repair_metadata_item(item: Dict[str, Any]) -> Dict[str, Any]:
    """Parse stringified list/dict fields back into structured values."""
    fixed = dict(item)
    for field in _STRUCTURED_FIELDS:
        value = fixed.get(field)
        if isinstance(value, str):
            try:
                fixed[field] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                pass
    version = fixed.get("index_text_version")
    if isinstance(version, str) and version.isdigit():
        fixed["index_text_version"] = int(version)
    return fixed


def migrate(
    faiss_index_path: str,
    metadata_path: str,
    out_dir: str,
    *,
    faiss_meta_path: Optional[str] = None,
    metric: Optional[str] = None,
    dimension: Optional[int] = None,
    index_type: str = "flat",
) -> Dict[str, Any]:
    from photo_search_engine_tpu_torch.core.keyword_index import KeywordIndex
    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex

    with open(metadata_path, "r", encoding="utf-8") as f:
        metadata = json.load(f)
    metadata = [repair_metadata_item(item) for item in metadata]
    count = len(metadata)

    sidecar = faiss_meta_path or f"{faiss_index_path}.meta.json"
    if os.path.exists(sidecar):
        with open(sidecar, "r", encoding="utf-8") as f:
            faiss_meta = json.load(f)
        metric = metric or faiss_meta.get("metric", "cosine")
        dimension = dimension or faiss_meta.get("dimension")
    metric = metric or "cosine"
    if not dimension:
        raise ValueError("dimension unknown: pass --dimension or provide the sidecar")

    vectors = extract_faiss_vectors(faiss_index_path, count, dimension)

    os.makedirs(out_dir, exist_ok=True)
    vector_index = VectorIndex(
        dimension=dimension,
        index_path=os.path.join(out_dir, "photo_search.index"),
        metadata_path=os.path.join(out_dir, "metadata.json"),
        metric=metric,
        # "ivf" stamps the sidecar so a VECTOR_INDEX_TYPE=ivf server can
        # open the migrated corpus directly (lists build lazily on first
        # search); the stored vectors are identical either way
        index_type=index_type,
    )
    vector_index.add_batch(vectors, metadata)
    vector_index.save()

    keyword_index = KeywordIndex(os.path.join(out_dir, "keyword_index.json"))
    for item in metadata:
        time_info = item.get("time_info") or {}
        exif = item.get("exif_data") or {}
        keyword_index.add_document(
            hashlib.md5(str(item.get("photo_path", "")).encode()).hexdigest(),
            {
                "photo_path": item.get("photo_path", ""),
                "description": item.get("description", ""),
                "outer_scene_summary": item.get("outer_scene_summary"),
                "inner_content_summary": item.get("inner_content_summary"),
                "retrieval_text": item.get("retrieval_text"),
                "ocr_text": item.get("ocr_text") or "",
                "file_name": os.path.basename(str(item.get("photo_path", ""))),
                "media_types": item.get("media_types") or [],
                "tags": item.get("top_tags") or item.get("tags") or [],
                "identity_names": item.get("identity_names") or [],
                "identity_evidence": item.get("identity_evidence") or [],
                "year": time_info.get("year"),
                "month": time_info.get("month"),
                "day": time_info.get("day"),
                "hour": time_info.get("hour"),
                "season": time_info.get("season"),
                "time_period": time_info.get("time_period"),
                "weekday": time_info.get("weekday"),
                "camera": exif.get("camera"),
                "datetime": time_info.get("datetime_str"),
            },
        )
    keyword_index.save()

    return {
        "count": count,
        "dimension": dimension,
        "metric": metric,
        "out_dir": out_dir,
        "vector_index": vector_index.index_path,
        "keyword_index": keyword_index.index_path,
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--faiss-index", required=True)
    parser.add_argument("--metadata", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--metric", default=None)
    parser.add_argument("--dimension", type=int, default=None)
    parser.add_argument(
        "--index-type", default="flat", choices=["flat", "ivf"],
        help="index type stamped into the sidecar (ivf for million-scale)",
    )
    args = parser.parse_args(argv)
    report = migrate(
        args.faiss_index,
        args.metadata,
        args.out_dir,
        metric=args.metric,
        dimension=args.dimension,
        index_type=args.index_type,
    )
    print(json.dumps(report, ensure_ascii=False, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
