"""Structured-analysis normalization and index-text composition.

Pure functions, no device code.  Behavior-parity target:
reference utils/structured_analysis.py:1-364 —

* ``INDEX_TEXT_VERSION`` (= reference ``EMBEDDING_TEXT_VERSION``,
  structured_analysis.py:6) is stamped into every metadata record; a bump
  forces an automatic full rebuild (indexer schema gate).
* Two distinct index texts are produced from one analysis payload:
  - ``embedding_text`` (structured_analysis.py:263-309): media types +
    person roles + tags + outer/inner summaries + only *visually confirmed,
    depicted* identities.  Feeds the vector index.
  - ``retrieval_text`` (structured_analysis.py:216-241): media types + tags
    + outer/inner summaries + OCR text + *all* accepted identity names.
    Feeds the keyword (BM25) index.
* Identity selection uses per-evidence-type confidence thresholds
  (text >= 0.70, visual >= 0.92; structured_analysis.py:116-149).
* ``enhanced_analysis_reason`` (structured_analysis.py:169-213) is the
  signal-score heuristic that decides whether the vision service should run
  a second, focused analysis pass.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

INDEX_TEXT_VERSION = 2

# Signal-score thresholds (reference structured_analysis.py:7-11).
OCR_HEAVY_LEN = 36
OCR_STRONG_LEN = 48
RICH_DESCRIPTION_LEN = 24
RICH_INNER_SUMMARY_LEN = 18
SKIP_SIGNAL_SCORE = 3

DEFAULT_DESCRIPTION = "一张照片"


def clean_text(value: Any) -> str:
    """Collapse whitespace runs and strip; None-safe."""
    if value is None:
        return ""
    return " ".join(str(value).split()).strip()


def unique_preserving(values: Sequence[str]) -> List[str]:
    """Case-insensitive order-preserving dedup of non-empty strings."""
    out: List[str] = []
    seen: set = set()
    for v in values:
        if not v:
            continue
        folded = v.lower()
        if folded not in seen:
            seen.add(folded)
            out.append(v)
    return out


def normalize_media_types(values: Sequence[Any]) -> List[str]:
    return unique_preserving([clean_text(v) for v in (values or [])])


def normalize_tags(values: Sequence[Any], min_confidence: float) -> List[str]:
    """Keep tags whose confidence >= min_confidence.

    Dict tags use their ``confidence`` field (missing → 1.0, unparsable →
    0.0); bare-string tags count as confidence 1.0.
    (reference structured_analysis.py:39-55)
    """
    kept: List[str] = []
    for item in values or []:
        if isinstance(item, dict):
            label = clean_text(item.get("tag") or item.get("name") or item.get("value"))
            raw_conf = item.get("confidence")
            if raw_conf is None:
                conf = 1.0
            else:
                try:
                    conf = float(raw_conf)
                except (TypeError, ValueError):
                    conf = 0.0
        else:
            label = clean_text(item)
            conf = 1.0
        if label and conf >= min_confidence:
            kept.append(label)
    return unique_preserving(kept)


def normalize_ocr_text(value: Any) -> str:
    """OCR text capped at 400 chars (reference structured_analysis.py:58-60)."""
    text = clean_text(value)
    return text[:400]


def normalize_person_roles(values: Sequence[Any]) -> List[str]:
    return unique_preserving([clean_text(v) for v in (values or [])])


def normalize_analysis_flags(value: Any) -> Dict[str, bool]:
    if not isinstance(value, dict):
        return {}
    out: Dict[str, bool] = {}
    for key, flag in value.items():
        name = clean_text(key)
        if name:
            out[name] = bool(flag)
    return out


# ---------------------------------------------------------------------------
# Identity candidates
# ---------------------------------------------------------------------------

def _normalize_candidate(raw: Any) -> Optional[Dict[str, Any]]:
    """Canonicalize one identity candidate dict; drop nameless entries.

    (reference structured_analysis.py:79-113)
    """
    if not isinstance(raw, dict):
        return None
    name = clean_text(raw.get("name"))
    if not name:
        return None
    try:
        confidence = float(raw.get("confidence", 0.0))
    except (TypeError, ValueError):
        confidence = 0.0
    return {
        "name": name,
        "aliases": unique_preserving([clean_text(a) for a in (raw.get("aliases") or []) if clean_text(a)]),
        "confidence": round(confidence, 4),
        "evidence_sources": unique_preserving(
            [clean_text(s) for s in (raw.get("evidence_sources") or []) if clean_text(s)]
        ),
        "evidence_types": unique_preserving(
            [clean_text(t) for t in (raw.get("evidence_types") or []) if clean_text(t)]
        ),
        "scope": clean_text(raw.get("scope")),
    }


def candidate_threshold(candidate: Dict[str, Any], text_threshold: float, visual_threshold: float) -> float:
    """Per-evidence-type acceptance threshold.

    text evidence → text_threshold; visual-only → visual_threshold; neither →
    the stricter of the two (reference structured_analysis.py:116-122).
    """
    kinds = {t.lower() for t in candidate.get("evidence_types") or []}
    if "text" in kinds:
        return text_threshold
    if "visual" in kinds:
        return visual_threshold
    return max(text_threshold, visual_threshold)


def select_identity_names(
    candidates: Sequence[Any],
    text_threshold: float,
    visual_threshold: float,
) -> Tuple[List[str], List[str], List[Dict[str, Any]]]:
    """Return (accepted names+aliases, their evidence sources, all normalized
    candidates).  (reference structured_analysis.py:125-149)"""
    names: List[str] = []
    evidence: List[str] = []
    normalized: List[Dict[str, Any]] = []
    for raw in candidates or []:
        cand = _normalize_candidate(raw)
        if cand is None:
            continue
        normalized.append(cand)
        if cand["confidence"] >= candidate_threshold(cand, text_threshold, visual_threshold):
            names.append(cand["name"])
            names.extend(cand["aliases"])
            evidence.extend(cand["evidence_sources"])
    return unique_preserving(names), unique_preserving(evidence), normalized


def _candidate_is_visual_depicted(
    candidate: Dict[str, Any], *, text_threshold: float, visual_threshold: float
) -> bool:
    """True for confident, visually-evidenced, actually-depicted identities —
    the only identities allowed into ``embedding_text``
    (reference structured_analysis.py:244-260)."""
    if candidate.get("confidence", 0.0) < candidate_threshold(candidate, text_threshold, visual_threshold):
        return False
    kinds = {str(t).strip().lower() for t in candidate.get("evidence_types") or [] if str(t).strip()}
    if not kinds.intersection({"visual", "mixed"}):
        return False
    scope = str(candidate.get("scope") or "").strip().lower()
    return not scope or scope == "depicted"


# ---------------------------------------------------------------------------
# Enhanced-analysis gating
# ---------------------------------------------------------------------------

def _has_confident_candidate(candidates: Sequence[Any], threshold: float = 0.7) -> bool:
    for cand in candidates or []:
        if not isinstance(cand, dict):
            continue
        try:
            conf = float(cand.get("confidence", 0.0))
        except (TypeError, ValueError):
            conf = 0.0
        if conf >= threshold:
            return True
    return False


def enhanced_analysis_reason(analysis: Dict[str, Any]) -> Optional[str]:
    """Decide whether a second focused vision pass is warranted.

    Returns one of ``model_marked_uncertain`` / ``person_identity_missing`` /
    ``ocr_signal_weak`` / ``retrieval_signal_sparse`` or None.
    (reference structured_analysis.py:169-213)
    """
    flags = normalize_analysis_flags(analysis.get("analysis_flags"))
    ocr_text = normalize_ocr_text(analysis.get("ocr_text"))
    media_types = normalize_media_types(analysis.get("media_types") or [])
    person_roles = normalize_person_roles(analysis.get("person_roles") or [])
    tags = normalize_tags(analysis.get("tags") or [], min_confidence=0.0)
    description = clean_text(analysis.get("description"))
    inner_summary = clean_text(analysis.get("inner_content_summary"))
    identity_names = [clean_text(n) for n in analysis.get("identity_names") or [] if clean_text(n)]
    identity_candidates = analysis.get("identity_candidates") or []

    text_heavy = bool(flags.get("text_heavy")) or len(ocr_text) >= OCR_HEAVY_LEN
    strong_ocr = len(ocr_text) >= (OCR_STRONG_LEN if text_heavy else 16)
    missing_media = not media_types
    confident_identity = _has_confident_candidate(identity_candidates)
    rich_inner = len(inner_summary) >= RICH_INNER_SUMMARY_LEN

    signal_score = sum(
        [
            not missing_media,
            len(description) >= RICH_DESCRIPTION_LEN,
            rich_inner,
            strong_ocr,
            len(tags) >= 2,
            bool(identity_names) or confident_identity,
        ]
    )

    if flags.get("classification_uncertain"):
        return "model_marked_uncertain"
    if (
        person_roles
        and not identity_names
        and not confident_identity
        and signal_score < SKIP_SIGNAL_SCORE
    ):
        return "person_identity_missing"
    if text_heavy and not strong_ocr and signal_score < SKIP_SIGNAL_SCORE:
        return "ocr_signal_weak"
    if signal_score < SKIP_SIGNAL_SCORE and (
        missing_media or not rich_inner or (text_heavy and not strong_ocr)
    ):
        return "retrieval_signal_sparse"
    return None


def should_run_enhanced_analysis(analysis: Dict[str, Any]) -> bool:
    return enhanced_analysis_reason(analysis) is not None


# ---------------------------------------------------------------------------
# Index-text composition
# ---------------------------------------------------------------------------

def compose_retrieval_text(
    analysis: Dict[str, Any], identity_names: Sequence[str], ocr_text: str
) -> str:
    """BM25-facing text: media types, tags, outer/inner summaries, OCR, all
    accepted identity names (reference structured_analysis.py:216-241)."""
    parts: List[str] = []
    media_types = normalize_media_types(analysis.get("media_types") or [])
    if media_types:
        parts.append(" ".join(media_types))
    tags = normalize_tags(analysis.get("tags") or [], min_confidence=0.0)
    if tags:
        parts.append(" ".join(tags))
    for key in ("outer_scene_summary", "inner_content_summary"):
        text = clean_text(analysis.get(key))
        if text:
            parts.append(text)
    if ocr_text:
        parts.append(ocr_text)
    identity_text = " ".join(unique_preserving([clean_text(n) for n in identity_names]))
    if identity_text:
        parts.append(identity_text)
    if not parts:
        parts.append(clean_text(analysis.get("description")) or DEFAULT_DESCRIPTION)
    return " ".join(p for p in parts if p).strip()


def compose_embedding_text(
    analysis: Dict[str, Any],
    identity_candidates: Sequence[Dict[str, Any]],
    *,
    identity_text_threshold: float,
    identity_visual_threshold: float,
) -> str:
    """Vector-facing text: visual semantics only; identities must be
    visually confirmed and depicted (reference structured_analysis.py:263-309)."""
    parts: List[str] = []
    media_types = normalize_media_types(analysis.get("media_types") or [])
    if media_types:
        parts.append(" ".join(media_types))
    person_roles = normalize_person_roles(analysis.get("person_roles") or [])
    if person_roles:
        parts.append(" ".join(person_roles))
    tags = normalize_tags(analysis.get("tags") or [], min_confidence=0.0)
    if tags:
        parts.append(" ".join(tags))
    for key in ("outer_scene_summary", "inner_content_summary"):
        text = clean_text(analysis.get(key))
        if text:
            parts.append(text)

    visual_names: List[str] = []
    for cand in identity_candidates or []:
        if not isinstance(cand, dict):
            continue
        if _candidate_is_visual_depicted(
            cand,
            text_threshold=identity_text_threshold,
            visual_threshold=identity_visual_threshold,
        ):
            visual_names.append(clean_text(cand.get("name")))
    visual_text = " ".join(unique_preserving([n for n in visual_names if n]))
    if visual_text:
        parts.append(visual_text)

    if not parts:
        parts.append(clean_text(analysis.get("description")) or DEFAULT_DESCRIPTION)
    return " ".join(p for p in parts if p).strip()


def normalize_analysis_payload(
    payload: Dict[str, Any],
    tag_min_confidence: float,
    identity_text_threshold: float,
    identity_visual_threshold: float,
) -> Dict[str, Any]:
    """Canonicalize a raw vision-LLM payload and attach both index texts.

    (reference structured_analysis.py:312-351)
    """
    ocr_text = normalize_ocr_text(payload.get("ocr_text"))
    identity_names, identity_evidence, identity_candidates = select_identity_names(
        payload.get("identity_candidates") or [],
        text_threshold=identity_text_threshold,
        visual_threshold=identity_visual_threshold,
    )
    normalized: Dict[str, Any] = {
        "description": clean_text(payload.get("description")) or DEFAULT_DESCRIPTION,
        "outer_scene_summary": clean_text(payload.get("outer_scene_summary")),
        "inner_content_summary": clean_text(payload.get("inner_content_summary")),
        "media_types": normalize_media_types(payload.get("media_types") or []),
        "tags": normalize_tags(payload.get("tags") or [], min_confidence=tag_min_confidence),
        "ocr_text": ocr_text,
        "person_roles": normalize_person_roles(payload.get("person_roles") or []),
        "identity_candidates": identity_candidates,
        "identity_names": identity_names,
        "identity_evidence": identity_evidence,
        "analysis_flags": normalize_analysis_flags(payload.get("analysis_flags")),
    }
    normalized["embedding_text"] = compose_embedding_text(
        normalized,
        identity_candidates,
        identity_text_threshold=identity_text_threshold,
        identity_visual_threshold=identity_visual_threshold,
    )
    normalized["retrieval_text"] = compose_retrieval_text(normalized, identity_names, ocr_text)
    return normalized


def build_match_summary(metadata: Dict[str, Any]) -> Dict[str, Any]:
    """Explainability payload attached to every search hit
    (reference structured_analysis.py:354-364)."""
    return {
        "media_types": list(metadata.get("media_types") or []),
        "top_tags": list(metadata.get("top_tags") or metadata.get("tags") or [])[:8],
        "identities": list(metadata.get("identity_names") or []),
        "identity_evidence": list(metadata.get("identity_evidence") or []),
        "ocr_excerpt": normalize_ocr_text(metadata.get("ocr_text"))[:120],
    }
