"""Vision analysis services: structured image understanding.

Behavior-parity target: reference utils/vision_llm_service.py —
* one-shot structured-JSON prompt demanding the full analysis schema
  {description, outer/inner summaries, media_types, tags(+confidence),
  ocr_text, person_roles, identity_candidates(evidence_types/scope),
  analysis_flags} (vision_llm_service.py:120-139)
* robust JSON extraction: fenced-code stripping + balanced-brace scanning
  (177-247), LLM-based JSON repair on parse failure (253-277)
* conditional enhanced second pass keyed on the signal-score reason with
  reason-specific focus instructions, merging only changed fields
  (286-348, 431-492)
* per-stage timing metrics via get_last_analysis_metrics (350-378)
* ``LocalVisionService``: deterministic offline backend (524-588) — ours
  additionally derives tags from filename tokens and image statistics so
  offline indexes are actually searchable.
"""

from __future__ import annotations

import base64
import json
import re
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

from photo_search_engine_tpu_torch.services.analysis import (
    enhanced_analysis_reason,
    normalize_analysis_payload,
)
from photo_search_engine_tpu_torch.services.llm_compat import (
    OpenAIHttpClient,
    build_image_url_content,
    create_chat_completion,
    extract_response_text,
    normalize_openai_base_url,
    requires_api_key,
    resolve_api_key,
)
from photo_search_engine_tpu_torch.utils.image_parser import (
    filename_tokens,
    generate_fallback_description,
    get_image_dimensions,
    resize_and_optimize_image,
)

ANALYSIS_KEYS = (
    "description",
    "outer_scene_summary",
    "inner_content_summary",
    "media_types",
    "tags",
    "ocr_text",
    "person_roles",
    "identity_candidates",
    "analysis_flags",
)

_ENHANCEMENT_FOCUS = {
    "model_marked_uncertain": "优先重新确认内容类型、关键文字和主体身份。",
    "person_identity_missing": "优先复核主体身份，并说明 evidence_types 与 scope。",
    "ocr_signal_weak": "优先补强 ocr_text 与 inner_content_summary，只保留关键文字。",
    "retrieval_signal_sparse": "优先补强 inner_content_summary、media_types、tags 和关键 OCR。",
}


def _normalize(payload: Dict[str, Any]) -> Dict[str, Any]:
    return normalize_analysis_payload(
        payload,
        tag_min_confidence=0.65,
        identity_text_threshold=0.7,
        identity_visual_threshold=0.92,
    )


def _clip(value: Any, limit: int) -> str:
    text = str(value or "").strip()
    return text if len(text) <= limit else text[: max(0, limit - 1)].rstrip() + "…"


# ---------------------------------------------------------------------------
# JSON extraction from messy model output
# ---------------------------------------------------------------------------

def strip_code_fences(text: str) -> str:
    cleaned = (text or "").strip()
    if cleaned.startswith("```"):
        cleaned = re.sub(r"^```[a-zA-Z]*\s*", "", cleaned)
        cleaned = re.sub(r"\s*```$", "", cleaned)
    return cleaned.strip()


def balanced_json_objects(text: str) -> List[str]:
    """Every balanced {...} span in ``text``, string-literal aware
    (reference vision_llm_service.py:205-231)."""
    spans: List[str] = []
    for start, char in enumerate(text):
        if char != "{":
            continue
        depth = 0
        in_string = False
        escaped = False
        for pos in range(start, len(text)):
            current = text[pos]
            if in_string:
                if escaped:
                    escaped = False
                elif current == "\\":
                    escaped = True
                elif current == '"':
                    in_string = False
                continue
            if current == '"':
                in_string = True
            elif current == "{":
                depth += 1
            elif current == "}":
                depth -= 1
                if depth == 0:
                    spans.append(text[start : pos + 1])
                    break
    return spans


def parse_json_object(response_text: str) -> Dict[str, Any]:
    """Parse the first JSON object recoverable from model output."""
    cleaned = strip_code_fences(response_text)
    candidates: List[str] = []
    if cleaned:
        candidates.append(cleaned)
        candidates.extend(balanced_json_objects(cleaned))
    seen = set()
    for candidate in candidates:
        candidate = candidate.strip()
        if not candidate or candidate in seen:
            continue
        seen.add(candidate)
        try:
            data = json.loads(candidate)
        except Exception:
            continue
        if isinstance(data, dict):
            return data
        if isinstance(data, list):
            for item in data:
                if isinstance(item, dict):
                    return item
    raise ValueError(f"vision response is not parseable JSON: {_clip(response_text, 240)}")


# ---------------------------------------------------------------------------
# Service interfaces
# ---------------------------------------------------------------------------

class VisionService(ABC):
    """Abstract vision interface (reference vision_llm_service.py:27-48)."""

    @abstractmethod
    def analyze_image(self, image_path: str) -> Dict[str, Any]:
        ...

    def analyze_image_batch(self, image_paths: List[str]) -> List[Dict[str, Any]]:
        return [self.analyze_image(p) for p in image_paths]

    def generate_description(self, image_path: str) -> str:
        description = str(self.analyze_image(image_path).get("description") or "").strip()
        if not description:
            raise ValueError("vision model returned an empty description")
        return description

    def generate_description_batch(self, image_paths: List[str]) -> List[str]:
        return [self.generate_description(p) for p in image_paths]

    def get_last_analysis_metrics(self) -> Optional[Dict[str, Any]]:
        return None


class OpenAIVisionService(VisionService):
    """Structured two-pass vision analysis over an OpenAI-compatible API."""

    def __init__(
        self,
        api_key: str,
        model_name: str,
        base_url: str,
        timeout: int = 45,
        max_retries: int = 3,
        client: Optional[Any] = None,
        image_max_size: int = 1024,
        image_quality: int = 85,
        image_format: str = "WEBP",
        reasoning_effort: str = "medium",
        enhanced_reasoning_effort: str = "low",
        base_max_output_tokens: int = 700,
        enhanced_max_output_tokens: int = 420,
        repair_max_output_tokens: int = 420,
        enhanced_analysis_enabled: bool = True,
    ) -> None:
        if client is None and requires_api_key(base_url) and not api_key:
            # an injected client is already authenticated (mirror the
            # QueryFormatter contract, query_formatter.py:92)
            raise ValueError("VISION_API_KEY is not set")
        resolved = resolve_api_key(api_key, base_url)
        self.api_key = resolved
        self.model_name = model_name
        self.base_url = normalize_openai_base_url(base_url)
        self.timeout = timeout
        self.max_retries = max(1, max_retries)
        self.client = client or OpenAIHttpClient(resolved, self.base_url, timeout)
        self.image_max_size = image_max_size
        self.image_quality = image_quality
        self.image_format = (image_format or "WEBP").upper()
        if self.image_format == "JPG":  # PIL/mime canonical name
            self.image_format = "JPEG"
        self.reasoning_effort = reasoning_effort
        self.enhanced_reasoning_effort = enhanced_reasoning_effort
        self.base_max_output_tokens = max(128, int(base_max_output_tokens))
        self.enhanced_max_output_tokens = max(128, int(enhanced_max_output_tokens))
        self.repair_max_output_tokens = max(128, int(repair_max_output_tokens))
        self.enhanced_analysis_enabled = bool(enhanced_analysis_enabled)
        self._metrics: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------
    def _encode_image(self, image_path: str) -> str:
        blob = resize_and_optimize_image(
            image_path,
            max_size=self.image_max_size,
            quality=self.image_quality,
            format=self.image_format,
        )
        # unknown formats fall through image_parser's else-branch and emit
        # JPEG bytes — the declared mime must match the actual encoding
        mime = {"JPEG": "image/jpeg", "PNG": "image/png", "WEBP": "image/webp"}.get(
            self.image_format, "image/jpeg"
        )
        return f"data:{mime};base64,{base64.b64encode(blob).decode('utf-8')}"

    @staticmethod
    def _analysis_prompt() -> str:
        return (
            "观察图片并只返回 JSON。字段固定为："
            '{"description":"","outer_scene_summary":"","inner_content_summary":"",'
            '"media_types":[],"tags":[],"ocr_text":"","person_roles":[],'
            '"identity_candidates":[],"analysis_flags":{}}。\n'
            "要求：description 一句话总结；outer_scene_summary 只写相机实际拍到的外层场景；"
            "inner_content_summary 只写被拍对象内部最有检索价值的内容。"
            "media_types 用自由短语描述图片载体或内容类型。"
            "tags 最多 8 个高价值短标签，可用 {\"tag\":\"\",\"confidence\":0-1} 对象。"
            "ocr_text 只保留最有检索价值的关键文字（200 字内）。"
            "identity_candidates 仅在证据充分时返回，格式 "
            '{"name":"","aliases":[],"confidence":0-1,"evidence_sources":[],'
            '"evidence_types":[],"scope":""}；'
            "evidence_types 用 text、visual 或 mixed；scope 用 depicted、embedded 或 mentioned。"
            "analysis_flags 只保留为 true 的键（text_heavy, has_stage, has_screen, "
            "has_packaging, has_public_figure_likelihood, classification_uncertain）。"
            "不要猜测身份，不要输出 JSON 以外内容。"
        )

    def _chat(self, content: Any, *, effort: str, max_tokens: int) -> Any:
        return create_chat_completion(
            self.client,
            model=self.model_name,
            messages=[{"role": "user", "content": content}],
            timeout=self.timeout,
            response_format={"type": "json_object"},
            reasoning_effort=effort,
            max_tokens=max_tokens,
        )

    def _repair(self, raw_text: str, stage: str) -> Dict[str, Any]:
        """Ask the model to rewrite unparseable output as strict JSON
        (reference vision_llm_service.py:253-277)."""
        prompt = (
            "请把下面的模型原始输出整理成一个严格 JSON 对象，只返回 JSON，不要解释。\n"
            f"阶段：{stage}。\n"
            "保留原始字段语义，去掉 Markdown 和多余说明。\n"
            f"原始输出：{_clip(raw_text, 4000)}"
        )
        started = time.perf_counter()
        response = self._chat(prompt, effort="low", max_tokens=self.repair_max_output_tokens)
        elapsed = time.perf_counter() - started
        payload = parse_json_object(extract_response_text(response))
        if not any(key in payload for key in ANALYSIS_KEYS):
            raise ValueError("repaired response carries no analysis fields")
        return {"payload": payload, "elapsed": round(elapsed, 4)}

    def _enhanced_prompt(self, base: Dict[str, Any], reason: Optional[str]) -> str:
        compact = {
            "description": _clip(base.get("description"), 80),
            "outer_scene_summary": _clip(base.get("outer_scene_summary"), 80),
            "inner_content_summary": _clip(base.get("inner_content_summary"), 120),
            "media_types": list(base.get("media_types") or [])[:4],
            "tags": list(base.get("tags") or [])[:8],
            "ocr_text_excerpt": _clip(base.get("ocr_text"), 200),
            "person_roles": list(base.get("person_roles") or [])[:4],
            "identity_names": list(base.get("identity_names") or [])[:4],
            "analysis_flags": {
                str(k): True for k, v in (base.get("analysis_flags") or {}).items() if v
            },
        }
        focus = _ENHANCEMENT_FOCUS.get(reason or "", "优先修正最影响检索的字段。")
        return (
            "同一张图片做第二轮复核，只返回 JSON。"
            "只返回需要修改或补充的字段，未修改字段省略；"
            "可返回字段仅限 description, outer_scene_summary, inner_content_summary, "
            "media_types, tags, ocr_text, identity_candidates, analysis_flags。"
            f"触发原因：{reason or 'unknown'}。{focus}"
            "不要把第一次结果整份重写回来。"
            f"第一次结果摘要：{json.dumps(compact, ensure_ascii=False, separators=(',', ':'))}"
        )

    def get_last_analysis_metrics(self) -> Optional[Dict[str, Any]]:
        return dict(self._metrics) if self._metrics else None

    # ------------------------------------------------------------------
    def analyze_image(self, image_path: str) -> Dict[str, Any]:
        encode_started = time.perf_counter()
        image_url = self._encode_image(image_path)
        metrics: Dict[str, Any] = {
            "image_encode_seconds": round(time.perf_counter() - encode_started, 4),
            "attempts": [],
            "base_analysis_seconds": 0.0,
            "base_parse_seconds": 0.0,
            "base_repair_seconds": 0.0,
            "base_normalize_seconds": 0.0,
            "enhanced_prompt_seconds": 0.0,
            "enhanced_analysis_seconds": 0.0,
            "enhanced_parse_seconds": 0.0,
            "enhanced_repair_seconds": 0.0,
            "enhanced_normalize_seconds": 0.0,
            "enhanced_triggered": False,
            "enhanced_succeeded": False,
            "used_fallback": False,
        }
        self._metrics = metrics
        content: List[Dict[str, Any]] = [
            {"type": "text", "text": self._analysis_prompt()},
            build_image_url_content(image_url, self.base_url),
        ]

        last_error: Optional[Exception] = None
        for attempt in range(self.max_retries):
            attempt_info: Dict[str, Any] = {"attempt": attempt + 1}
            try:
                normalized = self._run_base_pass(content, metrics, attempt_info)
                reason = enhanced_analysis_reason(normalized)
                run_enhanced = self.enhanced_analysis_enabled and reason is not None
                attempt_info["enhanced_triggered"] = run_enhanced
                attempt_info["enhanced_reason"] = reason
                metrics["enhanced_triggered"] = run_enhanced
                metrics["enhanced_reason"] = reason
                if run_enhanced:
                    normalized = self._run_enhanced_pass(
                        normalized, reason, image_url, metrics, attempt_info
                    )
                attempt_info["status"] = "success"
                metrics["attempts"].append(attempt_info)
                return normalized
            except Exception as exc:
                last_error = exc
                attempt_info["status"] = "failed"
                attempt_info["error"] = str(exc)
                metrics["attempts"].append(attempt_info)
                if attempt < self.max_retries - 1:
                    time.sleep(1)
        raise ValueError(f"structured analysis failed: {last_error}") from last_error

    def _run_base_pass(
        self,
        content: Sequence[Dict[str, Any]],
        metrics: Dict[str, Any],
        attempt_info: Dict[str, Any],
    ) -> Dict[str, Any]:
        started = time.perf_counter()
        response = self._chat(
            list(content),
            effort=self.reasoning_effort,
            max_tokens=self.base_max_output_tokens,
        )
        request_elapsed = time.perf_counter() - started
        attempt_info["base_request_seconds"] = round(request_elapsed, 4)
        metrics["base_analysis_seconds"] = round(
            metrics["base_analysis_seconds"] + request_elapsed, 4
        )

        parse_started = time.perf_counter()
        text = extract_response_text(response)
        repaired = None
        try:
            parsed = parse_json_object(text)
            # a truncated reply can balance on an INNER fragment (e.g. one
            # tag object) — run the same sanity check the repair path uses
            # so junk never reaches _normalize marked as success
            if not any(key in parsed for key in ANALYSIS_KEYS):
                raise ValueError("parsed fragment lacks analysis keys")
        except Exception:
            parse_elapsed = time.perf_counter() - parse_started
            repaired = self._repair(text, "base")
            parsed = repaired["payload"]
            attempt_info["base_repair_seconds"] = repaired["elapsed"]
            metrics["base_repair_seconds"] = round(
                metrics["base_repair_seconds"] + repaired["elapsed"], 4
            )
        # parse time excludes the repair round-trip (it has its own metric;
        # including it double-counted repair latency in per-stage sums)
        if repaired is None:
            parse_elapsed = time.perf_counter() - parse_started
        metrics["base_parse_seconds"] = round(
            metrics["base_parse_seconds"] + parse_elapsed, 4
        )

        normalize_started = time.perf_counter()
        normalized = _normalize(parsed)
        metrics["base_normalize_seconds"] = round(
            metrics["base_normalize_seconds"] + (time.perf_counter() - normalize_started), 4
        )
        return normalized

    def _run_enhanced_pass(
        self,
        normalized: Dict[str, Any],
        reason: Optional[str],
        image_url: str,
        metrics: Dict[str, Any],
        attempt_info: Dict[str, Any],
    ) -> Dict[str, Any]:
        try:
            prompt_started = time.perf_counter()
            prompt = self._enhanced_prompt(normalized, reason)
            metrics["enhanced_prompt_seconds"] = round(
                metrics["enhanced_prompt_seconds"] + (time.perf_counter() - prompt_started), 4
            )
            request_started = time.perf_counter()
            response = self._chat(
                [
                    {"type": "text", "text": prompt},
                    build_image_url_content(image_url, self.base_url),
                ],
                effort=self.enhanced_reasoning_effort,
                max_tokens=self.enhanced_max_output_tokens,
            )
            metrics["enhanced_analysis_seconds"] = round(
                metrics["enhanced_analysis_seconds"] + (time.perf_counter() - request_started), 4
            )
            parse_started = time.perf_counter()
            text = extract_response_text(response)
            try:
                parsed = parse_json_object(text)
                parse_elapsed = time.perf_counter() - parse_started
            except Exception:
                parse_elapsed = time.perf_counter() - parse_started
                repaired = self._repair(text, "enhanced")
                parsed = repaired["payload"]
                attempt_info["enhanced_repair_seconds"] = repaired["elapsed"]
                metrics["enhanced_repair_seconds"] = round(
                    metrics["enhanced_repair_seconds"] + repaired["elapsed"], 4
                )
            # parse metric excludes the repair round-trip (own metric)
            metrics["enhanced_parse_seconds"] = round(
                metrics["enhanced_parse_seconds"] + parse_elapsed, 4
            )
            # merge only fields the second pass actually returned
            merged = dict(normalized)
            merged.update(parsed)
            normalize_started = time.perf_counter()
            normalized = _normalize(merged)
            metrics["enhanced_normalize_seconds"] = round(
                metrics["enhanced_normalize_seconds"]
                + (time.perf_counter() - normalize_started),
                4,
            )
            attempt_info["enhanced_succeeded"] = True
            metrics["enhanced_succeeded"] = True
        except Exception as exc:
            attempt_info["enhanced_succeeded"] = False
            attempt_info["enhanced_error"] = str(exc)
        return normalized


class LocalVisionService(VisionService):
    """Deterministic offline vision backend.

    Like the reference's LocalVisionLLMService (vision_llm_service.py:
    524-588) it is cheap and reproducible, but it additionally derives
    tags from filename tokens and coarse image statistics so offline
    indexes are genuinely searchable (the tokens feed both index texts)."""

    def __init__(self) -> None:
        self._metrics: Optional[Dict[str, Any]] = None

    def get_last_analysis_metrics(self) -> Optional[Dict[str, Any]]:
        return dict(self._metrics) if self._metrics else None

    def analyze_image(self, image_path: str) -> Dict[str, Any]:
        self._metrics = {
            "image_encode_seconds": 0.0,
            "attempts": [{"attempt": 1, "status": "success", "base_request_seconds": 0.0}],
            "base_analysis_seconds": 0.0,
            "base_parse_seconds": 0.0,
            "base_normalize_seconds": 0.0,
            "enhanced_prompt_seconds": 0.0,
            "enhanced_analysis_seconds": 0.0,
            "enhanced_parse_seconds": 0.0,
            "enhanced_normalize_seconds": 0.0,
            "enhanced_triggered": False,
            "enhanced_succeeded": False,
            "used_fallback": False,
        }
        width, height = get_image_dimensions(image_path)
        caption = generate_fallback_description(image_path)
        tokens = filename_tokens(image_path)
        tags = tokens[:6]
        if width > 0 and height > 0:
            tags.append(f"{width}x{height}")
            orientation = "横图" if width >= height else "竖图"
        else:
            orientation = ""
        return _normalize(
            {
                "description": caption,
                "outer_scene_summary": caption,
                "inner_content_summary": " ".join(tokens),
                "media_types": ["photo"] + ([orientation] if orientation else []),
                "tags": tags,
                "ocr_text": "",
                "person_roles": [],
                "identity_candidates": [],
                "analysis_flags": {},
            }
        )
