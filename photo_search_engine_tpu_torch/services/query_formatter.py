"""LLM query planner: format → expand → reflect.

Behavior-parity target: reference utils/query_formatter.py —
* ``format_query`` (76-298) → intent dict {search_text (visual-only),
  retrieval_mode hybrid|filter_only, media_terms[], identity_terms[],
  strict_identity_filter, intent_mode strict|open, intent_contract
  {core_target, must_keep[], avoid_drift}, time_hint, season,
  time_period}; degrade-to-raw-query fallback (255-298)
* intent normalizers (300-440): mode defaulting from
  strict_identity_filter, retrieval-mode inference from empty
  search_text + filter hints, contract inheritance from the base intent
* ``expand_query_intents`` (442-531) → ≤N conservative alternatives each
  tagged ``contract_satisfied``
* ``reflect_on_weak_results`` (533-621) → single refined intent or {}.

Added: ``backend="local"`` — a deterministic rule-based planner (no LLM)
that strips politeness/task words, lifts season/time-period/time-hint
words out of the visual text, and guesses media terms, so the full search
pipeline (including filter_only mode) works offline.
"""

from __future__ import annotations

import json
import re
import time
from datetime import datetime
from typing import Any, Dict, List, Optional

from photo_search_engine_tpu_torch.services.vision import parse_json_object
from photo_search_engine_tpu_torch.services.llm_compat import (
    OpenAIHttpClient,
    create_chat_completion,
    extract_response_text,
    normalize_openai_base_url,
    requires_api_key,
    resolve_api_key,
)

SEASON_WORDS = ("春天", "夏天", "秋天", "冬天")
TIME_PERIOD_WORDS = ("凌晨", "早晨", "上午", "中午", "下午", "傍晚", "夜晚")
_TIME_HINT_PATTERN = re.compile(
    r"(今天|昨天|前天|明天|后天|今年|去年|前年|明年|上周|这周|下周|上个月|这个月|下个月|最近"
    r"|(?:19|20)\d{2}\s*年(?:\s*\d{1,2}\s*月(?:\s*\d{1,2}\s*日)?)?|\d{1,2}\s*月(?:\s*\d{1,2}\s*日)?)"
)
# multi-char phrases may strip anywhere; the single-char "请" and the verb
# "搜索"/"查找" family strip only at the START of the query — bare
# substring removal corrupts content words that contain them
# ("邀请函"→"邀函", "搜索引擎"→"引擎")
_POLITENESS_ANYWHERE = (
    "帮我找", "帮我搜", "帮我看", "给我看", "给我找", "请展示", "请给我", "请找",
    "找一下", "找找", "帮我", "我想看", "我要找", "show me",
)
_POLITENESS_PREFIX = ("搜索", "检索", "查找", "请")
# longest-first so "的照片" matches before "照片" eats it
_GENERIC_NOUNS = ("的照片", "的图片", "照片", "图片", "相片", "图像")
_MEDIA_HINTS = {
    "截图": "截图", "屏幕截图": "截图", "screenshot": "screenshot",
    "海报": "海报", "poster": "poster", "表情包": "表情包", "meme": "meme",
    "证件": "证件", "扫描件": "扫描件", "合影": "合影", "自拍": "自拍", "selfie": "selfie",
}


def default_intent_contract(
    *,
    user_query: str,
    search_text: str,
    media_terms: List[str],
    identity_terms: List[str],
) -> Dict[str, Any]:
    core = (
        search_text.strip()
        or " ".join(identity_terms).strip()
        or " ".join(media_terms).strip()
        or user_query.strip()
    )
    return {"core_target": core, "must_keep": [], "avoid_drift": ""}


class QueryFormatter:
    """format / expand / reflect planner with LLM and local backends."""

    def __init__(
        self,
        api_key: str = "",
        model_name: str = "",
        base_url: str = "",
        reasoning_effort: str = "low",
        timeout: int = 15,
        max_retries: int = 3,
        client: Optional[Any] = None,
        backend: str = "auto",
        enabled: bool = True,
        now_fn: Optional[Any] = None,
    ) -> None:
        self.backend = (backend or "auto").strip().lower()
        if self.backend == "auto":
            self.backend = "openai" if (base_url or client) else "local"
        if self.backend == "openai" and requires_api_key(base_url) and not api_key and client is None:
            raise ValueError("QUERY_FORMAT_API_KEY is not set")
        resolved = resolve_api_key(api_key, base_url)
        self.api_key = resolved
        self.model_name = model_name
        self.base_url = normalize_openai_base_url(base_url)
        self.reasoning_effort = reasoning_effort
        self.timeout = timeout
        self.max_retries = max(1, max_retries)
        self.enabled = bool(enabled)
        self._now = now_fn or datetime.now
        if self.backend == "openai":
            self.client = client or OpenAIHttpClient(resolved, self.base_url, timeout)
        else:
            self.client = client

    def is_enabled(self) -> bool:
        return self.enabled

    # ------------------------------------------------------------------
    # Normalizers (contract parity with reference query_formatter.py:300-440)
    # ------------------------------------------------------------------
    @staticmethod
    def normalize_intent_mode(value: Any, *, strict_identity_filter: bool) -> str:
        mode = str(value or "").strip().lower()
        if mode in {"strict", "open"}:
            return mode
        return "strict" if strict_identity_filter else "open"

    @staticmethod
    def normalize_retrieval_mode(
        value: Any, *, search_text: str, time_hint: Any = None,
        season: Any = None, time_period: Any = None,
    ) -> str:
        mode = str(value or "").strip().lower()
        if mode in {"hybrid", "filter_only"}:
            return mode
        if (time_hint or season or time_period) and not str(search_text or "").strip():
            return "filter_only"
        return "hybrid"

    @staticmethod
    def normalize_intent_contract(
        value: Any,
        *,
        user_query: str,
        search_text: str,
        media_terms: List[str],
        identity_terms: List[str],
        base_contract: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        contract = value if isinstance(value, dict) else {}
        inherited = base_contract if isinstance(base_contract, dict) else {}
        core = str(contract.get("core_target") or inherited.get("core_target") or "").strip()
        if not core:
            core = default_intent_contract(
                user_query=user_query,
                search_text=search_text,
                media_terms=media_terms,
                identity_terms=identity_terms,
            )["core_target"]
        raw_keep = contract.get("must_keep")
        if not isinstance(raw_keep, list):
            raw_keep = inherited.get("must_keep") if isinstance(inherited.get("must_keep"), list) else []
        must_keep: List[str] = []
        seen = set()
        for item in raw_keep or []:
            token = str(item or "").strip()
            if token and token.lower() not in seen:
                must_keep.append(token)
                seen.add(token.lower())
        avoid = str(contract.get("avoid_drift") or inherited.get("avoid_drift") or "").strip()
        return {"core_target": core, "must_keep": must_keep, "avoid_drift": avoid}

    @classmethod
    def normalize_intent_payload(
        cls,
        payload: Dict[str, Any],
        *,
        user_query: str,
        time_hint: Any = None,
        season: Any = None,
        time_period: Any = None,
        base_intent: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        intent: Dict[str, Any] = {
            "search_text": str(payload.get("search_text") or "").strip(),
            "retrieval_mode": payload.get("retrieval_mode"),
            "media_terms": [
                str(v).strip() for v in (payload.get("media_terms") or []) if str(v).strip()
            ],
            "identity_terms": [
                str(v).strip() for v in (payload.get("identity_terms") or []) if str(v).strip()
            ],
            "strict_identity_filter": bool(payload.get("strict_identity_filter", False)),
            "contract_satisfied": bool(payload.get("contract_satisfied", True)),
            "time_hint": time_hint,
            "season": season,
            "time_period": time_period,
            "original_query": user_query,
            "reason": str(payload.get("reason") or "").strip(),
        }
        intent["retrieval_mode"] = cls.normalize_retrieval_mode(
            payload.get("retrieval_mode"),
            search_text=intent["search_text"],
            time_hint=time_hint,
            season=season,
            time_period=time_period,
        )
        intent["intent_mode"] = cls.normalize_intent_mode(
            payload.get("intent_mode"),
            strict_identity_filter=intent["strict_identity_filter"],
        )
        base_contract = {}
        if isinstance(base_intent, dict) and isinstance(base_intent.get("intent_contract"), dict):
            base_contract = base_intent["intent_contract"]
        intent["intent_contract"] = cls.normalize_intent_contract(
            payload.get("intent_contract"),
            user_query=user_query,
            search_text=intent["search_text"],
            media_terms=intent["media_terms"],
            identity_terms=intent["identity_terms"],
            base_contract=base_contract,
        )
        for key in ("season", "time_period", "time_hint"):
            if intent[key] is not None:
                intent[key] = str(intent[key]).strip() or None
        return intent

    def _fallback_intent(self, user_query: str) -> Dict[str, Any]:
        """Degrade to the raw query (reference query_formatter.py:255-298)."""
        return {
            "search_text": user_query,
            "retrieval_mode": "hybrid",
            "media_terms": [],
            "identity_terms": [],
            "strict_identity_filter": False,
            "intent_mode": "open",
            "intent_contract": default_intent_contract(
                user_query=user_query, search_text=user_query,
                media_terms=[], identity_terms=[],
            ),
            "contract_satisfied": True,
            "time_hint": None,
            "season": None,
            "time_period": None,
            "original_query": user_query,
        }

    # ------------------------------------------------------------------
    # format_query
    # ------------------------------------------------------------------
    def format_query(self, user_query: str) -> Dict[str, Any]:
        if self.backend == "local":
            return self._format_local(user_query)
        return self._format_remote(user_query)

    def _format_local(self, user_query: str) -> Dict[str, Any]:
        """Deterministic rule-based intent extraction."""
        text = str(user_query or "").strip()
        season = next((w for w in SEASON_WORDS if w in text), None)
        time_period = next((w for w in TIME_PERIOD_WORDS if w in text), None)
        # keep EVERY time hint (e.g. "去年3月" matches twice) — the hint
        # feeds the time parser; dropping the tail silently widens ranges
        time_hint = "".join(
            m.group(0) for m in _TIME_HINT_PATTERN.finditer(text)
        ) or None

        cleaned = text
        for phrase in _POLITENESS_ANYWHERE:
            cleaned = cleaned.replace(phrase, "")
        changed = True
        while changed:
            changed = False
            for phrase in _POLITENESS_PREFIX:
                if cleaned.startswith(phrase):
                    cleaned = cleaned[len(phrase):]
                    changed = True
        # lift time words out of the visual text
        cleaned = _TIME_HINT_PATTERN.sub("", cleaned)
        for word in SEASON_WORDS + TIME_PERIOD_WORDS:
            cleaned = cleaned.replace(word, "")
        media_terms: List[str] = []
        for hint, term in _MEDIA_HINTS.items():
            if hint in text and term not in media_terms:
                media_terms.append(term)
        for noun in _GENERIC_NOUNS:
            cleaned = cleaned.replace(noun, "")
        cleaned = re.sub(r"[的和与在]$", "", cleaned.strip())
        cleaned = re.sub(r"\s+", " ", cleaned).strip(" ，。,.!？?的")

        payload = {
            "search_text": cleaned,
            "retrieval_mode": None,  # inferred by the normalizer
            "media_terms": media_terms,
            "identity_terms": [],
            "strict_identity_filter": False,
            "intent_mode": "open",
            "intent_contract": {},
            "contract_satisfied": True,
        }
        return self.normalize_intent_payload(
            payload,
            user_query=user_query,
            time_hint=time_hint,
            season=season,
            time_period=time_period,
        )

    def _format_remote(self, user_query: str) -> Dict[str, Any]:
        current_time = self._now().strftime("%Y-%m-%d")
        system_message = (
            f"当前时间是 {current_time}。\n"
            "你是照片搜索查询理解器，把用户 query 解析成结构化检索意图 JSON。"
            "输出字段固定为 search_text, retrieval_mode, media_terms, identity_terms, "
            "strict_identity_filter, intent_mode, intent_contract, time_hint, season, time_period。\n"
            "原则：search_text 表达正确结果里应该能直接看到什么，可保守归纳但不能编造；"
            "名字、称呼、编号等放 identity_terms；媒介/载体词放 media_terms；"
            "retrieval_mode 默认 hybrid，只有纯过滤需求才用 filter_only；"
            "strict_identity_filter 只在用户明确要求必须是本人时为 true；"
            "intent_mode 只能是 strict 或 open，明确不可替换目标时用 strict；"
            'intent_contract 格式 {"core_target":"","must_keep":[],"avoid_drift":""}；'
            "time_hint 保留原始时间表达；season 和 time_period 做结构化归纳。"
            "只返回 JSON，不要解释。"
        )
        prompt = (
            '输出 JSON：{"search_text":"","retrieval_mode":"hybrid","media_terms":[],'
            '"identity_terms":[],"strict_identity_filter":false,"intent_mode":"open",'
            '"intent_contract":{"core_target":"","must_keep":[],"avoid_drift":""},'
            '"time_hint":null,"season":null,"time_period":null}\n'
            "抽取规则：删除礼貌词、任务词和空泛检索词（帮我找、给我看、搜索、照片、图片等）；"
            "如果 query 同时包含时间和画面内容，search_text 只保留画面内容；"
            "缺少稳定视觉目标且本质是过滤条件时 search_text 允许为空。\n"
            f"用户 query: {user_query}"
        )
        for attempt in range(self.max_retries):
            try:
                response = create_chat_completion(
                    self.client,
                    model=self.model_name,
                    messages=[
                        {"role": "system", "content": system_message},
                        {"role": "user", "content": prompt},
                    ],
                    temperature=0,
                    response_format={"type": "json_object"},
                    timeout=self.timeout,
                    reasoning_effort=self.reasoning_effort,
                )
                payload = parse_json_object(extract_response_text(response))
                return self.normalize_intent_payload(
                    payload,
                    user_query=user_query,
                    time_hint=payload.get("time_hint"),
                    season=payload.get("season"),
                    time_period=payload.get("time_period"),
                )
            except Exception:
                if attempt == self.max_retries - 1:
                    return self._fallback_intent(user_query)
                time.sleep(1)
        return self._fallback_intent(user_query)

    # ------------------------------------------------------------------
    # expand_query_intents
    # ------------------------------------------------------------------
    def expand_query_intents(
        self,
        user_query: str,
        base_intent: Dict[str, Any],
        max_alternatives: int = 2,
    ) -> List[Dict[str, Any]]:
        if self.backend == "local":
            return self._expand_local(user_query, base_intent, max_alternatives)
        current_time = self._now().strftime("%Y-%m-%d")
        system_message = (
            f"当前时间是 {current_time}。你是照片搜索的第二轮查询扩写器。"
            "在第一轮检索偏弱时，给出少量更容易召回的替代检索意图；"
            "围绕原意做保守补充，不得偏题，不得虚构。只返回 JSON："
            '{"alternatives":[{"search_text":"","retrieval_mode":"hybrid","media_terms":[],'
            '"identity_terms":[],"strict_identity_filter":false,"intent_mode":"open",'
            '"intent_contract":{"core_target":"","must_keep":[],"avoid_drift":""},'
            '"contract_satisfied":true,"reason":""}]}'
        )
        prompt = (
            f"用户原始查询：{user_query}\n"
            f"第一轮意图：{json.dumps(base_intent, ensure_ascii=False)}\n"
            f"请生成不超过 {max_alternatives} 个替代检索意图。"
            "必须显式判断替代意图是否仍遵守第一轮 intent_contract（contract_satisfied）；"
            "strict 模式下必须保留 core_target 和 must_keep。只返回 JSON。"
        )
        for attempt in range(self.max_retries):
            try:
                response = create_chat_completion(
                    self.client,
                    model=self.model_name,
                    messages=[
                        {"role": "system", "content": system_message},
                        {"role": "user", "content": prompt},
                    ],
                    temperature=0,
                    response_format={"type": "json_object"},
                    timeout=self.timeout,
                    reasoning_effort=self.reasoning_effort,
                )
                payload = parse_json_object(extract_response_text(response))
                alternatives = payload.get("alternatives") or []
                normalized: List[Dict[str, Any]] = []
                for item in alternatives[:max_alternatives]:
                    if isinstance(item, dict):
                        normalized.append(
                            self.normalize_intent_payload(
                                item,
                                user_query=user_query,
                                time_hint=base_intent.get("time_hint"),
                                season=base_intent.get("season"),
                                time_period=base_intent.get("time_period"),
                                base_intent=base_intent,
                            )
                        )
                return normalized
            except Exception:
                if attempt == self.max_retries - 1:
                    break
                time.sleep(1)
        return []

    def _expand_local(
        self, user_query: str, base_intent: Dict[str, Any], max_alternatives: int
    ) -> List[Dict[str, Any]]:
        """One conservative alternative: base text plus media terms inlined."""
        if max_alternatives <= 0:
            return []
        search_text = str(base_intent.get("search_text") or "").strip()
        media_terms = list(base_intent.get("media_terms") or [])
        pieces = [p for p in [search_text] + media_terms if p]
        if not pieces:
            return []
        alt_text = " ".join(dict.fromkeys(pieces))
        if alt_text == search_text:
            return []
        payload = {
            "search_text": alt_text,
            "media_terms": media_terms,
            "identity_terms": list(base_intent.get("identity_terms") or []),
            "strict_identity_filter": bool(base_intent.get("strict_identity_filter", False)),
            "intent_mode": base_intent.get("intent_mode"),
            "contract_satisfied": True,
            "reason": "本地保守扩写：并入媒介词",
        }
        return [
            self.normalize_intent_payload(
                payload,
                user_query=user_query,
                time_hint=base_intent.get("time_hint"),
                season=base_intent.get("season"),
                time_period=base_intent.get("time_period"),
                base_intent=base_intent,
            )
        ]

    # ------------------------------------------------------------------
    # reflect_on_weak_results
    # ------------------------------------------------------------------
    def reflect_on_weak_results(
        self,
        user_query: str,
        base_intent: Dict[str, Any],
        weak_results: List[Dict[str, Any]],
    ) -> Dict[str, Any]:
        if self.backend == "local":
            return {}  # the local planner has no reflection signal
        current_time = self._now().strftime("%Y-%m-%d")
        summaries = []
        for item in (weak_results or [])[:5]:
            summaries.append(
                {
                    "photo_path": item.get("photo_path"),
                    "score": item.get("score"),
                    "match_summary": item.get("match_summary") or {},
                }
            )
        system_message = (
            f"当前时间是 {current_time}。你是照片搜索的第三轮反思器。"
            "当前几轮结果偏弱时，分析为什么没搜准，并给出一个更稳健的单一改进意图；"
            "不得偏题，不得引入用户未表达的新人物或场景；"
            "允许在更宽或更窄之间做一次保守调整。只返回 JSON："
            '{"search_text":"","retrieval_mode":"hybrid","media_terms":[],"identity_terms":[],'
            '"strict_identity_filter":false,"intent_mode":"open",'
            '"intent_contract":{"core_target":"","must_keep":[],"avoid_drift":""},'
            '"contract_satisfied":true,"reason":""}；'
            "如果没有值得尝试的改进，返回 {}。"
        )
        prompt = (
            f"用户原始查询：{user_query}\n"
            f"当前意图：{json.dumps(base_intent, ensure_ascii=False)}\n"
            f"当前弱结果摘要：{json.dumps(summaries, ensure_ascii=False)}\n"
            "只返回 JSON。"
        )
        for attempt in range(self.max_retries):
            try:
                response = create_chat_completion(
                    self.client,
                    model=self.model_name,
                    messages=[
                        {"role": "system", "content": system_message},
                        {"role": "user", "content": prompt},
                    ],
                    temperature=0,
                    response_format={"type": "json_object"},
                    timeout=self.timeout,
                    reasoning_effort=self.reasoning_effort,
                )
                payload = parse_json_object(extract_response_text(response))
                if not payload or not isinstance(payload, dict):
                    return {}
                if not str(payload.get("search_text") or "").strip() and not payload.get(
                    "identity_terms"
                ):
                    return {}
                return self.normalize_intent_payload(
                    payload,
                    user_query=user_query,
                    time_hint=base_intent.get("time_hint"),
                    season=base_intent.get("season"),
                    time_period=base_intent.get("time_period"),
                    base_intent=base_intent,
                )
            except Exception:
                if attempt == self.max_retries - 1:
                    break
                time.sleep(1)
        return {}
