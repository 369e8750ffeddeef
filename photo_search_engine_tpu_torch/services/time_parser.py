"""Time-constraint detection and extraction.

Behavior-parity target: reference utils/time_parser.py —
* ``LOCAL_TIME_HINTS`` keyword gate + any-digit rule (time_parser.py:22-94)
* ``detect_time_terms(query, strategy)``: ``local_first`` (default) uses
  only the local gate; ``always`` additionally asks the model
  ``{"has_time_constraint": bool}`` (96-141)
* ``extract_time_constraints`` → ``{start_date, end_date, precision}``
  ISO dates; seasons/time-of-day words alone must NOT produce a date
  range (prompt rule, 160-162)
* ``_infer_precision`` from the day span (196-212).

Added for offline/TPU-local operation: ``backend="local"`` — a
deterministic rule-based parser for Chinese relative/absolute time
expressions (今天/昨天/去年/上周/2023年7月/…), used whenever no LLM
endpoint is configured.  Same output contract.
"""

from __future__ import annotations

import json
import re
import time
from datetime import date, datetime, timedelta
from typing import Any, Callable, Dict, Optional

from photo_search_engine_tpu_torch.services.llm_compat import (
    OpenAIHttpClient,
    create_chat_completion,
    extract_response_text,
    normalize_openai_base_url,
    requires_api_key,
    resolve_api_key,
)

_EMPTY: Dict[str, Any] = {"start_date": None, "end_date": None, "precision": "none"}

_SEASON_MONTHS = {
    "春天": (3, 5),
    "夏天": (6, 8),
    "秋天": (9, 11),
    "冬天": (12, 2),  # spans the year boundary
}


def _month_end(year: int, month: int) -> date:
    if month == 12:
        return date(year, 12, 31)
    return date(year, month + 1, 1) - timedelta(days=1)


class TimeParser:
    """Detect and extract structured time constraints from a query."""

    LOCAL_TIME_HINTS = (
        "今天", "昨天", "前天", "明天", "后天",
        "今年", "去年", "前年", "明年",
        "上周", "这周", "下周",
        "上个月", "这个月", "下个月",
        "最近",
        "春天", "夏天", "秋天", "冬天",
        "凌晨", "早晨", "上午", "中午", "下午", "傍晚", "夜晚",
        "周一", "周二", "周三", "周四", "周五", "周六", "周日", "星期",
    )

    def __init__(
        self,
        api_key: str = "",
        model_name: str = "",
        base_url: str = "",
        reasoning_effort: str = "low",
        timeout: int = 10,
        max_retries: int = 3,
        client: Optional[Any] = None,
        backend: str = "auto",
        now_fn: Optional[Callable[[], datetime]] = None,
    ) -> None:
        self.backend = (backend or "auto").strip().lower()
        if self.backend == "auto":
            self.backend = "openai" if (base_url or client) else "local"
        if self.backend == "openai" and requires_api_key(base_url) and not api_key and client is None:
            raise ValueError("TIME_PARSE_API_KEY is not set")
        resolved = resolve_api_key(api_key, base_url)
        self.api_key = resolved
        self.model_name = model_name
        self.base_url = normalize_openai_base_url(base_url)
        self.reasoning_effort = reasoning_effort
        self.timeout = timeout
        self.max_retries = max(1, max_retries)
        self._now = now_fn or datetime.now
        if self.backend == "openai":
            self.client = client or OpenAIHttpClient(resolved, self.base_url, timeout)
        else:
            self.client = client

    # ------------------------------------------------------------------
    # Detection
    # ------------------------------------------------------------------
    @classmethod
    def has_local_time_terms(cls, query: str) -> bool:
        text = str(query or "").strip()
        if not text:
            return False
        if any(hint in text for hint in cls.LOCAL_TIME_HINTS):
            return True
        return any(ch.isdigit() for ch in text)

    def has_time_terms(self, query: str) -> bool:
        return bool(query and query.strip()) and self.has_local_time_terms(query)

    def needs_remote_parse(self, query: str, strategy: str = "local_first") -> bool:
        if str(strategy or "local_first").strip().lower() == "always":
            return True
        return self.has_local_time_terms(query)

    def detect_time_terms(self, query: str, strategy: str = "local_first") -> bool:
        if not query or not query.strip():
            return False
        if not self.needs_remote_parse(query, strategy=strategy):
            return False
        if str(strategy or "local_first").strip().lower() != "always":
            return True
        if self.backend != "openai":
            return self.has_local_time_terms(query)
        prompt = (
            f"当前日期：{self._now().strftime('%Y-%m-%d')}\n\n用户查询：{query}\n\n"
            '请判断这个查询是否包含时间约束，只返回 JSON：{"has_time_constraint": true 或 false}。'
            "相对时间、绝对时间、季节、时段都算时间约束；没有时间语义就返回 false。"
        )
        for attempt in range(self.max_retries):
            try:
                response = create_chat_completion(
                    self.client,
                    model=self.model_name,
                    messages=[{"role": "user", "content": prompt}],
                    temperature=0,
                    response_format={"type": "json_object"},
                    timeout=self.timeout,
                    reasoning_effort=self.reasoning_effort,
                )
                payload = json.loads(extract_response_text(response))
                return bool(payload.get("has_time_constraint"))
            except Exception:
                if attempt == self.max_retries - 1:
                    break
                time.sleep(1)
        return False

    # ------------------------------------------------------------------
    # Extraction
    # ------------------------------------------------------------------
    def extract_time_constraints(
        self, query: str, strategy: str = "local_first"
    ) -> Dict[str, Any]:
        # the caller's configured strategy must reach this gate too: with
        # strategy="always" the remote detector may say True for queries
        # with no LOCAL_TIME_HINTS words, and re-detecting here with the
        # default would veto the extraction it just paid for
        if not self.detect_time_terms(query, strategy=strategy):
            return dict(_EMPTY)
        if self.backend == "openai":
            result = self._extract_remote(query)
        else:
            result = self._extract_local(query)
        return result

    def _extract_remote(self, query: str) -> Dict[str, Any]:
        prompt = (
            f"当前日期：{self._now().strftime('%Y-%m-%d')}\n\n用户查询：{query}\n\n"
            "请只返回 JSON：\n"
            '{"has_time_constraint": true, "start_date": "YYYY-MM-DD" 或 null, '
            '"end_date": "YYYY-MM-DD" 或 null}\n'
            "规则：1. 只有明确年份、月份、日期或相对时间时才返回日期范围。"
            "2. 仅出现季节词或时段词但没有年份限定时，不生成日期范围。"
            "3. 返回内容必须是合法 JSON。"
        )
        for attempt in range(self.max_retries):
            try:
                response = create_chat_completion(
                    self.client,
                    model=self.model_name,
                    messages=[{"role": "user", "content": prompt}],
                    temperature=0,
                    response_format={"type": "json_object"},
                    timeout=self.timeout,
                    reasoning_effort=self.reasoning_effort,
                )
                payload = json.loads(extract_response_text(response))
                if not payload.get("has_time_constraint"):
                    return dict(_EMPTY)
                start = payload.get("start_date")
                end = payload.get("end_date")
                return {
                    "start_date": start,
                    "end_date": end,
                    "precision": self.infer_precision(start, end),
                }
            except Exception:
                if attempt == self.max_retries - 1:
                    break
                time.sleep(1)
        return dict(_EMPTY)

    # -- deterministic rule-based extraction ---------------------------
    def _extract_local(self, query: str) -> Dict[str, Any]:
        today = self._now().date()
        text = str(query or "")
        span = self._relative_day_span(text, today)
        if span is None:
            span = self._week_span(text, today)
        if span is None:
            span = self._month_span(text, today)
        if span is None:
            span = self._explicit_date_span(text, today)
        if span is None:
            span = self._year_span(text, today)
        if span is None and "最近" in text:
            span = (today - timedelta(days=30), today)
        if span is None:
            # season / time-period words alone: no date range (rule 2)
            return dict(_EMPTY)
        start, end = span
        start_iso, end_iso = start.isoformat(), end.isoformat()
        return {
            "start_date": start_iso,
            "end_date": end_iso,
            "precision": self.infer_precision(start_iso, end_iso),
        }

    @staticmethod
    def _relative_day_span(text: str, today: date):
        offsets = {"今天": 0, "昨天": -1, "前天": -2, "明天": 1, "后天": 2}
        for word, offset in offsets.items():
            if word in text:
                day = today + timedelta(days=offset)
                return day, day
        return None

    @staticmethod
    def _week_span(text: str, today: date):
        shifts = {"上周": -1, "这周": 0, "下周": 1}
        for word, weeks in shifts.items():
            if word in text:
                monday = today - timedelta(days=today.weekday()) + timedelta(weeks=weeks)
                return monday, monday + timedelta(days=6)
        return None

    @staticmethod
    def _month_span(text: str, today: date):
        shifts = {"上个月": -1, "这个月": 0, "下个月": 1}
        for word, months in shifts.items():
            if word in text:
                month = today.month + months
                year = today.year
                if month < 1:
                    month += 12
                    year -= 1
                elif month > 12:
                    month -= 12
                    year += 1
                return date(year, month, 1), _month_end(year, month)
        return None

    def _year_span(self, text: str, today: date):
        shifts = {"前年": -2, "去年": -1, "今年": 0, "明年": 1}
        year = None
        for word, offset in shifts.items():
            if word in text:
                year = today.year + offset
                break
        if year is None:
            match = re.search(r"(19|20)\d{2}\s*年", text)
            if match:
                year = int(match.group(0).rstrip("年").strip())
        if year is None:
            return None
        season = next((s for s in _SEASON_MONTHS if s in text), None)
        if season:
            first_month, last_month = _SEASON_MONTHS[season]
            if season == "冬天":  # Dec..Feb of the next year
                return date(year, 12, 1), _month_end(year + 1, 2)
            return date(year, first_month, 1), _month_end(year, last_month)
        return date(year, 1, 1), date(year, 12, 31)

    @staticmethod
    def _relative_year(text: str, today: date) -> int:
        """Year implied by a relative-year word, defaulting to this year —
        "去年3月" must resolve the month against LAST year, not today's."""
        for word, offset in (("前年", -2), ("去年", -1), ("明年", 1), ("今年", 0)):
            if word in text:
                return today.year + offset
        return today.year

    @classmethod
    def _explicit_date_span(cls, text: str, today: date):
        full = re.search(r"((?:19|20)\d{2})\s*年\s*(\d{1,2})\s*月\s*(\d{1,2})\s*日", text)
        if full:
            try:
                day = date(int(full.group(1)), int(full.group(2)), int(full.group(3)))
                return day, day
            except ValueError:
                return None
        iso = re.search(r"((?:19|20)\d{2})-(\d{1,2})-(\d{1,2})", text)
        if iso:
            try:
                day = date(int(iso.group(1)), int(iso.group(2)), int(iso.group(3)))
                return day, day
            except ValueError:
                return None
        year_month = re.search(r"((?:19|20)\d{2})\s*年\s*(\d{1,2})\s*月", text)
        if year_month:
            year, month = int(year_month.group(1)), int(year_month.group(2))
            if 1 <= month <= 12:
                return date(year, month, 1), _month_end(year, month)
            return None
        # month (+ optional day) without a 4-digit year: the year comes
        # from any relative-year word ("去年3月", "明年2月") or this year
        month_day = re.search(r"(?<![\d])(\d{1,2})\s*月\s*(\d{1,2})\s*日", text)
        if month_day:
            month, day = int(month_day.group(1)), int(month_day.group(2))
            try:
                d = date(cls._relative_year(text, today), month, day)
                return d, d
            except ValueError:
                return None
        bare_month = re.search(r"(?<![\d])(\d{1,2})\s*月", text)
        if bare_month:
            month = int(bare_month.group(1))
            if 1 <= month <= 12:
                year = cls._relative_year(text, today)
                return date(year, month, 1), _month_end(year, month)
        return None

    # ------------------------------------------------------------------
    @staticmethod
    def infer_precision(start_date: Optional[str], end_date: Optional[str]) -> str:
        """Day-span → precision bucket (reference time_parser.py:196-212)."""
        if not start_date or not end_date:
            return "none"
        try:
            start = datetime.fromisoformat(start_date)
            end = datetime.fromisoformat(end_date)
        except Exception:
            return "none"
        delta = end - start
        if end.year != start.year:
            return "season" if delta.days <= 95 else "range"
        if delta.days <= 31:
            return "month"
        if delta.days <= 95:
            return "season"
        return "year"
