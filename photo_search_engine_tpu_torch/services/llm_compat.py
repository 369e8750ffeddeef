"""OpenAI-compatible LLM plumbing, SDK-free.

Behavior-parity target: reference utils/llm_compat.py —
* Ollama URL detection + keyless auth (llm_compat.py:8-37)
* base-URL ``/v1`` normalization (40-53)
* per-provider image-content payload shape (56-59)
* deep recursive response-text extraction across response shapes (62-161)
* ``create_chat_completion`` with progressive parameter degradation:
  {response_format + reasoning_effort} → {response_format} →
  {reasoning_effort} → bare (164-220).

Because the openai SDK is not a dependency here, ``OpenAIHttpClient``
implements the two SDK surfaces the framework uses
(``client.chat.completions.create`` and ``client.embeddings.create``)
over plain HTTP; services accept any object with that shape (tests inject
``unittest.mock.Mock``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional
from unittest.mock import Mock
from urllib.parse import urlparse

try:
    import requests
except ImportError:  # pragma: no cover
    requests = None

_LOCAL_OLLAMA_HOSTS = {"localhost", "127.0.0.1", "0.0.0.0", "host.docker.internal"}
_TEXTY_KEYS = ("output_text", "parsed", "json", "text", "content", "message", "choices", "output")


# ---------------------------------------------------------------------------
# URL / auth helpers
# ---------------------------------------------------------------------------

def is_local_ollama_base_url(base_url: str) -> bool:
    parsed = urlparse((base_url or "").strip())
    host = (parsed.hostname or "").lower()
    return host in _LOCAL_OLLAMA_HOSTS and parsed.port in {None, 11434}


def is_ollama_base_url(base_url: str) -> bool:
    parsed = urlparse((base_url or "").strip())
    host = (parsed.hostname or "").lower()
    return is_local_ollama_base_url(base_url) or host.endswith("ollama.com")


def requires_api_key(base_url: str) -> bool:
    return not is_local_ollama_base_url(base_url)


def resolve_api_key(api_key: str, base_url: str) -> str:
    if api_key:
        return api_key
    return "ollama" if is_local_ollama_base_url(base_url) else ""


def normalize_openai_base_url(base_url: str) -> str:
    normalized = (base_url or "").strip().rstrip("/")
    if not normalized or not is_ollama_base_url(normalized):
        return normalized
    if normalized.endswith("/v1"):
        return normalized
    if normalized.endswith("/api"):
        return normalized[: -len("/api")] + "/v1"
    if urlparse(normalized).path in {"", "/"}:
        return normalized + "/v1"
    return normalized


def build_image_url_content(image_url: str, base_url: str) -> Dict[str, Any]:
    if is_ollama_base_url(base_url):
        return {"type": "image_url", "image_url": image_url}
    return {"type": "image_url", "image_url": {"url": image_url}}


# ---------------------------------------------------------------------------
# Response-text extraction
# ---------------------------------------------------------------------------

def safe_get_attr(value: Any, name: str) -> Any:
    if value is None:
        return None
    if isinstance(value, dict):
        return value.get(name)
    if isinstance(value, Mock):  # Mock auto-creates attrs; read real ones only
        return vars(value).get(name)
    return getattr(value, name, None)


def extract_text_from_content(content: Any) -> str:
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if isinstance(content, bytes):
        return content.decode("utf-8", errors="ignore")
    if isinstance(content, dict):
        for key in ("text",):
            if isinstance(content.get(key), str):
                return content[key]
        for key in ("parsed", "json"):
            if isinstance(content.get(key), dict):
                return str(content[key])
        nested = content.get("content")
        if isinstance(nested, str):
            return nested
        if nested is not None:
            return extract_text_from_content(nested)
        return str(content)
    if isinstance(content, list):
        parts = [extract_text_from_content(item) for item in content]
        return "\n".join(p for p in parts if p).strip()
    text_attr = safe_get_attr(content, "text")
    if isinstance(text_attr, str):
        return text_attr
    nested = safe_get_attr(content, "content")
    if nested is not None:
        return extract_text_from_content(nested)
    return str(content)


def _collect_candidates(value: Any, depth: int, seen: set) -> List[str]:
    if value is None or depth > 6 or id(value) in seen:
        return []
    seen.add(id(value))
    if isinstance(value, str):
        stripped = value.strip()
        return [stripped] if stripped else []
    if isinstance(value, bytes):
        return _collect_candidates(value.decode("utf-8", errors="ignore"), depth + 1, seen)
    out: List[str] = []
    if isinstance(value, dict):
        for key in _TEXTY_KEYS:
            if key in value:
                out.extend(_collect_candidates(value[key], depth + 1, seen))
        for key, item in value.items():
            if key not in _TEXTY_KEYS:
                out.extend(_collect_candidates(item, depth + 1, seen))
        return out
    if isinstance(value, list):
        for item in value:
            out.extend(_collect_candidates(item, depth + 1, seen))
        return out
    dump = safe_get_attr(value, "model_dump")
    if callable(dump) and not isinstance(value, Mock):
        try:
            out.extend(_collect_candidates(dump(), depth + 1, seen))
        except Exception:
            pass
    for attr in _TEXTY_KEYS:
        attr_value = safe_get_attr(value, attr)
        if attr_value is not None:
            out.extend(_collect_candidates(attr_value, depth + 1, seen))
    return out


def extract_response_text(response: Any) -> str:
    """Deep extraction of the assistant text from any response shape."""
    if response is None:
        raise ValueError("empty model response")
    for candidate in _collect_candidates(response, 0, set()):
        extracted = extract_text_from_content(candidate).strip()
        if extracted:
            return extracted
    raise ValueError(f"cannot extract response text from {type(response).__name__}")


# ---------------------------------------------------------------------------
# Progressive-degradation chat call
# ---------------------------------------------------------------------------

def create_chat_completion(
    client: Any,
    *,
    model: str,
    messages: List[Dict[str, Any]],
    timeout: int,
    temperature: Optional[float] = None,
    response_format: Optional[Dict[str, Any]] = None,
    reasoning_effort: Optional[str] = None,
    max_tokens: Optional[int] = None,
) -> Any:
    """Try the richest parameter set first, degrading for strict gateways
    (reference llm_compat.py:164-220)."""
    base: Dict[str, Any] = {"model": model, "messages": messages, "timeout": timeout}
    if temperature is not None:
        base["temperature"] = temperature
    if max_tokens is not None:
        base["max_tokens"] = max_tokens

    attempts: List[Dict[str, Any]] = []
    if response_format is not None or reasoning_effort:
        richest = dict(base)
        if response_format is not None:
            richest["response_format"] = response_format
        if reasoning_effort:
            richest["extra_body"] = {"reasoning_effort": reasoning_effort}
        attempts.append(richest)
    if response_format is not None:
        attempts.append({**base, "response_format": response_format})
    if reasoning_effort:
        attempts.append({**base, "extra_body": {"reasoning_effort": reasoning_effort}})
    attempts.append(dict(base))

    last_error: Optional[Exception] = None
    tried = set()
    for kwargs in attempts:
        signature = tuple(sorted(kwargs))
        if signature in tried:
            continue
        tried.add(signature)
        try:
            return client.chat.completions.create(**kwargs)
        except Exception as exc:  # vendor-specific failure shapes
            last_error = exc
            # parameter degradation exists for strict gateways that REJECT
            # a parameter shape; a timeout/connection failure will fail the
            # same way for every shape — retrying the remaining shapes
            # multiplies a 45s hang by 4 (and callers retry on top)
            name = type(exc).__name__.lower()
            if "timeout" in name or "connection" in name:
                raise
    if last_error is not None:
        raise last_error
    raise ValueError("chat completion failed")


# ---------------------------------------------------------------------------
# Minimal OpenAI-compatible HTTP client (SDK replacement)
# ---------------------------------------------------------------------------

class _Endpoint:
    def __init__(self, client: "OpenAIHttpClient", path: str):
        self._client = client
        self._path = path

    def create(self, **kwargs: Any) -> Dict[str, Any]:
        return self._client.post_json(self._path, kwargs)


class _ChatNamespace:
    def __init__(self, client: "OpenAIHttpClient"):
        self.completions = _Endpoint(client, "/chat/completions")


class OpenAIHttpClient:
    """Tiny requests-backed stand-in for the openai SDK client.

    Exposes ``chat.completions.create(**kw)`` and ``embeddings.create(**kw)``
    returning the decoded JSON dict (which ``extract_response_text`` and the
    embedding service both understand).
    """

    def __init__(self, api_key: str, base_url: str, timeout: int = 60) -> None:
        if requests is None:  # pragma: no cover
            raise ImportError("requests is required for HTTP LLM backends")
        self.api_key = api_key or ""
        self.base_url = (base_url or "").rstrip("/")
        self.default_timeout = timeout
        self.chat = _ChatNamespace(self)
        self.embeddings = _Endpoint(self, "/embeddings")

    def post_json(self, path: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        payload = dict(payload)
        timeout = payload.pop("timeout", self.default_timeout)
        extra_body = payload.pop("extra_body", None)
        if isinstance(extra_body, dict):
            payload.update(extra_body)
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        response = requests.post(
            f"{self.base_url}{path}",
            headers=headers,
            data=json.dumps(payload),
            timeout=timeout,
        )
        response.raise_for_status()
        return response.json()
