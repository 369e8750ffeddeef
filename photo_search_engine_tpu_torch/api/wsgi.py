"""Minimal WSGI micro-framework (stdlib only).

Provides just enough of a Flask-like surface for the photo-search routes:
path routing with methods, JSON body parsing, query strings, multipart
file uploads (email-parser based, works on Python 3.12 where cgi is
gone), JSON/bytes responses, and a test client.
"""

from __future__ import annotations

import io
import json
from email.parser import BytesParser
from email.policy import HTTP as HTTP_POLICY
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote

_STATUS_TEXT = {
    200: "OK",
    400: "Bad Request",
    403: "Forbidden",
    404: "Not Found",
    405: "Method Not Allowed",
    409: "Conflict",
    500: "Internal Server Error",
}


class UploadedFile:
    def __init__(self, filename: str, content: bytes) -> None:
        self.filename = filename
        self.content = content

    def save_to(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.content)


class Request:
    def __init__(self, environ: Dict[str, Any]) -> None:
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "/")
        # keep_blank_values: "?path=" must surface as {"path": ""} like
        # Flask/werkzeug, not vanish
        self.query: Dict[str, str] = {
            k: v[0]
            for k, v in parse_qs(
                environ.get("QUERY_STRING", ""), keep_blank_values=True
            ).items()
        }
        self.content_type = environ.get("CONTENT_TYPE", "")
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        stream = environ.get("wsgi.input")
        self.body = stream.read(length) if (stream and length) else b""
        self._form: Optional[Dict[str, str]] = None
        self._files: Optional[Dict[str, UploadedFile]] = None

    # ------------------------------------------------------------------
    def get_json(self, silent: bool = False) -> Optional[Dict[str, Any]]:
        """JSON-object body, or None for an EMPTY body.  Malformed or
        non-object JSON raises ValueError unless ``silent`` (Flask
        semantics — handlers' ValueError→400 mapping turns it into a
        client error instead of conflating it with 'no body')."""
        if not self.body:
            return None
        try:
            data = json.loads(self.body.decode("utf-8"))
        except Exception:
            if silent:
                return None
            raise ValueError("请求体必须为JSON格式")
        if not isinstance(data, dict):
            if silent:
                return None
            raise ValueError("请求体必须为JSON对象")
        return data

    def _parse_form(self) -> None:
        self._form = {}
        self._files = {}
        ctype = self.content_type or ""
        if ctype.startswith("multipart/form-data"):
            header = (
                b"Content-Type: " + ctype.encode("utf-8") + b"\r\n"
                b"MIME-Version: 1.0\r\n\r\n"
            )
            message = BytesParser(policy=HTTP_POLICY).parsebytes(header + self.body)
            for part in message.iter_parts():
                name = part.get_param("name", header="content-disposition")
                if not name:
                    continue
                filename = part.get_filename()
                payload = part.get_payload(decode=True) or b""
                if filename:
                    self._files[name] = UploadedFile(filename, payload)
                else:
                    self._form[name] = payload.decode("utf-8", errors="replace")
        elif ctype.startswith("application/x-www-form-urlencoded"):
            for key, values in parse_qs(self.body.decode("utf-8", errors="replace")).items():
                self._form[key] = values[0]

    @property
    def form(self) -> Dict[str, str]:
        if self._form is None:
            self._parse_form()
        return self._form

    @property
    def files(self) -> Dict[str, UploadedFile]:
        if self._files is None:
            self._parse_form()
        return self._files


class Response:
    def __init__(
        self,
        body: bytes = b"",
        status: int = 200,
        content_type: str = "text/plain; charset=utf-8",
        headers: Optional[List[Tuple[str, str]]] = None,
    ) -> None:
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = headers or []


def json_response(payload: Any, status: int = 200) -> Response:
    return Response(
        json.dumps(payload, ensure_ascii=False).encode("utf-8"),
        status=status,
        content_type="application/json; charset=utf-8",
    )


def _coerce(result: Any) -> Response:
    if isinstance(result, Response):
        return result
    if isinstance(result, tuple):
        payload, status = result
        if isinstance(payload, (dict, list)):
            return json_response(payload, status)
        if isinstance(payload, str):
            return Response(payload.encode("utf-8"), status=status)
        return Response(bytes(payload), status=status)
    if isinstance(result, (dict, list)):
        return json_response(result)
    if isinstance(result, str):
        return Response(result.encode("utf-8"))
    return Response(bytes(result))


class App:
    """Route table + WSGI callable."""

    def __init__(self) -> None:
        self._routes: Dict[str, Dict[str, Callable[[Request], Any]]] = {}
        self._error_handlers: Dict[int, Callable[[Request], Any]] = {}

    def route(self, path: str, methods: Optional[List[str]] = None):
        methods = [m.upper() for m in (methods or ["GET"])]

        def decorator(handler: Callable[[Request], Any]):
            table = self._routes.setdefault(path, {})
            for method in methods:
                table[method] = handler
            return handler

        return decorator

    def errorhandler(self, status: int):
        def decorator(handler: Callable[[Request], Any]):
            self._error_handlers[status] = handler
            return handler

        return decorator

    def _error(self, request: Request, status: int) -> Response:
        handler = self._error_handlers.get(status)
        if handler is not None:
            return _coerce(handler(request))
        return json_response({"status": "error", "message": _STATUS_TEXT.get(status, "error")}, status)

    # ------------------------------------------------------------------
    def __call__(self, environ, start_response):
        request = Request(environ)
        table = self._routes.get(request.path)
        if table is None:
            response = self._error(request, 404)
        elif request.method not in table:
            response = self._error(request, 405)
        else:
            try:
                response = _coerce(table[request.method](request))
            except Exception:
                import traceback

                traceback.print_exc()
                response = self._error(request, 500)
        status_line = f"{response.status} {_STATUS_TEXT.get(response.status, 'OK')}"
        headers = [
            ("Content-Type", response.content_type),
            ("Content-Length", str(len(response.body))),
        ] + response.headers
        start_response(status_line, headers)
        return [response.body]

    # ------------------------------------------------------------------
    def test_client(self) -> "TestClient":
        return TestClient(self)


class TestClient:
    """In-process WSGI test client (no socket)."""

    def __init__(self, app: App) -> None:
        self.app = app

    def request(
        self,
        method: str,
        path: str,
        *,
        json_body: Any = None,
        data: Optional[Dict[str, Any]] = None,
        files: Optional[Dict[str, Tuple[str, bytes]]] = None,
    ) -> "TestResponse":
        query = ""
        if "?" in path:
            path, query = path.split("?", 1)
        body = b""
        content_type = ""
        if json_body is not None:
            body = json.dumps(json_body, ensure_ascii=False).encode("utf-8")
            content_type = "application/json"
        elif files is not None or data is not None:
            boundary = "testboundary123456"
            chunks: List[bytes] = []
            for key, value in (data or {}).items():
                chunks.append(
                    (
                        f"--{boundary}\r\nContent-Disposition: form-data; "
                        f'name="{key}"\r\n\r\n{value}\r\n'
                    ).encode("utf-8")
                )
            for key, (filename, content) in (files or {}).items():
                chunks.append(
                    (
                        f"--{boundary}\r\nContent-Disposition: form-data; "
                        f'name="{key}"; filename="{filename}"\r\n'
                        "Content-Type: application/octet-stream\r\n\r\n"
                    ).encode("utf-8")
                    + content
                    + b"\r\n"
                )
            chunks.append(f"--{boundary}--\r\n".encode("utf-8"))
            body = b"".join(chunks)
            content_type = f"multipart/form-data; boundary={boundary}"
        environ = {
            "REQUEST_METHOD": method.upper(),
            "PATH_INFO": unquote(path),
            "QUERY_STRING": query,
            "CONTENT_TYPE": content_type,
            "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body),
        }
        captured: Dict[str, Any] = {}

        def start_response(status_line: str, headers: List[Tuple[str, str]]):
            captured["status"] = int(status_line.split(" ", 1)[0])
            captured["headers"] = headers

        chunks = self.app(environ, start_response)
        return TestResponse(captured["status"], captured["headers"], b"".join(chunks))

    def get(self, path: str, **kw) -> "TestResponse":
        return self.request("GET", path, **kw)

    def post(self, path: str, **kw) -> "TestResponse":
        return self.request("POST", path, **kw)


class TestResponse:
    def __init__(self, status: int, headers: List[Tuple[str, str]], body: bytes) -> None:
        self.status_code = status
        self.headers = dict(headers)
        self.data = body

    def get_json(self) -> Any:
        return json.loads(self.data.decode("utf-8"))
