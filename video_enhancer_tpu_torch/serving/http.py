"""Minimal HTTP routing layer over the stdlib ThreadingHTTPServer: a copy
of video_enhancer_tpu/serving/http.py (standard library only).

Features used by the API surface: path parameters (``/job/{id}``), JSON
bodies, multipart/form-data file uploads, query strings, per-request timing
header (the reference adds X-Process-Time middleware, api/main.py:152-175),
CORS + GZip middleware (reference api/main.py:139-149), an early
Content-Length cap (bodies larger than ``Router.max_body`` are rejected with
413 *before* being buffered), and structured error responses.
"""

from __future__ import annotations

import email
import email.policy
import gzip
import json
import re
import threading
import time
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

__all__ = ["Request", "Response", "Router", "serve"]


class Request:
    def __init__(self, method: str, path: str, query: dict, headers: dict,
                 body: bytes, path_params: dict | None = None,
                 client: str = ""):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.path_params = path_params or {}
        self.client = client

    def json(self) -> Any:
        return json.loads(self.body or b"{}")

    def multipart(self) -> dict[str, Any]:
        """Parse multipart/form-data into {name: bytes|str, ...} with
        ``(filename, data)`` tuples for file fields."""
        ctype = self.headers.get("content-type", "")
        if "multipart/form-data" not in ctype:
            raise ValueError("not multipart")
        raw = (
            b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + self.body
        )
        msg = email.message_from_bytes(raw, policy=email.policy.HTTP)
        out: dict[str, Any] = {}
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if name is None:
                continue
            filename = part.get_filename()
            payload = part.get_payload(decode=True)
            if filename:
                out[name] = (filename, payload)
            else:
                out[name] = payload.decode("utf-8", "replace")
        return out


class Response:
    def __init__(self, body: Any = None, status: int = 200,
                 headers: dict | None = None, content_type: str | None = None):
        self.status = status
        self.headers = dict(headers or {})
        if isinstance(body, (dict, list)):
            self.data = json.dumps(body, default=str).encode()
            self.headers.setdefault("Content-Type", "application/json")
        elif isinstance(body, bytes):
            self.data = body
            self.headers.setdefault(
                "Content-Type", content_type or "application/octet-stream")
        elif body is None:
            self.data = b""
        else:
            self.data = str(body).encode()
            self.headers.setdefault("Content-Type", "text/plain")
        if content_type:
            self.headers["Content-Type"] = content_type


CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, POST, PUT, DELETE, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type, X-API-Key",
}
GZIP_MIN_BYTES = 512
GZIP_TYPES = ("application/json", "text/")


class Router:
    # Largest acceptable request body: the 500MB upload cap plus multipart
    # framing overhead. Checked against Content-Length before reading.
    max_body = 500 * 1024 * 1024 + 64 * 1024

    def __init__(self):
        self.routes: list[tuple[str, re.Pattern, Callable]] = []
        self.middleware: list[Callable] = []

    def route(self, method: str, pattern: str):
        regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
        )

        def deco(fn):
            self.routes.append((method.upper(), regex, fn))
            return fn

        return deco

    def get(self, pattern):
        return self.route("GET", pattern)

    def post(self, pattern):
        return self.route("POST", pattern)

    def delete(self, pattern):
        return self.route("DELETE", pattern)

    def dispatch(self, req: Request) -> Response:
        for mw in self.middleware:
            resp = mw(req)
            if resp is not None:
                return resp
        for method, regex, fn in self.routes:
            if method != req.method:
                continue
            m = regex.match(req.path)
            if m:
                req.path_params = m.groupdict()
                try:
                    return fn(req)
                except Exception as e:
                    traceback.print_exc()
                    # Structured classification (reference api/main.py:178-285
                    # ErrorCode -> HTTP mapping).
                    from ..utils.errors import create_error_response

                    body, status = create_error_response(e, context=req.path)
                    return Response(body, status=status)
        return Response({"error": {"code": "API_404",
                                   "message": f"not found: {req.path}"}},
                        status=404)


def serve(router: Router, host: str = "0.0.0.0", port: int = 8000,
          background: bool = False):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _send(self, resp: Response, t0: float, accept_encoding: str = ""):
            data = resp.data
            ctype = resp.headers.get("Content-Type", "")
            if ("gzip" in accept_encoding and len(data) >= GZIP_MIN_BYTES
                    and ctype.startswith(GZIP_TYPES)
                    and "Content-Encoding" not in resp.headers):
                data = gzip.compress(data, compresslevel=5)
                resp.headers["Content-Encoding"] = "gzip"
            self.send_response(resp.status)
            resp.headers.update(CORS_HEADERS)
            resp.headers["X-Process-Time"] = f"{time.time() - t0:.4f}"
            resp.headers["Content-Length"] = str(len(data))
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _handle(self):
            t0 = time.time()
            parsed = urllib.parse.urlparse(self.path)
            query = {
                k: v[0]
                for k, v in urllib.parse.parse_qs(parsed.query).items()
            }
            length = int(self.headers.get("Content-Length") or 0)
            if length > router.max_body:
                # Reject oversized bodies before buffering them (the upload
                # size cap must not be a post-hoc check on a fully-read body).
                self.close_connection = True
                self._send(Response({"error": {
                    "code": "VAL_413",
                    "message": f"request body too large "
                               f"({length} > {router.max_body})"}}, 413), t0)
                return
            body = self.rfile.read(length) if length else b""
            req = Request(
                method=self.command,
                path=parsed.path,
                query=query,
                headers={k.lower(): v for k, v in self.headers.items()},
                body=body,
                client=self.client_address[0],
            )
            resp = router.dispatch(req)
            self._send(resp, t0,
                       self.headers.get("Accept-Encoding", "").lower())

        def do_OPTIONS(self):
            self._send(Response(None, status=204), time.time())

        do_GET = do_POST = do_DELETE = do_PUT = _handle

    server = ThreadingHTTPServer((host, port), Handler)
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return server
