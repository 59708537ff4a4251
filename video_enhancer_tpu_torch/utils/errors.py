"""Error classification + structured handling (standard library only).

Counterpart of video_enhancer_tpu/utils/errors.py: the codes, the five
exception classes with their codes, the classifier, the handler with its
stats, ``handle_exceptions`` and ``create_error_response`` (which the
server's router calls).

Re-creates the reference error subsystem (reference utils/error_handler.py):
``ErrorCode`` families SYS/INPUT/MODEL/PROC/AGENT/API/VAL/SEC (:36-97), an
exception hierarchy (:110-178), a handler that classifies, produces user
messages + suggestions and keeps stats (:180-383), an ``@handle_exceptions``
decorator (:385-423) and HTTP-response formatting (:425+).
"""

from __future__ import annotations

import collections
import enum
import functools
import logging
import threading
import traceback
from typing import Any

log = logging.getLogger(__name__)

__all__ = ["ErrorCode", "VideoEnhancerError", "InputError", "ModelError",
           "ProcessingError", "ResourceError", "SecurityError",
           "ErrorHandler", "get_error_handler", "handle_exceptions",
           "create_error_response"]


class ErrorCode(str, enum.Enum):
    # system
    SYS_UNKNOWN = "SYS_000"
    SYS_OUT_OF_MEMORY = "SYS_001"
    SYS_DEVICE_UNAVAILABLE = "SYS_002"
    SYS_DISK_FULL = "SYS_003"
    SYS_TIMEOUT = "SYS_004"
    # input
    INPUT_NOT_FOUND = "INPUT_001"
    INPUT_CORRUPT = "INPUT_002"
    INPUT_UNSUPPORTED_FORMAT = "INPUT_003"
    INPUT_TOO_LARGE = "INPUT_004"
    INPUT_TOO_SMALL = "INPUT_005"
    # model
    MODEL_NOT_AVAILABLE = "MODEL_001"
    MODEL_LOAD_FAILED = "MODEL_002"
    MODEL_COMPILE_FAILED = "MODEL_003"
    MODEL_FORWARD_FAILED = "MODEL_004"
    MODEL_WEIGHTS_MISSING = "MODEL_005"
    # processing
    PROC_FAILED = "PROC_001"
    PROC_CANCELLED = "PROC_002"
    PROC_QUALITY_GATE = "PROC_003"
    PROC_ENCODE_FAILED = "PROC_004"
    # agent
    AGENT_UNAVAILABLE = "AGENT_001"
    AGENT_REJECTED = "AGENT_002"
    AGENT_TIMEOUT = "AGENT_003"
    # api
    API_NOT_FOUND = "API_404"
    API_CONFLICT = "API_409"
    API_BAD_REQUEST = "API_400"
    # validation
    VAL_INVALID_PARAMS = "VAL_001"
    VAL_INVALID_FILE = "VAL_002"
    # security
    SEC_UNAUTHORIZED = "SEC_401"
    SEC_FORBIDDEN = "SEC_403"
    SEC_RATE_LIMITED = "SEC_429"
    SEC_THREAT_DETECTED = "SEC_001"


_HTTP_STATUS = {
    "SYS": 500, "INPUT": 400, "MODEL": 503, "PROC": 500,
    "AGENT": 503, "API": 400, "VAL": 422, "SEC": 403,
}

_SUGGESTIONS = {
    ErrorCode.SYS_OUT_OF_MEMORY: [
        "reduce tile size or chunk length",
        "use a stricter latency class (smaller model)",
    ],
    ErrorCode.INPUT_UNSUPPORTED_FORMAT: [
        "convert to mp4 (h264/mp4v) before uploading",
    ],
    ErrorCode.INPUT_CORRUPT: [
        "re-encode the file; verify it plays locally",
    ],
    ErrorCode.MODEL_NOT_AVAILABLE: [
        "check enabled models via /api/v1/strategies",
        "a fallback model was likely used",
    ],
    ErrorCode.PROC_QUALITY_GATE: [
        "escalate to a higher-quality model (vsrm/seedvr2)",
    ],
    ErrorCode.SEC_RATE_LIMITED: ["retry after the rate window resets"],
}


class VideoEnhancerError(Exception):
    code: ErrorCode = ErrorCode.SYS_UNKNOWN

    def __init__(self, message: str, code: ErrorCode | None = None,
                 details: dict | None = None):
        super().__init__(message)
        if code is not None:
            self.code = code
        self.details = details or {}


class InputError(VideoEnhancerError):
    code = ErrorCode.INPUT_CORRUPT


class ModelError(VideoEnhancerError):
    code = ErrorCode.MODEL_FORWARD_FAILED


class ProcessingError(VideoEnhancerError):
    code = ErrorCode.PROC_FAILED


class ResourceError(VideoEnhancerError):
    code = ErrorCode.SYS_OUT_OF_MEMORY


class SecurityError(VideoEnhancerError):
    code = ErrorCode.SEC_THREAT_DETECTED


def classify_exception(exc: BaseException) -> ErrorCode:
    """Map arbitrary exceptions to an ErrorCode (reference
    error_handler.py:180-280 classification)."""
    if isinstance(exc, VideoEnhancerError):
        return exc.code
    name = type(exc).__name__
    msg = str(exc).lower()
    if isinstance(exc, FileNotFoundError) or "no such file" in msg:
        return ErrorCode.INPUT_NOT_FOUND
    if isinstance(exc, (IOError, OSError)) and "cannot open video" in msg:
        return ErrorCode.INPUT_CORRUPT
    if "out of memory" in msg or "resource exhausted" in msg or \
            name == "OutOfMemoryError":
        return ErrorCode.SYS_OUT_OF_MEMORY
    if isinstance(exc, TimeoutError) or "timeout" in msg:
        return ErrorCode.SYS_TIMEOUT
    if isinstance(exc, (ValueError, TypeError)):
        return ErrorCode.VAL_INVALID_PARAMS
    if isinstance(exc, KeyError) and "model" in msg:
        return ErrorCode.MODEL_NOT_AVAILABLE
    if isinstance(exc, ImportError):
        return ErrorCode.MODEL_NOT_AVAILABLE
    return ErrorCode.SYS_UNKNOWN


class ErrorHandler:
    def __init__(self, history: int = 1000):
        self._lock = threading.Lock()
        self._counts: collections.Counter = collections.Counter()
        self._recent: collections.deque = collections.deque(maxlen=history)

    def handle_error(self, exc: BaseException, context: str = "",
                     reraise: bool = False) -> dict:
        code = classify_exception(exc)
        record = {
            "code": code.value,
            "type": type(exc).__name__,
            "message": str(exc),
            "context": context,
            "suggestions": _SUGGESTIONS.get(code, []),
            "traceback": traceback.format_exc(limit=5),
        }
        with self._lock:
            self._counts[code.value] += 1
            self._recent.append({k: record[k] for k in
                                 ("code", "type", "message", "context")})
        log.error("[%s] %s: %s (%s)", code.value, type(exc).__name__,
                  exc, context)
        if reraise:
            raise exc
        return record

    def get_stats(self) -> dict:
        with self._lock:
            return {
                "total_errors": sum(self._counts.values()),
                "by_code": dict(self._counts),
                "recent": list(self._recent)[-20:],
            }


_handler: ErrorHandler | None = None
_handler_lock = threading.Lock()


def get_error_handler() -> ErrorHandler:
    global _handler
    with _handler_lock:
        if _handler is None:
            _handler = ErrorHandler()
        return _handler


def handle_exceptions(context: str = "", default: Any = None,
                      reraise: bool = False):
    """Decorator: an exception of the wrapped call is recorded by the
    shared handler (``context``, else the function's qualified name) and
    ``default`` returned, or re-raised with ``reraise`` (reference
    error_handler.py:385-423)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                get_error_handler().handle_error(
                    e, context or fn.__qualname__, reraise=reraise)
                return default

        return wrapped

    return deco


def create_error_response(exc: BaseException, context: str = "") -> tuple[dict, int]:
    """(body, http_status) for the API layer (reference error_handler.py:425+,
    api/main.py:178-285 exception handlers)."""
    record = get_error_handler().handle_error(exc, context)
    family = record["code"].split("_")[0]
    status = _HTTP_STATUS.get(family, 500)
    body = {"error": {k: record[k] for k in
                      ("code", "message", "suggestions")}}
    return body, status
