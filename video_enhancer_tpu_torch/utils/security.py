"""Security facade: file validation, threat scanning, rate limiting.

A copy of video_enhancer_tpu/utils/security.py (standard library only)
without its encryption at rest: the JAX package's API server makes its
``SecurityManager`` with no protection manager, so no upload is encrypted
there either, and ``record_id`` is always None. It re-creates the
reference security pair (reference utils/file_security.py: magic-number
validation, extension/MIME cross-check, embedded-executable and
script-content scan, filename traversal checks :139-654; and
utils/security_integration.py: env-driven ``SecurityConfig``,
sliding-window rate limiting, ``validate_and_secure_file`` :268-330,
security event log :400-480).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import re
import threading
import time
from pathlib import Path

from .auth import RateLimiter

log = logging.getLogger(__name__)

__all__ = ["SecurityConfig", "SecurityThreat", "FileValidator",
           "SecurityManager"]

VIDEO_MAGIC = {
    ".mp4": (b"ftyp",),
    ".mov": (b"ftyp", b"moov"),
    ".avi": (b"RIFF",),
    ".mkv": (b"\x1a\x45\xdf\xa3",),
    ".webm": (b"\x1a\x45\xdf\xa3",),
}
EXEC_SIGNATURES = (b"MZ", b"\x7fELF", b"#!", b"<script", b"PK\x03\x04")
SCRIPT_PATTERNS = (rb"<\s*script", rb"eval\s*\(", rb"exec\s*\(",
                   rb"subprocess", rb"os\.system")


@dataclasses.dataclass
class SecurityConfig:
    """Env-driven toggles (reference security_integration.py:34-62)."""

    enable_file_validation: bool = True
    enable_threat_scan: bool = True
    enable_encryption: bool = False
    enable_rate_limiting: bool = True
    max_file_bytes: int = 500 * 1024 * 1024
    min_file_bytes: int = 1024
    # External scanner hook (reference file_security.py ClamAV option):
    # a command invoked as `<scanner_cmd...> <path>`; nonzero exit =
    # threat. E.g. VETPU_SCANNER_CMD="clamscan --no-summary".
    scanner_cmd: str = ""
    scanner_timeout_s: float = 30.0

    @classmethod
    def from_env(cls) -> "SecurityConfig":
        def flag(name, default):
            return os.environ.get(name, str(default)).lower() in (
                "1", "true", "yes")

        return cls(
            enable_file_validation=flag("VETPU_SEC_VALIDATE", True),
            enable_threat_scan=flag("VETPU_SEC_SCAN", True),
            enable_encryption=flag("VETPU_SEC_ENCRYPT", False),
            enable_rate_limiting=flag("VETPU_SEC_RATELIMIT", True),
            scanner_cmd=os.environ.get("VETPU_SCANNER_CMD", ""),
            scanner_timeout_s=float(
                os.environ.get("VETPU_SCANNER_TIMEOUT_S", "30")),
        )


@dataclasses.dataclass
class SecurityThreat:
    """(reference file_security.py:44-58)."""

    kind: str
    severity: str  # low | medium | high | critical
    detail: str


class FileValidator:
    def validate_filename(self, filename: str) -> list[SecurityThreat]:
        threats = []
        name = str(filename)
        if ".." in name or name.startswith(("/", "\\")) or ":" in name[1:3]:
            threats.append(SecurityThreat(
                "path_traversal", "critical",
                f"filename contains traversal components: {name!r}"))
        if re.search(r"[\x00-\x1f]", name):
            threats.append(SecurityThreat(
                "control_chars", "high", "filename has control characters"))
        return threats

    def validate_content(self, filename: str, data: bytes
                         ) -> list[SecurityThreat]:
        threats = []
        ext = Path(filename).suffix.lower()
        magics = VIDEO_MAGIC.get(ext)
        if magics is None:
            threats.append(SecurityThreat(
                "extension", "medium", f"unsupported extension {ext}"))
        elif not any(m in data[:64] for m in magics):
            threats.append(SecurityThreat(
                "magic_mismatch", "high",
                f"content does not match {ext} container signature"))
        head = data[:4096]
        for sig in EXEC_SIGNATURES:
            if head.startswith(sig):
                threats.append(SecurityThreat(
                    "embedded_executable", "critical",
                    f"file starts with executable signature {sig!r}"))
        for pat in SCRIPT_PATTERNS:
            if re.search(pat, head, re.IGNORECASE):
                threats.append(SecurityThreat(
                    "script_content", "high",
                    f"script-like content matched {pat!r}"))
        return threats


class SecurityManager:
    def __init__(self, config: SecurityConfig | None = None):
        self.config = config or SecurityConfig.from_env()
        self.validator = FileValidator()
        self.rate_limiter = RateLimiter(max_requests=120, window_sec=60)
        self._events: list[dict] = []
        self._lock = threading.Lock()
        # In-process pluggable scanners: fn(filename, data) ->
        # list[SecurityThreat]. register_scanner() appends; the env-driven
        # external command (config.scanner_cmd) is wired automatically.
        self._scanners: list = []
        if self.config.scanner_cmd:
            self._scanners.append(self._external_cmd_scanner)

    def register_scanner(self, fn) -> None:
        """Plug an extra threat scanner into the upload path (reference
        file_security.py's optional ClamAV hook, generalized). ``fn``
        receives (filename, data) and returns a list of SecurityThreat;
        scanner exceptions are logged and treated as a high-severity
        scan_error (fail closed)."""
        self._scanners.append(fn)

    def _external_cmd_scanner(self, filename: str,
                              data: bytes) -> list[SecurityThreat]:
        import shlex
        import subprocess
        import tempfile

        with tempfile.NamedTemporaryFile(
                suffix=Path(filename).suffix or ".bin") as tmp:
            tmp.write(data)
            tmp.flush()
            cmd = shlex.split(self.config.scanner_cmd) + [tmp.name]
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=self.config.scanner_timeout_s)
        if r.returncode != 0:
            return [SecurityThreat(
                "external_scanner", "critical",
                f"{cmd[0]} exit {r.returncode}: "
                f"{(r.stdout or r.stderr)[:200]}")]
        return []

    def _event(self, kind: str, **extra):
        with self._lock:
            self._events.append({"ts": time.time(), "kind": kind, **extra})
            self._events = self._events[-1000:]

    def check_rate_limit(self, client: str) -> bool:
        if not self.config.enable_rate_limiting:
            return True
        ok = self.rate_limiter.allow(client)
        if not ok:
            self._event("rate_limited", client=client)
        return ok

    def validate_and_secure_file(self, filename: str, data: bytes,
                                 client: str = "") -> dict:
        """validate -> scan (reference security_integration.py:268-330).
        Returns {ok, threats, record_id}; ``record_id`` is None (no
        encryption at rest)."""
        threats: list[SecurityThreat] = []
        if self.config.enable_file_validation:
            threats += self.validator.validate_filename(filename)
            if not (self.config.min_file_bytes <= len(data)
                    <= self.config.max_file_bytes):
                threats.append(SecurityThreat(
                    "size", "medium",
                    f"size {len(data)} outside allowed window"))
        if self.config.enable_threat_scan:
            threats += self.validator.validate_content(filename, data)
            for scanner in self._scanners:
                try:
                    threats += scanner(filename, data)
                except Exception as e:
                    log.warning("scanner %r failed: %s", scanner, e)
                    threats.append(SecurityThreat(
                        "scan_error", "high",
                        f"external scanner failed: {str(e)[:120]}"))

        blocking = [t for t in threats if t.severity in ("high", "critical")]
        if blocking:
            self._event("file_blocked", filename=filename,
                        threats=[t.kind for t in blocking], client=client)
            return {"ok": False,
                    "threats": [dataclasses.asdict(t) for t in threats]}

        self._event("file_accepted", filename=filename, client=client)
        return {"ok": True,
                "threats": [dataclasses.asdict(t) for t in threats],
                "record_id": None}

    def get_security_status(self) -> dict:
        with self._lock:
            events = list(self._events)
        counts: dict[str, int] = {}
        for e in events:
            counts[e["kind"]] = counts.get(e["kind"], 0) + 1
        return {"config": dataclasses.asdict(self.config),
                "event_counts": counts, "recent_events": events[-20:]}
