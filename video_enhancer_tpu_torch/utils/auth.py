"""API-key authentication: a copy of video_enhancer_tpu/utils/auth.py
(standard library only; the reference's utils/auth.py re-designed).

Salted-hash API keys persisted to JSON, roles (admin/user/service/readonly),
per-key sliding-window rate limits, failed-attempt IP lockout (reference
auth.py:85-401).
"""

from __future__ import annotations

import collections
import hashlib
import json
import secrets
import threading
import time
from pathlib import Path

__all__ = ["AuthManager", "RateLimiter"]

ROLES = ("admin", "user", "service", "readonly")
LOCKOUT_ATTEMPTS = 5
LOCKOUT_WINDOW = 300.0


class RateLimiter:
    """Sliding-window limiter (reference security_integration.py:76-117)."""

    def __init__(self, max_requests: int = 60, window_sec: float = 60.0):
        self.max_requests = max_requests
        self.window = window_sec
        self._hits: dict[str, collections.deque] = {}
        self._lock = threading.Lock()

    def allow(self, key: str, max_requests: int | None = None) -> bool:
        limit = self.max_requests if max_requests is None else max_requests
        now = time.time()
        with self._lock:
            dq = self._hits.setdefault(key, collections.deque())
            while dq and dq[0] < now - self.window:
                dq.popleft()
            if len(dq) >= limit:
                return False
            dq.append(now)
            return True


class AuthManager:
    def __init__(self, store_path: str | Path = "data/api_keys.json",
                 require_auth: bool = False):
        self.store_path = Path(store_path)
        self.require_auth = require_auth
        self._lock = threading.Lock()
        self._keys: dict[str, dict] = {}
        self._failed: dict[str, collections.deque] = {}
        self.rate_limiter = RateLimiter()
        self._load()

    def _load(self):
        if self.store_path.exists():
            try:
                self._keys = json.loads(self.store_path.read_text())
            except Exception:
                self._keys = {}

    def _save(self):
        self.store_path.parent.mkdir(parents=True, exist_ok=True)
        self.store_path.write_text(json.dumps(self._keys, indent=2))

    @staticmethod
    def _hash(key: str, salt: str) -> str:
        return hashlib.sha256((salt + key).encode()).hexdigest()

    # -- key CRUD (reference admin_endpoints.py surface) --------------------
    def create_key(self, name: str, role: str = "user",
                   rate_limit: int = 60, daily_quota: int = 200,
                   user: str | None = None) -> str:
        """``user`` is the owning ACCOUNT (defaults to the key name): the
        OAuth analog under zero egress (reference app.py:1124-1172 gates
        quota per HF login). Several keys may share one user, and quota
        aggregates per user, not per key."""
        if role not in ROLES:
            raise ValueError(f"invalid role {role}")
        key = "vetpu_" + secrets.token_urlsafe(32)
        salt = secrets.token_hex(8)
        with self._lock:
            self._keys[self._hash(key, salt)] = {
                "name": name, "role": role, "salt": salt,
                "user": user or name,
                "rate_limit": rate_limit, "daily_quota": daily_quota,
                "created_at": time.time(), "enabled": True, "uses": 0,
            }
            # store salt-indexed: we must be able to find records by key
            self._save()
        return key

    def list_keys(self) -> list[dict]:
        with self._lock:
            return [
                {k: v for k, v in rec.items() if k != "salt"}
                for rec in self._keys.values()
            ]

    def revoke_key(self, name: str) -> bool:
        with self._lock:
            for rec in self._keys.values():
                if rec["name"] == name and rec["enabled"]:
                    rec["enabled"] = False
                    self._save()
                    return True
        return False

    # -- authentication -----------------------------------------------------
    def _locked_out(self, ip: str) -> bool:
        dq = self._failed.get(ip)
        if not dq:
            return False
        now = time.time()
        while dq and dq[0] < now - LOCKOUT_WINDOW:
            dq.popleft()
        return len(dq) >= LOCKOUT_ATTEMPTS

    def authenticate(self, api_key: str | None, ip: str = "") -> dict | None:
        """Returns the key record or None; records failures per IP."""
        if self._locked_out(ip):
            return None
        if not api_key:
            if not self.require_auth:
                return {"name": "anonymous", "role": "user",
                        "rate_limit": 60}
            self._failed.setdefault(ip, collections.deque()).append(time.time())
            return None
        with self._lock:
            for hashed, rec in self._keys.items():
                if rec["enabled"] and \
                        self._hash(api_key, rec["salt"]) == hashed:
                    rec["uses"] += 1
                    return dict(rec)
        self._failed.setdefault(ip, collections.deque()).append(time.time())
        return None

    def check_rate(self, record: dict, ip: str) -> bool:
        """Enforce the record's own rate_limit; anonymous users are keyed
        by client IP so one anonymous client cannot exhaust the bucket for
        everyone."""
        name = record.get("name", "")
        key = f"ip:{ip}" if name in ("", "anonymous") else f"key:{name}"
        limit = int(record.get("rate_limit", 60))
        return self.rate_limiter.allow(key, max_requests=limit)
