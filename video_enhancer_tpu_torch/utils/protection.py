"""Data protection: encryption at rest + retention + audit log.

A copy of video_enhancer_tpu/utils/protection.py (plain Python). Fernet
comes from ``cryptography``, imported at the first encryption, as there:
without the package, storing or reading a record raises ImportError and
nothing else changes. It re-creates the reference data-protection layer
(reference utils/data_protection.py): Fernet ``EncryptionManager`` with a
key file (:94-189) and a manager keeping encrypted-at-rest records in an
indexed store with per-category retention, access/audit logging and secure
delete (:191-580).
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import time
import uuid
from pathlib import Path

log = logging.getLogger(__name__)

__all__ = ["EncryptionManager", "DataProtectionManager"]

RETENTION_POLICIES = {  # category -> seconds (reference :191-240)
    "uploads": 24 * 3600,
    "outputs": 7 * 24 * 3600,
    "logs": 30 * 24 * 3600,
    "permanent": None,
}


class EncryptionManager:
    def __init__(self, key_path: str | Path = "data/protection.key"):
        self.key_path = Path(key_path)
        self._fernet = None

    def _get(self):
        if self._fernet is None:
            from cryptography.fernet import Fernet

            if self.key_path.exists():
                key = self.key_path.read_bytes().strip()
            else:
                key = Fernet.generate_key()
                self.key_path.parent.mkdir(parents=True, exist_ok=True)
                self.key_path.write_bytes(key)
                os.chmod(self.key_path, 0o600)
            self._fernet = Fernet(key)
        return self._fernet

    def encrypt(self, data: bytes) -> bytes:
        return self._get().encrypt(data)

    def decrypt(self, token: bytes) -> bytes:
        return self._get().decrypt(token)


class DataProtectionManager:
    def __init__(self, root: str | Path = "data/protected",
                 key_path: str | Path | None = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.enc = EncryptionManager(key_path or self.root / "protection.key")
        self._index_path = self.root / "index.json"
        self._audit_path = self.root / "audit.log"

    def _index(self) -> dict:
        if self._index_path.exists():
            try:
                return json.loads(self._index_path.read_text())
            except Exception:
                return {}
        return {}

    def _save_index(self, idx: dict) -> None:
        self._index_path.write_text(json.dumps(idx, indent=2))

    def _audit(self, action: str, record_id: str, **extra) -> None:
        entry = {"ts": time.time(), "action": action,
                 "record_id": record_id, **extra}
        with open(self._audit_path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    # -- records ------------------------------------------------------------
    def store(self, data: bytes, category: str = "uploads",
              meta: dict | None = None) -> str:
        record_id = uuid.uuid4().hex
        blob = self.enc.encrypt(data)
        (self.root / f"{record_id}.bin").write_bytes(blob)
        idx = self._index()
        idx[record_id] = {
            "category": category,
            "created_at": time.time(),
            "size": len(data),
            "meta": meta or {},
        }
        self._save_index(idx)
        self._audit("store", record_id, category=category, size=len(data))
        return record_id

    def retrieve(self, record_id: str) -> bytes:
        blob = (self.root / f"{record_id}.bin").read_bytes()
        self._audit("retrieve", record_id)
        return self.enc.decrypt(blob)

    def secure_delete(self, record_id: str) -> bool:
        path = self.root / f"{record_id}.bin"
        if not path.exists():
            return False
        size = path.stat().st_size
        # Overwrite before unlink (reference multi-pass delete,
        # file_security.py secure temp handling).
        with open(path, "wb") as f:
            f.write(secrets.token_bytes(min(size, 1 << 20)))
        path.unlink()
        idx = self._index()
        idx.pop(record_id, None)
        self._save_index(idx)
        self._audit("delete", record_id)
        return True

    def cleanup_expired(self) -> int:
        idx = self._index()
        now = time.time()
        removed = 0
        for record_id, rec in list(idx.items()):
            ttl = RETENTION_POLICIES.get(rec["category"])
            if ttl is not None and now - rec["created_at"] > ttl:
                if self.secure_delete(record_id):
                    removed += 1
        return removed

    def get_audit_log(self, limit: int = 100) -> list[dict]:
        if not self._audit_path.exists():
            return []
        lines = self._audit_path.read_text().strip().splitlines()
        return [json.loads(x) for x in lines[-limit:]]
