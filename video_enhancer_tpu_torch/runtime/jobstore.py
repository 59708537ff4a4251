"""Persistent job store (sqlite): a copy of
video_enhancer_tpu/runtime/jobstore.py (standard library only).

The reference keeps jobs in an in-memory dict and loses them on restart
(reference api/v1/process_endpoints.py:66-68, acknowledged at
api/main.py:566-574). Jobs here persist in sqlite with the same record
shape, so a server restart resumes with full job history.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
import uuid
from pathlib import Path

__all__ = ["JobStore", "JobStatus"]


class JobStatus:
    QUEUED = "queued"
    ANALYZING = "analyzing"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id TEXT PRIMARY KEY,
    status TEXT NOT NULL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    record TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_jobs_created ON jobs (created_at);
"""


class JobStore:
    def __init__(self, path: str | Path = "data/jobs.sqlite"):
        self.path = str(path)
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        with self._conn() as c:
            c.executescript(_SCHEMA)

    def _conn(self):
        conn = sqlite3.connect(self.path, timeout=10)
        conn.row_factory = sqlite3.Row
        return conn

    def create(self, record: dict, job_id: str | None = None) -> str:
        job_id = job_id or uuid.uuid4().hex
        now = time.time()
        record = {**record, "job_id": job_id, "created_at": now,
                  "status": record.get("status", JobStatus.QUEUED)}
        with self._lock, self._conn() as c:
            c.execute(
                "INSERT INTO jobs VALUES (?,?,?,?,?)",
                (job_id, record["status"], now, now, json.dumps(record)),
            )
        return job_id

    def update(self, job_id: str, **fields) -> dict | None:
        with self._lock, self._conn() as c:
            row = c.execute("SELECT record FROM jobs WHERE job_id=?",
                            (job_id,)).fetchone()
            if row is None:
                return None
            record = json.loads(row["record"])
            record.update(fields)
            record["updated_at"] = time.time()
            c.execute(
                "UPDATE jobs SET status=?, updated_at=?, record=? "
                "WHERE job_id=?",
                (record.get("status", JobStatus.QUEUED),
                 record["updated_at"], json.dumps(record), job_id),
            )
            return record

    def get(self, job_id: str) -> dict | None:
        with self._conn() as c:
            row = c.execute("SELECT record FROM jobs WHERE job_id=?",
                            (job_id,)).fetchone()
            return json.loads(row["record"]) if row else None

    def list(self, status: str | None = None, limit: int = 100,
             offset: int = 0) -> list[dict]:
        q = "SELECT record FROM jobs"
        args: tuple = ()
        if status:
            q += " WHERE status=?"
            args = (status,)
        q += " ORDER BY created_at DESC LIMIT ? OFFSET ?"
        with self._conn() as c:
            rows = c.execute(q, args + (limit, offset)).fetchall()
            return [json.loads(r["record"]) for r in rows]

    def delete(self, job_id: str) -> bool:
        with self._lock, self._conn() as c:
            cur = c.execute("DELETE FROM jobs WHERE job_id=?", (job_id,))
            return cur.rowcount > 0

    def counts(self) -> dict:
        with self._conn() as c:
            rows = c.execute(
                "SELECT status, COUNT(*) AS n FROM jobs GROUP BY status"
            ).fetchall()
            return {r["status"]: r["n"] for r in rows}

    def count_since(self, age_sec: float, client: str | None = None) -> int:
        """Jobs created in the window (per-client quota accounting)."""
        cutoff = time.time() - age_sec
        with self._conn() as c:
            if client is None:
                row = c.execute(
                    "SELECT COUNT(*) AS n FROM jobs WHERE created_at >= ?",
                    (cutoff,)).fetchone()
            else:
                row = c.execute(
                    "SELECT COUNT(*) AS n FROM jobs WHERE created_at >= ? "
                    "AND json_extract(record, '$.client') = ?",
                    (cutoff, client)).fetchone()
            return int(row["n"])

    def cleanup_older_than(self, age_sec: float) -> int:
        cutoff = time.time() - age_sec
        with self._lock, self._conn() as c:
            cur = c.execute(
                "DELETE FROM jobs WHERE created_at < ? AND status IN (?,?,?)",
                (cutoff, JobStatus.COMPLETED, JobStatus.FAILED,
                 JobStatus.CANCELLED),
            )
            return cur.rowcount
