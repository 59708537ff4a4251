"""Storage management + retention: video_enhancer_tpu/runtime/storage.py
without its checksum index and emergency cleanup, which no caller of the
port uses (standard library only).

Re-creates the reference storage pair (reference utils/storage_manager.py:
data/{outputs,temp,uploads,cache,metadata} dirs, policy->retention map, size
limits, checksum index, cleanup-by-size, usage/integrity/maintenance
:71-623; and utils/storage_retention.py: glob+age+size retention rules with
priorities, dry-run, emergency cleanup :50-579).
"""

from __future__ import annotations

import dataclasses
import logging
import shutil
import time
from pathlib import Path

log = logging.getLogger(__name__)

__all__ = ["RetentionRule", "StorageManager", "DEFAULT_RULES"]


@dataclasses.dataclass
class RetentionRule:
    """Glob + age/size limits (reference storage_retention.py:50-61)."""

    name: str
    pattern: str
    max_age_sec: float | None = None
    max_total_bytes: int | None = None
    priority: int = 0  # higher priority rules run first


DEFAULT_RULES = [
    RetentionRule("temp", "temp/**/*", max_age_sec=12 * 3600, priority=10),
    RetentionRule("uploads", "uploads/**/*", max_age_sec=24 * 3600,
                  priority=5),
    RetentionRule("outputs_age", "outputs/**/*", max_age_sec=7 * 24 * 3600,
                  priority=1),
    RetentionRule("outputs_size", "outputs/**/*",
                  max_total_bytes=10 * 1024**3, priority=0),
]


class StorageManager:
    SUBDIRS = ("outputs", "temp", "uploads", "cache", "metadata")

    def __init__(self, root: str | Path = "data",
                 rules: list[RetentionRule] | None = None):
        self.root = Path(root)
        for sub in self.SUBDIRS:
            (self.root / sub).mkdir(parents=True, exist_ok=True)
        self.rules = sorted(rules or DEFAULT_RULES,
                            key=lambda r: -r.priority)

    # -- usage --------------------------------------------------------------
    def get_usage(self) -> dict:
        usage = {}
        total = 0
        for sub in self.SUBDIRS:
            size = sum(
                f.stat().st_size
                for f in (self.root / sub).rglob("*") if f.is_file()
            )
            usage[sub] = size
            total += size
        free = shutil.disk_usage(self.root).free
        return {"by_dir": usage, "total_bytes": total, "disk_free": free}

    # -- retention ----------------------------------------------------------
    def apply_retention(self, dry_run: bool = False) -> dict:
        report = {}
        for rule in self.rules:
            files = sorted(
                (f for f in self.root.glob(rule.pattern) if f.is_file()),
                key=lambda f: f.stat().st_mtime,
            )
            to_delete = []
            now = time.time()
            if rule.max_age_sec is not None:
                to_delete += [f for f in files
                              if now - f.stat().st_mtime > rule.max_age_sec]
            if rule.max_total_bytes is not None:
                total = sum(f.stat().st_size for f in files)
                i = 0
                while total > rule.max_total_bytes and i < len(files):
                    f = files[i]
                    if f not in to_delete:
                        to_delete.append(f)
                        total -= f.stat().st_size
                    i += 1
            freed = sum(f.stat().st_size for f in to_delete)
            if not dry_run:
                for f in to_delete:
                    f.unlink(missing_ok=True)
            report[rule.name] = {"deleted": len(to_delete),
                                 "freed_bytes": freed, "dry_run": dry_run}
        return report

    def run_maintenance(self) -> dict:
        return {
            "retention": self.apply_retention(),
            "usage": self.get_usage(),
        }
