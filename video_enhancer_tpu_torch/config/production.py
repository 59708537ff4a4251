"""Production configuration from the environment.

Counterpart of video_enhancer_tpu/config/production.py, with the same
fields, variables, defaults and ``validate()``, less ``jax_cache_dir``
(``$VETPU_JAX_CACHE``): torch has no compile cache to point, and the port's
kernel library is already kept between starts in ``kernels.BUILD_DIR``,
named by a hash of its sources.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["ProductionConfig"]


def _env(name: str, default, cast=str):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes")
    return cast(raw)


@dataclasses.dataclass(frozen=True)
class ProductionConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    workers: int = 1
    data_dir: str = "data"
    max_file_bytes: int = 10 * 1024**3  # 10GB (reference production.py)
    require_auth: bool = False
    log_dir: str | None = None
    structured_logs: bool = True
    sentry_dsn: str | None = None  # hook only; nothing is sent
    mesh_data: int = 1
    mesh_time: int = 1
    mesh_space: int = 1

    @classmethod
    def from_env(cls) -> "ProductionConfig":
        return cls(
            host=_env("VETPU_HOST", "0.0.0.0"),
            port=_env("VETPU_PORT", 8000, int),
            workers=_env("VETPU_WORKERS", 1, int),
            data_dir=_env("VETPU_DATA_DIR", "data"),
            max_file_bytes=_env("VETPU_MAX_FILE_BYTES", 10 * 1024**3, int),
            require_auth=_env("VETPU_REQUIRE_AUTH", False, bool),
            log_dir=_env("VETPU_LOG_DIR", None),
            structured_logs=_env("VETPU_STRUCTURED_LOGS", True, bool),
            sentry_dsn=_env("SENTRY_DSN", None),
            mesh_data=_env("VETPU_MESH_DATA", 1, int),
            mesh_time=_env("VETPU_MESH_TIME", 1, int),
            mesh_space=_env("VETPU_MESH_SPACE", 1, int),
        )

    def validate(self) -> list[str]:
        errors = []
        if not (1 <= self.port <= 65535):
            errors.append(f"invalid port {self.port}")
        if self.workers < 1:
            errors.append("workers must be >= 1")
        if self.max_file_bytes < 1024:
            errors.append("max_file_bytes too small")
        return errors
