"""Ordered model fallback hierarchies.

Counterpart of video_enhancer_tpu/runtime/fallback.py: for each requested
model an ordered list of candidates (``FALLBACK_HIERARCHIES``, a copy of
:22-31), and ``ModelFallbackManager.load_model_with_fallbacks``, which builds
the first candidate that builds within the timeout while the host keeps its
free-memory floor (``psutil`` when installed; without it the check passes,
as in the JAX package) and records every attempt in its history. A model
the port does not serve yet (realesrgan) fails its build like any other
failed build: the attempt is recorded and the next candidate tried.
Handlers are built on ``device`` (the card unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

import logging
import threading
import time

import torch

log = logging.getLogger(__name__)

__all__ = ["ModelFallbackManager", "FALLBACK_HIERARCHIES"]

FALLBACK_HIERARCHIES: dict[str, list[str]] = {
    "vsrm": ["vsrm", "rvrt", "fast_mamba_vsr", "realesrgan", "cnn_upscaler",
             "bicubic"],
    "fast_mamba_vsr": ["fast_mamba_vsr", "realesrgan", "cnn_upscaler",
                       "bicubic"],
    "seedvr2": ["seedvr2", "ditvr", "vsrm", "cnn_upscaler", "bicubic"],
    "ditvr": ["ditvr", "seedvr2", "vsrm", "cnn_upscaler", "bicubic"],
    "rvrt": ["rvrt", "vsrm", "cnn_upscaler", "bicubic"],
    "realesrgan": ["realesrgan", "cnn_upscaler", "bicubic"],
    "cnn_upscaler": ["cnn_upscaler", "bicubic"],
    "bicubic": ["bicubic"],
}


class ModelFallbackManager:
    def __init__(self, policy=None, min_free_host_gb: float = 2.0,
                 build_timeout_sec: float = 600.0,
                 device: str | torch.device | None = None):
        self.policy = policy
        self.min_free_host_gb = min_free_host_gb
        self.build_timeout_sec = build_timeout_sec
        self.device = device
        self.history: list[dict] = []
        self._lock = threading.Lock()

    def _memory_ok(self) -> bool:
        try:
            import psutil

            return psutil.virtual_memory().available >= \
                self.min_free_host_gb * 1024**3
        except Exception:
            return True

    def _build_with_timeout(self, name: str):
        from .registry import build_handler

        result: dict = {}

        def target():
            try:
                result["handler"] = build_handler(name, self.policy,
                                                  device=self.device)
            except Exception as e:
                result["error"] = e

        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join(self.build_timeout_sec)
        if t.is_alive():
            raise TimeoutError(f"building {name} exceeded "
                               f"{self.build_timeout_sec}s")
        if "error" in result:
            raise result["error"]
        return result["handler"]

    def load_model_with_fallbacks(self, model_type: str):
        """Return (handler, name_used). Tries each candidate in order."""
        candidates = FALLBACK_HIERARCHIES.get(model_type,
                                              [model_type, "bicubic"])
        errors = []
        for name in candidates:
            if not self._memory_ok():
                errors.append(f"{name}: host memory below "
                              f"{self.min_free_host_gb}GB floor")
                continue
            t0 = time.time()
            try:
                handler = self._build_with_timeout(name)
                with self._lock:
                    self.history.append({
                        "requested": model_type, "used": name,
                        "sec": time.time() - t0, "ok": True,
                    })
                if name != model_type:
                    log.warning("model %s unavailable; using fallback %s",
                                model_type, name)
                return handler, name
            except Exception as e:
                errors.append(f"{name}: {e}")
                with self._lock:
                    self.history.append({
                        "requested": model_type, "used": name,
                        "sec": time.time() - t0, "ok": False,
                        "error": str(e),
                    })
        raise RuntimeError(
            f"no model available for {model_type}: {'; '.join(errors)}")

    def get_history(self, limit: int = 50) -> list[dict]:
        with self._lock:
            return list(self.history)[-limit:]
