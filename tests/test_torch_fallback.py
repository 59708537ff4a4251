"""The port's fallback hierarchies and ``ModelFallbackManager`` against the
JAX package's, on the CPU: the tables, the order of attempts and their ok
flags, the models the port does not serve yet, the build timeout and the
host-memory floor."""

from __future__ import annotations

import time

import pytest

from video_enhancer_tpu.runtime import fallback as jfallback
from video_enhancer_tpu.runtime import registry as jregistry
from video_enhancer_tpu_torch.runtime import fallback as tfallback
from video_enhancer_tpu_torch.runtime import registry


def _attempts(manager):
    return [(h["requested"], h["used"], h["ok"])
            for h in manager.get_history()]


def test_hierarchies_match_jax():
    assert tfallback.FALLBACK_HIERARCHIES == jfallback.FALLBACK_HIERARCHIES


def test_rvrt_is_served_first():
    jm = jfallback.ModelFallbackManager()
    _, jname = jm.load_model_with_fallbacks("rvrt")
    tm = tfallback.ModelFallbackManager(device="cpu")
    handler, name = tm.load_model_with_fallbacks("rvrt")
    assert name == jname == "rvrt"
    assert _attempts(tm) == _attempts(jm) == [("rvrt", "rvrt", True)]
    assert handler.name == "rvrt" and handler.device.type == "cpu"
    assert (handler.scale, handler.chunk, handler.overlap) == (4, 7, 4)


def test_failed_rvrt_build_lands_on_vsrm(monkeypatch):
    def failing(real):
        def build(name, *a, **kw):
            if name == "rvrt":
                raise RuntimeError("rvrt failed on purpose")
            return real(name, *a, **kw)
        return build

    monkeypatch.setattr(jregistry, "build_handler",
                        failing(jregistry.build_handler))
    monkeypatch.setattr(registry, "build_handler",
                        failing(registry.build_handler))
    jm = jfallback.ModelFallbackManager()
    _, jname = jm.load_model_with_fallbacks("rvrt")
    tm = tfallback.ModelFallbackManager(device="cpu")
    handler, name = tm.load_model_with_fallbacks("rvrt")
    assert name == jname == "vsrm" and handler.name == "vsrm"
    assert _attempts(tm) == _attempts(jm) == [("rvrt", "rvrt", False),
                                              ("rvrt", "vsrm", True)]
    assert tm.get_history()[0]["error"] == "rvrt failed on purpose"


@pytest.mark.parametrize("requested,used", [("seedvr2", "ditvr"),
                                            ("realesrgan", "cnn_upscaler"),
                                            ("nonexistent", "bicubic")])
def test_unserved_models_fail_their_build_and_fall_through(requested, used):
    """A model the port does not serve yet fails its build as the
    reference's failed builds do, and the next candidate is tried."""
    tm = tfallback.ModelFallbackManager(device="cpu")
    handler, name = tm.load_model_with_fallbacks(requested)
    assert name == used and handler.name == used
    assert _attempts(tm) == [(requested, requested, False),
                             (requested, used, True)]
    assert "the port serves" in tm.get_history()[0]["error"]


def test_build_timeout_moves_on(monkeypatch):
    real = registry.build_handler

    def slow(name, *a, **kw):
        if name == "cnn_upscaler":
            time.sleep(2.0)
        return real(name, *a, **kw)

    monkeypatch.setattr(registry, "build_handler", slow)
    tm = tfallback.ModelFallbackManager(build_timeout_sec=0.5, device="cpu")
    handler, name = tm.load_model_with_fallbacks("cnn_upscaler")
    assert name == "bicubic" and handler.scale == 2
    assert "exceeded" in tm.get_history()[0]["error"]


def test_memory_floor_and_exhaustion(monkeypatch):
    tm = tfallback.ModelFallbackManager(device="cpu")
    monkeypatch.setattr(tm, "_memory_ok", lambda: False)
    with pytest.raises(RuntimeError, match="host memory below"):
        tm.load_model_with_fallbacks("rvrt")
    assert tm.get_history() == []
    monkeypatch.setattr(registry, "build_handler",
                        lambda *a, **kw: (_ for _ in ()).throw(
                            RuntimeError("no")))
    tm = tfallback.ModelFallbackManager(device="cpu")
    with pytest.raises(RuntimeError, match="no model available for rvrt"):
        tm.load_model_with_fallbacks("rvrt")
    assert [ok for _, _, ok in _attempts(tm)] == [False] * 4
