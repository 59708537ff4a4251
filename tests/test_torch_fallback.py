"""The port's fallback hierarchies and ``ModelFallbackManager`` against the
JAX package's, on the CPU: the tables, the order of attempts and their ok
flags, the models the port does not serve yet, the build timeout and the
host-memory floor."""

from __future__ import annotations

import dataclasses
import time

import jax
import pytest

from video_enhancer_tpu.runtime import fallback as jfallback
from video_enhancer_tpu.runtime import registry as jregistry
from video_enhancer_tpu_torch.config import default_policy
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


def test_seedvr2_is_served_first(monkeypatch):
    """seedvr2 builds in both packages on its first attempt. (The JAX
    package's init is taken as shapes only: its registry fills every leaf
    from the bundled checkpoint, and the eager random init takes ~30 s on
    the CPU.)"""
    from video_enhancer_tpu.models import seedvr2 as jseedvr2

    real = jseedvr2.init
    monkeypatch.setattr(jseedvr2, "init", lambda key, **kw: (
        jax.eval_shape(lambda: real(key, **kw)[0]), {}))
    jm = jfallback.ModelFallbackManager()
    _, jname = jm.load_model_with_fallbacks("seedvr2")
    tm = tfallback.ModelFallbackManager(device="cpu")
    handler, name = tm.load_model_with_fallbacks("seedvr2")
    assert name == jname == "seedvr2"
    assert _attempts(tm) == _attempts(jm) == [("seedvr2", "seedvr2", True)]
    assert handler.name == "seedvr2" and handler.device.type == "cpu"
    assert (handler.scale, handler.chunk, handler.overlap) == (1, 8, 2)


@pytest.mark.parametrize("requested,used", [("realesrgan_fast", "bicubic"),
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


# A variant the JAX registry serves (registry.py:170-173, 196-201) and the
# port does not have yet raises at build_handler, never serving the default
# model in its place.
def _policy_with(name, **extra):
    policy = default_policy()
    entry = policy.models[name]
    models = dict(policy.models)
    models[name] = dataclasses.replace(entry, extra={**entry.extra, **extra})
    return dataclasses.replace(policy, models=models)


@pytest.mark.parametrize("value", ["attentive", "MambaIRv2"])
def test_preferred_backbone_env_refuses_vsrm(monkeypatch, value):
    """The variable picks vsrm's attentive mixer in the JAX registry; the
    port raises, also with a default vsrm handler already in its cache
    (the variable is not part of the cache's key)."""
    monkeypatch.delenv("VETPU_PREFERRED_BACKBONE", raising=False)
    registry.build_handler("vsrm", device="cpu")
    monkeypatch.setenv("VETPU_PREFERRED_BACKBONE", value)
    with pytest.raises(NotImplementedError,
                       match=f"vsrm with backbone='{value.lower()}' is not "
                             f"ported yet"):
        registry.build_handler("vsrm", device="cpu")


@pytest.mark.parametrize("backbone", ["mambairv2", "Attentive"])
def test_policy_backbone_refuses_vsrm(monkeypatch, backbone):
    """``extra.backbone`` on the policy's entry wins over the variable."""
    monkeypatch.setenv("VETPU_PREFERRED_BACKBONE", "eamamba")
    with pytest.raises(NotImplementedError, match="backbone="):
        registry.build_handler("vsrm", _policy_with("vsrm", backbone=backbone),
                               device="cpu")


def test_temporal_mixer_ssd_refuses_fast_mamba_vsr():
    with pytest.raises(NotImplementedError,
                       match="fast_mamba_vsr with temporal_mixer='ssd' is "
                             "not ported yet"):
        registry.build_handler(
            "fast_mamba_vsr", _policy_with("fast_mamba_vsr",
                                           temporal_mixer="ssd"),
            device="cpu")


def test_fallback_records_an_unported_variant_and_moves_on(monkeypatch):
    """vsrm's build fails on the variable and rvrt, its next candidate,
    serves; fast_mamba_vsr on the ssd mixer falls to cnn_upscaler (the
    port has no realesrgan either)."""
    monkeypatch.setenv("VETPU_PREFERRED_BACKBONE", "attentive")
    tm = tfallback.ModelFallbackManager(device="cpu")
    handler, name = tm.load_model_with_fallbacks("vsrm")
    assert name == "rvrt" and handler.name == "rvrt"
    assert _attempts(tm) == [("vsrm", "vsrm", False), ("vsrm", "rvrt", True)]
    assert "not ported yet" in tm.get_history()[0]["error"]
    tm = tfallback.ModelFallbackManager(
        _policy_with("fast_mamba_vsr", temporal_mixer="ssd"), device="cpu")
    handler, name = tm.load_model_with_fallbacks("fast_mamba_vsr")
    assert name == "cnn_upscaler"
    assert _attempts(tm)[0] == ("fast_mamba_vsr", "fast_mamba_vsr", False)
    assert "temporal_mixer='ssd'" in tm.get_history()[0]["error"]


@pytest.mark.parametrize("name,extra,env", [
    ("vsrm", {}, None), ("vsrm", {}, "eamamba"),
    ("vsrm", {"backbone": "eamamba"}, "attentive"),
    ("fast_mamba_vsr", {}, None),
    ("fast_mamba_vsr", {"temporal_mixer": "ssm"}, "attentive"),
    ("rvrt", {}, "attentive"), ("cnn_upscaler", {}, "attentive")])
def test_default_variants_still_build(monkeypatch, name, extra, env):
    if env is None:
        monkeypatch.delenv("VETPU_PREFERRED_BACKBONE", raising=False)
    else:
        monkeypatch.setenv("VETPU_PREFERRED_BACKBONE", env)
    handler = registry.build_handler(name, _policy_with(name, **extra),
                                     device="cpu")
    assert handler.name == name
