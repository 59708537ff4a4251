"""The port's serving scaffolding against the JAX package's, on the CPU:
the production config, the debug, recovery, memory and protection utils,
the one-port app's UI and routes, warm start and validation.

Each util scenario is the JAX package's own (tests/test_infra_utils.py,
tests/test_parity_extras.py), run on both packages with equal outcomes.
The JAX models are traced with ``jax.eval_shape``, never compiled. Shapes
and outcomes compare exactly.
"""

from __future__ import annotations

import importlib
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from video_enhancer_tpu import validate as jvalidate
from video_enhancer_tpu.runtime import registry as jregistry
from video_enhancer_tpu_torch import app as tapp
from video_enhancer_tpu_torch import validate as tvalidate
from video_enhancer_tpu_torch import warm_start as twarm
from video_enhancer_tpu_torch.runtime import registry as tregistry
from video_enhancer_tpu_torch.utils import logging_config

PKGS = ("video_enhancer_tpu", "video_enhancer_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _production(pkg, monkeypatch):
    cfg_mod = _mod(pkg, "config.production")
    out = []
    for env in ({}, {"VETPU_PORT": "9999", "VETPU_REQUIRE_AUTH": "true",
                     "VETPU_WORKERS": "0", "VETPU_MESH_TIME": "2",
                     "VETPU_STRUCTURED_LOGS": "no", "SENTRY_DSN": "x"}):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            cfg = cfg_mod.ProductionConfig.from_env()
        fields = {k: v for k, v in vars(cfg).items() if k != "jax_cache_dir"}
        out.append((fields, cfg.validate()))
    out.append(cfg_mod.ProductionConfig(port=99999,
                                        max_file_bytes=10).validate())
    return out


def _debug(pkg, monkeypatch):
    debug = _mod(pkg, "utils.debug")
    seen = []

    class Keep:
        def handle(self, record):
            seen.append(record.getMessage())

    log = debug.get_debug_logger()
    monkeypatch.setattr(log, "callHandlers", Keep().handle)
    with debug.TimedOperation("outer", log_level=40) as t:
        with debug.debug_context("inner"):
            debug.get_debug_logger().error("in %s", "both")
    return [t.elapsed >= 0] + [s.split(" took")[0] for s in seen]


def _recovery(pkg, monkeypatch):
    rec = _mod(pkg, "utils.recovery")
    out = []
    calls = {"n": 0}

    @rec.with_recovery(max_retries=3, base_delay=0.01)
    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    out += [flaky(), calls["n"], flaky.recovery_manager.stats]
    breaker = rec.CircuitBreaker(failure_threshold=2, recovery_timeout=0.2,
                                 name="t")

    @breaker
    def always_fails():
        raise RuntimeError("down")

    for _ in range(2):
        with pytest.raises(RuntimeError):
            always_fails()
    with pytest.raises(rec.CircuitOpenError) as e:
        always_fails()
    out += [str(e.value), breaker.state]
    time.sleep(0.25)
    out.append(breaker.state)
    chain = rec.create_fallback_chain(
        lambda: (_ for _ in ()).throw(RuntimeError("a")), lambda: "second")
    out.append(chain())
    rm = rec.RecoveryManager(max_retries=1, base_delay=0.01)
    with pytest.raises(ValueError):
        rm.run(lambda: (_ for _ in ()).throw(ValueError("always")))
    return out + [rm.stats]


def _memory(pkg, monkeypatch, tmp_path):
    mem = _mod(pkg, "utils.memory")
    cache = mem.ModelCache(capacity=2)
    cache.put("a", 1)
    cache.put("b", 2)
    out = [cache.get("a")]
    cache.put("c", 3)                    # evicts b
    out += [cache.get("b"), cache.keys(), dict(cache.stats),
            cache.get("d", builder=lambda: 4)]
    tm = mem.TempFileManager()
    p = tmp_path / f"{pkg}.tmp"
    p.write_text("hi")
    tm.register(p)
    out += [tm.cleanup(max_age_sec=9999), tm.cleanup_all(), p.exists()]
    mm = mem.MemoryManager(host_threshold_pct=101.0)
    mm.model_cache.put("m", object())
    out += [mm.check_pressure(), mm.emergency_cleanup(),
            mm.get_status()["model_cache"]]
    return out


def _protection(pkg, monkeypatch, tmp_path):
    prot = _mod(pkg, "utils.protection")
    dp = prot.DataProtectionManager(tmp_path / pkg / "protected")
    rid = dp.store(b"secret video bytes", category="uploads")
    blob = (tmp_path / pkg / "protected" / f"{rid}.bin").read_bytes()
    return [b"secret" in blob, dp.retrieve(rid), dp.secure_delete(rid),
            dp.secure_delete(rid),
            [e["action"] for e in dp.get_audit_log()],
            dp.cleanup_expired()]


def _rollback(pkg, monkeypatch, tmp_path):
    jobstore = _mod(pkg, "runtime.jobstore")
    data = tmp_path / pkg
    store = jobstore.JobStore(data / "jobs.sqlite")
    live = store.create({"status": jobstore.JobStatus.PROCESSING})
    done = store.create({"status": jobstore.JobStatus.COMPLETED})
    (data / "tmp").mkdir(parents=True)
    (data / "tmp" / "x.bin").write_text("junk")
    steps = _mod(pkg, "validate").run_rollback(str(data))
    steps["clean_temp"]["cleaned"] = [
        c.replace(str(data), "") for c in steps["clean_temp"]["cleaned"]]
    return [steps, store.get(live)["status"], store.get(done)["status"],
            (data / "tmp" / "x.bin").exists(), (data / "tmp").is_dir()]


SCENARIOS = {"production_config": _production, "debug": _debug,
             "recovery": _recovery}
FILE_SCENARIOS = {"memory": _memory, "protection": _protection,
                  "rollback": _rollback}


@pytest.mark.parametrize("name", sorted(SCENARIOS) + sorted(FILE_SCENARIOS))
def test_util_scenarios_match_jax(name, monkeypatch, tmp_path):
    if name in SCENARIOS:
        want, got = (SCENARIOS[name](pkg, monkeypatch) for pkg in PKGS)
    else:
        want, got = (FILE_SCENARIOS[name](pkg, monkeypatch, tmp_path)
                     for pkg in PKGS)
    assert got == want


def test_ui_and_one_port_routes_match_jax(tmp_path):
    """``/ui`` is served as the JAX package serves it (tests/test_api.py:
    216-225), and the one-port router (``create_app`` + ``register_ui``)
    has the JAX app's route set."""
    routes = []
    for pkg in PKGS:
        app = _mod(pkg, "serving.app")
        http = _mod(pkg, "serving.http")
        kw = {"device": "cpu"} if pkg.endswith("torch") else {}
        router = app.create_app(app.ApiServer(
            data_dir=str(tmp_path / pkg), start_scheduler=False,
            worker_threads=0, **kw))
        _mod(pkg, "serving.ui").register_ui(router)
        routes.append({(m, rx.pattern) for m, rx, _ in router.routes})
        resp = router.dispatch(http.Request("GET", "/ui", {}, {}, b""))
        assert resp.status == 200
        assert b"Enhance a video" in resp.data
        assert resp.headers["Content-Type"] == "text/html"
    assert routes[0] == routes[1]
    assert ("GET", "^/ui$") in routes[1]


def test_warm_start_gives_jax_shapes():
    clip = jnp.zeros((2, 32, 32, 3))
    got = twarm.warm_start(["cnn_upscaler", "bicubic"], size=32, frames=2,
                           device="cpu")
    for name in ("cnn_upscaler", "bicubic"):
        want = jax.eval_shape(jregistry.build_handler(name).enhance_frames,
                              clip)
        assert got[name]["ok"]
        assert got[name]["out_shape"] == list(want.shape)


def test_tiny_structures_give_jax_shapes():
    got = tvalidate.validate_model_structures("cpu")
    clip = jax.ShapeDtypeStruct(tvalidate.TINY_CLIP, jnp.float32)
    fwd = {"fast_mamba_vsr": jvalidate._fwd_fmv, "vsrm": jvalidate._fwd_vsrm,
           "ditvr": jvalidate._fwd_ditvr, "seedvr2": jvalidate._fwd_seedvr2,
           "rvrt": jvalidate._fwd_rvrt}
    assert list(got) == list(fwd)

    for name, f in fwd.items():
        # the JAX forward returns a shape: trace it for the output's
        holder = {}

        def run(c, f=f):
            holder["shape"] = tuple(f(c))
            return jnp.zeros(())
        jax.eval_shape(run, clip)
        assert got[name]["ok"], got[name]
        assert got[name]["out_shape"] == list(holder["shape"]), name


def test_validate_models_matches_jax():
    assert tvalidate.validate_models() == jvalidate.validate_models()


def test_entry_points_need_a_device_they_can_have(monkeypatch, tmp_path,
                                                  capsys):
    """Without a card and without ``--device cpu`` or ``$VETPU_PLATFORM``
    the three entry points fail, naming the missing card; ``cpu`` from the
    variable runs them on the CPU; a platform the port lacks raises,
    naming it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VETPU_PLATFORM", raising=False)
    # the root logger of this worker stays as it is
    monkeypatch.setattr(logging_config, "setup_logging", lambda **kw: None)
    data = str(tmp_path / "data")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twarm.main(["--models", "bicubic", "--size", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main(["--data-dir", data, "--port", "0"])
    assert tvalidate.main(["--mode", "ci", "--data-dir", data]) == 1
    assert "device: no CUDA device" in capsys.readouterr().out
    with pytest.raises(ValueError, match="'tpu'"):
        twarm.main(["--platform", "tpu"])
    monkeypatch.setenv("VETPU_PLATFORM", "cpu")
    assert twarm.main(["--models", "bicubic", "--size", "8"]) == 0
    assert tvalidate.main(["--mode", "ci", "--data-dir", data]) == 0
    monkeypatch.setenv("VETPU_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="VETPU_PLATFORM|'tpu'"):
        tregistry.build_handler("bicubic")
