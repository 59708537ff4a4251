"""The last scaffolding of the port against the JAX package's, on the CPU:
``FramePipeline`` (JAX's own ``test_frame_pipeline_windows`` case and its
error cases), the error classes and ``handle_exceptions``, the structured
logging (``StructuredFormatter``, ``setup_logging`` with its rotating file,
``PerformanceLogger``, ``RequestContext``), ``ModelKind``, each model's
``default_config()``, the three mesh placements, and a check that every
public top-level ``def``/``class`` of the JAX package has a counterpart in
the port (or a mapped name). Everything here is exact: equal values,
equal strings, equal index blocks.
"""

from __future__ import annotations

import ast
import json
import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from video_enhancer_tpu import config as jconfig
from video_enhancer_tpu.io.demo import write_demo_video
from video_enhancer_tpu.io.pipeline import FramePipeline as JFramePipeline
from video_enhancer_tpu.parallel import mesh as jmesh
from video_enhancer_tpu.utils import errors as jerrors
from video_enhancer_tpu.utils import logging_config as jlog
from video_enhancer_tpu_torch import config as tconfig
from video_enhancer_tpu_torch.io.pipeline import FramePipeline
from video_enhancer_tpu_torch.parallel import mesh as tmesh
from video_enhancer_tpu_torch.utils import errors as terrors
from video_enhancer_tpu_torch.utils import logging_config as tlog
from video_enhancer_tpu_torch.utils.memory import DeviceMemoryManager

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def demo_video(tmp_path_factory):
    path = tmp_path_factory.mktemp("vids") / "demo.mp4"
    write_demo_video(path, frames=12, size_hw=(48, 64))
    return str(path)


def test_frame_pipeline_windows(demo_video):
    """JAX's case (tests/test_io_and_slice.py:37-46): 12 frames, window 5,
    stride 5 -> starts 0, 5, 10, the last padded; float32 in [0, 1] on the
    asked device, equal to JAX's windows."""
    items = list(FramePipeline(demo_video, window=5, stride=5, device="cpu"))
    jitems = list(JFramePipeline(demo_video, window=5, stride=5))
    assert [it["start"] for it in items] == [0, 5, 10]
    assert [it["valid"] for it in items] == [5, 5, 2]
    for it, jit in zip(items, jitems):
        f = it["frames"]
        assert isinstance(f, torch.Tensor) and f.device.type == "cpu"
        assert f.dtype == torch.float32 and tuple(f.shape) == (5, 48, 64, 3)
        assert (it["start"], it["valid"]) == (jit["start"], jit["valid"])
        np.testing.assert_array_equal(f.numpy(), np.asarray(jit["frames"]))
    assert 0.0 <= float(items[0]["frames"].min())
    assert float(items[0]["frames"].max()) <= 1.0


def test_frame_pipeline_overlap_and_transform(demo_video):
    """Overlapping windows (7 every 3) through a transform, against JAX's."""
    def flip(a):
        return a[:, ::-1]

    items = list(FramePipeline(demo_video, window=7, stride=3,
                               transform=flip, device="cpu"))
    jitems = list(JFramePipeline(demo_video, window=7, stride=3,
                                 transform=flip))
    assert [(i["start"], i["valid"]) for i in items] == \
        [(j["start"], j["valid"]) for j in jitems]
    for it, jit in zip(items, jitems):
        np.testing.assert_array_equal(it["frames"].numpy(),
                                      np.asarray(jit["frames"]))


def test_frame_pipeline_raises_decode_errors(tmp_path, demo_video):
    """A missing file raises IOError at construction (JAX's
    tests/test_robustness.py:61-65); a producer error reaches the consumer
    after the windows before it."""
    with pytest.raises(IOError):
        FramePipeline(str(tmp_path / "nope.mp4"), window=4, device="cpu")

    def boom(a):
        if boom.calls:
            raise RuntimeError("transform failed")
        boom.calls += 1
        return a

    boom.calls = 0
    got = []
    with pytest.raises(RuntimeError, match="transform failed"):
        for it in FramePipeline(demo_video, window=4, transform=boom,
                                device="cpu"):
            got.append(it["start"])
    assert got == [0]


@pytest.mark.parametrize("name", ["VideoEnhancerError", "InputError",
                                  "ModelError", "ProcessingError",
                                  "ResourceError", "SecurityError"])
def test_error_classes_match_jax(name):
    tcls, jcls = getattr(terrors, name), getattr(jerrors, name)
    assert tcls.code.value == jcls.code.value
    assert [c.__name__ for c in tcls.__mro__] == \
        [c.__name__ for c in jcls.__mro__]
    e = tcls("boom", details={"k": 1})
    assert terrors.classify_exception(e).value == \
        jerrors.classify_exception(jcls("boom")).value
    assert e.details == {"k": 1} and str(e) == "boom"


def test_handle_exceptions_as_jax():
    """JAX's case (tests/test_infra_utils.py:8-36): the default comes back
    and the handler counts the error, by the code the classifier gives; with
    ``reraise`` the exception passes; the wrapped name is kept."""
    out = {}
    for mod in (terrors, jerrors):
        @mod.handle_exceptions(context="t", default="fallback")
        def boom():
            raise ValueError("nope")

        before = mod.get_error_handler().get_stats()["by_code"].get(
            "VAL_001", 0)
        res = boom()
        stats = mod.get_error_handler().get_stats()
        out[mod] = (res, stats["by_code"]["VAL_001"] - before,
                    stats["recent"][-1]["context"], boom.__name__)

        @mod.handle_exceptions(reraise=True)
        def again():
            raise mod.ModelError("forward failed")

        with pytest.raises(mod.ModelError):
            again()
        assert mod.get_error_handler().get_stats()["recent"][-1][
            "context"].endswith("again")
    assert out[terrors] == out[jerrors] == ("fallback", 1, "t", "boom")
    body, status = terrors.create_error_response(FileNotFoundError("gone"))
    assert (body, status) == jerrors.create_error_response(
        FileNotFoundError("gone"))


def _record(msg="hello %s", args=("x",), exc=False, ctx=None):
    exc_info = None
    if exc:
        try:
            raise KeyError("k")
        except KeyError:
            import sys
            exc_info = sys.exc_info()
    rec = logging.LogRecord("t", logging.WARNING, "f", 1, msg, args, exc_info)
    rec.created = 1_700_000_000.25
    if ctx is not None:
        rec.ctx = ctx
    return rec


@pytest.mark.parametrize("exc,ctx", [(False, None), (True, None),
                                     (False, {"job_id": "j1"})])
def test_structured_formatter_matches_jax(exc, ctx):
    rec = _record(exc=exc, ctx=ctx)
    got = tlog.StructuredFormatter().format(rec)
    assert got == jlog.StructuredFormatter().format(rec)
    entry = json.loads(got)
    assert entry["message"] == "hello x" and entry["level"] == "WARNING"


@pytest.fixture
def root_logger():
    """The root logger's handlers, filters and level, restored after; the
    two ring buffers, once attached, stay (each package attaches its own
    once a process)."""
    root = logging.getLogger()
    saved = (root.handlers[:], root.filters[:], root.level)
    yield root
    for h in root.handlers[:]:
        if h not in saved[0] and h not in (tlog._ring, jlog._ring):
            root.removeHandler(h)
            h.close()
    root.filters[:] = saved[1]
    root.setLevel(saved[2])


@pytest.mark.parametrize("structured", [True, False])
def test_setup_logging_as_jax(tmp_path, root_logger, structured):
    """Both packages add the same handlers with the same formatters: a
    stream (JSON or plain text), with ``log_dir`` a rotating JSON file of
    10 MiB x 5, and the ring buffer; a record reaches the file as JSON."""
    def added(mod, d):
        before = root_logger.handlers[:]
        mod.setup_logging(log_dir=d, level=logging.DEBUG,
                          structured=structured)
        new = [h for h in root_logger.handlers if h not in before]
        return [(type(h).__name__, type(h.formatter).__name__,
                 getattr(h, "maxBytes", None),
                 getattr(h, "backupCount", None)) for h in new]

    got = added(tlog, tmp_path / "t")
    assert got == added(jlog, tmp_path / "j")
    assert root_logger.level == logging.DEBUG
    assert got[0][1] == ("StructuredFormatter" if structured
                         else "Formatter")
    logging.getLogger("filetest").info("to the file")
    lines = (tmp_path / "t" / "video_enhancer.log").read_text().splitlines()
    assert json.loads(lines[-1])["message"] == "to the file"


def test_performance_logger_and_request_context(root_logger):
    """Each event's ``ctx`` equals JAX's (``device_memory``: the port's
    ``DeviceMemoryManager``); inside ``RequestContext`` a record gains the
    request id (JAX's tests/test_infra_utils.py:208-230)."""
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append((record.getMessage(), dict(record.ctx)))

    perf = logging.getLogger("perf")
    keep, level = Keep(), perf.level
    perf.addHandler(keep)
    perf.setLevel(logging.INFO)
    try:
        for mod in (tlog, jlog):
            pl = mod.PerformanceLogger()
            pl.processing_start("j1", "vsrm", frames=8)
            pl.processing_end("j1", 2.0, 8, scale=4)
            pl.processing_end("j2", 0.0, 3)
            pl.model_load("vsrm", 1.5, source="bundled")
        half = len(seen) // 2
        assert seen[:half] == seen[half:] and half == 4
        assert seen[1][1]["fps"] == 4.0 and seen[2][1]["fps"] == 0
        tlog.PerformanceLogger().device_memory()
        assert seen[-1] == ("device_memory", DeviceMemoryManager.get_info())
    finally:
        perf.removeHandler(keep)
        perf.setLevel(level)
    for mod in (tlog, jlog):
        with mod.RequestContext("req42") as rc:
            assert rc.request_id == "req42"
            rec = _record(ctx={"a": 1})
            for f in logging.getLogger().filters:
                f.filter(rec)
            assert rec.ctx == {"a": 1, "request_id": "req42"}
        assert len(mod.RequestContext().request_id) == 8
    assert not any(type(f).__name__ == "_F"
                   for f in logging.getLogger().filters)


def test_model_kind_matches_jax():
    assert [(m.name, m.value) for m in tconfig.ModelKind] == \
        [(m.name, m.value) for m in jconfig.ModelKind]


@pytest.mark.parametrize("model", ["ditvr", "fast_mamba_vsr", "realesrgan",
                                   "rife", "rvrt", "seedvr2", "vsrm"])
def test_default_configs_match_jax(model):
    import importlib

    t = importlib.import_module(f"video_enhancer_tpu_torch.models.{model}")
    j = importlib.import_module(f"video_enhancer_tpu.models.{model}")
    assert t.default_config() == j.default_config()


def _slices(index: tuple, shape: tuple) -> tuple:
    return tuple((s.start or 0, shape[i] if s.stop is None else s.stop)
                 for i, s in enumerate(index))


@pytest.mark.parametrize("dims", [(2, 2, 2), (1, 4, 2), (4, 1, 1),
                                  (1, 1, 1)])
@pytest.mark.parametrize("kind", ["clip", "frame", "replicated"])
def test_mesh_placements_match_jax(cpu_mesh_devices, dims, kind):
    """Each rank's block under ``clip_sharding``, ``frame_sharding`` and
    ``replicated`` is the block JAX's ``NamedSharding`` puts on the device
    at that rank's mesh position."""
    data, time, space = dims
    n = data * time * space
    jm = jmesh.make_mesh(data, time, space, devices=cpu_mesh_devices[:n])
    shape = (8, 8, 8, 3, 2) if kind == "clip" else (8, 8, 3, 2)
    sharding = getattr(jmesh, f"{kind}_sharding" if kind != "replicated"
                       else "replicated")(jm)
    want = sharding.devices_indices_map(shape)
    x = torch.arange(int(np.prod(shape))).reshape(shape)
    fn = getattr(tmesh, f"{kind}_sharding" if kind != "replicated"
                 else "replicated")
    grid = np.asarray(jm.devices)
    for rank in range(n):
        coords = np.unravel_index(rank, dims)
        mesh = tmesh.Mesh({name: tmesh.Axis(size, int(c), None,
                                            torch.device("cpu"))
                           for name, size, c in zip(tmesh.AXES, dims,
                                                    coords)},
                          rank, torch.device("cpu"))
        block = x[tuple(slice(a, b) for a, b in _slices(
            want[grid[coords]], shape))]
        assert torch.equal(fn(mesh, x), block)


def test_placements_refuse_uneven_blocks():
    mesh = tmesh.Mesh({name: tmesh.Axis(2, 0, None, torch.device("cpu"))
                       for name in tmesh.AXES}, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.clip_sharding(mesh, torch.zeros(2, 3, 4, 1, 1))


# JAX names the port keeps under another name or in another module (each
# also in ROADMAP.md, "Checked and matching"), and the TPU-only
# utils/jaxenv.py (device.py maps $VETPU_PLATFORM)
MAPPED = {
    ("models/official_arch.py", "conv_transpose2d_apply"):
        "nn/core.py conv_transpose2d_apply",
    ("ops/attention.py", "window_attention_diffable"):
        "ops/attention.py window_attention (differentiable itself)",
    ("runtime/weights.py", "unflatten_into"):
        "runtime/weights.py params_from_jax + load_into",
    ("runtime/experts.py", "estimate_flow_farneback"):
        "ops/optflow.py estimate_flow_farneback (imported by experts)",
    ("utils/jaxenv.py", "setup"): "device.py resolve_device",
}
# the dataclasses of config/types.py live in the port's config/__init__.py
PORT_MODULE = {"config/types.py": "config/__init__.py"}


def _public_names(path: Path, aliases: bool = False) -> set[str]:
    """Public top-level functions and classes; with ``aliases`` also names
    bound at the top level (``selective_scan_ref = selective_scan_plain``)."""
    tree = ast.parse(path.read_text())
    names = {n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef,
                               ast.AsyncFunctionDef))}
    if aliases:
        names |= {t.id for n in tree.body if isinstance(n, ast.Assign)
                  for t in n.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_every_public_jax_name_has_a_counterpart():
    """Every public top-level function and class of each JAX module is
    defined (or bound) in the port's module of the same path, or listed in
    ``MAPPED``."""
    jroot = ROOT / "video_enhancer_tpu"
    troot = ROOT / "video_enhancer_tpu_torch"
    missing = []
    for jpath in sorted(jroot.rglob("*.py")):
        rel = jpath.relative_to(jroot).as_posix()
        tpath = troot / PORT_MODULE.get(rel, rel)
        have = _public_names(tpath, aliases=True) if tpath.exists() \
            else set()
        missing += [(rel, name) for name in sorted(_public_names(jpath))
                    if name not in have and (rel, name) not in MAPPED]
    assert missing == []
