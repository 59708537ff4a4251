"""The port's agents (video_enhancer_tpu_torch/agents/) and its LPIPS
proxy (train/lpips.py) against the JAX package's, on the CPU, on a tiny
raw ``.avi`` the port writes (cv2 reads it for the JAX side).

Tolerances: ``lpips_distance``, ``assess_clips`` (with the calibrated
proxy and with the random-feature fallback) and the quality agent's
metrics within 1e-5 (relative for PSNR); ``severity_ladder_corr`` equal;
the analyzer's recommendations and resource estimate equal; the
coordinator's workflow, the broker and the registry as in
tests/test_agents.py.
"""

import asyncio
import functools
import shutil

import jax
import numpy as np
import pytest
import torch

from video_enhancer_tpu.agents import quality as jq
from video_enhancer_tpu.io.demo import make_demo_frames as j_demo
from video_enhancer_tpu.train import lpips as jl
from video_enhancer_tpu_torch import agents as ta
from video_enhancer_tpu_torch.agents import quality as tq
from video_enhancer_tpu_torch.agents.communication import AgentMessage
from video_enhancer_tpu_torch.io.demo import write_demo_video
from video_enhancer_tpu_torch.train import lpips as tl


@functools.lru_cache(maxsize=None)
def _jax_proxy():
    from video_enhancer_tpu.runtime.weights import try_load_params

    loaded = try_load_params(tl.PROXY_NPZ,
                             {"layers": jl.feat_init(jax.random.PRNGKey(0))})
    return loaded["layers"]


@pytest.fixture(autouse=True)
def _jax_proxy_loaded_outside_jit(monkeypatch):
    """JAX's quality agent loads its proxy lazily, inside the first jit
    trace of its ``assess_clips``, so a test that traced it first leaves
    tracers in that module's cache: load it here, outside any trace."""
    monkeypatch.setattr(jq, "_CALIBRATED", _jax_proxy())


def _close(a, b, tol=1e-5):
    return abs(a - b) <= tol * max(1.0, abs(b))


@pytest.fixture(scope="module")
def avi(tmp_path_factory):
    path = tmp_path_factory.mktemp("vids") / "agents_demo.avi"
    write_demo_video(path, frames=8, size_hw=(48, 64))
    return str(path)


def test_lpips_distance_and_ladder_match_jax(one_thread):
    jp, tp = jq._load_calibrated(), tl.load_proxy("cpu")
    assert jp is not False and tp is not None
    rng = np.random.default_rng(0)
    a = rng.random((3, 48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ref = np.asarray(jl.lpips_distance(jp, a, b))
    got = tl.lpips_distance(tp, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    frames = j_demo(16, (160, 160))
    corr = tl.severity_ladder_corr(tp, frames, n_ladders=8, seed=777)
    assert corr >= 0.8
    assert corr == jl.severity_ladder_corr(jp, frames, n_ladders=8,
                                           seed=777)


@pytest.mark.parametrize("calibrated", [True, False])
def test_assess_clips_matches_jax(calibrated, monkeypatch):
    if not calibrated:
        monkeypatch.setattr(jq, "_CALIBRATED", False)
        monkeypatch.setitem(tq._PROXY, "cpu", None)
    rng = np.random.default_rng(1)
    # another shape for each case: JAX's jitted assess_clips keeps the
    # distance it traced for a shape
    shape = (3, 32, 48, 3) if calibrated else (2, 24, 40, 3)
    ref = rng.random(shape).astype(np.float32)
    out = np.clip(ref + rng.normal(0, 0.05, ref.shape), 0, 1).astype(
        np.float32)
    want = {k: float(v) for k, v in jq.assess_clips(out, ref).items()}
    got = {k: float(v) for k, v in tq.assess_clips(
        torch.from_numpy(out), torch.from_numpy(ref)).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert _close(got[k], want[k]), (k, got[k], want[k])
    one = {k: float(v) for k, v in tq.assess_clips(
        torch.from_numpy(out[:1]), torch.from_numpy(ref[:1])).items()}
    assert one["flicker"] == 0.0 and one["temporal_consistency"] == 1.0


def test_quality_agent_matches_jax(avi, tmp_path, one_thread):
    from video_enhancer_tpu.agents import QualityAssessmentAgent as JQA
    from video_enhancer_tpu_torch.io.video import read_video, write_video

    same = str(tmp_path / "copy.avi")
    shutil.copy(avi, same)
    big = str(tmp_path / "big.avi")                  # the resize path
    frames = read_video(avi)
    write_video(big, np.repeat(np.repeat(frames, 2, 1), 2, 2), fps=24.0)
    for out in (same, big):
        task = ta.TaskSpecification(task_type=ta.TaskType.QUALITY_ASSESSMENT,
                                    input_path=avi, output_path=out)
        res = ta.QualityAssessmentAgent(device="cpu").process_task(task)
        ref = JQA().process_task(task)
        assert res.status == ref.status == "success", res.error
        for k, v in ref.metrics.items():
            if isinstance(v, float):
                assert _close(res.metrics[k], v), (out, k)
            else:
                assert res.metrics[k] == v, (out, k)
    assert res.metrics["category"] in ("excellent", "good", "acceptable",
                                       "poor", "unacceptable")


def test_analyzer_matches_jax(avi, one_thread):
    from video_enhancer_tpu.agents import VideoAnalyzerAgent as JVA

    task = ta.TaskSpecification(task_type=ta.TaskType.VIDEO_ANALYSIS,
                                input_path=avi)
    res = ta.VideoAnalyzerAgent(device="cpu").process_task(task)
    ref = JVA().process_task(task)
    assert res.status == ref.status == "success"
    assert res.metrics["recommendations"] == ref.metrics["recommendations"]
    est, want = (r.metrics["resource_estimate"] for r in (res, ref))
    assert est["primary_model"] == want["primary_model"]
    assert _close(est["estimated_time_sec"], want["estimated_time_sec"])
    assert _close(est["estimated_device_memory_gb"],
                  want["estimated_device_memory_gb"])


@pytest.fixture
def one_thread():
    """One torch thread beside the other test workers (the workflow's x4
    model on the CPU slows ~50x when every worker runs all cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_coordinator_full_workflow(tmp_path, one_thread):
    src = write_demo_video(tmp_path / "in.avi", frames=6, size_hw=(24, 32))
    coord = ta.CoordinatorAgent(device="cpu")
    out = str(tmp_path / "wf_out.avi")
    wf = coord.run_workflow(src, out, quality="fast", assess_quality=True)
    assert wf.status == "completed", wf.results.get("error")
    assert "analysis" in wf.results and "quality" in wf.results
    assert wf.results["summary"]["frames"] == 6
    assert coord.get_workflow_stats()["completed"] == 1
    from video_enhancer_tpu_torch.io.video import read_video

    enhanced = torch.from_numpy(read_video(out)).float() / 255.0
    src = torch.from_numpy(read_video(src)).float() / 255.0
    from video_enhancer_tpu_torch.ops.resize import resize

    again = tq.assess_clips(enhanced, resize(src, enhanced.shape[1:3]))
    for k, v in again.items():
        assert wf.results["quality"][k] == float(v), k


def test_communication_broker_registry_and_rejection():
    async def run():
        broker = ta.MessageBroker()
        broker.register("a")
        broker.register("b")
        assert await broker.send(AgentMessage("a", "b", "ping", {"x": 1}))
        msg = await broker.receive("b", timeout=1)
        assert msg.payload == {"x": 1}
        assert await broker.broadcast(AgentMessage("a", "*", "hello")) == 1
        assert not await broker.send(AgentMessage("a", "ghost", "x"))

    asyncio.run(run())
    comm = ta.AgentCommunicationSystem()
    comm.register_agent("w1")
    comm.registry._agents["w1"]["last_heartbeat"] -= 1000
    assert comm.registry.check_timeouts() == ["w1"]
    assert comm.registry.get_status()["w1"]["status"] == "unavailable"
    comm.registry.heartbeat("w1")
    assert comm.registry.get_status()["w1"]["status"] == "available"
    res = ta.VideoEnhancementAgent(device="cpu").process_task(
        ta.TaskSpecification(task_type=ta.TaskType.VIDEO_ANALYSIS,
                             input_path="x"))
    assert res.status == "rejected" and "unsupported" in res.error


def test_quality_gates_match_the_policy_yaml():
    import dataclasses

    from video_enhancer_tpu.config import default_policy as j_policy
    from video_enhancer_tpu_torch.config import default_policy

    assert dataclasses.asdict(default_policy().quality_gates) == \
        dataclasses.asdict(j_policy().quality_gates)
    assert jax.default_backend() == "cpu"
