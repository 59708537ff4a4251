"""The port's REST job server (video_enhancer_tpu_torch/serving/) against the
JAX package's, and the enhancement agent's model choice.

- Both servers run in this process on port 0 and are sent the same
  requests: root, strategies, ``/api/v1/me``, uploads rejected for their
  extension, size and magic, an accepted upload, list, status, download of
  an unfinished job and delete; with keys required: the bootstrap key, the
  quota, a non-owner's 404, roles. Their statuses are equal, and so are
  their JSON bodies once ids, times, devices, uptime, keys' secrets, paths
  (the output's container differs on purpose) and routing plans (held
  equal by the router tests) are taken out. No worker thread runs there:
  jobs stay queued.
- On the port alone (CPU, one worker): a bicubic job through its whole life
  (upload ``.avi``, poll, download as ``video/x-msvideo``, evaluate,
  delete), and a vsrm job on 8 frames of 32x48 whose downloaded frames
  equal ``build_handler("vsrm", device="cpu").enhance_frames`` on the same
  frames (0 LSB).
- ``VideoEnhancementAgent.select_model`` returns the JAX agent's choice on a
  table of tasks, analyses and availabilities.
"""

from __future__ import annotations

import itertools
import json
import sys
import time
import urllib.error
import urllib.request
import uuid
from pathlib import Path

import numpy as np
import pytest

from video_enhancer_tpu.agents import VideoEnhancementAgent as JAgent
from video_enhancer_tpu.agents import task_spec as jts
from video_enhancer_tpu.serving import app as japp
from video_enhancer_tpu.serving import http as jhttp
from video_enhancer_tpu_torch.agents import VideoEnhancementAgent as TAgent
from video_enhancer_tpu_torch.agents import task_spec as tts
from video_enhancer_tpu_torch.io.demo import write_demo_video
from video_enhancer_tpu_torch.io.video import read_video, write_video
from video_enhancer_tpu_torch.runtime.registry import build_handler
from video_enhancer_tpu_torch.runtime.upscaler_handler import \
    CnnUpscalerHandler
from video_enhancer_tpu_torch.serving import app as tapp
from video_enhancer_tpu_torch.serving import http as thttp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import synthetic_clip  # noqa: E402

VOLATILE = {"job_id", "created_at", "updated_at", "uptime_sec", "devices",
            "api_key", "input_path", "output_path", "routing_plan"}


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _multipart(filename: str, data: bytes, **fields) -> tuple[bytes, str]:
    b = uuid.uuid4().hex
    parts = [f'--{b}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
             f"{v}\r\n".encode() for k, v in fields.items()]
    parts.append(f'--{b}\r\nContent-Disposition: form-data; name="file"; '
                 f'filename="{filename}"\r\nContent-Type: '
                 "application/octet-stream\r\n\r\n".encode() + data + b"\r\n")
    parts.append(f"--{b}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={b}"


class Client:
    def __init__(self, httpd, key: str | None = None):
        self.port = httpd.server_address[1]
        self.key = key

    def call(self, method: str, path: str, body: bytes | None = None,
             ctype: str | None = None, key: str | None = None):
        key = key or self.key
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}",
                                     data=body, method=method)
        if ctype:
            req.add_header("Content-Type", ctype)
        if key:
            req.add_header("X-API-Key", key)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                status, headers, raw = r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            status, headers, raw = e.code, dict(e.headers), e.read()
        ct = headers.get("Content-Type", "")
        return status, (json.loads(raw) if ct == "application/json"
                        else raw), headers

    def upload(self, filename: str, data: bytes, key: str | None = None,
               **fields):
        body, ctype = _multipart(filename, data, **fields)
        return self.call("POST", "/api/v1/process/auto", body, ctype, key)


def _start(app_mod, http_mod, tmp: Path, **kw):
    server = app_mod.ApiServer(data_dir=str(tmp), start_scheduler=False, **kw)
    httpd = http_mod.serve(app_mod.create_app(server), host="127.0.0.1",
                           port=0, background=True)
    return server, httpd


@pytest.fixture
def twins(tmp_path):
    """A JAX and a port server with no worker thread; ``require_auth`` as
    the test asks."""
    made = []

    def make(require_auth: bool):
        pair = []
        for name, (app_mod, http_mod, kw) in {
                "jax": (japp, jhttp, {}),
                "port": (tapp, thttp, {"device": "cpu"})}.items():
            _, httpd = _start(app_mod, http_mod,
                              tmp_path / f"{name}{require_auth}",
                              require_auth=require_auth, worker_threads=0,
                              **kw)
            made.append(httpd)
            pair.append(Client(httpd))
        return pair

    yield make
    for httpd in made:
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture(scope="module")
def clip_bytes(tmp_path_factory) -> bytes:
    path = tmp_path_factory.mktemp("clip") / "demo.avi"
    write_demo_video(path, frames=8, size_hw=(32, 48))
    return path.read_bytes()


def _both(pair, *args, **kw):
    (s1, b1, _), (s2, b2, _) = (c.call(*args, **kw) for c in pair)
    assert s1 == s2, (args, s1, b1, s2, b2)
    assert _strip(b1) == _strip(b2), (args, b1, b2)
    return b1, b2


def _both_upload(pair, *args, **kw):
    (s1, b1, _), (s2, b2, _) = (c.upload(*args, **kw) for c in pair)
    assert s1 == s2, (args[0], s1, b1, s2, b2)
    assert _strip(b1) == _strip(b2), (args[0], b1, b2)
    return b1, b2


def test_answers_match_jax(twins, clip_bytes):
    pair = twins(require_auth=False)
    _both(pair, "GET", "/")
    _both(pair, "GET", "/api/v1/strategies")
    _both(pair, "GET", "/api/v1/me")
    _both_upload(pair, "clip.txt", clip_bytes)                 # extension
    _both_upload(pair, "clip.avi", clip_bytes[:500])            # size
    _both_upload(pair, "clip.avi", b"\x07" * 2048)              # magic
    j, t = _both_upload(pair, "clip.avi", clip_bytes,
                        latency_class="standard")
    assert j["status"] == "queued" and j["strategy"] == t["strategy"]
    ids = (j["job_id"], t["job_id"])
    (_, lj, _), (_, lt, _) = (c.call("GET", "/api/v1/jobs") for c in pair)
    assert _strip(lj) == _strip(lt) and len(lj["jobs"]) == 1
    for path in ("/api/v1/job/{}", "/api/v1/job/{}/download"):
        (s1, b1, _), (s2, b2, _) = (c.call("GET", path.format(i))
                                    for c, i in zip(pair, ids))
        assert (s1, _strip(b1)) == (s2, _strip(b2))
    assert pair[1].call("GET", f"/api/v1/job/{ids[1]}")[1][
        "output_path"].endswith(f"enhanced_{ids[1]}.avi")
    (s1, b1, _), (s2, b2, _) = (c.call("DELETE", f"/api/v1/job/{i}")
                                for c, i in zip(pair, ids))
    assert s1 == s2 == 200 and _strip(b1) == _strip(b2) == {
        "status": "cancelled"}
    _both(pair, "GET", "/api/v1/job/none")
    _both(pair, "GET", "/api/v1/me")
    # the process-wide tracker holds other tests' operations (and the JAX
    # router's): its two routes are held to their status alone
    for path in ("/health", "/metrics", "/performance/stats", "/storage",
                 "/logs", "/security/status", "/api/v1/agent/status"):
        (s1, b1, _), (s2, b2, _) = (c.call("GET", path) for c in pair)
        assert s1 == s2 == 200, path
        if path not in ("/metrics", "/performance/stats"):
            assert set(b1) == set(b2), (path, b1, b2)
    status, health, _ = pair[1].call("GET", "/health")
    assert status == 200 and health["devices"] == ["cpu"]
    status, metrics, _ = pair[1].call("GET", "/metrics")
    assert status == 200 and set(metrics["system"]) == {
        "cpu_percent", "memory_percent", "disk_percent"}


def test_auth_quota_and_ownership_match_jax(twins, clip_bytes):
    pair = twins(require_auth=True)
    _both(pair, "GET", "/api/v1/me")                            # 401
    body = json.dumps({"name": "root", "role": "admin"}).encode()
    admin = [c.call("POST", "/api/v1/admin/keys", body)[1]["api_key"]
             for c in pair]
    keys = {}
    for name, quota in (("alice", 0), ("bob", 5)):
        body = json.dumps({"name": name, "daily_quota": quota}).encode()
        keys[name] = [c.call("POST", "/api/v1/admin/keys", body, key=k)[1][
            "api_key"] for c, k in zip(pair, admin)]

    def each(method, path, who, body=None, ctype=None):
        out = [c.call(method, path.format(**ids) if ids else path, body,
                      ctype, key=k)
               for c, k, ids in zip(pair, who, job_ids)]
        (s1, b1, _), (s2, b2, _) = out
        assert s1 == s2 and _strip(b1) == _strip(b2), (path, b1, b2)
        return s1, b1

    job_ids = [None, None]
    up = [c.upload("clip.avi", clip_bytes, key=k)
          for c, k in zip(pair, keys["alice"])]
    assert up[0][0] == up[1][0] == 429 and up[0][1] == up[1][1]
    up = [c.upload("clip.avi", clip_bytes, key=k)
          for c, k in zip(pair, keys["bob"])]
    assert up[0][0] == up[1][0] == 202
    job_ids = [{"id": u[1]["job_id"]} for u in up]
    assert each("GET", "/api/v1/job/{id}", keys["alice"])[0] == 404
    assert each("GET", "/api/v1/job/{id}", keys["bob"])[0] == 200
    assert each("GET", "/api/v1/job/{id}", admin)[0] == 200
    each("GET", "/api/v1/jobs", keys["alice"])
    each("GET", "/api/v1/me", keys["bob"])
    assert each("GET", "/api/v1/admin/keys", keys["bob"])[0] == 403
    each("GET", "/api/v1/admin/users", admin)
    each("GET", "/api/v1/admin/keys", admin)
    assert each("DELETE", "/api/v1/admin/keys/bob", admin)[1] == {
        "revoked": True}
    assert each("GET", "/api/v1/me", keys["bob"])[0] == 401


@pytest.fixture(scope="module")
def port_server(tmp_path_factory):
    """The port's server with one worker, driven with an admin key of its
    own whose rate limit polling cannot reach (anonymous clients get 60
    requests a minute, a job's polls under load can take more)."""
    server, httpd = _start(tapp, thttp, tmp_path_factory.mktemp("srv"),
                           device="cpu", worker_threads=1)
    body = json.dumps({"name": "tests", "role": "admin",
                       "rate_limit": 100_000}).encode()
    key = Client(httpd).call("POST", "/api/v1/admin/keys", body)[1]["api_key"]
    yield server, Client(httpd, key)
    httpd.shutdown()
    httpd.server_close()


def _run_job(client, data: bytes, strategy: str) -> tuple[str, dict]:
    status, body, _ = client.upload("clip.avi", data, vsr_strategy=strategy)
    assert status == 202 and body["strategy"] == strategy
    job_id = body["job_id"]
    return job_id, _wait(client, job_id)


def _wait(client, job_id: str) -> dict:
    deadline = time.time() + 180
    while time.time() < deadline:
        job = client.call("GET", f"/api/v1/job/{job_id}")[1]
        if job["status"] in ("completed", "failed"):
            break
        time.sleep(0.1)
    assert job["status"] == "completed", job
    return job


def _download(client, job_id, tmp_path) -> np.ndarray:
    status, raw, headers = client.call("GET",
                                       f"/api/v1/job/{job_id}/download")
    assert status == 200 and headers["Content-Type"] == "video/x-msvideo"
    assert headers["Content-Disposition"].endswith(f'enhanced_{job_id}.avi"')
    path = tmp_path / f"{job_id}.avi"
    path.write_bytes(raw)
    return read_video(path)


def test_bicubic_job_through_its_life(port_server, clip_bytes, tmp_path):
    server, client = port_server
    job_id, job = _run_job(client, clip_bytes, "bicubic")
    assert job["result"]["model_used"] == "bicubic"
    assert job["result"]["audio"] == "dropped (no ffmpeg)"
    got = _download(client, job_id, tmp_path)
    src = tmp_path / "src.avi"
    src.write_bytes(clip_bytes)
    want = np.stack(list(CnnUpscalerHandler(use_cnn=False, device="cpu")
                         .enhance_frames(iter(read_video(src)))))
    np.testing.assert_array_equal(got, want)
    status, metrics, _ = client.call("POST", f"/api/v1/job/{job_id}/evaluate")
    assert status == 200 and metrics["psnr"] > 20
    assert client.call("GET", f"/api/v1/job/{job_id}")[1]["evaluation"] == \
        metrics
    status, body, _ = client.call("DELETE", f"/api/v1/job/{job_id}")
    assert status == 200 and body["status"] == "deleted"
    assert not Path(job["output_path"]).exists()


def test_demo_job_writes_avi(port_server, tmp_path):
    server, client = port_server
    body = json.dumps({"frames": 4, "strategy": "bicubic"}).encode()
    status, job, _ = client.call("POST", "/api/v1/demo", body)
    assert status == 202 and job["strategy"] == "bicubic"
    assert _wait(client, job["job_id"])["filename"] == "demo.avi"
    assert _download(client, job["job_id"], tmp_path).shape == \
        (4, 480, 640, 3)


def test_vsrm_job_equals_the_handler(port_server, tmp_path):
    server, client = port_server
    frames = np.stack(synthetic_clip(8, 32, 48))
    src = write_video(tmp_path / "src.avi", frames, fps=24.0)
    job_id, job = _run_job(client, Path(src).read_bytes(), "vsrm")
    assert job["result"]["model_used"] == "vsrm"
    got = _download(client, job_id, tmp_path)
    want = np.stack(list(build_handler("vsrm", device="cpu")
                         .enhance_frames(iter(frames))))
    assert got.shape == (8, 128, 192, 3)
    np.testing.assert_array_equal(got, want)


_ANALYSES = [None, {"degradations": {"unknown": 0.7}},
             {"content_analysis": {"motion_complexity": 0.8}},
             {"degradations": {"unknown": 0.7},
              "content_analysis": {"motion_complexity": 0.8}}]
_AVAILABLE = [None, {"cnn_upscaler", "bicubic"}, {"realesrgan", "bicubic"},
              {"seedvr2", "ditvr", "fast_mamba_vsr"}, set()]


def test_select_model_matches_jax():
    jagent, tagent = JAgent(), TAgent(device="cpu")
    assert jagent.available == tagent.available
    full = set(jagent.available)
    cases = 0
    for avail, task_type, quality, pref, frames, analysis in itertools.product(
            _AVAILABLE, list(jts.TaskType), list(jts.Quality),
            [None, "ditvr", "rife", "nonexistent"], [1, 100], _ANALYSES):
        jagent.available = tagent.available = (full if avail is None
                                               else avail)
        specs = dict(width=48, height=32, frame_count=frames)
        jt = jts.TaskSpecification(
            task_type=task_type, quality=quality, model_preference=pref,
            video_specs=jts.VideoSpecs(**specs))
        tt = tts.TaskSpecification(
            task_type=tts.TaskType(task_type.value),
            quality=tts.Quality(quality.value), model_preference=pref,
            video_specs=tts.VideoSpecs(**specs))
        assert tagent.select_model(tt, analysis) == \
            jagent.select_model(jt, analysis), (avail, task_type, quality,
                                                pref, frames, analysis)
        cases += 1
    assert cases == 5 * 8 * 4 * 4 * 2 * 4
