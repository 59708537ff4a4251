"""REST API application of the port: a counterpart of
video_enhancer_tpu/serving/app.py with every route, request field, status
code and error code, whose jobs run on the card unless the server was made
with ``device="cpu"``. The differences kept on purpose:

- an upload's output takes the upload's container: an ``.avi`` upload
  gives ``outputs/enhanced_{id}.avi`` (raw AVI, served as
  ``video/x-msvideo``), any other gives ``.mp4`` through OpenCV, as in the
  JAX package; ``/api/v1/demo`` writes its input as ``.avi``. On a machine
  without OpenCV (the card's) a non-AVI upload ends as a ``failed`` job
  whose error names the missing OpenCV;
- ``/health`` lists the ``torch.cuda`` devices (or ``cpu``);
- ``/metrics`` answers without psutil: the host's memory and disk from the
  standard library, the CPU's share from psutil where it is installed and
  null where it is not.

As the JAX module, it re-creates the reference FastAPI surface
(reference api/main.py + api/v1/process_endpoints.py +
api/v1/admin_endpoints.py) on the stdlib router:

  POST   /api/v1/process/auto      upload + auto-routed enhancement job
  GET    /api/v1/job/{job_id}      job status
  GET    /api/v1/job/{job_id}/download
  GET    /api/v1/jobs              list jobs
  DELETE /api/v1/job/{job_id}      cancel/delete
  GET    /api/v1/strategies        available models/strategies
  GET    /health /metrics /performance/stats /
  POST   /api/v1/admin/keys        create API key (admin)
  GET    /api/v1/admin/keys        list keys (admin)
  DELETE /api/v1/admin/keys/{name} revoke (admin)

Upload validation mirrors process_endpoints.py:208-305 (extension, magic
bytes, 1 KB - 500 MB size window). Background processing runs in a worker
thread against the VideoEnhancementAgent (reference :892-1021), with
job records persisted in sqlite.
"""

from __future__ import annotations

import shutil
import threading
import time
import uuid
from pathlib import Path

import torch

from ..analysis import DegradationRouter
from ..config import default_policy
from ..device import resolve_device
from ..io.video import scratch_suffix
from ..runtime.jobstore import JobStatus, JobStore
from ..runtime.registry import probe_available
from ..utils.auth import AuthManager
from ..utils.perf import get_tracker
from .http import Request, Response, Router

__all__ = ["create_app", "ApiServer"]

MIN_SIZE = 1 * 1024  # relaxed from the reference's 1MB for test videos
MAX_SIZE = 500 * 1024 * 1024  # 500MB (reference process_endpoints.py:214)
ALLOWED_EXT = {".mp4", ".avi", ".mov", ".mkv", ".webm"}
MAGIC = (b"\x00\x00\x00", b"RIFF", b"\x1a\x45\xdf\xa3", b"ftyp")

# s per minute of video (reference process_endpoints.py:724-733)
DURATION_ESTIMATES = {"vsrm": 120, "seedvr2": 180, "ditvr": 150,
                      "fast_mamba_vsr": 60, "cnn_upscaler": 10,
                      "bicubic": 5, "realesrgan": 90, "rvrt": 120}


def _system_stats() -> dict:
    """The host's memory (``/proc/meminfo``) and disk shares from the
    standard library; the CPU's share from psutil where it is installed;
    null for what cannot be read."""
    mem = None
    try:
        with open("/proc/meminfo") as f:
            info = {k: int(v.split()[0]) for k, v in
                    (line.split(":", 1) for line in f)}
        mem = 100.0 * (1 - info["MemAvailable"] / info["MemTotal"])
    except (OSError, KeyError, ValueError, ZeroDivisionError):
        pass
    du = shutil.disk_usage("/")
    try:
        import psutil
        cpu = psutil.cpu_percent()
    except ImportError:
        cpu = None
    return {"cpu_percent": cpu, "memory_percent": mem,
            "disk_percent": 100.0 * du.used / (du.used + du.free)}


def _validate_upload(filename: str, data: bytes) -> str | None:
    ext = Path(filename).suffix.lower()
    if ext not in ALLOWED_EXT:
        return f"unsupported file type {ext}"
    if len(data) < MIN_SIZE:
        return f"file too small ({len(data)} bytes)"
    if len(data) > MAX_SIZE:
        return f"file too large ({len(data)} bytes > {MAX_SIZE})"
    head = data[:32]
    if not any(m in head for m in MAGIC):
        return "file content does not look like a video container"
    return None


class ApiServer:
    def __init__(self, data_dir: str = "data", policy=None,
                 require_auth: bool = False, worker_threads: int = 1,
                 start_scheduler: bool = True,
                 device: str | torch.device | None = None):
        from ..runtime.scheduler import BackgroundScheduler, setup_default_tasks
        from ..runtime.storage import StorageManager
        from ..utils.security import SecurityManager

        self.device = resolve_device(device)
        self.policy = policy or default_policy()
        self.data_dir = Path(data_dir)
        for sub in ("uploads", "outputs"):
            (self.data_dir / sub).mkdir(parents=True, exist_ok=True)
        self.jobs = JobStore(self.data_dir / "jobs.sqlite")
        self.auth = AuthManager(self.data_dir / "api_keys.json",
                                require_auth=require_auth)
        self.security = SecurityManager()
        self.storage = StorageManager(self.data_dir)
        self.router_agent = DegradationRouter(
            self.policy, available_models=probe_available(self.policy))
        self._enhancer = None
        self._enhancer_lock = threading.Lock()
        self._queue: list[str] = []
        self._queue_cv = threading.Condition()
        self.started_at = time.time()
        # Background maintenance (reference api/main.py:513-554 startup).
        self.scheduler = BackgroundScheduler(poll_sec=30.0)
        setup_default_tasks(self.scheduler, job_store=self.jobs,
                            storage=self.storage)
        if start_scheduler:
            self.scheduler.start()
        for _ in range(worker_threads):
            threading.Thread(target=self._worker, daemon=True).start()

    # -- lazy singleton agent (reference process_endpoints.py:73-84) --------
    @property
    def enhancer(self):
        with self._enhancer_lock:
            if self._enhancer is None:
                from ..agents import VideoEnhancementAgent

                self._enhancer = VideoEnhancementAgent(policy=self.policy,
                                                       device=self.device)
            return self._enhancer

    # -- background worker --------------------------------------------------
    def _submit(self, job_id: str):
        with self._queue_cv:
            self._queue.append(job_id)
            self._queue_cv.notify()

    def _worker(self):
        while True:
            with self._queue_cv:
                while not self._queue:
                    self._queue_cv.wait()
                job_id = self._queue.pop(0)
            self._process_job(job_id)

    def _process_job(self, job_id: str):
        from ..agents import (Priority, Quality, TaskSpecification, TaskType,
                              VideoSpecs)
        from ..io.video import get_video_metadata

        job = self.jobs.get(job_id)
        if job is None or job["status"] == JobStatus.CANCELLED:
            return
        tracker = get_tracker()
        op = tracker.start_operation("api_job", job.get("strategy", "auto"),
                                     job_id=job_id)
        try:
            self.jobs.update(job_id, status=JobStatus.PROCESSING,
                             progress=0.1, stage="enhancement")
            meta = get_video_metadata(job["input_path"])
            task = TaskSpecification(
                task_type=TaskType(job.get("task_type", "video_enhancement")),
                input_path=job["input_path"],
                output_path=job["output_path"],
                quality=Quality(job.get("quality", "balanced")),
                priority=Priority.NORMAL,
                model_preference=job.get("model"),
                video_specs=VideoSpecs(
                    width=meta.width, height=meta.height, fps=meta.fps,
                    frame_count=meta.frame_count,
                    duration_sec=meta.duration_sec,
                ),
                params={"analysis": job.get("routing_plan", {})},
            )
            result = self.enhancer.process_task(task)
            if result.status == "success":
                post = {}
                # Post experts requested via the API (reference toggles,
                # process_endpoints.py:115-158): best-effort.
                try:
                    if job.get("enable_temporal_smoothing"):
                        self.jobs.update(job_id, progress=0.8,
                                         stage="temporal_smoothing")
                        from ..runtime.pipeline import (
                            _apply_temporal_smoothing,
                        )

                        _apply_temporal_smoothing(job["output_path"],
                                                  self.device)
                        post["temporal_smoothing"] = True
                    if job.get("enable_face_expert"):
                        self.jobs.update(job_id, progress=0.85,
                                         stage="face_restoration")
                        from ..runtime.face_handler import FaceRestorationExpert

                        FaceRestorationExpert(
                            device=self.device).process_video_selective(
                            job["output_path"], job["output_path"])
                        post["face_restoration"] = True
                    target_fps = job.get("target_fps")
                    if job.get("enable_hfr") or (
                            target_fps and target_fps > meta.fps * 1.5):
                        self.jobs.update(job_id, progress=0.9,
                                         stage="hfr_interpolation")
                        from ..runtime.rife_handler import RIFEHandler

                        tmp = (job["output_path"] + ".hfr"
                               + scratch_suffix(job["output_path"]))
                        RIFEHandler(device=self.device).interpolate_video(
                            job["output_path"], tmp,
                            target_fps=target_fps or meta.fps * 2)
                        Path(tmp).replace(job["output_path"])
                        post["hfr"] = True
                except Exception as e:
                    post["post_expert_error"] = str(e)
                # Audio passthrough (reference video_utils.py:137-199):
                # re-mux the source audio when ffmpeg exists; otherwise the
                # drop is recorded, not silent.
                from ..io.audio import passthrough_audio

                try:
                    post["audio"] = passthrough_audio(job["input_path"],
                                                      job["output_path"])
                except Exception as e:
                    post["audio"] = f"dropped ({e})"
                self.jobs.update(
                    job_id, status=JobStatus.COMPLETED, progress=1.0,
                    stage="done", result={**result.metrics, **post},
                    completed_at=time.time(),
                )
                tracker.finish_operation(op, success=True)
            else:
                self.jobs.update(job_id, status=JobStatus.FAILED,
                                 error=result.error)
                tracker.finish_operation(op, success=False,
                                         error=result.error)
        except Exception as e:
            self.jobs.update(job_id, status=JobStatus.FAILED, error=str(e))
            tracker.finish_operation(op, success=False, error=str(e))

    # -- strategy planning (reference process_endpoints.py:698-773) ---------
    def plan(self, input_path: str, latency_class: str) -> dict:
        plan = self.router_agent.analyze_and_route(
            input_path, latency_class=latency_class, device=self.device)
        primary = plan["expert_routing"]["primary_model"]
        meta = plan["content_analysis"]
        minutes = (meta.get("frame_count", 0)
                   / max(meta.get("fps", 24.0), 1.0)) / 60.0
        est = DURATION_ESTIMATES.get(primary, 90) * max(minutes, 0.05)
        stages = plan["processing_order"]
        return {"routing_plan": plan, "strategy": primary,
                "estimated_duration_sec": est, "stages": stages}


def create_app(server: ApiServer | None = None, **kw) -> Router:
    srv = server or ApiServer(**kw)
    r = Router()

    # -- middleware: auth + rate limiting ----------------------------------
    def auth_mw(req: Request):
        if req.path.startswith("/api/v1/admin"):
            return None  # admin routes check roles themselves
        record = srv.auth.authenticate(
            req.headers.get("x-api-key"), req.client)
        if record is None:
            return Response({"error": {"code": "SEC_401",
                                       "message": "unauthorized"}}, 401)
        if not srv.auth.check_rate(record, req.client):
            return Response({"error": {"code": "SEC_429",
                                       "message": "rate limit exceeded"}},
                            429)
        req.user = record
        return None

    r.middleware.append(auth_mw)

    def _identity(req) -> tuple[str, bool]:
        """(owner identity, is_admin). Authenticated keys resolve to their
        USER ACCOUNT (utils/auth.py create_key ``user`` field — several
        keys may share one account, quota and job ownership aggregate per
        account, the zero-egress analog of the reference's HF-OAuth user
        gating, app.py:1124-1172); anonymous clients resolve to their IP,
        so anonymous users don't share one bucket."""
        rec = getattr(req, "user", None) or {}
        name = rec.get("name") or "anonymous"
        if name == "anonymous":
            return req.client, False
        return rec.get("user") or name, rec.get("role") == "admin"

    def _check_quota(req):
        """Daily per-ACCOUNT quota (reference user-quota gating,
        app.py:1124-1172; keyed on the API key's user account, or client
        IP when anonymous). Returns a 429 Response or None. Applied to
        every job-creating endpoint (process/auto AND demo)."""
        quota_key, _ = _identity(req)
        daily_quota = int(getattr(req, "user", {}).get("daily_quota", 200))
        used = srv.jobs.count_since(24 * 3600, client=quota_key)
        if used >= daily_quota:
            return Response({"error": {
                "code": "SEC_429",
                "message": f"daily quota exceeded ({used}/{daily_quota} "
                           "jobs in 24h)",
            }}, 429)
        return None

    def _owned_job(req):
        """Job record if it exists AND the requester may access it, else
        None (404 — existence is not leaked to non-owners)."""
        job = srv.jobs.get(req.path_params["job_id"])
        if job is None:
            return None
        ident, is_admin = _identity(req)
        if is_admin or job.get("client") in (ident, None, ""):
            return job
        return None

    # -- root/health/metrics (reference api/main.py:294-510) ----------------
    @r.get("/")
    def root(req):
        return Response({
            "name": "video-enhancer-tpu",
            "version": "0.1.0",
            "endpoints": ["/api/v1/process/auto", "/api/v1/jobs",
                          "/api/v1/job/{id}", "/api/v1/strategies",
                          "/health", "/metrics"],
        })

    @r.get("/health")
    def health(req):
        try:
            devices = ([f"cuda:{i} {torch.cuda.get_device_name(i)}"
                        for i in range(torch.cuda.device_count())]
                       if srv.device.type == "cuda" else ["cpu"])
            status = "healthy"
        except RuntimeError as e:
            devices, status = [], f"degraded: {e}"
        return Response({
            "status": status,
            "uptime_sec": time.time() - srv.started_at,
            "devices": devices,
            "jobs": srv.jobs.counts(),
        })

    @r.get("/metrics")
    def metrics(req):
        tracker = get_tracker()
        return Response({
            "system": _system_stats(),
            "jobs": srv.jobs.counts(),
            "performance": tracker.get_stats(),
        })

    @r.get("/performance/stats")
    def perf_stats(req):
        return Response(get_tracker().get_stats())

    @r.get("/storage")
    def storage_stats(req):
        return Response({
            "usage": srv.storage.get_usage(),
            "scheduler": srv.scheduler.get_status(),
        })

    @r.get("/logs")
    def logs_tail(req):
        from ..utils.logging_config import get_ring_buffer

        n = int(req.query.get("n", 100))
        return Response({"lines": get_ring_buffer().tail(n)})

    @r.get("/security/status")
    def security_status(req):
        return Response(srv.security.get_security_status())

    @r.get("/api/v1/agent/status")
    def agent_status(req):
        """(reference process_endpoints.py /agent/status)."""
        if srv._enhancer is None:
            return Response({"agent": "not yet initialized",
                             "available_models":
                             sorted(probe_available(srv.policy))})
        status = srv.enhancer.get_status()
        status["model_usage"] = srv.enhancer.model_usage
        status["available_models"] = sorted(srv.enhancer.available)
        return Response(status)

    @r.get("/api/v1/me")
    def whoami(req):
        """Caller's account view: identity, role, quota standing (the
        reference surfaces this via HF OAuth user info, app.py:1124-1172;
        here identity comes from the API key's user account)."""
        ident, is_admin = _identity(req)
        rec = getattr(req, "user", None) or {}
        daily_quota = int(rec.get("daily_quota", 200))
        used = srv.jobs.count_since(24 * 3600, client=ident)
        return Response({
            "user": ident,
            "key_name": rec.get("name", "anonymous"),
            "role": rec.get("role", "user"),
            "authenticated": rec.get("name", "anonymous") != "anonymous",
            "daily_quota": daily_quota,
            "used_24h": used,
            "remaining_24h": max(daily_quota - used, 0),
        })

    @r.get("/api/v1/strategies")
    def strategies(req):
        from ..runtime.qualification import load_report

        # List every explicitly-requestable model; auto_routable reflects
        # the measured-quality demotion (runtime/qualification.py) so
        # clients can see WHY a model never appears in auto plans.
        avail = sorted(probe_available(srv.policy,
                                       include_disqualified=True))
        auto = probe_available(srv.policy)
        report = load_report()
        return Response({
            "strategies": [
                {
                    "name": name,
                    "enabled": True,
                    "auto_routable": name in auto,
                    "measured_gain_db": (report.get(name) or {}).get("ind"),
                    "scale": srv.policy.models[name].scale
                    if name in srv.policy.models else 2,
                    "estimated_sec_per_video_minute":
                        DURATION_ESTIMATES.get(name, 90),
                    # Window quality gating is restoration-only (scale 1);
                    # quality_threshold is ignored for VSR models.
                    "quality_gating": (srv.policy.models[name].scale
                                       if name in srv.policy.models
                                       else 2) == 1,
                }
                for name in avail
            ],
            "latency_classes": list(srv.policy.latency_budgets),
        })

    # -- job lifecycle ------------------------------------------------------
    @r.post("/api/v1/process/auto")
    def process_auto(req):
        try:
            form = req.multipart()
        except ValueError:
            return Response({"error": {"code": "INPUT_400",
                                       "message": "multipart form required "
                                       "with a 'file' field"}}, 400)
        if "file" not in form or not isinstance(form["file"], tuple):
            return Response({"error": {"code": "INPUT_400",
                                       "message": "missing file field"}}, 400)
        filename, data = form["file"]
        err = _validate_upload(filename, data)
        if err:
            return Response({"error": {"code": "VAL_400", "message": err}},
                            400)
        sec = srv.security.validate_and_secure_file(filename, data,
                                                    client=req.client)
        if not sec["ok"]:
            return Response({"error": {
                "code": "SEC_001",
                "message": "upload rejected by security scan",
                "threats": sec["threats"],
            }}, 400)

        quota_err = _check_quota(req)
        if quota_err is not None:
            return quota_err
        quota_key, _ = _identity(req)

        job_id = uuid.uuid4().hex
        in_path = srv.data_dir / "uploads" / f"{job_id}_{Path(filename).name}"
        out_path = (srv.data_dir / "outputs"
                    / f"enhanced_{job_id}{scratch_suffix(filename)}")
        in_path.write_bytes(data)

        latency = form.get("latency_class", "standard")
        try:
            plan = srv.plan(str(in_path), latency)
        except Exception as e:
            plan = {"routing_plan": {"error": str(e)}, "strategy": "bicubic",
                    "estimated_duration_sec": 60, "stages": ["sota_bicubic"]}

        record = {
            "status": JobStatus.QUEUED,
            "client": quota_key,
            "filename": filename,
            "input_path": str(in_path),
            "output_path": str(out_path),
            "strategy": form.get("vsr_strategy") or plan["strategy"],
            "model": form.get("vsr_strategy") or plan["strategy"],
            "quality": form.get("quality_tier", "balanced"),
            "latency_class": latency,
            # Extended request fields (reference Pydantic model,
            # process_endpoints.py:115-158).
            "target_fps": float(form["target_fps"])
            if form.get("target_fps") else None,
            "enable_face_expert": form.get("enable_face_expert", "")
            .lower() in ("1", "true", "yes"),
            "enable_hfr": form.get("enable_hfr", "").lower()
            in ("1", "true", "yes"),
            "enable_temporal_smoothing":
            form.get("enable_temporal_smoothing", "").lower()
            in ("1", "true", "yes"),
            "output_codec": form.get("output_codec", "mp4v"),
            "progress": 0.0,
            "stage": "queued",
            "routing_plan": plan["routing_plan"],
            "estimated_duration_sec": plan["estimated_duration_sec"],
            "stages": plan["stages"],
        }
        srv.jobs.create(record, job_id=job_id)
        srv._submit(job_id)
        return Response({
            "job_id": job_id,
            "status": "queued",
            "strategy": record["strategy"],
            "estimated_duration_sec": plan["estimated_duration_sec"],
            "stages": plan["stages"],
        }, status=202)

    @r.post("/api/v1/demo")
    def run_demo(req):
        """Generate a synthetic demo video and queue it for enhancement
        (reference demo runner, app.py:1487-1576)."""
        quota_err = _check_quota(req)
        if quota_err is not None:
            return quota_err
        try:
            body = req.json() if req.body else {}
        except Exception:
            body = {}
        from ..io.demo import write_demo_video

        job_id = uuid.uuid4().hex
        in_path = srv.data_dir / "uploads" / f"{job_id}_demo.avi"
        write_demo_video(in_path, frames=int(body.get("frames", 24)),
                         size_hw=(240, 320))
        out_path = srv.data_dir / "outputs" / f"enhanced_{job_id}.avi"
        strategy = body.get("strategy", "cnn_upscaler")
        srv.jobs.create({
            "status": JobStatus.QUEUED,
            "client": _identity(req)[0],
            "filename": "demo.avi",
            "input_path": str(in_path),
            "output_path": str(out_path),
            "strategy": strategy,
            "model": strategy,
            "quality": "balanced",
            "latency_class": "standard",
            "progress": 0.0,
            "stage": "queued",
        }, job_id=job_id)
        srv._submit(job_id)
        return Response({"job_id": job_id, "status": "queued",
                         "strategy": strategy}, status=202)

    @r.get("/api/v1/job/{job_id}")
    def job_status(req):
        job = _owned_job(req)
        if job is None:
            return Response({"error": {"code": "API_404",
                                       "message": "job not found"}}, 404)
        public = {k: v for k, v in job.items()
                  if k not in ("input_path",)}
        return Response(public)

    @r.get("/api/v1/job/{job_id}/download")
    def job_download(req):
        job = _owned_job(req)
        if job is None:
            return Response({"error": {"code": "API_404",
                                       "message": "job not found"}}, 404)
        if job["status"] != JobStatus.COMPLETED:
            return Response({"error": {"code": "API_409",
                                       "message": f"job is {job['status']}"}},
                            409)
        path = Path(job["output_path"])
        if not path.exists():
            return Response({"error": {"code": "SYS_404",
                                       "message": "output missing"}}, 404)
        ctype = ("video/x-msvideo" if path.suffix.lower() == ".avi"
                 else "video/mp4")
        return Response(path.read_bytes(), content_type=ctype,
                        headers={"Content-Disposition":
                                 f'attachment; filename="{path.name}"'})

    @r.post("/api/v1/job/{job_id}/evaluate")
    def job_evaluate(req):
        """PSNR/SSIM/temporal-consistency of a job's output vs its input
        (reference _evaluate_psnr_ssim, app.py:1579-1602)."""
        job = _owned_job(req)
        if job is None:
            return Response({"error": {"code": "API_404",
                                       "message": "job not found"}}, 404)
        if job["status"] != JobStatus.COMPLETED:
            return Response({"error": {"code": "API_409",
                                       "message": f"job is {job['status']}"}},
                            409)
        from ..io.video import read_video
        from ..ops.resize import resize
        from ..utils.metrics import evaluate_pair

        def load(path):
            return torch.from_numpy(read_video(path)).to(
                srv.device).float() / 255.0

        out, ref = load(job["output_path"]), load(job["input_path"])
        n = min(out.shape[0], ref.shape[0])
        out, ref = out[:n], ref[:n]
        if out.shape[1:3] != ref.shape[1:3]:
            ref = resize(ref, tuple(out.shape[1:3]), method="cubic")
        metrics = {k: float(v) for k, v in evaluate_pair(out, ref).items()}
        srv.jobs.update(req.path_params["job_id"], evaluation=metrics)
        return Response(metrics)

    @r.get("/api/v1/jobs")
    def jobs_list(req):
        status = req.query.get("status")
        limit = int(req.query.get("limit", 50))
        ident, is_admin = _identity(req)
        return Response({"jobs": [
            {k: v for k, v in j.items() if k not in ("input_path",)}
            for j in srv.jobs.list(status=status, limit=limit)
            if is_admin or j.get("client") in (ident, None, "")
        ]})

    @r.delete("/api/v1/job/{job_id}")
    def job_delete(req):
        job_id = req.path_params["job_id"]
        job = _owned_job(req)
        if job is None:
            return Response({"error": {"code": "API_404",
                                       "message": "job not found"}}, 404)
        if job["status"] in (JobStatus.QUEUED, JobStatus.PROCESSING):
            srv.jobs.update(job_id, status=JobStatus.CANCELLED)
            return Response({"job_id": job_id, "status": "cancelled"})
        srv.jobs.delete(job_id)
        for key in ("input_path", "output_path"):
            p = Path(job.get(key, ""))
            if p.exists():
                p.unlink()
        return Response({"job_id": job_id, "status": "deleted"})

    # -- admin (reference admin_endpoints.py) -------------------------------
    def _require_admin(req):
        rec = srv.auth.authenticate(req.headers.get("x-api-key"), req.client)
        if rec is None or rec.get("role") != "admin":
            return None
        return rec

    @r.post("/api/v1/admin/keys")
    def admin_create_key(req):
        if not srv.auth.list_keys():
            # Bootstrap: the first key may be created unauthenticated, but
            # only from localhost — a remote client must never be able to
            # mint the initial admin key by winning a race.
            if req.client not in ("127.0.0.1", "::1", "localhost", ""):
                return Response({"error": {
                    "code": "SEC_403",
                    "message": "bootstrap key creation is localhost-only"}},
                    403)
        elif _require_admin(req) is None:
            return Response({"error": {"code": "SEC_403",
                                       "message": "admin required"}}, 403)
        body = req.json()
        key = srv.auth.create_key(body.get("name", "unnamed"),
                                  body.get("role", "user"),
                                  int(body.get("rate_limit", 60)),
                                  int(body.get("daily_quota", 200)),
                                  user=body.get("user"))
        return Response({"api_key": key}, status=201)

    @r.get("/api/v1/admin/users")
    def admin_list_users(req):
        """Per-account aggregation: keys, roles, 24h usage vs quota."""
        if _require_admin(req) is None:
            return Response({"error": {"code": "SEC_403",
                                       "message": "admin required"}}, 403)
        users: dict[str, dict] = {}
        for k in srv.auth.list_keys():
            u = users.setdefault(k.get("user") or k["name"], {
                "keys": [], "roles": set(), "daily_quota": 0})
            u["keys"].append(k["name"])
            u["roles"].add(k.get("role", "user"))
            u["daily_quota"] = max(u["daily_quota"],
                                   int(k.get("daily_quota", 200)))
        out = []
        for name, u in sorted(users.items()):
            out.append({"user": name, "keys": sorted(u["keys"]),
                        "roles": sorted(u["roles"]),
                        "daily_quota": u["daily_quota"],
                        "used_24h": srv.jobs.count_since(24 * 3600,
                                                         client=name)})
        return Response({"users": out})

    @r.get("/api/v1/admin/keys")
    def admin_list_keys(req):
        if _require_admin(req) is None:
            return Response({"error": {"code": "SEC_403",
                                       "message": "admin required"}}, 403)
        return Response({"keys": srv.auth.list_keys()})

    @r.delete("/api/v1/admin/keys/{name}")
    def admin_revoke(req):
        if _require_admin(req) is None:
            return Response({"error": {"code": "SEC_403",
                                       "message": "admin required"}}, 403)
        ok = srv.auth.revoke_key(req.path_params["name"])
        return Response({"revoked": ok}, status=200 if ok else 404)

    r.server = srv  # expose for tests
    return r
