"""Handler registry of the port: vsrm, fast_mamba_vsr (both temporal
mixers), seedvr2, ditvr, rvrt, realesrgan, realesrgan_fast, cnn_upscaler
and bicubic.

Counterpart of video_enhancer_tpu/runtime/registry.py: availability
(:48-75), the handler cache (:21-23, 78-90), the weight-resolution chain
(:93-123), the serving mesh (:126-135) and the handlers of cnn_upscaler
and bicubic (:145-160), fast_mamba_vsr and fast_mamba_vsr_ssd (:161-185),
vsrm (:187-215), seedvr2 (:218-233), ditvr (:235-266), rvrt (:268-281) and
realesrgan / realesrgan_fast (:284-341). Each handler reads its entry from
the policy it is given (the default policy otherwise). The JAX cache is
keyed by the model's name alone; this one is keyed by everything a build
reads (the name, the device, the policy's entry, the mesh and, for
realesrgan, ``$VETPU_REALESRGAN_CKPT``, for vsrm its resolved spatial
mixer), so a handler built for one device, entry or variant is never
handed to a caller of another.

fast_mamba_vsr's ssd temporal mixer is chosen, as in the JAX registry, by
the policy name ``fast_mamba_vsr_ssd`` or by ``extra.temporal_mixer: ssd``
on the base entry; both load ``fast_mamba_vsr_ssd_<scale>x.npz`` (the
variant on the base stem), and the calibrated strength follows the
handler's name (1.0 for fast_mamba_vsr_ssd, 0.6 for fast_mamba_vsr).

vsrm's spatial mixer is chosen by the JAX registry's rule (:187-207): the
entry's ``extra.backbone``, else ``$VETPU_PREFERRED_BACKBONE``; "mambairv2"
or "attentive" (in any case) selects the attentive mixer, which loads
``vsrm_attentive_<scale>x.npz`` (none is bundled, so its seeded init is
served, as in the JAX package). The resolved mixer is part of the cache's
key, so setting or clearing the variable after a vsrm handler was cached
builds the other one (the JAX cache, keyed by the name, would hand back
the stale handler).

``$VETPU_REALESRGAN_CKPT`` (realesrgan only) names a released RRDBNet
checkpoint (``RealESRGAN_x4plus.pth``), loaded into the official graph
(models/official_arch.py, ``_OFFICIAL_RRDB_CFG``) and served at full
strength; a file that loads nothing leaves the bundled weights served.
"""

from __future__ import annotations

import os
import threading
import zlib
from pathlib import Path

import torch
import torch.distributed as dist

from ..config import MODELS, ModelEntry, Policy, default_policy
from ..device import resolve_device
from ..models import (ditvr, fast_mamba_vsr, official_arch, realesrgan, rvrt,
                      seedvr2, vsrm)
from ..parallel.mesh import Mesh, mesh_on_group
from .calibration import calibrate_restore, calibrate_vsr
from .qualification import disqualified_models
from .upscaler_handler import CnnUpscalerHandler
from .vsr_handler import VSRHandler
from .weights import read_npz, try_load_params

__all__ = ["MODELS", "WEIGHTS_DIR", "bundled_weights", "load_params",
           "available_models", "probe_available", "build_handler",
           "clear_cache", "read_npz"]

WEIGHTS_DIR = (Path(__file__).resolve().parents[2] / "video_enhancer_tpu"
               / "weights")

_lock = threading.Lock()
_cache: dict[tuple, object] = {}
_meshes: dict[tuple, Mesh] = {}

# the released RealESRGAN_x4plus.pth graph (tests patch it to a tiny one)
_OFFICIAL_RRDB_CFG = {"features": 64, "num_blocks": 23, "growth": 32}


def bundled_weights(name: str, scale: int | None = None) -> Path | None:
    """The JAX package's bundled ``<name>_<scale>x.npz`` (read as a data
    file), if there is one."""
    scale = MODELS[name].scale if scale is None else scale
    cand = WEIGHTS_DIR / f"{name}_{scale}x.npz"
    return cand if cand.exists() else None


def _fmv_mixer(name: str, entry: ModelEntry) -> str:
    """fast_mamba_vsr's temporal mixer: ``extra.temporal_mixer``, by default
    "ssd" for fast_mamba_vsr_ssd and "ssm" for the base name."""
    default = "ssd" if name == "fast_mamba_vsr_ssd" else "ssm"
    return str(entry.extra.get("temporal_mixer", default))


def _vsrm_mixer(entry: ModelEntry) -> str:
    """vsrm's spatial mixer: ``extra.backbone``, else
    ``$VETPU_PREFERRED_BACKBONE`` (default "eamamba"); "mambairv2" or
    "attentive" means "attentive", anything else "ssd"."""
    backbone = str(entry.extra.get("backbone")
                   or os.environ.get("VETPU_PREFERRED_BACKBONE", "eamamba")
                   ).lower()
    return "attentive" if backbone in ("mambairv2", "attentive") else "ssd"


def _stem(name: str, entry: ModelEntry) -> str:
    """The bundled checkpoint's stem: fast_mamba_vsr's on a mixer other
    than "ssm" and vsrm's on a mixer other than "ssd" are the base name and
    the mixer's (the JAX registry's ``f"{name}_{variant}"``), so both
    selections of the ssd mixer load fast_mamba_vsr_ssd and the attentive
    vsrm loads vsrm_attentive; every other model's is its name."""
    if name in ("fast_mamba_vsr", "fast_mamba_vsr_ssd"):
        mixer = _fmv_mixer(name, entry)
        return ("fast_mamba_vsr" if mixer == "ssm"
                else f"fast_mamba_vsr_{mixer}")
    if name == "vsrm" and _vsrm_mixer(entry) != "ssd":
        return f"vsrm_{_vsrm_mixer(entry)}"
    return name


def _init(name: str, entry: ModelEntry, gen: torch.Generator) -> dict:
    x = entry.extra
    if name in ("realesrgan", "realesrgan_fast"):
        return realesrgan.init(gen, features=int(x.get("features", 64)),
                               num_blocks=int(x.get("num_blocks", 6)),
                               scale=entry.scale)
    if name == "vsrm":
        return vsrm.init(gen, dim=int(x.get("dim", 64)),
                         num_blocks=int(x.get("num_blocks", 6)),
                         scale=entry.scale, mixer=_vsrm_mixer(entry))
    if name == "ditvr":
        return ditvr.init(gen, dim=int(x.get("dim", 384)),
                          depth=int(x.get("depth", 8)),
                          patch=tuple(x.get("patch", (2, 4, 4))))
    if name == "rvrt":
        return rvrt.init(gen, dim=int(x.get("dim", 64)), scale=entry.scale)
    if name in ("fast_mamba_vsr", "fast_mamba_vsr_ssd"):
        return fast_mamba_vsr.init(gen, dim=int(x.get("dim", 48)),
                                   num_layers=int(x.get("num_layers", 8)),
                                   scale=entry.scale,
                                   temporal_mixer=_fmv_mixer(name, entry))
    if name == "seedvr2":
        return seedvr2.init(gen,
                            base_channels=int(x.get("base_channels", 32)))
    raise KeyError(f"no parameters to load for {name!r}")


def load_params(name: str, entry: ModelEntry | None = None) -> dict:
    """Seeded random parameters of ``name`` filled, by path and shape, from
    the first of the entry's path (``$<weights_env>`` when set) and the
    bundled ``<stem>_<scale>x.npz`` (``_stem``) that loads (fp32, CPU). A
    candidate that is missing, holds no checkpoint or matches no key is
    passed over, as the JAX package's ``_load_or_init`` does; with none,
    the init is served."""
    entry = entry or default_policy().models[name]
    gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
    params = _init(name, entry, gen)
    cands = [entry.weights_path] if entry.weights_path else []
    bundled = WEIGHTS_DIR / f"{_stem(name, entry)}_{entry.scale}x.npz"
    for cand in cands + [bundled]:
        loaded = try_load_params(cand, params)
        if loaded is not None:
            return loaded
    return params


def available_models(policy: Policy | None = None) -> list[str]:
    """The models the policy enables, in its order (served by the port or
    not), as the JAX registry's ``available_models``."""
    policy = policy or default_policy()
    return policy.enabled_models()


def probe_available(policy: Policy | None = None, *,
                    include_disqualified: bool = False) -> set[str]:
    """The served models the policy enables, minus those whose bundled
    weights measure no gain (runtime/qualification.py) unless
    ``include_disqualified``: explicit requests are not overridden by the
    measurement, as in the JAX package."""
    policy = policy or default_policy()
    out = {name for name in policy.enabled_models() if name in MODELS}
    return out if include_disqualified else out - disqualified_models()


def clear_cache() -> None:
    """Forget every cached handler."""
    with _lock:
        _cache.clear()


def _serving_mesh(policy: Policy, device: torch.device) -> Mesh | None:
    """The policy's ``data x time x space`` mesh over the initialised
    process group when the policy asks for more than one rank and the group
    has exactly that many; None otherwise, as the JAX registry serves
    unsharded with too few devices. One mesh is made per process group and
    device, by every rank at its first build (it creates the axes'
    groups)."""
    cfg = policy.mesh
    if (cfg.num_devices <= 1 or not dist.is_initialized()
            or dist.get_world_size() != cfg.num_devices):
        return None
    key = (cfg, dist.group.WORLD, str(device))
    with _lock:
        mesh = _meshes.get(key)
    if mesh is None:
        mesh = mesh_on_group(cfg.data, cfg.time, cfg.space, device)
        with _lock:
            mesh = _meshes.setdefault(key, mesh)
    return mesh


def build_handler(name: str = "vsrm", policy: Policy | None = None,
                  device: str | torch.device | None = None):
    """The serving handler of ``name`` on ``device`` (the card unless
    ``"cpu"`` is asked for), with its entry from ``policy``: the VSR models
    in bf16 behind their calibrated blends (seedvr2 blends inside its
    ``apply`` and gates sharp windows: ``quality_threshold``, 0.85 unless
    ``extra`` sets it), on the policy's mesh when one is up
    (``_serving_mesh``), cnn_upscaler in bf16, bicubic in fp32. A handler
    is built once for each name, device, entry, mesh and what it reads of
    the environment (``$VETPU_REALESRGAN_CKPT`` for realesrgan, vsrm's
    resolved mixer) and then handed out again (``clear_cache`` forgets
    them); a build that raises caches nothing. The build runs outside the
    cache's lock, so a slow build does not hold up others (two callers of
    one key may both build; the first stored is kept)."""
    policy = policy or default_policy()
    entry = policy.models.get(name)
    if name not in MODELS or entry is None:
        raise KeyError(f"the port serves {sorted(MODELS)}, not {name!r}")
    dev = resolve_device(device)
    mesh = (None if name in ("cnn_upscaler", "bicubic")
            else _serving_mesh(policy, dev))
    key = (name, str(dev), repr(entry), mesh, _official_ckpt(name),
           _vsrm_mixer(entry) if name == "vsrm" else None)
    with _lock:
        handler = _cache.get(key)
    if handler is None:
        handler = _build(name, entry, dev, mesh)
        with _lock:
            handler = _cache.setdefault(key, handler)
    return handler


def _per_frame(apply_fn):
    """A per-frame model ``(N, H, W, 3) -> (N, sH, sW, 3)`` as a clip
    function over the B*T frames of ``(B, T, H, W, 3)``."""
    def clip_apply(p, clip):
        b, t = clip.shape[:2]
        out = apply_fn(p, clip.reshape(b * t, *clip.shape[2:]))
        return out.reshape(b, t, *out.shape[1:])
    return clip_apply


def _official_ckpt(name: str) -> str | None:
    """``$VETPU_REALESRGAN_CKPT`` for realesrgan (realesrgan_fast has no
    official checkpoint), else None."""
    return os.environ.get("VETPU_REALESRGAN_CKPT") if name == "realesrgan" \
        else None


def _official_realesrgan(ckpt: str) -> dict | None:
    """The released RRDBNet's parameters from ``ckpt``, or None when it
    loads nothing."""
    gen = torch.Generator().manual_seed(0)
    template = official_arch.rrdb_official_init(gen, **_OFFICIAL_RRDB_CFG)
    return try_load_params(ckpt, template)


def _build(name: str, entry: ModelEntry, device: torch.device, mesh):
    if name in ("cnn_upscaler", "bicubic"):
        use_cnn = name == "cnn_upscaler"
        weights = entry.weights_path or bundled_weights(name, entry.scale)
        return CnnUpscalerHandler(
            scale=entry.scale, use_cnn=use_cnn,
            weights_path=weights if use_cnn else None, device=device)
    scale = entry.scale
    tiles = dict(tile=entry.tile, tile_overlap=entry.tile_overlap,
                 device=device, mesh=mesh)
    windows = dict(chunk=entry.window,
                   overlap=max(entry.window - entry.stride, 0), **tiles)
    if name in ("realesrgan", "realesrgan_fast"):
        # chunks of 4 frames, no overlap (the JAX registry's)
        frames = dict(chunk=4, overlap=0, **tiles)
        ckpt = _official_ckpt(name)
        official = _official_realesrgan(ckpt) if ckpt else None
        if official is not None:       # the released weights: full strength
            return VSRHandler(
                name, _per_frame(official_arch.rrdb_official_apply),
                official, scale=4, **frames)
        return VSRHandler(
            name, calibrate_vsr(name, _per_frame(
                lambda p, x: realesrgan.apply(p, x, scale=scale))),
            load_params(name, entry), scale=scale, **frames)
    params = load_params(name, entry)
    if name == "vsrm":
        mixer = _vsrm_mixer(entry)
        return VSRHandler(
            name,
            calibrate_vsr(name, lambda p, x: vsrm.apply(p, x, scale=scale,
                                                        mixer=mixer)),
            params, scale=scale, **windows)
    if name == "rvrt":
        return VSRHandler(
            name,
            calibrate_vsr(name, lambda p, x: rvrt.apply(p, x, scale=scale)),
            params, scale=scale, **windows)
    if name in ("fast_mamba_vsr", "fast_mamba_vsr_ssd"):
        return VSRHandler(
            name, calibrate_vsr(name, lambda p, x: fast_mamba_vsr.apply(
                p, x, scale=scale)),
            params, scale=scale, chunk=entry.chunk, overlap=entry.overlap,
            **tiles)
    if name == "seedvr2":
        # no calibration wrapper: the strength is applied inside ``apply``
        return VSRHandler(
            name, lambda p, x: seedvr2.apply(p, x), params, scale=1,
            quality_threshold=float(entry.extra.get("quality_threshold",
                                                    0.85)),
            **windows)
    heads = int(entry.extra.get("heads", 6))

    def ditvr_apply(p, x, degradation_scores, degradation_type):
        return ditvr.apply(p, x, degradation_type=degradation_type,
                           degradation_scores=degradation_scores, heads=heads)

    # the router's degradation estimate arrives per video (update_context)
    return VSRHandler(
        name, calibrate_restore(name, ditvr_apply), params, scale=1,
        context={
            "degradation_scores": torch.zeros(3, dtype=torch.float32),
            "degradation_type": torch.zeros((), dtype=torch.int64)},
        **windows)
