"""Handler registry of the port: vsrm, fast_mamba_vsr, ditvr, rvrt,
cnn_upscaler and bicubic.

Counterpart of video_enhancer_tpu/runtime/registry.py: availability
(:48-75), the weight-resolution chain (:93-123) and the handlers of
cnn_upscaler and bicubic (:145-160), fast_mamba_vsr (:161-185), vsrm
(:187-215), ditvr (:235-266) and rvrt (:268-281). Each handler reads its
entry from the policy it is given (the default policy otherwise). Unlike the
JAX registry, ``build_handler`` keeps no cache: each call builds a handler.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import torch

from ..config import MODELS, ModelEntry, Policy, default_policy
from ..models import ditvr, fast_mamba_vsr, rvrt, vsrm
from .calibration import calibrate_restore, calibrate_vsr
from .qualification import disqualified_models
from .upscaler_handler import CnnUpscalerHandler
from .vsr_handler import VSRHandler
from .weights import read_npz, try_load_params

__all__ = ["MODELS", "WEIGHTS_DIR", "bundled_weights", "load_params",
           "probe_available", "build_handler", "read_npz"]

WEIGHTS_DIR = (Path(__file__).resolve().parents[2] / "video_enhancer_tpu"
               / "weights")


def bundled_weights(name: str, scale: int | None = None) -> Path | None:
    """The JAX package's bundled ``<name>_<scale>x.npz`` (read as a data
    file), if there is one."""
    scale = MODELS[name].scale if scale is None else scale
    cand = WEIGHTS_DIR / f"{name}_{scale}x.npz"
    return cand if cand.exists() else None


def _init(name: str, entry: ModelEntry, gen: torch.Generator) -> dict:
    x = entry.extra
    if name == "vsrm":
        return vsrm.init(gen, dim=int(x.get("dim", 64)),
                         num_blocks=int(x.get("num_blocks", 6)),
                         scale=entry.scale)
    if name == "ditvr":
        return ditvr.init(gen, dim=int(x.get("dim", 384)),
                          depth=int(x.get("depth", 8)),
                          patch=tuple(x.get("patch", (2, 4, 4))))
    if name == "rvrt":
        return rvrt.init(gen, dim=int(x.get("dim", 64)), scale=entry.scale)
    if name == "fast_mamba_vsr":
        return fast_mamba_vsr.init(gen, dim=int(x.get("dim", 48)),
                                   num_layers=int(x.get("num_layers", 8)),
                                   scale=entry.scale)
    raise KeyError(f"no parameters to load for {name!r}")


def load_params(name: str, entry: ModelEntry | None = None) -> dict:
    """Seeded random parameters of ``name`` filled, by path and shape, from
    the first of the entry's path (``$<weights_env>`` when set) and the
    bundled ``<name>_<scale>x.npz`` that loads (fp32, CPU). A candidate that
    is missing, holds no checkpoint or matches no key is passed over, as the
    JAX package's ``_load_or_init`` does; with none, the init is served."""
    entry = entry or default_policy().models[name]
    gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
    params = _init(name, entry, gen)
    cands = [entry.weights_path] if entry.weights_path else []
    for cand in cands + [WEIGHTS_DIR / f"{name}_{entry.scale}x.npz"]:
        loaded = try_load_params(cand, params)
        if loaded is not None:
            return loaded
    return params


def probe_available(policy: Policy | None = None) -> set[str]:
    """The served models the policy enables, minus those whose bundled
    weights measure no gain (runtime/qualification.py)."""
    policy = policy or default_policy()
    return ({name for name in policy.enabled_models() if name in MODELS}
            - disqualified_models())


def build_handler(name: str = "vsrm", policy: Policy | None = None,
                  device: str | torch.device | None = None):
    """The serving handler of ``name`` on ``device`` (the card unless
    ``"cpu"`` is asked for), with its entry from ``policy``: the VSR models
    in bf16 behind their calibrated blends, cnn_upscaler in bf16, bicubic in
    fp32."""
    policy = policy or default_policy()
    entry = policy.models.get(name)
    if name not in MODELS or entry is None:
        raise KeyError(f"the port serves {sorted(MODELS)}, not {name!r}")
    if name in ("cnn_upscaler", "bicubic"):
        use_cnn = name == "cnn_upscaler"
        weights = entry.weights_path or bundled_weights(name, entry.scale)
        return CnnUpscalerHandler(
            scale=entry.scale, use_cnn=use_cnn,
            weights_path=weights if use_cnn else None, device=device)
    scale = entry.scale
    tiles = dict(tile=entry.tile, tile_overlap=entry.tile_overlap,
                 device=device)
    windows = dict(chunk=entry.window,
                   overlap=max(entry.window - entry.stride, 0), **tiles)
    params = load_params(name, entry)
    if name == "vsrm":
        return VSRHandler(
            name,
            calibrate_vsr(name, lambda p, x: vsrm.apply(p, x, scale=scale)),
            params, scale=scale, **windows)
    if name == "rvrt":
        return VSRHandler(
            name,
            calibrate_vsr(name, lambda p, x: rvrt.apply(p, x, scale=scale)),
            params, scale=scale, **windows)
    if name == "fast_mamba_vsr":
        return VSRHandler(
            name, calibrate_vsr(name, lambda p, x: fast_mamba_vsr.apply(
                p, x, scale=scale)),
            params, scale=scale, chunk=entry.chunk, overlap=entry.overlap,
            **tiles)
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
