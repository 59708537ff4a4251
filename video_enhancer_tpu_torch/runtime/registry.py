"""Handler registry of the port: vsrm, ditvr, cnn_upscaler and bicubic.

Counterpart of video_enhancer_tpu/runtime/registry.py: availability
(:48-75), weight resolution (:93-122) and the handlers of cnn_upscaler and
bicubic (:145-160), vsrm (:187-215) and ditvr (:235-266). The entries are
the port's copy of the policy (config.MODELS). Unlike the JAX registry,
``build_handler`` keeps no cache: each call builds a handler.
"""

from __future__ import annotations

import os
import zlib
from pathlib import Path

import torch

from ..config import MODELS, Policy, default_policy
from ..models import ditvr, vsrm
from .calibration import calibrate_restore, calibrate_vsr
from .qualification import disqualified_models
from .upscaler_handler import CnnUpscalerHandler
from .vsr_handler import VSRHandler
from .weights import load_into, params_from_jax, read_npz

__all__ = ["MODELS", "WEIGHTS_DIR", "bundled_weights", "load_params",
           "probe_available", "build_handler"]

WEIGHTS_DIR = (Path(__file__).resolve().parents[2] / "video_enhancer_tpu"
               / "weights")


def bundled_weights(name: str) -> Path | None:
    """The checkpoint for ``name``: ``$<weights_env>`` (a file, or a
    directory holding ``*.npz``) if set, else the JAX package's bundled
    ``<name>_<scale>x.npz``, read as a data file."""
    entry = MODELS[name]
    env = entry.weights_env and os.environ.get(entry.weights_env)
    if env:
        return Path(env)
    cand = WEIGHTS_DIR / f"{name}_{entry.scale}x.npz"
    return cand if cand.exists() else None


def _init(name: str, gen: torch.Generator) -> dict:
    entry = MODELS[name]
    x = entry.extra
    if name == "vsrm":
        return vsrm.init(gen, dim=x["dim"], num_blocks=x["num_blocks"],
                         scale=entry.scale)
    if name == "ditvr":
        return ditvr.init(gen, dim=x["dim"], depth=x["depth"],
                          patch=x["patch"])
    raise KeyError(f"no parameters to load for {name!r}")


def load_params(name: str) -> dict:
    """Seeded random parameters of vsrm or ditvr overlaid, by path and
    shape, with those of ``bundled_weights(name)`` (fp32, CPU)."""
    gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
    params = _init(name, gen)
    path = bundled_weights(name)
    if path is not None:
        params, _, _ = load_into(params, params_from_jax(read_npz(path)))
    return params


def probe_available(policy: Policy | None = None) -> set[str]:
    """The served models the policy enables, minus those whose bundled
    weights measure no gain (runtime/qualification.py)."""
    policy = policy or default_policy()
    return ({name for name in policy.enabled_models() if name in MODELS}
            - disqualified_models())


def build_handler(name: str = "vsrm",
                  device: str | torch.device | None = None):
    """The serving handler of ``name`` on ``device`` (the card unless
    ``"cpu"`` is asked for): vsrm and ditvr in bf16 behind their calibrated
    blends, cnn_upscaler in bf16, bicubic in fp32."""
    if name not in MODELS:
        raise KeyError(f"the port serves {sorted(MODELS)}, not {name!r}")
    entry = MODELS[name]
    if name in ("cnn_upscaler", "bicubic"):
        use_cnn = name == "cnn_upscaler"
        return CnnUpscalerHandler(
            scale=entry.scale, use_cnn=use_cnn,
            weights_path=bundled_weights(name) if use_cnn else None,
            device=device)
    common = dict(chunk=entry.window,
                  overlap=max(entry.window - entry.stride, 0),
                  tile=entry.tile, tile_overlap=entry.tile_overlap,
                  device=device)
    if name == "vsrm":
        scale = entry.scale
        return VSRHandler(
            name,
            calibrate_vsr(name, lambda p, x: vsrm.apply(p, x, scale=scale)),
            load_params(name), scale=scale, **common)
    heads = entry.extra["heads"]

    def ditvr_apply(p, x, degradation_scores, degradation_type):
        return ditvr.apply(p, x, degradation_type=degradation_type,
                           degradation_scores=degradation_scores, heads=heads)

    # the router's degradation estimate arrives per video (update_context)
    return VSRHandler(
        name, calibrate_restore(name, ditvr_apply), load_params(name),
        scale=1, context={
            "degradation_scores": torch.zeros(3, dtype=torch.float32),
            "degradation_type": torch.zeros((), dtype=torch.int64)},
        **common)
