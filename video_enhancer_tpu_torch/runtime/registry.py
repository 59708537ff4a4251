"""Handler registry of the port: one model, vsrm.

Counterpart of video_enhancer_tpu/runtime/registry.py:93-122 (weight
resolution) and :187-215 (the vsrm handler). The entry below is a copy of
vsrm's settings in video_enhancer_tpu/config/policy_v1.yaml:44-53.
"""

from __future__ import annotations

import os
import zlib
from pathlib import Path

import torch

from ..models import vsrm
from .calibration import calibrate_vsr
from .vsr_handler import VSRHandler
from .weights import load_into, params_from_jax, read_npz

__all__ = ["MODELS", "bundled_weights", "load_params", "build_handler"]

# config/policy_v1.yaml:44-53
MODELS: dict[str, dict] = {
    "vsrm": {
        "weights_env": "VSRM_DIR",
        "scale": 4,
        "window": 7,
        "stride": 3,
        "tile": 512,
        "tile_overlap": 32,
        "extra": {"dim": 64, "num_blocks": 6},
    },
}

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "video_enhancer_tpu" / "weights"


def bundled_weights(name: str) -> Path | None:
    """The checkpoint for ``name``: ``$<weights_env>`` (a file, or a
    directory holding ``*.npz``) if set, else the JAX package's bundled
    ``<name>_<scale>x.npz``, read as a data file."""
    entry = MODELS[name]
    env = os.environ.get(entry["weights_env"])
    if env:
        return Path(env)
    cand = WEIGHTS_DIR / f"{name}_{entry['scale']}x.npz"
    return cand if cand.exists() else None


def load_params(name: str) -> dict:
    """Seeded random parameters overlaid, by path and shape, with those of
    ``bundled_weights(name)`` (fp32, CPU)."""
    entry = MODELS[name]
    gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
    params = vsrm.init(gen, dim=entry["extra"]["dim"],
                       num_blocks=entry["extra"]["num_blocks"],
                       scale=entry["scale"])
    path = bundled_weights(name)
    if path is not None:
        params, _, _ = load_into(params, params_from_jax(read_npz(path)))
    return params


def build_handler(name: str = "vsrm",
                  device: str | torch.device | None = None) -> VSRHandler:
    """The serving handler of ``name`` with its calibrated blend, in bf16
    on ``device`` (the card unless ``"cpu"`` is asked for)."""
    if name not in MODELS:
        raise KeyError(f"the port serves {sorted(MODELS)}, not {name!r}")
    entry = MODELS[name]
    scale = entry["scale"]
    return VSRHandler(
        name,
        calibrate_vsr(name, lambda p, x: vsrm.apply(p, x, scale=scale)),
        load_params(name),
        scale=scale, chunk=entry["window"],
        overlap=max(entry["window"] - entry["stride"], 0),
        tile=entry["tile"], tile_overlap=entry["tile_overlap"],
        device=device)
