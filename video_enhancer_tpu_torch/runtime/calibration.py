"""Calibrated output strength: ``out = s * model(x) + (1 - s) * base(x)``,
where the base is the bicubic upscale for the VSR models and the input
itself for the 1x restorers.

Counterpart of video_enhancer_tpu/runtime/calibration.py:61-113. The table
is a copy of the JAX package's ``CALIBRATED_STRENGTH`` (its 6-seed
measured operating points); ``VETPU_STRENGTH_<NAME>`` overrides a model's
entry at wrap time.
"""

from __future__ import annotations

import os

import torch

from ..ops.resize import resize

__all__ = ["CALIBRATED_STRENGTH", "strength_for", "calibrate_vsr",
           "calibrate_restore"]

CALIBRATED_STRENGTH: dict[str, float] = {
    "fast_mamba_vsr": 0.6,
    "vsrm": 0.25,
    "rvrt": 0.25,
    "realesrgan_fast": 0.2,
    "realesrgan": 0.4,
    "rife": 0.9,
    "ditvr": 0.5,
    "cnn_upscaler": 0.7,
}


def strength_for(name: str) -> float:
    env = os.environ.get(f"VETPU_STRENGTH_{name.upper()}")
    if env is not None:
        return float(env)
    return CALIBRATED_STRENGTH.get(name, 1.0)


def calibrate_vsr(name: str, apply_fn):
    """Wrap a VSR apply ``(params, clip) -> upscaled clip`` with the
    calibrated blend toward the bicubic upscale. Identity when s >= 1."""
    s = strength_for(name)
    if s >= 1.0:
        return apply_fn

    def fn(p, x, *a, **kw):
        out = apply_fn(p, x, *a, **kw)
        base = resize(x, (out.shape[-3], out.shape[-2]))
        base = torch.clamp(base, 0.0, 1.0).to(out.dtype)
        return torch.clamp(s * out + (1.0 - s) * base, 0.0, 1.0)

    return fn


def calibrate_restore(name: str, apply_fn):
    """Wrap a 1x restoration apply with the calibrated blend toward the
    input itself. Identity when s >= 1."""
    s = strength_for(name)
    if s >= 1.0:
        return apply_fn

    def fn(p, x, *a, **kw):
        out = apply_fn(p, x, *a, **kw)
        return torch.clamp(s * out + (1.0 - s) * x.to(out.dtype), 0.0, 1.0)

    return fn
