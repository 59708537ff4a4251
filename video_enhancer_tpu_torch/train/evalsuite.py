"""Multi-seed quality evaluation of the bundled weights, and the
qualification report the router reads, on the port's models.

Counterpart of video_enhancer_tpu/train/evalsuite.py over both synthetic
families: ``ind`` (the demo frames degraded by train/data.py) and ``alt``
(the structurally disjoint train/evalgen.py). Each gain is the mean over
``n_seeds`` batches of a model's PSNR gain in dB over its non-ML
fallback: the bicubic upscale (VSR), the degraded input (1x restoration),
the average of the two frames (interpolation). The data is made on the
host in numpy and the models run on the card unless ``device="cpu"`` is
asked for, in fp32 as the JAX package evaluates them: fp32 parameters and
clips, inside ``device.full_fp32()`` (no TF32), with the port's kernels
in their fp32 forms on the card (vsrm's SSD too, which serving runs only
in bf16) and their plain versions on the CPU. ``model_entry`` wraps each
model in its calibrated strength (runtime/calibration.py), as the handlers
serve it.

``write_qualification_report`` writes to ``path``, else to
``$VETPU_QUALIFICATION``, and refuses to run with neither: the report the
routers read by default (runtime/qualification.py) is the JAX package's
committed ``weights/QUALIFICATION.json``, which the port never writes.

CLI: ``python -m video_enhancer_tpu_torch.train.evalsuite [model]
[--family ind|alt] [--n-seeds N] [--compare-npz SNAPSHOT] [--report]
[--device cpu]`` prints one JSON line; ``--compare-npz`` exits 1 when the
bundled weights measure below the snapshot.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib

import numpy as np
import torch

from ..device import full_fp32, resolve_device
from ..models import (ditvr, fast_mamba_vsr, realesrgan, rife, rvrt, seedvr2,
                      upscaler, vsrm)
from ..ops.resize import resize
from ..runtime import calibration as cal
from ..runtime.vsr_handler import cast_params
from ..runtime.weights import try_load_params
from ..utils.metrics import psnr

__all__ = ["vsr_gain", "restore_gain", "interp_gain", "frames_for",
           "model_entry", "bundled_gain", "gain_for_npz", "ALL_MODELS",
           "write_qualification_report", "WEIGHTS_DIR"]

WEIGHTS_DIR = (pathlib.Path(__file__).resolve().parents[2]
               / "video_enhancer_tpu" / "weights")

ALL_MODELS = ("vsrm", "fast_mamba_vsr", "fast_mamba_vsr_ssd", "rvrt",
              "realesrgan", "realesrgan_fast", "cnn_upscaler", "ditvr",
              "seedvr2", "rife")

_FRAME_CACHE: dict = {}


def frames_for(family: str, size: tuple[int, int] = (256, 256)):
    """Eval source frames for one family (cached per process)."""
    key = (family, size)
    if key not in _FRAME_CACHE:
        if family == "ind":
            from ..io.demo import make_demo_frames

            _FRAME_CACHE[key] = make_demo_frames(24, size)
        elif family == "alt":
            from .evalgen import make_alt_frames

            _FRAME_CACHE[key] = make_alt_frames(24, size, seed=0)
        else:
            raise ValueError(f"unknown eval family: {family}")
    return _FRAME_CACHE[key]


def _pairs(family: str, frames, batch, clip_len, crop, scale, seed):
    if family == "ind":
        from .data import make_pairs

        return make_pairs(frames, batch, clip_len, crop, scale, seed=seed)
    from .evalgen import make_alt_pairs

    return make_alt_pairs(frames, batch, clip_len, crop, scale, seed=seed)


def _triplets(family: str, frames, batch, crop, seed):
    if family == "ind":
        from .data import make_triplets

        return make_triplets(frames, batch, crop, seed=seed)
    from .evalgen import make_alt_triplets

    return make_alt_triplets(frames, batch, crop, seed=seed)


def _on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def vsr_gain(apply_fn, params, family: str, scale: int, *, crop: int = 128,
             batch: int = 2, clip_len: int = 4, n_seeds: int = 8,
             seed0: int = 999, device=None) -> float:
    """Mean PSNR gain (dB) of ``apply_fn(params, lr)`` over the bicubic
    upscale across ``n_seeds`` independently drawn batches."""
    dev = resolve_device(device)
    frames = frames_for(family)
    gains = []
    with torch.inference_mode(), full_fp32():
        for s in range(n_seeds):
            pr = _pairs(family, frames, batch, clip_len, crop, scale,
                        seed0 + s)
            lr, hr = _on(pr["lr"], dev), _on(pr["hr"], dev)
            out = apply_fn(params, lr)
            base = torch.clamp(resize(lr, (hr.shape[2], hr.shape[3])), 0, 1)
            gains.append(float(psnr(out, hr)) - float(psnr(base, hr)))
    return float(np.mean(gains))


def restore_gain(apply_fn, params, family: str, *, crop: int = 64,
                 batch: int = 2, clip_len: int = 4, n_seeds: int = 8,
                 seed0: int = 999, device=None) -> float:
    """Mean PSNR gain (dB) of a 1x restoration model over the degraded
    input itself."""
    dev = resolve_device(device)
    frames = frames_for(family)
    gains = []
    with torch.inference_mode(), full_fp32():
        for s in range(n_seeds):
            pr = _pairs(family, frames, batch, clip_len, crop, 1, seed0 + s)
            deg, clean = _on(pr["lr"], dev), _on(pr["hr"], dev)
            out = apply_fn(params, deg)
            gains.append(float(psnr(out, clean)) - float(psnr(deg, clean)))
    return float(np.mean(gains))


def interp_gain(interp_fn, params, family: str, *, crop: int = 128,
                batch: int = 4, n_seeds: int = 8, seed0: int = 999,
                device=None) -> float:
    """Mean PSNR gain (dB) of frame interpolation over the average-blend
    baseline on true-middle-frame triplets."""
    dev = resolve_device(device)
    frames = frames_for(family)
    gains = []
    with torch.inference_mode(), full_fp32():
        for s in range(n_seeds):
            tri = _triplets(family, frames, batch, crop, seed0 + s)
            f0, f1 = _on(tri["lr"][:, 0], dev), _on(tri["lr"][:, 1], dev)
            mid = _on(tri["hr"][:, 0], dev)
            out = interp_fn(params, f0, f1)
            gains.append(float(psnr(out, mid))
                         - float(psnr((f0 + f1) / 2, mid)))
    return float(np.mean(gains))


@functools.lru_cache(maxsize=None)
def model_entry(name: str):
    """(init_fn, apply_fn, npz_path, kind) of a bundled model, ``apply_fn``
    with the model's calibrated strength as the handlers serve it
    (seedvr2's strength lives inside its apply). ``VETPU_STRENGTH_<NAME>``
    is read when the entry is first built."""
    init_fn, apply_fn, npz, kind = _raw_model_entry(name)
    if name != "seedvr2":
        if kind in ("vsr4", "vsr2"):
            apply_fn = cal.calibrate_vsr(name, apply_fn)
        elif kind == "restore":
            apply_fn = cal.calibrate_restore(name, apply_fn)
        else:
            apply_fn = cal.calibrate_interp(name, apply_fn)
    return init_fn, apply_fn, npz, kind


def _per_frame(apply_fn):
    """A per-frame model as a function of ``(B, T, H, W, 3)`` clips."""
    def clip_apply(p, clip):
        b, t = clip.shape[:2]
        out = apply_fn(p, clip.reshape(b * t, *clip.shape[2:]))
        return out.reshape(b, t, *out.shape[1:])
    return clip_apply


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(0)


def _raw_model_entry(name: str):
    """The JAX package's eval configurations (evalsuite.py:166-250)."""
    w = WEIGHTS_DIR
    if name == "vsrm":
        return (lambda: vsrm.init(_gen(), dim=64, num_blocks=6, scale=4),
                lambda p, x: vsrm.apply(p, x, scale=4),
                w / "vsrm_4x.npz", "vsr4")
    if name in ("fast_mamba_vsr", "fast_mamba_vsr_ssd"):
        mixer = "ssd" if name == "fast_mamba_vsr_ssd" else "ssm"
        return (lambda: fast_mamba_vsr.init(_gen(), dim=48, num_layers=8,
                                            scale=4, temporal_mixer=mixer),
                lambda p, x: fast_mamba_vsr.apply(p, x, scale=4),
                w / f"{name}_4x.npz", "vsr4")
    if name in ("realesrgan", "realesrgan_fast"):
        blocks = 3 if name == "realesrgan_fast" else 6
        return (lambda: realesrgan.init(_gen(), features=64,
                                        num_blocks=blocks),
                _per_frame(lambda p, x: realesrgan.apply(p, x, scale=4)),
                w / f"{name}_4x.npz", "vsr4")
    if name == "rvrt":
        return (lambda: rvrt.init(_gen(), dim=64, scale=4),
                lambda p, x: rvrt.apply(p, x, scale=4),
                w / "rvrt_4x.npz", "vsr4")
    if name == "cnn_upscaler":
        return (lambda: upscaler.init(_gen(), features=128, scale=2, s2d=4),
                _per_frame(lambda p, x: upscaler.apply(p, x, scale=2,
                                                       s2d=4)),
                w / "cnn_upscaler_2x.npz", "vsr2")
    if name == "ditvr":
        return (lambda: ditvr.init(_gen()),
                lambda p, x: ditvr.apply(p, x, heads=3),
                w / "ditvr_1x.npz", "restore")
    if name == "seedvr2":
        return (lambda: seedvr2.init(_gen()),
                lambda p, x: seedvr2.apply(p, x),
                w / "seedvr2_1x.npz", "restore")
    if name == "rife":
        return (lambda: rife.init(_gen()), rife.interpolate_pair,
                w / "rife.npz", "interp")
    raise ValueError(f"unknown model: {name}")


def _gain(name: str, npz, family: str, n_seeds: int, device) -> float:
    init_fn, apply_fn, _, kind = model_entry(name)
    params = try_load_params(pathlib.Path(npz), init_fn())
    assert params is not None, f"weights failed to load: {npz}"
    dev = resolve_device(device)
    params = cast_params(params, torch.float32, dev)
    kw = dict(n_seeds=n_seeds, device=dev)
    if kind == "vsr4":
        return vsr_gain(apply_fn, params, family, 4, **kw)
    if kind == "vsr2":
        return vsr_gain(apply_fn, params, family, 2, **kw)
    if kind == "restore":
        return restore_gain(apply_fn, params, family, **kw)
    return interp_gain(apply_fn, params, family, **kw)


def bundled_gain(name: str, family: str, n_seeds: int = 8,
                 device=None) -> float:
    """The bundled npz of ``name`` measured on one eval family. Raises
    FileNotFoundError when the npz is not bundled."""
    npz = model_entry(name)[2]
    if not npz.exists():
        raise FileNotFoundError(npz)
    return _gain(name, npz, family, n_seeds, device)


def gain_for_npz(name: str, npz_path, family: str, n_seeds: int = 6,
                 device=None) -> float:
    """``bundled_gain`` for another weights file of ``name``'s
    architecture."""
    return _gain(name, npz_path, family, n_seeds, device)


def _report_dest(path) -> pathlib.Path:
    """Where the report goes: ``path``, else ``$VETPU_QUALIFICATION``. The
    default report that the routers read is the JAX package's committed
    file, which the port reads and never writes."""
    dest = path or os.environ.get("VETPU_QUALIFICATION")
    if not dest:
        raise ValueError("the qualification report needs path= or "
                         "$VETPU_QUALIFICATION")
    dest = pathlib.Path(dest).resolve()
    if WEIGHTS_DIR.parent in dest.parents:
        raise ValueError(f"{dest}: the port writes nothing under "
                         f"{WEIGHTS_DIR.parent}")
    return dest


def write_qualification_report(path=None, n_seeds: int = 6,
                               models=ALL_MODELS, device=None) -> dict:
    """Measures every bundled model on both families and writes the
    report to ``path`` or ``$VETPU_QUALIFICATION`` (ValueError if neither
    is set, or if it lies in the JAX package): model -> {ind, alt} mean
    gain in dB (rounded to 3 decimals). Models without bundled weights are
    left out."""
    dest = _report_dest(path)
    out = {}
    for name in models:
        entry = {}
        for family in ("ind", "alt"):
            try:
                entry[family] = round(
                    bundled_gain(name, family, n_seeds=n_seeds,
                                 device=device), 3)
            except FileNotFoundError:
                break
        if entry:
            out[name] = entry
    report = {"n_seeds": n_seeds,
              "gain_unit": "dB PSNR vs non-ML fallback, mean over seeds",
              "models": out}
    dest.write_text(json.dumps(report, indent=1, sort_keys=True) + "\n")
    return report


def _main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m video_enhancer_tpu_torch.train.evalsuite")
    p.add_argument("model", nargs="?", default=None)
    p.add_argument("--family", default="ind", choices=["ind", "alt"])
    p.add_argument("--n-seeds", type=int, default=6)
    p.add_argument("--compare-npz", default=None,
                   help="pre-train snapshot; exit 1 if bundled < snapshot")
    p.add_argument("--report", action="store_true",
                   help="measure every bundled model on both families and "
                        "write the qualification report")
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU; the card by default")
    args = p.parse_args(argv)

    if args.report:
        try:
            _report_dest(None)
        except ValueError as e:
            p.error(str(e))
        rep = write_qualification_report(n_seeds=args.n_seeds,
                                         device=args.device)
        print(json.dumps(rep))
        return 0
    if args.model is None:
        p.error("model is required unless --report is given")

    cur = bundled_gain(args.model, args.family, n_seeds=args.n_seeds,
                       device=args.device)
    out = {"model": args.model, "family": args.family,
           "gain_db": round(cur, 3)}
    rc = 0
    if args.compare_npz:
        prev = gain_for_npz(args.model, args.compare_npz, args.family,
                            n_seeds=args.n_seeds, device=args.device)
        out["snapshot_gain_db"] = round(prev, 3)
        rc = 1 if cur < prev else 0
        out["verdict"] = "regression" if rc else "ok"
    print(json.dumps(out))
    return rc


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(_main())
