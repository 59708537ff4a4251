#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (video_enhancer_tpu_torch) on one card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printing its own elapsed seconds; any failure exits non-zero:

1. environment: the card's name, the device count, its power limit;
2. build: both CUDA kernels from ``video_enhancer_tpu_torch/csrc`` in one
   nvcc call (ptxas's register/shared-memory/spill report on earlier lines);
3. kernels against their plain PyTorch versions at the main path's shapes,
   in fp32 (TF32 off) and bf16, each with its tolerance; time of each;
4. the main path: ``build_handler("vsrm")`` with the bundled weights at full
   width streams a seeded 16-frame 180x320 clip (window 7, stride 3,
   calibrated blend s = 0.25); checks the frames, that both kernels were
   launched the expected number of times, and one window against the plain
   versions; frames/s.

The line before the card's name and power limit holds the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``. The script
needs a card: without one it exits non-zero and prints no result. It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from video_enhancer_tpu_torch import kernels
from video_enhancer_tpu_torch.io.pipeline import iter_windows
from video_enhancer_tpu_torch.models import vsrm
from video_enhancer_tpu_torch.ops.scan import (fused_bidir_ssm_kernel,
                                               fused_bidir_ssm_plain)
from video_enhancer_tpu_torch.ops.ssd import (ssd_shared_kernel,
                                              ssd_shared_plain)
from video_enhancer_tpu_torch.runtime.calibration import calibrate_vsr
from video_enhancer_tpu_torch.runtime.registry import build_handler

SEED = 0
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA H100 SXM data sheet
H100_BF16_FLOPS = 989e12         # dense tensor-core rate
H100_FP32_FLOPS = 67e12          # CUDA-core rate

# main-path shapes at 180x320, window 7 (vsrm: dim 64 -> inner 128)
SSD_SHAPE = dict(b=7, L=180 * 320, H=2, P=64, N=16)
BISSM_SHAPE = dict(B=180 * 320, L=7, D=128, N=4, dt_rank=4, K=5)

# tolerances: max |kernel - plain| / max |plain|
TOL = {("ssd_shared", "float32"): 1e-4, ("ssd_shared", "bfloat16"): 2e-2,
       ("fused_bidir_ssm", "float32"): 1e-4,
       ("fused_bidir_ssm", "bfloat16"): 1e-2}
# one served window, kernels vs plain versions (both bf16), on [0, 1]
WINDOW_MAX_ABS, WINDOW_MEAN_ABS = 0.05, 0.005


class Failure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[phase {name}] ok in {time.perf_counter() - t0:.2f} s",
                  flush=True)
            return out
        return run
    return wrap


def time_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    diff = (got.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


@phase("1 environment")
def environment() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"device: {name}; count {count}; torch {torch.__version__}; "
          f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    print(f"nvidia-smi: {smi}")
    return {"kind": name, "count": count, "smi": smi}


@phase("2 build")
def build() -> float:
    t0 = time.perf_counter()
    so, log = kernels.build(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for line in log.splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill",
                                   "error", "warning")):
            print(f"  {line.strip()}")
    kernels.library()
    print(f"built {so.name} with one nvcc call in {secs:.2f} s")
    return secs


def _ssd_inputs(dtype, gen):
    s = SSD_SHAPE
    b, L, H, P, N = s["b"], s["L"], s["H"], s["P"], s["N"]
    # x, B and C as column slices of one (b, L, H*P + 2N) tensor, as bissd
    # hands them to the kernel.
    xbc = torch.randn((b, L, H * P + 2 * N), generator=gen, device="cuda")
    xbc = xbc.to(dtype)
    x = xbc[..., :H * P].reshape(b, L, H, P)
    Bm = xbc[..., H * P:H * P + N]
    Cm = xbc[..., H * P + N:]
    dt = 0.001 + 0.099 * torch.rand((b, L, H), generator=gen, device="cuda")
    A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device="cuda"))
    return x, dt, A, Bm, Cm


def _ssd_cost(dtype, Q: int) -> tuple[float, float]:
    s = SSD_SHAPE
    b, L, H, P, N = s["b"], s["L"], s["H"], s["P"], s["N"]
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * L * H * P * item + 2 * b * L * N * item
              + b * L * H * 4 + H * 4)
    K = -(-L // Q)
    # chunked-matmul form (the JAX package's count, ops/ssd.py:469-474)
    flops = b * K * (2.0 * Q * Q * N + H * (2.0 * Q * Q * (P + 1)
                                            + 4.0 * Q * N * P))
    return nbytes, flops


def _bissm_inputs(dtype, gen):
    s = BISSM_SHAPE
    B, L, D, N, r, K = (s["B"], s["L"], s["D"], s["N"], s["dt_rank"],
                        s["K"])

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    # u_pre and gate as the two halves of in_proj's output
    xz = rnd(B, L, 2 * D).to(dtype)
    u, gate = xz.chunk(2, dim=-1)
    w = dict(cw=rnd(D, 1, K, scale=0.3), cb=rnd(D, scale=0.1),
             wx=rnd(r + 2 * N, D, scale=0.2), wdt=rnd(D, r, scale=0.2),
             bdt=rnd(D, scale=0.1), dtbf=rnd(D, scale=0.1) - 2.0,
             dtbb=rnd(D, scale=0.1) - 2.0,
             Af=-torch.exp(rnd(D, N, scale=0.3)),
             Ab=-torch.exp(rnd(D, N, scale=0.3)), Df=rnd(D), Db=rnd(D))
    return (u, gate, w["cw"], w["cb"], w["wx"], w["wdt"], w["bdt"],
            w["dtbf"], w["dtbb"], w["Af"], w["Ab"], w["Df"], w["Db"], r)


def _bissm_cost(dtype) -> tuple[float, float]:
    s = BISSM_SHAPE
    B, L, D, N, r, K = (s["B"], s["L"], s["D"], s["N"], s["dt_rank"],
                        s["K"])
    item = torch.finfo(dtype).bits // 8
    R = r + 2 * N
    nbytes = 3 * B * L * D * item + 4 * (D * (K + 7 + R + r + 2 * N))
    # the JAX package's count (ops/scan.py:1029-1033)
    flops = (2 * (9.0 * B * L * D * N + 2.0 * B * L * D)
             + 2.0 * B * L * D * K + 2.0 * B * L * D * R
             + 2.0 * B * L * r * D + 8.0 * B * L * D)
    return nbytes, flops


@phase("3 kernels vs plain")
def kernels_vs_plain() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Q = kernels.library().vetk_ssd_chunk()
    rec = {}
    with torch.inference_mode():
        # --- kernel 1: ssd_shared, forward and reverse ---------------------
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            args = _ssd_inputs(dtype, gen)
            for reverse in (False, True):
                got = ssd_shared_kernel(*args, reverse=reverse)
                ref = ssd_shared_plain(*args, reverse=reverse)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), "ssd_shared: non-finite")
                err, rel = rel_err(got, ref)
                tol = TOL[("ssd_shared", str(dtype).split(".")[1])]
                d = "reverse" if reverse else "forward"
                ms = time_ms(lambda: ssd_shared_kernel(*args, reverse=reverse))
                print(f"ssd_shared {d} {dtype}: max_abs_err {err:.3e} "
                      f"rel {rel:.3e} (tol {tol:g}); kernel {ms:.4f} ms")
                check(rel <= tol, f"ssd_shared {d} {dtype}: rel {rel} > {tol}")
                if dtype == torch.bfloat16 and not reverse:
                    plain_ms = time_ms(
                        lambda: ssd_shared_plain(*args, reverse=reverse),
                        warmup=1, iters=3)
                    nbytes, flops = _ssd_cost(dtype, Q)
                    rec["ssd_shared"] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bytes=nbytes, flops=flops, peak=H100_BF16_FLOPS)
                del got, ref
            del args
        # --- kernel 2: fused_bidir_ssm -------------------------------------
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
            args = _bissm_inputs(dtype, gen)
            got = fused_bidir_ssm_kernel(*args)
            ref = fused_bidir_ssm_plain(*args)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "fused_bidir_ssm: non-finite")
            err, rel = rel_err(got, ref)
            tol = TOL[("fused_bidir_ssm", str(dtype).split(".")[1])]
            ms = time_ms(lambda: fused_bidir_ssm_kernel(*args))
            print(f"fused_bidir_ssm {dtype}: max_abs_err {err:.3e} rel "
                  f"{rel:.3e} (tol {tol:g}); kernel {ms:.4f} ms")
            check(rel <= tol, f"fused_bidir_ssm {dtype}: rel {rel} > {tol}")
            if dtype == torch.bfloat16:
                plain_ms = time_ms(lambda: fused_bidir_ssm_plain(*args),
                                   warmup=1, iters=3)
                nbytes, flops = _bissm_cost(dtype)
                rec["fused_bidir_ssm"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                    flops=flops, peak=H100_FP32_FLOPS)
            del got, ref, args
    torch.cuda.empty_cache()
    return rec


def synthetic_clip(n: int, h: int, w: int) -> list[np.ndarray]:
    """Seeded frames: smooth colour fields drifting across the frame plus
    fine noise, uint8 RGB."""
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    freq = rng.uniform(0.02, 0.08, size=(3, 2))
    frames = []
    for t in range(n):
        chans = [0.5 + 0.4 * np.sin(freq[c, 0] * (yy + 2 * t)
                                    + freq[c, 1] * (xx + 3 * t) + phase[c])
                 for c in range(3)]
        img = np.stack(chans, axis=-1) + rng.normal(0, 0.03, (h, w, 3))
        frames.append(np.clip(img * 255, 0, 255).astype(np.uint8))
    return frames


@phase("4 main path")
def main_path(device_line: str) -> dict:
    n, h, w = 16, 180, 320
    handler = build_handler("vsrm")
    check(handler.device.type == "cuda", "handler is not on the card")
    frames = synthetic_clip(n, h, w)
    stride = handler.chunk - handler.overlap
    windows = sum(1 for _ in iter_windows(frames, handler.chunk, stride))
    first = torch.from_numpy(np.stack(frames[:handler.chunk])).cuda()
    first = first.float() / 255.0
    handler.process_clip(first)                       # warm-up, not counted
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = list(handler.enhance_frames(iter(frames)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)

    check(len(out) == n, f"{len(out)} frames out of {n}")
    for f in out:
        check(f.shape == (4 * h, 4 * w, 3) and f.dtype == np.uint8,
              f"bad frame {f.shape} {f.dtype}")
    blocks = len(handler.params["blocks"])
    want = {"ssd_shared": 2 * blocks * windows,
            "fused_bidir_ssm": blocks * windows}
    print(f"windows {windows}; launches {counts}; expected {want}")
    check(counts == want, f"launch counts {counts} != {want}")
    fps = n / secs
    print(f"vsrm x4 {h}x{w} -> {4 * h}x{4 * w}: {n} frames in {secs:.3f} s, "
          f"{fps:.2f} frames/s, {1000 * secs / windows:.1f} ms/window "
          f"({device_line})")

    # one window: kernels against the plain versions on the card
    with torch.inference_mode():
        y_k = handler.process_clip(first)
        plain = calibrate_vsr("vsrm", lambda p, x: vsrm.apply(
            p, x, scale=handler.scale, kernels=False))
        y_p = plain(handler.params, first[None].to(handler.dtype)).float()[0]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y_k).all()), "window output not finite")
    diff = (y_k - y_p).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    print(f"window 0, kernels vs plain (bf16): max_abs {mx:.4e} (tol "
          f"{WINDOW_MAX_ABS}), mean_abs {mean:.4e} (tol {WINDOW_MEAN_ABS})")
    check(mx <= WINDOW_MAX_ABS and mean <= WINDOW_MEAN_ABS,
          "window output differs from the plain versions")
    # the streamed frames 0..6 are window 0's output
    u8 = torch.clamp(torch.round(y_k * 255.0), 0, 255).to(torch.uint8)
    lsb = np.abs(np.stack(out[:handler.chunk]).astype(np.int16)
                 - u8.cpu().numpy().astype(np.int16)).max()
    print(f"streamed frames 0..{handler.chunk - 1} vs window 0: max {lsb} LSB")
    check(lsb <= 1, "streamed frames differ from the window's output")
    return {"counts": counts, "fps": fps}


def kernel_record(rec: dict, counts: dict) -> list[dict]:
    meta = {
        "ssd_shared": ("video_enhancer_tpu_torch/csrc/ssd_shared.cu",
                       "video_enhancer_tpu/ops/ssd.py:325"),
        "fused_bidir_ssm": ("video_enhancer_tpu_torch/csrc/fused_bissm.cu",
                            "video_enhancer_tpu/ops/scan.py:941"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        r = rec[name]
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = r["flops"] / r["peak"] * 1e3
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    env = environment()
    build()
    rec = kernels_vs_plain()
    path = main_path(f"{env['kind']}, {env['smi']}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernel_record(rec, path["counts"])}))
    print(env["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["kind"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
