#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (video_enhancer_tpu_torch) on one card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printing its own elapsed seconds; any failure exits non-zero:

1. environment: the card's name, the device count, its power limit;
2. build: every CUDA kernel from ``video_enhancer_tpu_torch/csrc``, one
   nvcc process per source, all started together, and one link
   (ptxas's register/shared-memory/spill report on earlier lines);
3. kernels against their plain PyTorch versions at the main paths' shapes,
   in fp32 (TF32 off) and bf16, each with its tolerance; the flash kernel
   at ditvr's shape and at seedvr2's (one head of 128 over the 3600 tokens
   of each frame's 45x80 level, 8 frames), also at ragged lengths (one
   across a 128-row tile edge, Dh 48), the
   fused SSM also at fast_mamba_vsr's shape and at a count of sequences
   that is not a multiple of the sequences a block,
   the four Mamba-1 scans at the shapes of phases 8-9 (the short scan with
   a nonzero h0, and a control: run with h0 = 0 it must read far from the
   plain version), the shared bidirectional scan (row 10) at vsrm's and
   fast_mamba_vsr's temporal shapes and past its register bound (also
   against row 6, which computes the same sum), the depthwise conv + SiLU
   (row 11) on vsrm's strided in_proj slice at K = 5 and 4 (each of rows 6
   and 11 with its device time beside its bound, and a check that the
   served shape takes the redesigned route: row 6's tile kernel reading u,
   B and C once, row 11 two channels a thread in bf16; rows 8 and 10 as
   well, each with the exps' floor beside its bound: row 8 on its tile
   kernel with one channel a thread, row 10 at both served shapes on its
   tile kernel with a summing epilogue); time of each,
   and of the PyTorch library call that computes the same function where
   there is one; the device time of each of the SSD's three launches in
   one call (``torch.profiler``), on its tensor-core path (bf16) and its
   CUDA-core path (fp32), and of the long scan's three launches (row 9)
   and the window kernel (row 5); ptxas's registers and spills of the
   SSD's run kernels, the short scan's tile kernels, the long scan's chunk
   walks, the window kernel's tensor-core kernels, the conv kernel and the
   tile kernels of rows 6, 8 and 10;
4. the vsrm path: ``build_handler("vsrm")`` with the bundled weights at
   full width streams a seeded 16-frame 180x320 clip (window 7, stride 3,
   calibrated blend s = 0.25); checks the frames, that the SSM kernels were
   launched the expected number of times (and the flash kernel never), and
   one window against the plain versions; frames/s;
5. the auto route: ``run_auto_frames`` with ``engine="auto"`` on a seeded
   16-frame 180x320 clip that the router sends to ditvr by itself (dim,
   smooth, a fresh phase every frame); checks that the plan and the stats
   name ditvr with no fallback, that the router's degradation context
   reached the handler, that the flash kernel ran 8 times a window (and the
   SSM kernels never), the frames, and window 0 against the plain versions;
   frames/s;
6. the rvrt path: ``run_auto_frames`` with ``engine="rvrt"`` on the seeded
   16-frame 180x320 clip of phase 4 (window 7, stride 3, calibrated blend
   s = 0.25); checks that rvrt served it with no fallback, that the window
   kernel ran 4 times a window (and no other kernel), window 0 against the
   plain versions and the frames; frames/s; then that
   ``ModelFallbackManager().load_model_with_fallbacks("rvrt")`` serves rvrt
   on the card;
7. the strict-latency route: ``run_auto_frames`` with
   ``latency_class="strict"`` on a seeded 30-frame 180x320 clip; checks that
   the router itself picked fast_mamba_vsr, with no fallback, that the fused
   SSM kernel ran 8 times a window (windows of 16 overlapping by 2; no other
   kernel), window 0 against the plain versions and the frames; frames/s;
8. the exact time-sharded path on a one-rank NCCL group (``make_mesh``, a
   ``file://`` store in a temporary directory): ``make_exact_sharded_fmv``
   on phase 7's first 16 frames and ``make_exact_sharded_vsrm`` on phase 4's
   first 7, bundled weights in bf16; checks that each launched the short
   scan with state (32 and 24 times) and no other Mamba-1 scan or fused SSM
   kernel (vsrm: the SSD kernel 12 times), and that the output lies within
   the window tolerances of the single-device ``apply`` (which runs the
   fused SSM kernel); frames/s of both;
9. the layers: ``bimamba_apply`` per pixel (one bidirectional scan launch)
   and over 7 rasters (two long-scan launches), ``bissm_apply(impl=
   "composed")`` on vsrm's block-0 temporal input from phase 4's clip (one
   bidirectional scan launch; also against the fused kernel), ``ssm_apply``
   per pixel (one stateless short-scan launch), each against its plain form,
   with the route row 6 takes on each (the walking kernel at N 16, the tile
   kernel on the composed bissm) and the one row 8 takes on ``ssm_apply``
   (checked: its tile kernel with one channel a thread);
10. the opt-in kernels and the mesh code: (a) one vsrm window (phase 4's
   handler and clip) with ``vsrm.bissd_apply`` rebound to
   ``conv_impl="pallas"`` (6 conv launches, 12 SSD, 6 fused SSM, no other)
   against the grouped-conv window and the plain versions, ms per window of
   both; (b) the composed bissm on vsrm's block-0 temporal input with its
   scan on ``impl="bmajor"`` (one launch of row 10, with its route) against
   ``"bidir"`` and the plain forms; (c) on a one-rank NCCL mesh
   ``make_mesh(1, 1, 1)``, ``make_sharded_clip_fn`` (halo 2) and
   ``make_spatially_sharded_clip_fn`` (halo 8, scale 4) around
   ``vsrm.apply`` on those 7 frames against the model on the same
   edge-padded clip, trimmed, with frames/s; a handler on
   that mesh, and the registry's on the policy's (1, 1, 1) mesh, take the
   unsharded path;
11. the auto route to seedvr2: ``run_auto_frames`` on a seeded blocky
   16-frame 180x320 clip the router sends to seedvr2 (3 flash launches a
   window), window 0 against the plain versions; a sharp clip that its
   quality gate passes through with no launch;
12. the temporal-consistency post stage alone (``temporal_smooth``: torch
   Farneback flow, warp, 0.7/0.3 blend) on phase 4's 16 output frames of
   720x1280 and on its 180x320 input: ms a frame of the stage and of the
   flow, the flow's device kernels and device time from ``torch.profiler``;
   the card's flow for one pair against the CPU's (1e-4 px) and the card's
   smoothed frames against the CPU's (``STAGE_MAX_LSB``, ``STAGE_MEAN_LSB``);
   no hand-written kernel launched.

In phases 5-7 and 11 the route runs the temporal stage wherever its plan
holds ``temporal_consistency`` (phases 5-7 here): the streamed frames of
window 0 are then held within 1 LSB of the stage run on window 0's rounded
output (the stage is causal), and the stats must say it ran with no error.

The line before the card's name and power limit holds the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``. The script
needs a card: without one it exits non-zero and prints no result. It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from video_enhancer_tpu_torch import kernels
from video_enhancer_tpu_torch.config import MODELS, default_policy
from video_enhancer_tpu_torch.io.pipeline import iter_windows
from video_enhancer_tpu_torch.models import (ditvr, fast_mamba_vsr, rvrt,
                                             seedvr2, vsrm)
from video_enhancer_tpu_torch.nn import ssm
from video_enhancer_tpu_torch.nn.ssm import (bimamba_apply, bimamba_init,
                                             bissm_apply, ssm_apply)
from video_enhancer_tpu_torch.ops.attention import (attention_ref,
                                                    flash_attention,
                                                    window_attention,
                                                    window_attention_plain)
from video_enhancer_tpu_torch.ops.conv import (_dwconv_plan,
                                               depthwise_conv1d_silu,
                                               depthwise_conv1d_silu_plain)
from video_enhancer_tpu_torch.ops.scan import (
    _bidir_plan, _on_16_byte_grid, _same_view, _shared_scan_plan,
    _short_scan_plan,
    fused_bidir_ssm_kernel, fused_bidir_ssm_plain, scan_flops,
    selective_scan_assoc, selective_scan_bidir, selective_scan_bidir_plain,
    selective_scan_bidir_shared, selective_scan_bidir_shared_plain,
    selective_scan_pallas, selective_scan_pallas_short, selective_scan_plain)
from video_enhancer_tpu_torch.ops.optflow import estimate_flow_farneback
from video_enhancer_tpu_torch.ops.ssd import (_ssd_plan, ssd_shared_kernel,
                                              ssd_shared_plain)
from video_enhancer_tpu_torch.runtime.calibration import (calibrate_restore,
                                                          calibrate_vsr)
from video_enhancer_tpu_torch.parallel.inference import (
    make_exact_sharded_fmv, make_exact_sharded_vsrm, make_sharded_clip_fn)
from video_enhancer_tpu_torch.parallel.mesh import make_mesh
from video_enhancer_tpu_torch.parallel.spatial import \
    make_spatially_sharded_clip_fn
from video_enhancer_tpu_torch.runtime.experts import temporal_smooth
from video_enhancer_tpu_torch.runtime.fallback import ModelFallbackManager
from video_enhancer_tpu_torch.runtime.pipeline import (
    apply_degradation_context, preprocess_frames, run_auto_frames)
from video_enhancer_tpu_torch.runtime.registry import (build_handler,
                                                      bundled_weights,
                                                      load_params)
from video_enhancer_tpu_torch.runtime.vsr_handler import (VSRHandler,
                                                         cast_params,
                                                         window_quality)

SEED = 0
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA H100 SXM data sheet
H100_BF16_FLOPS = 989e12         # dense tensor-core rate
H100_FP32_FLOPS = 67e12          # CUDA-core rate
SFU_PER_SM_CLOCK = 16            # ex2 results an SM a clock (Hopper)

# main-path shapes at 180x320, window 7 (vsrm: dim 64 -> inner 128)
SSD_SHAPE = dict(b=7, L=180 * 320, H=2, P=64, N=16)
BISSM_SHAPE = dict(B=180 * 320, L=7, D=128, N=4, dt_rank=4, K=5)
# fast_mamba_vsr at 180x320, chunk 16: dim 48 -> inner 96, N 8, rank 3
BISSM_FMV_SHAPE = dict(B=180 * 320, L=16, D=96, N=8, dt_rank=3, K=5)
# vsrm's shape with 5 sequences fewer: not a multiple of the warps a block
BISSM_RAGGED_SHAPE = dict(BISSM_SHAPE, B=180 * 320 - 5)
# ditvr at 180x320, window 8: two 180x224 tiles in one batch, heads 3,
# 4 x 45 x 56 = 10080 tokens of patch (2, 4, 4)
FLASH_SHAPE = dict(B=2, H=3, L=10080, Dh=128)
# seedvr2 at 180x320, window 8: the UNet's spatial attention at level 2 is
# one head of 128 channels over each frame's 45 x 80 = 3600 tokens (232
# query tiles of 128, the last one 16 rows)
FLASH_SEEDVR2_SHAPE = dict(B=8, H=1, L=45 * 80, Dh=128)
FLASH_RAGGED = [dict(B=2, H=3, Lq=300, Lk=1000, Dh=64),
                dict(B=2, H=3, Lq=300, Lk=1000, Dh=128),
                dict(B=2, H=3, Lq=129, Lk=1000, Dh=48)]
# rvrt at 180x320, window 7: padded to 8x184x320, windows of 2x8x8 tokens,
# dim 64, heads 4
WINDOW_SHAPE = dict(nW=4 * 23 * 40, H=4, N=128, Dh=16)
# the Mamba-1 scans (TPU kernel rows 6-9) at 180x320: row 6 at vsrm's
# temporal bissm (composed), row 7 at fast_mamba_vsr's exact-sharded scans
# (16 frames), rows 8 and 9 at bimamba_init(dim=64)'s inner 128, N 16 per
# pixel (7 frames) and over one window's 7 rasters
SCAN_SHAPES = {"selective_scan_bidir": dict(B=180 * 320, L=7, D=128, N=4),
               "selective_scan_short": dict(B=180 * 320, L=16, D=96, N=8),
               "selective_scan_short_nostate": dict(B=180 * 320, L=7, D=128,
                                                    N=16),
               "selective_scan_long": dict(B=7, L=180 * 320, D=128, N=16)}
# row 10 at vsrm's composed temporal bissm (B and C column slices of x_proj,
# 4 + 2 * 4 = 12 wide) and at fast_mamba_vsr's (3 + 2 * 8 = 19 wide); a
# small case past the kernel's register bound (L > 32, fp32 workspace)
SHARED_SHAPES = [dict(B=180 * 320, L=7, D=128, N=4, dt_rank=4),
                 dict(B=180 * 320, L=16, D=96, N=8, dt_rank=3),
                 dict(B=4096, L=40, D=64, N=8, dt_rank=3)]
# row 11 at vsrm's spatial SSD: x (B*T 7, H*W 57600, C 160) a column slice
# of in_proj's 290-wide output (z 128 | x, B, C 160 | dt 2), K = 5; and K = 4
DWCONV_SHAPE = dict(B=7, L=180 * 320, C=160, ld=290, off=128)
DWCONV_KS = (5, 4)

# tolerances: max |kernel - plain| / max |plain|
TOL = {("ssd_shared", "float32"): 1e-4, ("ssd_shared", "bfloat16"): 2e-2,
       ("fused_bidir_ssm", "float32"): 1e-4,
       ("fused_bidir_ssm", "bfloat16"): 1e-2,
       ("flash_attention", "float32"): 1e-4,
       ("flash_attention", "bfloat16"): 2e-2,
       ("window_attention", "float32"): 1e-4,
       ("window_attention", "bfloat16"): 2e-2,
       **{(k, "float32"): 1e-4 for k in SCAN_SHAPES},
       **{(k, "bfloat16"): 1e-2 for k in SCAN_SHAPES},
       ("selective_scan_bidir_shared", "float32"): 1e-4,
       ("selective_scan_bidir_shared", "bfloat16"): 1e-2,
       ("dwconv_silu", "float32"): 1e-4,
       ("dwconv_silu", "bfloat16"): 1e-2}
# one served window, kernels vs plain versions (both bf16), on [0, 1]
WINDOW_MAX_ABS, WINDOW_MEAN_ABS = 0.05, 0.005
# the temporal stage, card against CPU: the flow in px; the smoothed
# frames in LSB (1/255), where a value a hair across k/255 on one side
# gives a gray level one apart and moves the flow a little there
FLOW_MAX_ABS = 1e-4
STAGE_MAX_LSB, STAGE_MEAN_LSB = 1.0, 0.01


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


@functools.cache
def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return float(out.splitlines()[0]) * 1e6


def ex2_floor_ms(n: float) -> float:
    """The least time ``n`` ex2 take on the card's special-function units:
    16 an SM a clock at its highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n / (SFU_PER_SM_CLOCK * sms * sm_clock_hz()) * 1e3


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
def build() -> str:
    """Builds the kernels; returns ptxas's report."""
    t0 = time.perf_counter()
    so, log = kernels.build(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for line in log.splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill",
                                   "error", "warning")):
            print(f"  {line.strip()}")
    kernels.library()
    print(f"built {so.name} (one nvcc per source, all at once, and one "
          f"link) in {secs:.2f} s")
    return log


# the kernels the redesigns of rows 1-2 and 7 (SSD, short scan), 5 (window
# attention), 11 (conv), 6 (bidirectional scan), 8 (short scan at N 16) and
# 10 (shared bidirectional scan) added or rewrote, and row 9's chunk walks
REDESIGNED = ("ssd_run_kernel", "scan_short_tile_kernel", "scan_chunk_kernel",
              "window_attn_mma", "dwconv_silu_tile_kernel",
              "scan_bidir_tile_kernel", "scan_short_n16_kernel",
              "scan_bidir_sum_kernel")


def ptxas_summary(log: str, names=REDESIGNED) -> list[str]:
    """One line per compiled instance of ``names``: its (mangled) name,
    registers and spills, from ptxas's report."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((mangled[mangled.index(n):] for n in names
                         if n in mangled), None)
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            out.append(f"{name}: {regs}; {spill}")
            name = None
    return out


def device_ms(fn, keys, iters: int = 10) -> dict:
    """Device time a call of each kernel whose name holds one of ``keys``,
    from ``torch.profiler`` (CUPTI), over ``iters`` calls after one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = (getattr(e, "device_time_total", None)
             or getattr(e, "cuda_time_total", 0))
        if t and any(k in e.key for k in keys):
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0]
            out[name] = round(out.get(name, 0.0) + t / 1e3 / iters, 4)
    return out


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


def _bissm_inputs(dtype, gen, s=BISSM_SHAPE):
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


def _bissm_cost(dtype, s=BISSM_SHAPE) -> tuple[float, float]:
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


def _flash_inputs(dtype, gen, B, H, Lq, Lk, Dh):
    """q, k, v as ditvr hands them over: (B, H, L, Dh) views of the column
    slices of one (B, L, 3*H*Dh) projection (of two when Lq != Lk)."""
    c = H * Dh

    def mh(z, n):
        return z.reshape(B, n, H, Dh).transpose(1, 2)

    if Lq == Lk:
        qkv = torch.randn((B, Lq, 3 * c), generator=gen, device="cuda")
        q, k, v = qkv.to(dtype).chunk(3, dim=-1)
        return mh(q, Lq), mh(k, Lk), mh(v, Lk)
    xq = torch.randn((B, Lq, c), generator=gen, device="cuda").to(dtype)
    xkv = torch.randn((B, Lk, 2 * c), generator=gen, device="cuda").to(dtype)
    k, v = xkv.chunk(2, dim=-1)
    return mh(xq, Lq), mh(k, Lk), mh(v, Lk)


def _flash_cost(dtype, B, H, Lq, Lk, Dh) -> tuple[float, float]:
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * H * Lq * Dh + 2 * B * H * Lk * Dh) * item
    return nbytes, 4.0 * B * H * Lq * Lk * Dh


def flash_vs_plain() -> dict:
    """The flash kernel against attention_ref at ditvr's and seedvr2's
    shapes and at ragged lengths; at the two paths' shapes its time beside
    the plain version's and SDPA's."""
    rec = {}
    named = {"flash_attention": FLASH_SHAPE,
             "flash_attention:seedvr2": FLASH_SEEDVR2_SHAPE}
    cases = [(key, dict(B=s["B"], H=s["H"], Lq=s["L"], Lk=s["L"],
                        Dh=s["Dh"])) for key, s in named.items()]
    cases += [(None, shp) for shp in FLASH_RAGGED]
    for ci, (key, shp) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 2 + ci)
            q, k, v = _flash_inputs(dtype, gen, **shp)
            got = flash_attention(q, k, v)
            ref = attention_ref(q, k, v)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  "flash_attention: non-finite")
            err, rel = rel_err(got, ref)
            tol = TOL[("flash_attention", str(dtype).split(".")[1])]
            ms = time_ms(lambda: flash_attention(q, k, v))
            print(f"flash_attention {shp} {dtype}: max_abs_err {err:.3e} "
                  f"rel {rel:.3e} (tol {tol:g}); kernel {ms:.4f} ms")
            check(rel <= tol, f"flash_attention {shp} {dtype}: rel {rel} > "
                              f"{tol}")
            if key is not None and dtype == torch.bfloat16:
                plain_ms = time_ms(lambda: attention_ref(q, k, v),
                                   warmup=1, iters=3)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                lib_ms = time_ms(lambda: sdpa(q, k, v))
                nbytes, flops = _flash_cost(dtype, **shp)
                print(f"{key} path shape bf16: plain {plain_ms:.3f} ms, "
                      f"scaled_dot_product_attention {lib_ms:.4f} ms")
                rec[key] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bytes=nbytes, flops=flops,
                    peak=H100_BF16_FLOPS)
            del got, ref, q, k, v
    return rec


def _window_inputs(dtype, gen, nW, H, N, Dh):
    """q, k, v as rvrt hands them over: (nW, H, N, Dh) views of the column
    slices of one (nW, N, 3 H Dh) projection; the (H, N, N) fp32 bias."""
    qkv = torch.randn((nW, N, 3 * H * Dh), generator=gen, device="cuda")
    q, k, v = (t.reshape(nW, N, H, Dh).transpose(1, 2)
               for t in qkv.to(dtype).chunk(3, dim=-1))
    # of the logits' own scale (q k^T Dh^-0.5 has a std of about 1), so
    # that a bias that is dropped or read at the wrong place moves o far
    # beyond the tolerance; rvrt's trained tables are smaller (std ~0.05)
    bias = torch.randn((H, N, N), generator=gen, device="cuda")
    return q, k, v, bias


# what a kernel that drops the bias, reads another head's or transposes its
# (N, N) block would compute; each must read at least CONTROL_MARGIN x the
# tolerance away from the kernel, so the check above would have failed it
WINDOW_CONTROLS = {"no bias": lambda b: torch.zeros_like(b),
                   "next head's bias": lambda b: b.roll(1, dims=0),
                   "transposed bias": lambda b: b.transpose(1, 2)}
CONTROL_MARGIN = 5.0


def _window_cost(dtype, nW, H, N, Dh) -> tuple[float, float]:
    item = torch.finfo(dtype).bits // 8
    return 4 * nW * H * N * Dh * item + H * N * N * 4, 4.0 * nW * H * N * N * Dh


def window_vs_plain() -> dict:
    """The window kernel against its plain version at rvrt's shape; its
    time beside the plain version's and SDPA's with the bias as a mask."""
    rec = {}
    s = WINDOW_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        q, k, v, bias = _window_inputs(dtype, gen, **s)
        got = window_attention(q, k, v, bias)
        ref = window_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()),
              "window_attention: non-finite")
        err, rel = rel_err(got, ref)
        tol = TOL[("window_attention", str(dtype).split(".")[1])]
        ms = time_ms(lambda: window_attention(q, k, v, bias))
        plain_ms = time_ms(lambda: window_attention_plain(q, k, v, bias),
                           warmup=1, iters=3)
        mask = bias[None].expand(s["nW"], -1, -1, -1).to(dtype)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask))
        nbytes, flops = _window_cost(dtype, **s)
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
        bound = max(nbytes / H100_BYTES_PER_S, flops / peak) * 1e3
        dev = device_ms(lambda: window_attention(q, k, v, bias),
                        ("window_attn",))
        print(f"window_attention {s} {dtype}: max_abs_err {err:.3e} rel "
              f"{rel:.3e} (tol {tol:g}); kernel {ms:.4f} ms (device ms "
              f"{dev}), plain {plain_ms:.3f} ms, "
              f"scaled_dot_product_attention with the bias mask "
              f"{lib_ms:.4f} ms, bound {bound:.4f} ms")
        check(rel <= tol, f"window_attention {dtype}: rel {rel} > {tol}")
        for what, wrong in WINDOW_CONTROLS.items():
            _, c_rel = rel_err(got, window_attention_plain(q, k, v,
                                                           wrong(bias)))
            print(f"  control, plain with the {what}: rel {c_rel:.3e} (must "
                  f"be >= {CONTROL_MARGIN * tol:g})")
            check(c_rel >= CONTROL_MARGIN * tol,
                  f"window_attention {dtype}: the check cannot tell the "
                  f"kernel from one with the {what} (rel {c_rel})")
        if dtype == torch.bfloat16:
            rec["window_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bytes=nbytes, flops=flops, peak=peak)
        del got, ref, q, k, v, bias, mask
    return rec


def _scan_inputs(dtype, gen, B, L, D, N, dt_rank=4):
    """x, dt, A, B, C, D as the layers hand them to the scans: B and C
    column slices of one x_proj output; dt a softplus (~0.05-0.4); A the
    S4D-real -(1..N) per channel, scaled; D of the skip's scale."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = rnd(B, L, D).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, L, D, scale=0.5) - 2.0).to(dtype)
    proj = rnd(B, L, dt_rank + 2 * N).to(dtype)
    Bm, Cm = proj[..., dt_rank:dt_rank + N], proj[..., dt_rank + N:]
    A = -torch.arange(1, N + 1, device="cuda").float() * torch.exp(
        rnd(D, 1, scale=0.3))
    return x, dt, A, Bm, Cm, rnd(D, scale=0.5)


def _nbytes(*ts) -> int:
    """Bytes of the distinct tensors (an operand passed twice counts once)."""
    seen = {(t.data_ptr(), tuple(t.shape), t.stride()): t for t in ts}
    return sum(t.numel() * t.element_size() for t in seen.values())


def scans_vs_plain() -> dict:
    """The four Mamba-1 scan kernels against their plain versions at the
    paths' shapes, in fp32 and bf16, with their times and bounds. The
    stateful short scan run with h0 = 0 must read at least CONTROL_MARGIN x
    the tolerance away from the plain version with the real h0."""
    rec = {}
    for key, s in SCAN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
            x, dt, A, Bm, Cm, Dv = _scan_inputs(dtype, gen, **s)
            tol = TOL[(key, str(dtype).split(".")[1])]
            state = key in ("selective_scan_short", "selective_scan_long")
            h0 = (torch.randn((s["B"], s["D"], s["N"]), generator=gen,
                              device="cuda") if state else None)
            if key == "selective_scan_bidir":
                # vsrm's composed bissm: u, B and C shared by both streams
                dtb = torch.nn.functional.softplus(
                    torch.randn(x.shape, generator=gen, device="cuda") * 0.5
                    - 2.0).to(dtype)
                Ab, Db = A.flip(1), Dv.flip(0)
                args = (x, dt, A, Bm, Cm, Dv, x, dtb, Ab, Bm, Cm, Db)
                # the served shape takes the tile kernel, x, B, C read once
                # (the wrapper's own tests of the operands)
                plan = _bidir_plan(
                    s["B"], s["L"], s["D"], s["N"], x.element_size(),
                    _on_16_byte_grid(*args[:2], *args[6:8]),
                    all(_same_view(args[i], args[i + 6]) for i in (0, 3, 4)))
                print(f"{key} {dtype}: route {plan['route']}, sequences a "
                      f"block {plan['seqs']}, shared {plan['shared']}")
                check(plan["route"] == "tile" and plan["shared"],
                      f"{key}: the served shape takes {plan}")
                shared = selective_scan_bidir_shared(x, dt, dtb, A, Ab, Bm,
                                                     Cm, Dv, Db)
                run = lambda: selective_scan_bidir(*args)        # noqa: E731
                plain = lambda: selective_scan_bidir_plain(*args)  # noqa: E731
                nbytes = _nbytes(*args) + 2 * x.numel() * x.element_size()
                flops = scan_flops(**s, streams=2)
            else:
                args = (x, dt, A, Bm, Cm, Dv)
                if key == "selective_scan_short_nostate":
                    # the served shape takes row 8's tile kernel with one
                    # channel a thread (the wrapper's own tests of x and dt)
                    plan = _short_scan_plan(
                        s["B"], s["L"], s["D"], s["N"], x.element_size(),
                        _on_16_byte_grid(x, dt), state=False)
                    print(f"{key} {dtype}: route {plan['route']}, sequences "
                          f"a block {plan['seqs']}")
                    check(plan["route"] == "tile_n16",
                          f"{key}: the served shape takes {plan}")
                if key == "selective_scan_long":
                    run = lambda: selective_scan_pallas(*args, h0=h0)  # noqa: E731
                    plain = lambda: selective_scan_assoc(*args, h0=h0)  # noqa: E731
                elif state:
                    run = lambda: selective_scan_pallas_short(  # noqa: E731
                        *args, h0=h0)
                    plain = lambda: selective_scan_plain(  # noqa: E731
                        *args, h0=h0)
                else:
                    run = lambda: selective_scan_pallas_short(  # noqa: E731
                        *args, need_state=False)
                    plain = lambda: selective_scan_plain(*args)  # noqa: E731
                nbytes = (_nbytes(*args) + x.numel() * x.element_size()
                          + (2 * h0.numel() * 4 if state else 0))
                flops = scan_flops(**s)
            got = run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ref = plain()
            torch.cuda.synchronize()
            print(f"{key} {dtype}: the plain version's peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            errs = []
            for name, g, r in zip(("yf", "yb") if key.endswith("bidir")
                                  else ("y", "h_last"), got, ref):
                if g is None:
                    continue
                check(bool(torch.isfinite(g.float()).all()),
                      f"{key} {name}: non-finite")
                err, rel = rel_err(g, r)
                errs.append(err)
                print(f"{key} {s} {dtype} {name}: max_abs_err {err:.3e} rel "
                      f"{rel:.3e} (tol {tol:g})")
                check(rel <= tol, f"{key} {name} {dtype}: rel {rel} > {tol}")
            if key.endswith("bidir"):
                _, rel = rel_err(shared, ref[0] + ref[1])
                print(f"  selective_scan_bidir_shared(impl='bidir'): rel "
                      f"{rel:.3e}")
                check(rel <= tol, f"bidir_shared {dtype}: rel {rel} > {tol}")
            if key == "selective_scan_short":
                y_zero, _ = selective_scan_pallas_short(
                    *args, h0=torch.zeros_like(h0))
                _, c_rel = rel_err(y_zero, ref[0])
                print(f"  control, the kernel with h0 = 0: rel {c_rel:.3e} "
                      f"(must be >= {CONTROL_MARGIN * tol:g})")
                check(c_rel >= CONTROL_MARGIN * tol,
                      f"{key} {dtype}: the check cannot tell a kernel that "
                      f"ignores h0 (rel {c_rel})")
            ms = time_ms(run)
            bound = max(nbytes / H100_BYTES_PER_S,
                        flops / H100_FP32_FLOPS) * 1e3
            print(f"{key} {dtype}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
            if key == "selective_scan_long":
                # its three launches: chunk states, the pass, outputs
                print(f"{key} {dtype}: device ms "
                      f"{device_ms(run, ('scan_chunk', 'scan_state_pass'))}")
            if key in ("selective_scan_bidir", "selective_scan_short_nostate"):
                exps = s["B"] * s["L"] * s["D"] * s["N"] * (
                    2 if key == "selective_scan_bidir" else 1)
                print(f"{key} {dtype}: device ms "
                      f"{device_ms(run, ('scan_bidir', 'scan_short'))} (bound "
                      f"{bound:.4f} ms; the exps' floor "
                      f"{ex2_floor_ms(exps):.4f} ms)")
            if dtype == torch.bfloat16:
                plain_ms = time_ms(plain, warmup=1, iters=3)
                print(f"{key} {dtype}: plain {plain_ms:.3f} ms")
                rec[key] = dict(max_abs_err=max(errs), ms=ms,
                                plain_ms=plain_ms, bytes=nbytes, flops=flops,
                                peak=H100_FP32_FLOPS, library_ms=None)
            del got, ref, args, run, plain, x, dt, Bm, Cm, h0
            torch.cuda.empty_cache()
    return rec


def shared_scan_vs_plain() -> dict:
    """Row 10 (``selective_scan_bidir_shared(impl="bmajor")``) against its
    plain version and against row 6 (``impl="bidir"``, the same yf + yb),
    at the paths' shapes and past the register bound, fp32 and bf16."""
    rec = {}
    for si, s in enumerate(SHARED_SHAPES):
        shape = {k: s[k] for k in ("B", "L", "D", "N")}
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + si)
            u, dtf, Af, Bm, Cm, Df = _scan_inputs(dtype, gen, **s)
            dtb = torch.nn.functional.softplus(
                torch.randn(u.shape, generator=gen, device="cuda") * 0.5
                - 2.0).to(dtype)
            Ab, Db = Af.flip(1), Df.flip(0)
            args = (u, dtf, dtb, Af, Ab, Bm, Cm, Df, Db)
            run = lambda: selective_scan_bidir_shared(  # noqa: E731
                *args, impl="bmajor")
            got = run()
            ref = selective_scan_bidir_shared_plain(*args)
            bidir = selective_scan_bidir_shared(*args, impl="bidir")
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  "selective_scan_bidir_shared: non-finite")
            tol = TOL[("selective_scan_bidir_shared",
                       str(dtype).split(".")[1])]
            err, rel = rel_err(got, ref)
            _, rel_b = rel_err(got, bidir)
            print(f"selective_scan_bidir_shared {shape} {dtype}: max_abs_err "
                  f"{err:.3e} rel {rel:.3e}, vs impl='bidir' rel {rel_b:.3e} "
                  f"(tol {tol:g})")
            check(rel <= tol and rel_b <= tol,
                  f"selective_scan_bidir_shared {shape} {dtype}: rel {rel} / "
                  f"{rel_b} > {tol}")
            ms = time_ms(run)
            nbytes = _nbytes(*args) + u.numel() * u.element_size()
            flops = scan_flops(**shape, streams=2)
            bound = max(nbytes / H100_BYTES_PER_S,
                        flops / H100_FP32_FLOPS) * 1e3
            # the served shapes take the tile kernel with a summing epilogue
            plan = _shared_scan_plan(*shape.values(), u.element_size(),
                                     _on_16_byte_grid(u, dtf, dtb))
            print(f"selective_scan_bidir_shared {shape} {dtype}: route "
                  f"{plan['route']}, sequences a block {plan['seqs']}")
            check(si == 2 or plan["route"] == "tile_sum",
                  f"selective_scan_bidir_shared {shape}: takes {plan}")
            line = (f"selective_scan_bidir_shared {shape} {dtype}: kernel "
                    f"{ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} "
                    f"MB, {flops / 1e9:.2f} GFLOP), the exps' floor "
                    f"{ex2_floor_ms(2 * u.numel() * shape['N']):.4f} ms, "
                    f"device ms {device_ms(run, ('scan_bidir',))}")
            if dtype == torch.bfloat16 and si < 2:
                plain_ms = time_ms(
                    lambda: selective_scan_bidir_shared_plain(*args),
                    warmup=1, iters=3)
                bidir_ms = time_ms(lambda: selective_scan_bidir_shared(
                    *args, impl="bidir"))
                line += (f", plain {plain_ms:.3f} ms, impl='bidir' (row 6 "
                         f"and a sum) {bidir_ms:.4f} ms")
                key = "selective_scan_bidir_shared" + (
                    "" if si == 0 else ":fast_mamba_vsr")
                rec[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bytes=nbytes, flops=flops,
                                peak=H100_FP32_FLOPS, library_ms=None)
            print(line)
            del got, ref, bidir, args, run, u, dtf, dtb, Bm, Cm
            torch.cuda.empty_cache()
    return rec


def _dwconv_inputs(dtype, gen, K):
    s = DWCONV_SHAPE
    wide = torch.randn((s["B"], s["L"], s["ld"]), generator=gen,
                       device="cuda").to(dtype)
    x = wide[..., s["off"]:s["off"] + s["C"]]
    # bissd casts the conv weight to x's dtype (nn/ssm.py)
    w = (torch.randn((s["C"], 1, K), generator=gen, device="cuda")
         / K ** 0.5).to(dtype)
    b = torch.randn((s["C"],), generator=gen, device="cuda") * 0.1
    return x, w, b


def dwconv_vs_plain() -> dict:
    """Row 11 (``depthwise_conv1d_silu``) against its plain version on
    vsrm's strided view, K = 5 and 4, fp32 and bf16; its time beside the
    plain version's and PyTorch's ``F.conv1d(groups=C)`` then ``F.silu``."""
    rec = {}
    s = DWCONV_SHAPE
    F = torch.nn.functional
    for K in DWCONV_KS:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 20 + K)
            x, w, b = _dwconv_inputs(dtype, gen, K)
            check(x.stride(1) == s["ld"] and not x.is_contiguous(),
                  "dwconv_silu: x is not vsrm's strided view")
            got = depthwise_conv1d_silu(x, w, b)
            ref = depthwise_conv1d_silu_plain(x, w, b)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  "dwconv_silu: non-finite")
            tol = TOL[("dwconv_silu", str(dtype).split(".")[1])]
            err, rel = rel_err(got, ref)
            ms = time_ms(lambda: depthwise_conv1d_silu(x, w, b))
            plan = _dwconv_plan(s["B"], s["L"], s["C"], K, s["ld"],
                                x.element_size(), x.data_ptr(),
                                kernels.sm_count(x.device))
            # vsrm's rows (580 bytes apart in bf16) are read two channels a
            # thread; fp32 one
            check(plan["vec"] == (2 if dtype == torch.bfloat16 else 1),
                  f"dwconv_silu {dtype}: plan {plan}")
            item = x.element_size()
            n = s["B"] * s["L"] * s["C"]
            nbytes = 2 * n * item + w.numel() * item + b.numel() * 4
            flops = n * (2.0 * K + 5.0)
            bound = max(nbytes / H100_BYTES_PER_S,
                        flops / H100_FP32_FLOPS) * 1e3
            print(f"dwconv_silu {s} K={K} {dtype}: max_abs_err {err:.3e} rel "
                  f"{rel:.3e} (tol {tol:g}); kernel {ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB); device ms "
                  f"{device_ms(lambda: depthwise_conv1d_silu(x, w, b), ('dwconv',))}"
                  f"; plan: {plan['vec']} channels a thread, "
                  f"{plan['rows']} rows a tile, "
                  f"{plan['smem']} B, grid {plan['grid']}")
            check(rel <= tol, f"dwconv_silu K={K} {dtype}: rel {rel} > {tol}")
            if dtype == torch.bfloat16:
                plain_ms = time_ms(lambda: depthwise_conv1d_silu_plain(
                    x, w, b), warmup=1, iters=3)
                print(f"dwconv_silu K={K} bf16: plain {plain_ms:.3f} ms")
            if dtype == torch.bfloat16 and K % 2:
                # two calls on the channels-first view of the same x (an odd
                # K pads both ends alike, so conv1d pads it itself)
                xt, bd = x.transpose(1, 2), b.to(dtype)
                lib_ms = time_ms(lambda: F.silu(F.conv1d(
                    xt, w, bd, padding=(K - 1) // 2, groups=s["C"])))
                _, lib_rel = rel_err(F.silu(F.conv1d(
                    xt, w, bd, padding=(K - 1) // 2,
                    groups=s["C"])).transpose(1, 2), ref)
                print(f"dwconv_silu K={K} bf16: F.conv1d(groups=C) then "
                      f"F.silu {lib_ms:.4f} ms (rel to plain {lib_rel:.3e})")
                rec["dwconv_silu"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bytes=nbytes, flops=flops,
                    peak=H100_FP32_FLOPS)
                del xt
            del got, ref, x, w, b
            torch.cuda.empty_cache()
    return rec


@phase("3 kernels vs plain")
def kernels_vs_plain(ptxas_log: str) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Q = kernels.library().vetk_ssd_chunk()
    rec = {}
    for line in ptxas_summary(ptxas_log):
        print(f"ptxas {line}")
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
                if not reverse:
                    # the device time of each of the call's three launches
                    plan = _ssd_plan(*args[0].shape, args[-1].shape[-1], dtype,
                                     kernels.sm_count(args[0].device))
                    split = device_ms(
                        lambda: ssd_shared_kernel(*args, reverse=False),
                        ("ssd_",))
                    print(f"ssd_shared split {dtype}, {plan['route']} path "
                          f"(chunks a run {plan['run']}, runs "
                          f"{plan['runs']}): device ms {split}")
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
        # --- kernel 2: fused_bidir_ssm, at vsrm's and fast_mamba_vsr's shape
        # and at a count of sequences that is not a multiple of a block's
        for key, shape in (("fused_bidir_ssm", BISSM_SHAPE),
                           ("fused_bidir_ssm:fast_mamba_vsr", BISSM_FMV_SHAPE),
                           ("fused_bidir_ssm:ragged B", BISSM_RAGGED_SHAPE)):
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
                args = _bissm_inputs(dtype, gen, shape)
                got = fused_bidir_ssm_kernel(*args)
                ref = fused_bidir_ssm_plain(*args)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"{key}: non-finite")
                err, rel = rel_err(got, ref)
                tol = TOL[("fused_bidir_ssm", str(dtype).split(".")[1])]
                ms = time_ms(lambda: fused_bidir_ssm_kernel(*args))
                print(f"{key} {shape} {dtype}: max_abs_err {err:.3e} rel "
                      f"{rel:.3e} (tol {tol:g}); kernel {ms:.4f} ms")
                check(rel <= tol, f"{key} {dtype}: rel {rel} > {tol}")
                if dtype == torch.bfloat16:
                    plain_ms = time_ms(lambda: fused_bidir_ssm_plain(*args),
                                       warmup=1, iters=3)
                    nbytes, flops = _bissm_cost(dtype, shape)
                    print(f"{key} bf16: plain {plain_ms:.3f} ms")
                    rec[key] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bytes=nbytes, flops=flops, peak=H100_FP32_FLOPS)
                del got, ref, args
        # --- kernel 3: flash_attention ---------------------------------------
        rec.update(flash_vs_plain())
        # --- kernel 4: window_attention --------------------------------------
        rec.update(window_vs_plain())
        # --- the Mamba-1 scans (TPU kernel rows 6-9) -------------------------
        rec.update(scans_vs_plain())
        # --- row 10: the shared bidirectional scan ---------------------------
        rec.update(shared_scan_vs_plain())
        # --- row 11: the depthwise conv + SiLU -------------------------------
        rec.update(dwconv_vs_plain())
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


@phase("4 vsrm path")
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
    want = dict.fromkeys(kernels.launch_counts, 0)
    want.update(ssd_shared=2 * blocks * windows,
                fused_bidir_ssm=blocks * windows)
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
    return {"counts": counts, "fps": fps, "frames": out}


def dim_clip(n: int, h: int, w: int, seed: int = SEED) -> list[np.ndarray]:
    """Seeded frames the router sends to ditvr: a dim, smooth sinusoid,
    0.2 + 0.15 sin(0.1 (x + 0.7 y) + phase), with a fresh random phase for
    every frame and channel, uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for _ in range(n):
        ph = rng.uniform(0, 2 * np.pi, size=3)
        img = np.stack([0.2 + 0.15 * np.sin(0.1 * (xx + 0.7 * yy) + ph[c])
                        for c in range(3)], axis=-1)
        frames.append(np.clip(np.round(img * 255), 0, 255).astype(np.uint8))
    return frames


def blocky_clip(n: int, h: int, w: int, seed: int = SEED) -> list[np.ndarray]:
    """Seeded frames the router sends to seedvr2: a smooth colour field,
    0.5 + 0.25 sin(0.03 (x + 2 t) + 0.02 y + phase), drifting slowly and
    averaged over each 8x8 block, as a coarse codec leaves it (compression
    1.0, unknown well below its threshold; soft enough that seedvr2's
    quality gate runs every window), uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, size=3)
    hb, wb = h // 8 * 8, w // 8 * 8
    frames = []
    for t in range(n):
        img = np.stack([0.5 + 0.25 * np.sin(0.03 * (xx + 2 * t) + 0.02 * yy
                                            + ph[c]) for c in range(3)], -1)
        blk = img[:hb, :wb].reshape(hb // 8, 8, wb // 8, 8, 3).mean((1, 3))
        img[:hb, :wb] = np.repeat(np.repeat(blk, 8, 0), 8, 1)
        frames.append(np.clip(np.round(img * 255), 0, 255).astype(np.uint8))
    return frames


def sharp_clip(n: int, h: int, w: int, seed: int = SEED) -> list[np.ndarray]:
    """Seeded uniform uint8 noise: a sharpness score of 1, so seedvr2's
    quality gate passes every window through."""
    rng = np.random.default_rng(seed)
    return list(rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8))


@phase("5 auto route to ditvr")
def auto_route(device_line: str) -> dict:
    n, h, w = 16, 180, 320
    frames = dim_clip(n, h, w)
    run_auto_frames(frames)                           # warm-up, not counted
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out, stats = run_auto_frames(frames)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)

    plan = stats["routing_plan"]
    routing = plan["expert_routing"]
    deg = plan["degradations"]
    print("degradations " + ", ".join(f"{k} {v:.4f}" for k, v in deg.items()))
    print(f"plan: primary {routing['primary_model']}, order "
          f"{plan['processing_order']}, experts "
          f"{sorted(k for k, v in routing['experts'].items() if v)}")
    check(routing["primary_model"] == "ditvr" and "fallback" not in plan,
          f"the router did not route to ditvr: {routing['primary_model']}, "
          f"{plan.get('content_analysis')}")
    check("fallback_from" not in stats and stats["model"] == "ditvr",
          f"the pipeline fell back: {stats.get('fallback_error')}")

    entry = MODELS["ditvr"]
    windows = sum(1 for _ in iter_windows(frames, entry.window, entry.stride))
    want = dict.fromkeys(kernels.launch_counts, 0)
    want["flash_attention"] = entry.extra["depth"] * windows
    print(f"windows {windows}; launches {counts}; expected {want}")
    check(counts == want, f"launch counts {counts} != {want}")
    check(len(out) == n, f"{len(out)} frames out of {n}")
    for f in out:
        check(f.shape == (h, w, 3) and f.dtype == np.uint8,
              f"bad frame {f.shape} {f.dtype}")

    # the conditioning the route ran with is the router's estimate
    handler = build_handler("ditvr")
    apply_degradation_context(handler, plan)
    ctx = {k: v.tolist() for k, v in handler.context.items()}
    print(f"context: {stats.get('context')}; from the plan: {ctx}")
    check(stats.get("context") == ctx, "the context did not reach the handler")
    check(ctx["degradation_scores"] != [0.0, 0.0, 0.0],
          "the context is still the handler's initial one")

    # window 0: kernels against the plain versions, and the streamed frames
    first = frames[:entry.window]
    if "preprocessing" in plan["processing_order"]:
        first = preprocess_frames(first, routing["experts"], handler.device)
    clip = torch.from_numpy(np.stack(first)).cuda().float() / 255.0
    heads = entry.extra["heads"]
    plain = copy.copy(handler)
    plain.apply_fn = calibrate_restore(
        "ditvr", lambda p, x, degradation_scores, degradation_type:
        ditvr.apply(p, x, degradation_type=degradation_type,
                    degradation_scores=degradation_scores, heads=heads,
                    kernels=False))
    with torch.inference_mode():
        y_k = handler.process_clip(clip)
        y_p = plain.process_clip(clip)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y_k).all()), "window output not finite")
    diff = (y_k - y_p).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    print(f"window 0, kernels vs plain (bf16): max_abs {mx:.4e} (tol "
          f"{WINDOW_MAX_ABS}), mean_abs {mean:.4e} (tol {WINDOW_MEAN_ABS})")
    check(mx <= WINDOW_MAX_ABS and mean <= WINDOW_MEAN_ABS,
          "window output differs from the plain versions")
    _lsb_check(out, y_k, entry.window, stats)

    enh = stats["processing_time_sec"]
    print(f"ditvr auto route {h}x{w}: {n} frames in {secs:.3f} s end to end "
          f"= {n / secs:.2f} frames/s (routing {plan['analysis_time_sec']:.3f}"
          f" s{_stage_note(stats, n)}); enhance {enh:.3f} s = "
          f"{stats['fps']:.2f} frames/s, "
          f"{1000 * enh / windows:.1f} ms/window ({device_line})")
    return {"counts": counts, "fps": n / secs}


def _window_check(frames, plan, handler, plain_apply) -> torch.Tensor:
    """Window 0 of a served run through the kernels against the plain
    versions (both bf16, on the card); returns the kernels' output."""
    routing = plan["expert_routing"]
    first = frames[:handler.chunk]
    if "preprocessing" in plan["processing_order"]:
        first = preprocess_frames(first, routing["experts"], handler.device)
    clip = torch.from_numpy(np.stack(first)).cuda().float() / 255.0
    plain = copy.copy(handler)
    plain.apply_fn = plain_apply
    with torch.inference_mode():
        y_k = handler.process_clip(clip)
        y_p = plain.process_clip(clip)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y_k).all()), "window output not finite")
    diff = (y_k - y_p).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    print(f"window 0, kernels vs plain (bf16): max_abs {mx:.4e} (tol "
          f"{WINDOW_MAX_ABS}), mean_abs {mean:.4e} (tol {WINDOW_MEAN_ABS})")
    check(mx <= WINDOW_MAX_ABS and mean <= WINDOW_MEAN_ABS,
          "window output differs from the plain versions")
    return y_k


def _served_run(frames, kw: dict, name: str, per_window: dict,
                chunk: int, stride: int, device_line: str,
                scale: int = 4) -> tuple:
    """One warm-up and one counted ``run_auto_frames`` call; checks the
    plan, the stats, the launches (``per_window`` for each window that ran
    the model: all but those the quality gate skipped) and the frames.
    Returns the frames out, the stats and the counts."""
    check(bundled_weights(name) is not None,
          f"{name}: no bundled checkpoint; the run would serve random init")
    run_auto_frames(frames, **kw)                     # warm-up, not counted
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out, stats = run_auto_frames(frames, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)

    plan = stats["routing_plan"]
    routing = plan["expert_routing"]
    print(f"plan: primary {routing['primary_model']}, order "
          f"{plan['processing_order']}, experts "
          f"{sorted(k for k, v in routing['experts'].items() if v)}")
    check(routing["primary_model"] == name and "fallback" not in plan,
          f"the plan's primary is {routing['primary_model']}, not {name}")
    check("fallback_from" not in stats and stats["model"] == name,
          f"the pipeline fell back: {stats.get('fallback_error')}")
    windows = sum(1 for _ in iter_windows(frames, chunk, stride))
    ran = windows - stats["windows_skipped"]
    want = {k: per_window.get(k, 0) * ran for k in kernels.launch_counts}
    print(f"windows {windows} ({stats['windows_skipped']} skipped); launches "
          f"{counts}; expected {want}")
    check(counts == want, f"launch counts {counts} != {want}")
    h, w = frames[0].shape[:2]
    check(len(out) == len(frames), f"{len(out)} frames out of {len(frames)}")
    for f in out:
        check(f.shape == (scale * h, scale * w, 3) and f.dtype == np.uint8,
              f"bad frame {f.shape} {f.dtype}")
    enh = stats["processing_time_sec"]
    n = len(frames)
    print(f"{name} x{scale} {h}x{w} -> {scale * h}x{scale * w}: {n} frames "
          f"in {secs:.3f} s "
          f"end to end = {n / secs:.2f} frames/s (routing "
          f"{plan['analysis_time_sec']:.3f} s{_stage_note(stats, n)}); "
          f"enhance {enh:.3f} s = "
          f"{stats['fps']:.2f} frames/s, {1000 * enh / windows:.1f} ms/window"
          f" ({device_line})")
    return out, stats, counts


def _stage_note(stats: dict, n: int) -> str:
    """The temporal stage's share of a served run, for its summary line."""
    if "temporal_smoothing_sec" not in stats:
        return "; no temporal stage"
    t = stats["temporal_smoothing_sec"]
    return f"; temporal stage {t:.3f} s = {1000 * t / n:.2f} ms/frame"


def _lsb_check(out, y_k, chunk: int, stats: dict) -> None:
    """The streamed frames of window 0 against its output or, where the
    plan holds the temporal stage, against the stage on its rounded output
    (the stage is causal, so the first frames out depend on these alone);
    the stats must say the stage ran, with no error."""
    u8 = torch.clamp(torch.round(y_k * 255.0), 0, 255).to(torch.uint8)
    check("temporal_consistency_error" not in stats,
          f"the temporal stage failed: "
          f"{stats.get('temporal_consistency_error')}")
    what = "window 0"
    if "temporal_consistency" in stats["routing_plan"]["processing_order"]:
        check(stats.get("temporal_smoothing") is True,
              "the plan holds the temporal stage and it did not run")
        with torch.inference_mode():
            smooth = temporal_smooth(u8.float() / 255.0)
        u8 = torch.clamp(torch.round(smooth * 255.0), 0, 255).to(torch.uint8)
        what = "the temporal stage on window 0"
    else:
        check("temporal_smoothing" not in stats,
              "the temporal stage ran without the plan asking for it")
    lsb = np.abs(np.stack(out[:chunk]).astype(np.int16)
                 - u8.cpu().numpy().astype(np.int16)).max()
    print(f"streamed frames 0..{chunk - 1} vs {what}: max {lsb} LSB")
    check(lsb <= 1, f"streamed frames differ from {what}")


@phase("6 rvrt path")
def rvrt_path(device_line: str) -> dict:
    frames = synthetic_clip(16, 180, 320)
    entry = MODELS["rvrt"]
    depth = 4                                          # rvrt.init's default
    out, stats, counts = _served_run(
        frames, {"engine": "rvrt"}, "rvrt", {"window_attention": depth},
        entry.window, entry.stride, device_line)
    handler = build_handler("rvrt")
    check(len(handler.params["blocks"]) == depth, "rvrt depth changed")
    y_k = _window_check(frames, stats["routing_plan"], handler,
                        calibrate_vsr("rvrt", lambda p, x: rvrt.apply(
                            p, x, scale=entry.scale, kernels=False)))
    _lsb_check(out, y_k, handler.chunk, stats)
    manager = ModelFallbackManager()
    fb, used = manager.load_model_with_fallbacks("rvrt")
    print(f"fallback manager for rvrt: {used} on {fb.device}; history "
          f"{[(h['used'], h['ok']) for h in manager.get_history()]}")
    check(used == "rvrt" and fb.name == "rvrt" and fb.device.type == "cuda",
          f"the fallback manager served {used} on {fb.device}")
    return {"counts": counts, "fps": stats["fps"]}


@phase("7 strict route to fast_mamba_vsr")
def strict_route(device_line: str) -> dict:
    frames = synthetic_clip(30, 180, 320)
    entry = MODELS["fast_mamba_vsr"]
    layers = entry.extra["num_layers"]
    out, stats, counts = _served_run(
        frames, {"latency_class": "strict"}, "fast_mamba_vsr",
        {"fused_bidir_ssm": layers}, entry.chunk,
        entry.chunk - entry.overlap, device_line)
    handler = build_handler("fast_mamba_vsr")
    check(len(handler.params["layers"]) == layers, "depth changed")
    y_k = _window_check(frames, stats["routing_plan"], handler,
                        calibrate_vsr("fast_mamba_vsr",
                                      lambda p, x: fast_mamba_vsr.apply(
                                          p, x, scale=entry.scale,
                                          kernels=False)))
    _lsb_check(out, y_k, handler.chunk, stats)
    return {"counts": counts, "fps": stats["fps"]}


def _counted(fn, *args) -> tuple:
    """``fn(*args)`` with the launch counts set to 0 just before and read
    just after; returns the output, the counts and the seconds."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, dict(kernels.launch_counts), time.perf_counter() - t0


def _only(**nonzero) -> dict:
    want = dict.fromkeys(kernels.launch_counts, 0)
    want.update(nonzero)
    return want


@phase("8 exact time-sharded path")
def sharded_path(device_line: str) -> dict:
    """Both exact T-sharded factories on a one-rank NCCL group against the
    single-device model on the same clip."""
    frames = synthetic_clip(16, 180, 320)
    clip16 = (torch.from_numpy(np.stack(frames)).cuda().float() / 255.0)
    cases = [("fast_mamba_vsr", clip16, make_exact_sharded_fmv,
              fast_mamba_vsr.apply),
             ("vsrm", clip16[:7], make_exact_sharded_vsrm, vsrm.apply)]
    axis = make_mesh(time=1)
    counts = {}
    try:
        check(axis.size == 1 and axis.index == 0 and axis.device.type == "cuda",
              f"time axis {axis.size}/{axis.index} on {axis.device}")
        for name, frames_t, make, apply in cases:
            check(bundled_weights(name) is not None, f"{name}: no weights")
            raw = load_params(name)
            depth = len(raw["blocks" if name == "vsrm" else "layers"])
            params = cast_params(raw, torch.bfloat16, axis.device)
            clip = frames_t[None].to(torch.bfloat16)
            fn = make(axis, scale=4)
            with torch.inference_mode():
                fn(params, clip)                      # warm-up, not counted
                y_s, c_s, t_s = _counted(fn, params, clip)
                y_1, c_1, t_1 = _counted(lambda p, c: apply(p, c, scale=4),
                                         params, clip)
            ssd = 2 * depth if name == "vsrm" else 0
            want_s = _only(selective_scan_short=4 * depth, ssd_shared=ssd)
            want_1 = _only(fused_bidir_ssm=depth, ssd_shared=ssd)
            print(f"{name}: sharded launches {c_s} (expected {want_s}); "
                  f"single-device {c_1}")
            check(c_s == want_s, f"{name} sharded launches {c_s} != {want_s}")
            check(c_1 == want_1, f"{name} single launches {c_1} != {want_1}")
            check(tuple(y_s.shape) == tuple(y_1.shape)
                  and bool(torch.isfinite(y_s.float()).all()),
                  f"{name}: sharded output {tuple(y_s.shape)} not finite or "
                  f"not {tuple(y_1.shape)}")
            diff = (y_s.float() - y_1.float()).abs()
            mx, mean = diff.max().item(), diff.mean().item()
            n = clip.shape[1]
            print(f"{name} x4 {n} frames: sharded (one rank, short-scan "
                  f"kernel) vs single-device (fused kernel), bf16: max_abs "
                  f"{mx:.4e} (tol {WINDOW_MAX_ABS}), mean_abs {mean:.4e} (tol "
                  f"{WINDOW_MEAN_ABS}); sharded {t_s:.3f} s = {n / t_s:.2f} "
                  f"frames/s, single {t_1:.3f} s = {n / t_1:.2f} frames/s "
                  f"({device_line})")
            check(mx <= WINDOW_MAX_ABS and mean <= WINDOW_MEAN_ABS,
                  f"{name}: the sharded output differs from the single-device "
                  f"model")
            counts[name] = c_s
            del raw, params, y_s, y_1
            torch.cuda.empty_cache()
    finally:
        axis.destroy()
    return counts


def _block0_temporal_input(params, clip) -> torch.Tensor:
    """The input vsrm's block 0 hands its temporal SSM, caught in a run of
    ``vsrm.apply``."""
    caught = []
    real = vsrm.bissm_apply

    def catch(p, x, impl="fused"):
        caught.append(x)
        return real(p, x, impl=impl)

    vsrm.bissm_apply = catch
    try:
        vsrm.apply(params, clip, scale=4)
    finally:
        vsrm.bissm_apply = real
    return caught[0]


def _window_tol(name: str, got, ref) -> None:
    diff = (got.float() - ref.float()).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    print(f"{name}: max_abs {mx:.4e} (tol {WINDOW_MAX_ABS}), mean_abs "
          f"{mean:.4e} (tol {WINDOW_MEAN_ABS})")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: not finite")
    check(mx <= WINDOW_MAX_ABS and mean <= WINDOW_MEAN_ABS,
          f"{name}: differs from its plain form")


@phase("9 layers")
def layers() -> dict:
    """Each Mamba-1 layer once at the phase-3 shapes, its launches and its
    output against its plain form (bf16 on the card)."""
    gen = torch.Generator().manual_seed(SEED)
    pb = cast_params(bimamba_init(gen, 64), torch.bfloat16, "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    pixels = torch.randn((180 * 320, 7, 64), generator=g,
                         device="cuda").bfloat16()
    rasters = torch.randn((7, 180 * 320, 64), generator=g,
                          device="cuda").bfloat16()
    vp = cast_params(load_params("vsrm"), torch.bfloat16, "cuda")
    clip = (torch.from_numpy(np.stack(synthetic_clip(7, 180, 320))).cuda()
            .float()[None] / 255.0).bfloat16()
    counts = {}
    with torch.inference_mode():
        seq = _block0_temporal_input(vp, clip)
        tp = vp["blocks"][0]["temporal_ssm"]
        cases = [
            ("bimamba_apply per pixel", lambda: bimamba_apply(pb, pixels),
             lambda: bimamba_apply(pb, pixels, impl="ref"),
             dict(selective_scan_bidir=1)),
            ("bissm_apply(impl='composed') on vsrm's block 0",
             lambda: bissm_apply(tp, seq, impl="composed"),
             lambda: bissm_apply(tp, seq, impl="plain"),
             dict(selective_scan_bidir=1)),
            ("ssm_apply per pixel", lambda: ssm_apply(pb["fwd"], pixels),
             lambda: ssm_apply(pb["fwd"], pixels, impl="ref"),
             dict(selective_scan_short_nostate=1)),
            ("bimamba_apply over 7 rasters", lambda: bimamba_apply(pb, rasters),
             lambda: bimamba_apply(pb, rasters, impl="assoc"),
             dict(selective_scan_long=2)),
        ]
        # row 6's route on each layer (both streams dense and bf16 here)
        routes = {name: "row 6 route " + _bidir_plan(
                      x.shape[0], x.shape[1], *a.shape, 2, True,
                      shared)["route"]
                  for name, x, a, shared in (
                      ("bimamba_apply per pixel", pixels,
                       pb["fwd"]["A_log"], False),
                      ("bissm_apply(impl='composed') on vsrm's block 0", seq,
                       tp["A_log_f"], True))}
        # row 8's on ssm_apply per pixel, from the streams the layer passes
        u, _, dt, _, _ = ssm._ssm_streams(pb["fwd"], pixels, reverse=False)
        row8 = _short_scan_plan(*u.shape, pb["fwd"]["A_log"].shape[1],
                                u.element_size(), _on_16_byte_grid(u, dt),
                                state=False)["route"]
        check(row8 == "tile_n16", f"ssm_apply per pixel: row 8 takes {row8}")
        routes["ssm_apply per pixel"] = f"row 8 route {row8}"
        del u, dt
        for name, run, plain, want in cases:
            got, c, secs = _counted(run)
            print(f"{name}: launches {c}, {1000 * secs:.2f} ms"
                  + (f"; {routes[name]}" if name in routes else ""))
            check(c == _only(**want), f"{name}: launches {c} != {want}")
            for k, v in want.items():
                counts[k] = counts.get(k, 0) + v
            _window_tol(f"  {name} vs plain", got, plain())
            if "composed" in name:
                _window_tol("  ... vs the fused kernel",
                            got, bissm_apply(tp, seq, impl="fused"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return counts


def _conv_window(handler, first, device_line: str) -> int:
    """Phase 10 (a): one vsrm window with every block's spatial SSD on the
    conv kernel (``vsrm.bissd_apply`` rebound to ``conv_impl="pallas"``, as
    the JAX package's A/B scripts switch it) against the grouped-conv
    window and the plain versions; returns the conv kernel's launches."""
    real = vsrm.bissd_apply
    with torch.inference_mode():
        y_grouped = handler.process_clip(first)
        plain = calibrate_vsr("vsrm", lambda p, x: vsrm.apply(
            p, x, scale=handler.scale, kernels=False))
        y_plain = plain(handler.params,
                        first[None].to(handler.dtype)).float()[0]
        grouped_ms = time_ms(lambda: handler.process_clip(first), warmup=1,
                             iters=5)
        vsrm.bissd_apply = functools.partial(real, conv_impl="pallas")
        try:
            handler.process_clip(first)               # warm-up, not counted
            y_pallas, c, _ = _counted(handler.process_clip, first)
            pallas_ms = time_ms(lambda: handler.process_clip(first),
                                warmup=1, iters=5)
        finally:
            vsrm.bissd_apply = real
    blocks = len(handler.params["blocks"])
    want = _only(dwconv_silu=blocks, ssd_shared=2 * blocks,
                 fused_bidir_ssm=blocks)
    print(f"(a) vsrm window with conv_impl='pallas': launches {c} (expected "
          f"{want})")
    check(c == want, f"conv window launches {c} != {want}")
    _window_tol("  vs the grouped-conv window", y_pallas, y_grouped)
    _window_tol("  vs the plain versions", y_pallas, y_plain)
    print(f"  ms per window: grouped conv {grouped_ms:.3f}, conv kernel "
          f"{pallas_ms:.3f} ({device_line})")
    return c["dwconv_silu"]


def _shared_scan_layer(vp, clip) -> int:
    """Phase 10 (b): ``bissm_apply(impl="composed")`` on vsrm's block-0
    temporal input with its scan on ``impl="bmajor"`` (row 10), its output
    against the composed layer on ``impl="bidir"`` and the plain layer, and
    the scan against its plain version and row 6 on the same streams;
    returns row 10's launches."""
    real = ssm.selective_scan_bidir_shared
    caught = []

    def bmajor(*args, impl="bidir"):
        caught.append(args)
        return real(*args, impl="bmajor")

    with torch.inference_mode():
        seq = _block0_temporal_input(vp, clip)
        tp = vp["blocks"][0]["temporal_ssm"]
        ssm.selective_scan_bidir_shared = bmajor
        try:
            got, c, secs = _counted(
                lambda: bissm_apply(tp, seq, impl="composed"))
        finally:
            ssm.selective_scan_bidir_shared = real
        want = _only(selective_scan_bidir_shared=1)
        print(f"(b) composed bissm on vsrm's block 0 {tuple(seq.shape)}, "
              f"scan impl='bmajor': launches {c} (expected {want}), "
              f"{1000 * secs:.2f} ms")
        check(c == want, f"bmajor launches {c} != {want}")
        _window_tol("  vs the composed layer with impl='bidir'", got,
                    bissm_apply(tp, seq, impl="composed"))
        _window_tol("  vs the plain layer", got,
                    bissm_apply(tp, seq, impl="plain"))
        args = caught[0]
        plan = _shared_scan_plan(*args[0].shape, args[3].shape[1],
                                 args[0].element_size(),
                                 _on_16_byte_grid(*args[:3]))
        print(f"  row 10 route {plan['route']}, sequences a block "
              f"{plan['seqs']}")
        y = real(*args, impl="bmajor")
        tol = TOL[("selective_scan_bidir_shared", "bfloat16")]
        for name, ref in (("plain", selective_scan_bidir_shared_plain(*args)),
                          ("impl='bidir'", real(*args, impl="bidir"))):
            _, rel = rel_err(y, ref)
            print(f"  the scan vs {name}: rel {rel:.3e} (tol {tol:g})")
            check(rel <= tol, f"bmajor scan vs {name}: rel {rel} > {tol}")
    return c["selective_scan_bidir_shared"]


def _edge_pad(clip, n: int, dim: int):
    """``clip`` with ``n`` copies of its first and last slice along
    ``dim`` (what a one-rank halo exchange adds)."""
    first = clip.narrow(dim, 0, 1)
    last = clip.narrow(dim, clip.shape[dim] - 1, 1)
    return torch.cat([first] * n + [clip] + [last] * n, dim=dim)


def _mesh_path(vp, clip, device_line: str) -> None:
    """Phase 10 (c): the halo factories around ``vsrm.apply`` on a one-rank
    NCCL mesh, each against the model on the same padded clip, trimmed; a
    handler with that mesh, and the registry's with the policy's (1, 1, 1),
    take the unsharded path."""
    apply = lambda p, x: vsrm.apply(p, x, scale=4)      # noqa: E731
    mesh = make_mesh(1, 1, 1)
    try:
        check(mesh.shape == {"data": 1, "time": 1, "space": 1}
              and mesh.device.type == "cuda",
              f"mesh {mesh.shape} on {mesh.device}")
        n = clip.shape[1]
        cases = [
            ("make_sharded_clip_fn (halo 2)",
             make_sharded_clip_fn(apply, mesh, halo=2),
             lambda: apply(vp, _edge_pad(clip, 2, 1))[:, 2:n + 2]),
            ("make_spatially_sharded_clip_fn (halo 8, scale 4)",
             make_spatially_sharded_clip_fn(apply, mesh, halo=8, scale=4),
             lambda: apply(vp, _edge_pad(clip, 8, 2))[
                 :, :, 32:32 + 4 * clip.shape[2]]),
        ]
        with torch.inference_mode():
            for name, fn, ref in cases:
                fn(vp, clip)                          # warm-up, not counted
                got, c, secs = _counted(fn, vp, clip)
                blocks = len(vp["blocks"])
                want = _only(ssd_shared=2 * blocks, fused_bidir_ssm=blocks)
                print(f"(c) {name}: launches {c}; {secs:.3f} s = "
                      f"{n / secs:.2f} frames/s ({device_line})")
                check(c == want, f"{name}: launches {c} != {want}")
                check(got.shape == (1, n, 4 * clip.shape[2],
                                    4 * clip.shape[3], 3),
                      f"{name}: shape {tuple(got.shape)}")
                _window_tol("  vs vsrm.apply on the padded clip, trimmed",
                            got, ref())
        h = VSRHandler("vsrm", apply, vp, scale=4, chunk=7, overlap=4,
                       mesh=mesh)
        check(h.mesh is mesh and h._sharded is None,
              "a handler on a one-rank mesh must take the unsharded path")
        served = build_handler("vsrm")
        print(f"  handler on the one-rank mesh: unsharded; the registry's "
              f"vsrm handler with the policy's mesh {default_policy().mesh}"
              f" and the group up: mesh {served.mesh}")
        check(served.mesh is None and served._sharded is None,
              "the registry's handler should serve unsharded at mesh "
              "(1, 1, 1), as the JAX registry's does")
    finally:
        mesh.destroy()


@phase("10 opt-in kernels")
def opt_in_kernels(device_line: str) -> dict:
    """Rows 10 and 11 on the paths that reach them (each behind the switch
    the JAX package keeps for A/B runs) and the halo-approximate mesh code
    at one rank."""
    handler = build_handler("vsrm")
    frames = synthetic_clip(handler.chunk, 180, 320)
    first = torch.from_numpy(np.stack(frames)).cuda().float() / 255.0
    counts = {"dwconv_silu": _conv_window(handler, first, device_line)}
    vp = cast_params(load_params("vsrm"), torch.bfloat16, "cuda")
    clip = first[None].bfloat16()
    counts["selective_scan_bidir_shared"] = _shared_scan_layer(vp, clip)
    _mesh_path(vp, clip, device_line)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return counts


@phase("11 auto route to seedvr2")
def seedvr2_route(device_line: str) -> dict:
    frames = blocky_clip(16, 180, 320)
    entry = MODELS["seedvr2"]
    handler = build_handler("seedvr2")
    unet = handler.params["unet"]
    attn = 1 + sum("attn" in st for st in unet["down"] + unet["up"])
    check(attn == 3, f"the UNet has {attn} attention blocks, not 3")
    out, stats, counts = _served_run(
        frames, {}, "seedvr2", {"flash_attention": attn}, entry.window,
        entry.stride, device_line, scale=1)
    check(stats["windows_skipped"] == 0,
          f"the gate skipped {stats['windows_skipped']} soft windows")
    # window 0 through the kernels against the plain versions: both bf16
    # and both drawing the noise of seed 0
    y_k = _window_check(frames, stats["routing_plan"], handler,
                        lambda p, x: seedvr2.apply(p, x, kernels=False))
    _lsb_check(out, y_k, handler.chunk, stats)

    # the gate: a sharp clip passes through unchanged, no kernel launched
    sharp = sharp_clip(16, 180, 320)
    score = window_quality(torch.from_numpy(np.stack(sharp[:8])).cuda())
    gate = {}
    got, gate_counts, secs = _counted(
        lambda: list(handler.enhance_frames(iter(sharp), gate)))
    windows = sum(1 for _ in iter_windows(sharp, entry.window, entry.stride))
    lsb = np.abs(np.stack(got).astype(np.int16)
                 - np.stack(sharp).astype(np.int16)).max()
    print(f"gate: score {score:.4f} (threshold {handler.quality_threshold}); "
          f"windows {windows}, skipped {gate['windows_skipped']}; launches "
          f"{gate_counts}; output vs input max {lsb} LSB; {len(sharp)} "
          f"frames in {secs:.3f} s ({device_line})")
    check(score > handler.quality_threshold, "the sharp clip is not sharp")
    check(gate["windows_skipped"] == windows, "the gate ran a sharp window")
    check(gate_counts == _only(), f"the gated run launched {gate_counts}")
    check(len(got) == len(sharp) and lsb == 0,
          "a skipped window changed its frames")
    torch.cuda.empty_cache()
    return {"counts": counts, "fps": stats["fps"]}


def _kernel_profile(fn) -> tuple:
    """The device kernels one call of ``fn`` launches, their device time in
    ms and the five that take most of it (name, launches, ms), from
    ``torch.profiler`` (CUPTI); None where it sees none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            us = (getattr(e, "device_time_total", None)
                  or getattr(e, "cuda_time_total", 0))
            name = e.key.replace("void ", "").split("(")[0][:60]
            rows.append((us / 1e3, e.count, name))
    if not rows:
        return None, None, []
    rows.sort(reverse=True)
    return (sum(r[1] for r in rows), sum(r[0] for r in rows),
            [f"{name} x{n} {ms:.3f}" for ms, n, name in rows[:5]])


@phase("12 temporal stage")
def temporal_stage(big: list, small: list, device_line: str) -> None:
    """``temporal_smooth`` alone on the card on 16 frames of 720x1280
    (phase 4's output) and of 180x320 (its input): ms a frame of the stage
    and of the flow, with the flow's kernels and device time; then the
    card's flow and smoothed frames at 720x1280 against the CPU's."""
    clips = {}
    for frames in (big, small):
        clip = torch.from_numpy(np.stack(frames)).cuda().float() / 255.0
        n, h, w = clip.shape[:3]
        clips[h] = clip
        with torch.inference_mode():
            temporal_smooth(clip[:2])                 # warm-up, not counted
            _, counts, _ = _counted(temporal_smooth, clip)
            check(counts == _only(),
                  f"the temporal stage launched a kernel: {counts}")
            # events around a host-bound call read its wall time
            stage = time_ms(lambda: temporal_smooth(clip), 1, 3)
            flows = time_ms(lambda: [estimate_flow_farneback(clip[i - 1],
                                                             clip[i])
                                     for i in range(1, n)], 1, 3)
            launches, dev, top = _kernel_profile(
                lambda: estimate_flow_farneback(clip[0], clip[1]))
        flow_ms = flows / (n - 1)
        prof = ("not measured" if launches is None else
                f"{launches} device kernels, {dev:.3f} ms device time "
                f"({100 * (1 - dev / flow_ms):.0f}% of its wall time idle)")
        print(f"temporal stage {h}x{w}, {n} frames: {stage / n:.3f} ms/frame"
              f" ({stage:.1f} ms); Farneback {flow_ms:.3f} ms a pair; one "
              f"pair: {prof} ({device_line})")
        if top:
            print(f"  its top device kernels (ms): {'; '.join(top)}")

    clip = clips[720]
    with torch.inference_mode():
        card = estimate_flow_farneback(clip[0], clip[1])
        cpu = estimate_flow_farneback(clip[0].cpu(), clip[1].cpu())
        err = (card.cpu() - cpu).abs().max().item()
        print(f"flow 720x1280, card vs CPU: max_abs {err:.3e} px (tol "
              f"{FLOW_MAX_ABS}); max |flow| {cpu.abs().max().item():.3f} px")
        check(err <= FLOW_MAX_ABS, "the card's flow differs from the CPU's")
        t0 = time.perf_counter()
        ref = temporal_smooth(clip.cpu())
        cpu_s = time.perf_counter() - t0
        got = temporal_smooth(clip).cpu()
    check(bool(torch.isfinite(got).all()), "smoothed frames not finite")
    lsb = (got - ref).abs() * 255.0
    mx, mean = lsb.max().item(), lsb.mean().item()
    moved = ((ref - clip.cpu()).abs() * 255.0).max().item()
    print(f"smoothed frames 720x1280, card vs CPU ({cpu_s:.1f} s on the "
          f"CPU): max {mx:.4f} LSB (tol {STAGE_MAX_LSB}), mean {mean:.2e} "
          f"LSB (tol {STAGE_MEAN_LSB}); the stage moves frames by up to "
          f"{moved:.1f} LSB")
    check(mx <= STAGE_MAX_LSB and mean <= STAGE_MEAN_LSB,
          "the card's smoothed frames differ from the CPU's")
    check(moved > 1.0, "the stage left the frames as they were")
    torch.cuda.empty_cache()


SCAN_CU = "video_enhancer_tpu_torch/csrc/selective_scan.cu"


def kernel_record(rec: dict, counts: dict) -> list[dict]:
    meta = {
        "ssd_shared": ("video_enhancer_tpu_torch/csrc/ssd_shared.cu",
                       "video_enhancer_tpu/ops/ssd.py:325"),
        "fused_bidir_ssm": ("video_enhancer_tpu_torch/csrc/fused_bissm.cu",
                            "video_enhancer_tpu/ops/scan.py:941"),
        "flash_attention": ("video_enhancer_tpu_torch/csrc/flash_attn.cu",
                            "video_enhancer_tpu/ops/attention.py:118"),
        "flash_attention:seedvr2": (
            "video_enhancer_tpu_torch/csrc/flash_attn.cu",
            "video_enhancer_tpu/ops/attention.py:118"),
        "window_attention": ("video_enhancer_tpu_torch/csrc/window_attn.cu",
                             "video_enhancer_tpu/ops/attention.py:232"),
        "fused_bidir_ssm:fast_mamba_vsr": (
            "video_enhancer_tpu_torch/csrc/fused_bissm.cu",
            "video_enhancer_tpu/ops/scan.py:941"),
        "selective_scan_bidir": (SCAN_CU, "video_enhancer_tpu/ops/scan.py:460"),
        "selective_scan_short": (SCAN_CU, "video_enhancer_tpu/ops/scan.py:241"),
        "selective_scan_short_nostate": (
            SCAN_CU, "video_enhancer_tpu/ops/scan.py:362"),
        "selective_scan_long": (SCAN_CU, "video_enhancer_tpu/ops/scan.py:556"),
        "selective_scan_bidir_shared": (
            SCAN_CU, "video_enhancer_tpu/ops/scan.py:736"),
        "dwconv_silu": ("video_enhancer_tpu_torch/csrc/dwconv_silu.cu",
                        "video_enhancer_tpu/ops/conv.py:220"),
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
            "library_ms": r.get("library_ms")})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    env = environment()
    rec = kernels_vs_plain(build())
    path = main_path(f"{env['kind']}, {env['smi']}")
    route = auto_route(f"{env['kind']}, {env['smi']}")
    rv = rvrt_path(f"{env['kind']}, {env['smi']}")
    strict = strict_route(f"{env['kind']}, {env['smi']}")
    sharded = sharded_path(f"{env['kind']}, {env['smi']}")
    layer_counts = layers()
    opt_in = opt_in_kernels(f"{env['kind']}, {env['smi']}")
    sv = seedvr2_route(f"{env['kind']}, {env['smi']}")
    temporal_stage(path.pop("frames"), synthetic_clip(16, 180, 320),
                   f"{env['kind']}, {env['smi']}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    # each kernel's launches in the run of the path that carries it
    counts = {"ssd_shared": path["counts"]["ssd_shared"],
              "fused_bidir_ssm": path["counts"]["fused_bidir_ssm"],
              "flash_attention": route["counts"]["flash_attention"],
              "flash_attention:seedvr2": sv["counts"]["flash_attention"],
              "window_attention": rv["counts"]["window_attention"],
              "fused_bidir_ssm:fast_mamba_vsr":
                  strict["counts"]["fused_bidir_ssm"],
              # row 7: both sharded calls of phase 8; rows 6, 8, 9: phase 9
              "selective_scan_short": sum(
                  c["selective_scan_short"] for c in sharded.values()),
              **{k: layer_counts[k] for k in (
                  "selective_scan_bidir", "selective_scan_short_nostate",
                  "selective_scan_long")},
              # rows 10 and 11: phase 10
              **opt_in}
    print(json.dumps({"kernels": kernel_record(rec, counts)}))
    print(env["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["kind"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
