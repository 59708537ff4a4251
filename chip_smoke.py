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
   that is not a multiple of the sequences a block, the SSD (bf16, both
   directions) also at fast_mamba_vsr_ssd's temporal shape (57,600
   sequences of 16 steps, 2 heads of 48, N 8) and at 368,640 sequences
   (one launch a call past 65,535), each with its plain time and bound,
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
   no hand-written kernel launched;
13. realesrgan and realesrgan_fast x4 at full width with the bundled
   weights: ``run_auto_frames(engine=...)`` on phase 4's clip (chunks of 4,
   no overlap, calibrated blends 0.4 and 0.2): no fallback, no kernel
   launched, window 0 in bf16 against the same model in fp32 on the card,
   the streamed frames, frames/s; the official RRDBNet at full size (23
   blocks, seeded random weights) written to a ``.pth`` and served through
   ``$VETPU_REALESRGAN_CKPT`` on 4 frames at full strength; then
   ``ModelFallbackManager().load_model_with_fallbacks("realesrgan")``
   serves realesrgan on the card;
14. fast_mamba_vsr_ssd: ``run_auto_frames(engine="fast_mamba_vsr_ssd")``
   on phase 7's 30 frames (the SSD kernel 16 times a window, 8 layers x 2
   directions; no other kernel), window 0 against the plain forms,
   frames/s; 16 frames of 360x640 (two 360x512 tiles in one group: 368,640
   sequences a scan) served by it, not by bicubic; fast_mamba_vsr with
   ``extra.temporal_mixer: ssd`` serves a window as 0.6 of it blended with
   the bicubic upscale;
15. the frame-interpolation stage: ``run_auto_frames(enable_hfr=True)`` on
   phase 5's clip (ditvr, the temporal stage, then RIFE): 31 frames, the
   stats (``hfr``, no error, no blend fallback); RIFE alone on phase 4's 16
   output frames of 720x1280 (ms a pair, its device kernels and time, no
   hand-written kernel; cuDNN's TF32 at PyTorch's default); one pair's
   midframe on the card against the CPU's, bf16 on both
   (``HFR_MAX_LSB``, ``HFR_MEAN_LSB``);
16. the face path: ``run_auto_frames(engine="realesrgan",
   enable_face_expert=True)`` on a seeded 16-frame 180x320 clip with two
   blurred faces (``face_clip``): the router's ``face_prominence`` above
   0.03, ``face_restoration`` in the plan before the later stages, the
   stage's stats (faces restored, no error) and no hand-written kernel
   launched in the whole call; ms of routing a 180x320 clip and of its
   detector alone; the stage alone on realesrgan's 16 output frames of
   720x1280 (ms a frame, split into detection and restoration), with the
   card's boxes equal to the CPU's on every frame and its restored frames
   within ``FACE_MAX_LSB`` of the CPU's (and what cuDNN's TF32 default
   would change in the detector's and restorer's outputs); GFPGANv1Clean at
   the v1.4 release configuration (512, seeded weights in a ``.pth``
   served through ``$VETPU_GFPGAN_CKPT``): one face's ms beside its bound
   (``gfpgan_flops``), device kernels, and its output against the CPU's
   (``GFPGAN_MAX_ABS``);
17. the entry points: phase 4's clip written as raw ``.avi`` by the port's
   writer; the router's pick of it on the CPU (seedvr2: its compression
   score is 0.99); ``python -m video_enhancer_tpu_torch.cli`` ``metadata``,
   ``enhance --engine auto`` (that pick, no fallback) and ``eval`` as
   subprocesses, each exiting 0; then the REST job server in this process
   (``ApiServer``, ``serve(port=0, background=True)``): the clip POSTed to
   ``/api/v1/process/auto`` with ``vsr_strategy=vsrm``, its plan at upload
   naming the CPU's pick, polled to ``completed``, downloaded as
   ``video/x-msvideo`` and decoded by the port's reader, its frames equal to
   ``build_handler("vsrm").enhance_frames`` on the same frames (0 LSB, both
   on the card), with exactly 60 SSD and 30 fused-SSM launches (5 windows x
   12 and x 6) and no other kernel from the POST to completion; the
   upload-to-completed wall time, the job's frames/s and the CLI enhance's
   wall time.

In phases 5-7, 11, 13 and 14 the route runs the temporal stage wherever its
plan holds ``temporal_consistency`` (all but 11 here): the streamed frames of
window 0 are then held within 1 LSB of the stage run on window 0's rounded
output (the stage is causal), and the stats must say it ran with no error.

The line before the card's name and power limit holds the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``. The script
needs a card: without one it exits non-zero and prints no result. It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
import uuid
from pathlib import Path

import numpy as np
import torch

from video_enhancer_tpu_torch import kernels
from video_enhancer_tpu_torch.analysis import DegradationRouter, face_net
from video_enhancer_tpu_torch.analysis.faces import (face_area_ratio,
                                                     nn_detector)
from video_enhancer_tpu_torch.config import MODELS, default_policy
from video_enhancer_tpu_torch.device import full_fp32
from video_enhancer_tpu_torch.io.video import (read_video, sample_indices,
                                               write_video)
from video_enhancer_tpu_torch.io.pipeline import iter_windows
from video_enhancer_tpu_torch.models import (ditvr, fast_mamba_vsr,
                                             official_arch, rvrt, seedvr2,
                                             vsrm)
from video_enhancer_tpu_torch.models.official_gfpgan import (
    gfpgan_channels, gfpgan_official_apply, gfpgan_official_init)
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
from video_enhancer_tpu_torch.ops.resize import resize
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
from video_enhancer_tpu_torch.runtime.face_handler import (
    FaceRestorationExpert, _face_net_apply)
from video_enhancer_tpu_torch.runtime.fallback import ModelFallbackManager
from video_enhancer_tpu_torch.runtime.pipeline import (
    apply_degradation_context, preprocess_frames, run_auto_frames)
from video_enhancer_tpu_torch.runtime.registry import (build_handler,
                                                      bundled_weights,
                                                      load_params,
                                                      probe_available)
from video_enhancer_tpu_torch.runtime.rife_handler import RIFEHandler
from video_enhancer_tpu_torch.runtime.vsr_handler import (VSRHandler,
                                                         cast_params,
                                                         window_quality)
from video_enhancer_tpu_torch.runtime.weights import flatten_params
from video_enhancer_tpu_torch.serving.app import ApiServer, create_app
from video_enhancer_tpu_torch.serving.http import serve

SEED = 0
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA H100 SXM data sheet
H100_BF16_FLOPS = 989e12         # dense tensor-core rate
H100_FP32_FLOPS = 67e12          # CUDA-core rate
SFU_PER_SM_CLOCK = 16            # ex2 results an SM a clock (Hopper)

# main-path shapes at 180x320, window 7 (vsrm: dim 64 -> inner 128)
SSD_SHAPE = dict(b=7, L=180 * 320, H=2, P=64, N=16)
# fast_mamba_vsr_ssd's temporal SSD: a sequence per pixel over a window of
# 16 frames, dim 48 -> inner 96 in 2 heads of 48, N 8; at 180x320 (one
# tile) and for a group of two 360x512 tiles of a 360x640 clip, past the
# 65,535 blocks of a grid's y and z
SSD_FMV_SHAPE = dict(b=180 * 320, L=16, H=2, P=48, N=8)
SSD_WIDE_SHAPE = dict(SSD_FMV_SHAPE, b=2 * 360 * 512)
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
# RIFE's midframe, card against CPU, bf16 on both, each conv rounded once:
# the convs sum in another order (cuDNN, oneDNN; the CPU's kernels depend
# on its instruction set), an output an ulp apart now and then, which the
# flows carry: 4 LSB and 0.038 on average on phase 4's first pair, 3 and
# 0.016 on a moving 720x1280 pair (scripts/torch_rife_parity.py), where a
# conv rounded twice (cuDNN's bf16 conv with its bias) reads 0.14
HFR_MAX_LSB, HFR_MEAN_LSB = 8.0, 0.1
# the face stage, card against CPU, fp32 nets on both (TF32 off): restored
# frames in LSB; GFPGAN's output on [-1, 1]
FACE_MAX_LSB = 1.0
GFPGAN_MAX_ABS = 1e-3


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


def _ssd_inputs(dtype, gen, s=SSD_SHAPE):
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


def _ssd_cost(dtype, Q: int, s=SSD_SHAPE) -> tuple[float, float]:
    b, L, H, P, N = s["b"], s["L"], s["H"], s["P"], s["N"]
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * L * H * P * item + 2 * b * L * N * item
              + b * L * H * 4 + H * 4)
    Q = min(Q, L)           # a sequence shorter than a chunk needs no more
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
        # --- kernel 1 at fast_mamba_vsr_ssd's temporal shapes (bf16, the
        # tensor-core path, one partial chunk of 16 steps a sequence)
        rec.update(ssd_fmv_vs_plain(Q))
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


def ssd_fmv_vs_plain(Q: int) -> dict:
    """The SSD kernel against its plain version at fast_mamba_vsr_ssd's
    temporal shapes, bf16, both directions: at 180x320 (b 57,600) and at
    b 368,640 (one launch a call past 65,535 sequences); ms, plain ms and
    the bound of each, and the plan (route, one block a sequence)."""
    rec = {}
    for key, shape in (("ssd_shared:fast_mamba_vsr_ssd", SSD_FMV_SHAPE),
                       ("ssd_shared:b 368640", SSD_WIDE_SHAPE)):
        dtype = torch.bfloat16
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        args = _ssd_inputs(dtype, gen, shape)
        plan = _ssd_plan(*args[0].shape, args[-1].shape[-1], dtype,
                         kernels.sm_count(args[0].device))
        check(plan["route"] == "mma" and plan["grid"] == (shape["b"], 1),
              f"{key}: plan {plan}")
        nbytes, flops = _ssd_cost(dtype, Q, shape)
        bound = max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3
        for reverse in (False, True):
            got, counts, _ = _counted(
                lambda: ssd_shared_kernel(*args, reverse=reverse))
            ref = ssd_shared_plain(*args, reverse=reverse)
            torch.cuda.synchronize()
            check(counts == _only(ssd_shared=1),
                  f"{key}: {counts} launches for one call")
            check(bool(torch.isfinite(got).all()), f"{key}: non-finite")
            err, rel = rel_err(got, ref)
            tol = TOL[("ssd_shared", "bfloat16")]
            d = "reverse" if reverse else "forward"
            ms = time_ms(lambda: ssd_shared_kernel(*args, reverse=reverse))
            plain_ms = time_ms(lambda: ssd_shared_plain(*args,
                                                        reverse=reverse),
                               warmup=1, iters=3)
            print(f"{key} {shape} {d} bf16: max_abs_err {err:.3e} rel "
                  f"{rel:.3e} (tol {tol:g}); kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
                  f"plan {plan['route']}, grid {plan['grid']}")
            check(rel <= tol, f"{key} {d}: rel {rel} > {tol}")
            if not reverse:
                rec[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bytes=nbytes, flops=flops,
                                peak=H100_BF16_FLOPS)
            del got, ref
        del args
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


def _box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """A k x k mean of ``(H, W, C)`` with replicated borders."""
    r = k // 2
    for axis in (0, 1):
        pad = [(0, 0)] * img.ndim
        pad[axis] = (r + 1, r)
        c = np.cumsum(np.pad(img, pad, mode="edge"), axis=axis)
        img = (np.take(c, range(k, c.shape[axis]), axis=axis)
               - np.take(c, range(0, c.shape[axis] - k), axis=axis)) / k
    return img


def face_clip(n: int, h: int, w: int, seed: int = SEED) -> list[np.ndarray]:
    """Seeded frames with faces: a smooth blue-green field and two
    skin-toned elliptical faces (dark eyes, a red mouth) of heights 0.6 h
    and 0.46 h, drifting a pixel a frame, the whole frame blurred by a 7x7
    box twice, so that each face's quality score falls under 0.5 (the
    expert's "balanced" threshold), uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, size=3)
    base = np.stack([0.25 + 0.08 * np.sin(0.02 * xx + ph[0]),
                     0.45 + 0.08 * np.cos(0.03 * yy + ph[1]),
                     0.62 + 0.05 * np.sin(0.01 * (xx + yy) + ph[2])], -1)
    heads = [(0.3 * w, 0.52 * h, 0.3 * h, 1.0),
             (0.72 * w, 0.47 * h, 0.23 * h, -1.0)]

    def ellipse(cx, cy, rx, ry):
        return ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0

    frames = []
    for t in range(n):
        img = base.copy()
        for cx, cy, ry, drift in heads:
            cx, rx = cx + drift * t, 0.75 * ry
            img[ellipse(cx, cy, rx, ry)] = (0.8, 0.6, 0.48)
            for ex in (cx - 0.38 * rx, cx + 0.38 * rx):
                img[ellipse(ex, cy - 0.25 * ry, 0.16 * rx, 0.09 * ry)] = (
                    0.15, 0.1, 0.1)
            img[ellipse(cx, cy + 0.45 * ry, 0.36 * rx, 0.08 * ry)] = (
                0.55, 0.2, 0.2)
        img = _box_blur(_box_blur(img, 7), 7)
        frames.append(np.clip(np.round(img * 255), 0, 255).astype(np.uint8))
    return frames


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


def _window_profile(handler, clip, name: str, device_line: str) -> None:
    """One window's wall ms (CUDA events) and its device kernels, device
    ms, idle share and top five kernels (``torch.profiler``)."""
    with torch.inference_mode():
        wall = time_ms(lambda: handler.process_clip(clip), 1, 3)
        launches, dev, top = _kernel_profile(
            lambda: handler.process_clip(clip))
    prof = ("not measured" if launches is None else
            f"{launches} device kernels, {dev:.3f} ms device time (idle "
            f"{1 - dev / wall:.3f})")
    print(f"{name} window of {clip.shape[0]} frames: {wall:.3f} ms wall; "
          f"{prof} ({device_line})")
    if top:
        print(f"  its top device kernels (ms): {'; '.join(top)}")


def _fp32_window(frames, plan, handler, name: str) -> torch.Tensor:
    """Window 0 of a served run in the handler's bf16 against the same
    model in fp32 on the card (TF32 off since phase 3), both through its
    calibrated blend; returns the bf16 output."""
    first = frames[:handler.chunk]
    if "preprocessing" in plan["processing_order"]:
        first = preprocess_frames(first, plan["expert_routing"]["experts"],
                                  handler.device)
    clip = torch.from_numpy(np.stack(first)).cuda().float() / 255.0
    f32 = copy.copy(handler)
    f32.dtype = torch.float32
    f32.params = cast_params(load_params(name), torch.float32, handler.device)
    with torch.inference_mode():
        y_k = handler.process_clip(clip)
        y_f = f32.process_clip(clip)
    torch.cuda.synchronize()
    _window_tol(f"{name} window 0, bf16 vs fp32", y_k, y_f)
    return y_k


def _torch_state_dict(params) -> dict:
    """A parameter tree in PyTorch's layouts as the state dict of the
    module it mirrors (``w`` -> ``weight``, ``b`` -> ``bias``)."""
    leaf = {"w": "weight", "b": "bias"}
    sd = {}
    for key, t in flatten_params(params).items():
        base, _, last = key.rpartition(".")
        sd[f"{base}.{leaf.get(last, last)}"] = t.contiguous()
    return sd


def _official_realesrgan(frames, device_line: str) -> None:
    """The released RRDBNet at full size (23 blocks, random weights of a
    seed) written to a .pth and served through $VETPU_REALESRGAN_CKPT on 4
    frames: the official graph, at full strength (no blend), no kernel."""
    import os
    import tempfile
    from pathlib import Path

    params = official_arch.rrdb_official_init(
        torch.Generator().manual_seed(SEED))
    prev = os.environ.get("VETPU_REALESRGAN_CKPT")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "RealESRGAN_x4plus.pth"
        torch.save(_torch_state_dict(params), path)
        os.environ["VETPU_REALESRGAN_CKPT"] = str(path)
        try:
            handler = build_handler("realesrgan")
        finally:
            if prev is None:
                del os.environ["VETPU_REALESRGAN_CKPT"]
            else:
                os.environ["VETPU_REALESRGAN_CKPT"] = prev
    check("conv_first" in handler.params
          and len(handler.params["body"]) == 23,
          "the checkpoint did not load into the official RRDBNet")
    four = frames[:4]
    clip = torch.from_numpy(np.stack(four)).cuda().float() / 255.0
    with torch.inference_mode():
        handler.process_clip(clip)                    # warm-up, not counted
        out, counts, secs = _counted(
            lambda: list(handler.enhance_frames(iter(four))))
        y = handler.process_clip(clip)
        raw = official_arch.rrdb_official_apply(
            handler.params, clip.to(handler.dtype)).float()
    check(counts == _only(), f"the official RRDBNet launched {counts}")
    h, w = four[0].shape[:2]
    check(len(out) == 4 and out[0].shape == (4 * h, 4 * w, 3),
          f"official RRDBNet frames {len(out)} {out[0].shape}")
    diff = (y - raw).abs().max().item()
    print(f"official RRDBNet (23 blocks, .pth via $VETPU_REALESRGAN_CKPT) x4 "
          f"{h}x{w}: 4 frames in {secs:.3f} s = {4 / secs:.2f} frames/s; "
          f"served vs the bare graph: max_abs {diff:.3e} (full strength: no "
          f"blend) ({device_line})")
    check(diff <= 1e-3, "the official checkpoint was served through a blend")
    del handler
    torch.cuda.empty_cache()


@phase("13 realesrgan paths")
def realesrgan_paths(device_line: str) -> dict:
    """realesrgan and realesrgan_fast x4 at full width with the bundled
    weights through ``run_auto_frames(engine=...)`` on phase 4's clip
    (chunks of 4, no overlap): no fallback, no kernel, window 0 in bf16
    against fp32 on the card, the streamed frames, frames/s; the official
    RRDBNet through ``$VETPU_REALESRGAN_CKPT``; the fallback manager."""
    frames = synthetic_clip(16, 180, 320)
    counts = {}
    for name in ("realesrgan", "realesrgan_fast"):
        out, stats, counts[name] = _served_run(
            frames, {"engine": name}, name, {}, 4, 4, device_line)
        handler = build_handler(name)
        check((handler.chunk, handler.overlap) == (4, 0),
              f"{name}: chunk {handler.chunk}, overlap {handler.overlap}")
        blocks = MODELS[name].extra["num_blocks"]
        check(len(handler.params["rrdb"]) == blocks, f"{name}: depth changed")
        y_k = _fp32_window(frames, stats["routing_plan"], handler, name)
        _lsb_check(out, y_k, handler.chunk, stats)
        _window_profile(handler, torch.from_numpy(np.stack(
            frames[:4])).cuda().float() / 255.0, name, device_line)
    _official_realesrgan(frames, device_line)
    manager = ModelFallbackManager()
    fb, used = manager.load_model_with_fallbacks("realesrgan")
    print(f"fallback manager for realesrgan: {used} on {fb.device}; history "
          f"{[(h['used'], h['ok']) for h in manager.get_history()]}")
    check(used == "realesrgan" and fb.device.type == "cuda"
          and "stem" in fb.params,
          f"the fallback manager served {used} on {fb.device}")
    torch.cuda.empty_cache()
    return counts


def _with_ssd_mixer():
    policy = default_policy()
    models = dict(policy.models)
    entry = models["fast_mamba_vsr"]
    models["fast_mamba_vsr"] = dataclasses.replace(
        entry, extra={**entry.extra, "temporal_mixer": "ssd"})
    return dataclasses.replace(policy, models=models)


@phase("14 fast_mamba_vsr_ssd path")
def fmv_ssd_path(device_line: str) -> dict:
    """``run_auto_frames(engine="fast_mamba_vsr_ssd")`` on phase 7's 30
    frames (the SSD kernel 16 times a window, no other kernel; window 0
    against the plain forms), 16 frames of 360x640 (two 360x512 tiles in
    one group: b = 368,640 sequences), and the base entry on the ssd mixer
    with its 0.6 blend."""
    name = "fast_mamba_vsr_ssd"
    entry = MODELS[name]
    layers = entry.extra["num_layers"]
    frames = synthetic_clip(30, 180, 320)
    out, stats, counts = _served_run(
        frames, {"engine": name}, name, {"ssd_shared": 2 * layers},
        entry.chunk, entry.chunk - entry.overlap, device_line)
    handler = build_handler(name)
    check(len(handler.params["layers"]) == layers
          and "norm_scale" in handler.params["layers"][0]["bimamba"],
          "fast_mamba_vsr_ssd is not on the ssd mixer")
    y_k = _window_check(frames, stats["routing_plan"], handler,
                        calibrate_vsr(name, lambda p, x: fast_mamba_vsr.apply(
                            p, x, scale=entry.scale, kernels=False)))
    _lsb_check(out, y_k, handler.chunk, stats)
    _window_profile(handler, torch.from_numpy(np.stack(
        frames[:entry.chunk])).cuda().float() / 255.0, name, device_line)

    wide = synthetic_clip(16, 360, 640)
    (big, big_stats), big_counts, secs = _counted(
        lambda: run_auto_frames(wide, engine=name))
    print(f"{name} 360x640 (b = {2 * 360 * 512} sequences a scan): "
          f"model {big_stats['model']}, launches {big_counts}; 16 frames in "
          f"{secs:.3f} s, enhance {big_stats['processing_time_sec']:.3f} s "
          f"({device_line})")
    check(big_stats["model"] == name and "fallback_from" not in big_stats,
          f"360x640 served {big_stats['model']}: "
          f"{big_stats.get('fallback_error')}")
    wide_windows = sum(1 for _ in iter_windows(
        wide, entry.chunk, entry.chunk - entry.overlap))
    check(big_counts == _only(ssd_shared=2 * layers * wide_windows),
          f"360x640 launches {big_counts} in {wide_windows} windows")
    wide_counts = big_counts
    check(len(big) == 16 and big[0].shape == (1440, 2560, 3),
          f"360x640 frames {len(big)} {big[0].shape}")
    del big

    base = build_handler("fast_mamba_vsr", _with_ssd_mixer())
    clip = torch.from_numpy(np.stack(frames[:entry.chunk])).cuda()
    clip = clip.float() / 255.0
    with torch.inference_mode():
        y_b, base_counts, _ = _counted(base.process_clip, clip)
        y_ssd = handler.process_clip(clip)
        bicubic = torch.clamp(resize(clip, tuple(y_ssd.shape[1:3])), 0.0, 1.0)
        want = torch.clamp(0.6 * y_ssd + 0.4 * bicubic, 0.0, 1.0)
    check(base_counts == _only(ssd_shared=2 * layers),
          f"the base entry on the ssd mixer launched {base_counts}")
    _window_tol("fast_mamba_vsr on the ssd mixer vs 0.6 of "
                "fast_mamba_vsr_ssd's window", y_b, want)
    torch.cuda.empty_cache()
    return {"counts": counts, "wide_counts": wide_counts, "fps": stats["fps"]}


@phase("15 hfr stage")
def hfr_stage(big: list, device_line: str) -> dict:
    """``run_auto_frames(enable_hfr=True)`` on phase 5's clip (ditvr, the
    temporal stage, then RIFE): 31 frames, the stats; the stage alone on
    phase 4's 16 output frames of 720x1280 (ms a pair, device kernels, no
    hand-written kernel); one pair's midframe on the card against the
    CPU's, bf16 on both. RIFE's convs run in fp32 on bf16 values
    (``round_once``): at PyTorch's default, which this phase restores
    (phase 3 turned it off for its fp32 checks), cuDNN takes TF32 there,
    which holds bf16 values exactly."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        return _hfr_stage(big, device_line)
    finally:
        torch.backends.cudnn.allow_tf32 = False


def _hfr_stage(big: list, device_line: str) -> dict:
    frames = dim_clip(16, 180, 320)
    run_auto_frames(frames[:4], enable_hfr=True)      # warm-up, not counted
    (out, stats), counts, secs = _counted(
        lambda: run_auto_frames(frames, enable_hfr=True))
    order = stats["routing_plan"]["processing_order"]
    entry = MODELS["ditvr"]
    windows = sum(1 for _ in iter_windows(frames, entry.window, entry.stride))
    print(f"route with enable_hfr: model {stats['model']}, order {order}; "
          f"{len(out)} frames out; hfr {stats.get('hfr')}, stage "
          f"{stats.get('hfr_interpolation_sec', 0):.3f} s, blend fallbacks "
          f"{stats.get('hfr_blend_fallbacks', 0)}; launches {counts}; "
          f"{secs:.3f} s end to end ({device_line})")
    check(order[-1] == "hfr_interpolation" and stats["model"] == "ditvr",
          f"the plan is {order} for {stats['model']}")
    check("fallback_from" not in stats, "the route fell back")
    check(stats.get("hfr") is True and "hfr_interpolation_error" not in stats
          and "hfr_blend_fallbacks" not in stats,
          f"the hfr stage: {stats.get('hfr_interpolation_error')}, "
          f"{stats.get('hfr_blend_fallbacks')} blend fallbacks")
    check(len(out) == 31 and all(f.shape == (180, 320, 3) for f in out),
          f"{len(out)} frames out of 16 doubled")
    check(counts == _only(flash_attention=entry.extra["depth"] * windows),
          f"route launches {counts}")

    rife = RIFEHandler()
    clip = torch.from_numpy(np.stack(big)).cuda().float() / 255.0
    n = clip.shape[0]
    rife._double(clip[:2])                             # warm-up, not counted
    doubled, stage_counts, stage_s = _counted(rife._double, clip)
    pair = time_ms(lambda: rife._mid(clip[:1], clip[1:2]), 2, 5)
    launches, dev, top = _kernel_profile(
        lambda: rife._mid(clip[:1], clip[1:2]))
    check(stage_counts == _only(), f"RIFE launched {stage_counts}")
    check(rife.blend_fallbacks == 0, "RIFE fell back to blending")
    check(doubled.shape[0] == 2 * n - 1
          and bool(torch.isfinite(doubled).all()), "RIFE's output")
    prof = ("not measured" if launches is None else
            f"{launches} device kernels, {dev:.3f} ms device time "
            f"({100 * (1 - dev / pair):.0f}% of its wall time idle)")
    print(f"hfr stage 720x1280, {n} frames -> {2 * n - 1}: "
          f"{1000 * stage_s / (n - 1):.3f} ms a pair ({stage_s:.3f} s); one "
          f"pair {pair:.3f} ms: {prof} ({device_line})")
    if top:
        print(f"  its top device kernels (ms): {'; '.join(top)}")
    cpu = RIFEHandler(device="cpu")
    t0 = time.perf_counter()
    ref = cpu._mid(clip[:1].cpu(), clip[1:2].cpu())
    cpu_s = time.perf_counter() - t0
    got = doubled[1:2].cpu()
    lsb = (torch.round(got * 255.0) - torch.round(ref * 255.0)).abs()
    moved = (ref - 0.5 * (clip[:1] + clip[1:2]).cpu()).abs().max().item()
    print(f"midframe 720x1280, card vs CPU, bf16 both ({cpu_s:.1f} s on the "
          f"CPU): max {lsb.max().item():.0f} LSB, mean {lsb.mean().item():.2e}"
          f" LSB; the model moves it up to {255 * moved:.1f} LSB from the "
          f"pair's average")
    check(lsb.max().item() <= HFR_MAX_LSB and lsb.mean().item()
          <= HFR_MEAN_LSB, "the card's midframe differs from the CPU's")
    torch.cuda.empty_cache()
    return {"ms_pair": 1000 * stage_s / (n - 1)}


def gfpgan_flops(out_size: int = 512, nsf: int = 512,
                 channel_multiplier: float = 2.0, narrow: float = 1.0,
                 different_w: bool = True, sft_half: bool = True,
                 num_mlp: int = 8, input_is_latent: bool = True
                 ) -> tuple[float, float]:
    """The FLOPs of one GFPGANv1Clean face from its channel table
    (``gfpgan_channels``): its convs (2 per multiply-add), and its linears
    with the modulated convs' demodulation products; the resizes and the
    elementwise work are left out."""
    def conv(r, k, cin, cout):
        return 2.0 * r * r * k * k * cin * cout

    log_size = int(math.log2(out_size))
    u = gfpgan_channels(channel_multiplier, narrow * 0.5)
    c = gfpgan_channels(channel_multiplier, narrow)
    convs = conv(out_size, 1, 3, u[out_size]) + conv(4, 3, u[8], u[4])
    cin = u[out_size]
    for i in range(log_size, 2, -1):            # down: r -> r / 2
        r, cout = 2 ** i, u[2 ** (i - 1)]
        convs += (conv(r, 3, cin, cin) + conv(r // 2, 3, cin, cout)
                  + conv(r // 2, 1, cin, cout))
        cin = cout
    for i in range(3, log_size + 1):            # up: r / 2 -> r, SFT convs
        r, cout = 2 ** i, u[2 ** i]
        sft = cout if sft_half else 2 * cout
        convs += (conv(r // 2, 3, cin, cin) + conv(r, 3, cin, cout)
                  + conv(r, 1, cin, cout)
                  + 2 * (conv(r, 3, cout, cout) + conv(r, 3, cout, sft)))
        cin = cout
    num_latent = 2 * log_size - 2
    rows = num_latent if different_w else 1
    linear = 2.0 * u[4] * 16 * rows * nsf
    if not input_is_latent:
        linear += num_mlp * rows * 2.0 * nsf * nsf

    def modconv(r, k, cin, cout, demod):
        nonlocal convs, linear
        convs += conv(r, k, cin, cout)
        linear += 2.0 * nsf * cin + (2.0 * cin * cout if demod else 0.0)

    modconv(4, 3, c[4], c[4], True)
    modconv(4, 1, c[4], 3, False)
    cin = c[4]
    for i in range(3, log_size + 1):
        r, cout = 2 ** i, c[2 ** i]
        modconv(r, 3, cin, cout, True)
        modconv(r, 3, cout, cout, True)
        modconv(r, 1, cout, 3, False)
        cin = cout
    return convs, linear


def _face_stage_split(expert, frames) -> tuple[float, float]:
    """Seconds of the expert's detections on ``frames`` and of the whole
    stage (``process_frames_selective``) on them, each ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        expert.detect_faces(f)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    expert.process_frames_selective(frames)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1


def _tf32_drift(frames, expert) -> str:
    """What cuDNN's TF32 would change: the detector's head outputs on the
    first frame and the restorer's output on its first face, TF32 against
    fp32 (max abs), and whether the decoded boxes stay."""
    params = nn_detector(expert.device)
    box = expert.detect_faces(frames[0])[0]
    x, y, w, h = box
    crop = torch.from_numpy(np.ascontiguousarray(
        frames[0][y:y + h, x:x + w])).cuda().float() / 255.0
    inp = resize(crop, (128, 128), method="linear")[None]
    outs = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.inference_mode():
            head = face_net.apply(params, face_net.net_input(
                frames[0], expert.device))[0]
            rest = _face_net_apply(expert.params, inp)
        outs[tf32] = (head.cpu().numpy(), rest)
    torch.backends.cudnn.allow_tf32 = False
    same = (face_net.decode(outs[True][0]) == face_net.decode(outs[False][0]))
    return (f"TF32 vs fp32: detector head max_abs "
            f"{np.abs(outs[True][0] - outs[False][0]).max():.3e} (boxes "
            f"{'unchanged' if same else 'CHANGED'}), restorer "
            f"{(outs[True][1] - outs[False][1]).abs().max().item() * 255:.3f}"
            f" LSB")


@phase("16 face path")
def face_path(device_line: str) -> dict:
    """The face stage through ``run_auto_frames``, routing with the
    detector, the stage alone at 720x1280 on the card against the CPU, and
    GFPGAN at 512 through ``$VETPU_GFPGAN_CKPT``."""
    frames = face_clip(16, 180, 320)
    kw = {"engine": "realesrgan", "enable_face_expert": True}
    run_auto_frames(frames[:4], **kw)                 # warm-up, not counted
    (out, stats), counts, secs = _counted(lambda: run_auto_frames(frames,
                                                                  **kw))
    plan = stats["routing_plan"]
    order = plan["processing_order"]
    prominence = plan["content_analysis"]["face_prominence"]
    print(f"route with enable_face_expert: model {stats['model']}, order "
          f"{order}; face_prominence {prominence:.4f}; faces restored "
          f"{stats.get('faces_restored')}, stage "
          f"{stats.get('face_restoration_sec', 0):.3f} s; launches {counts};"
          f" {secs:.3f} s end to end ({device_line})")
    check(prominence > 0.03, f"face_prominence {prominence}")
    check("face_restoration" in order
          and order[order.index("face_restoration") - 1] == "sota_realesrgan",
          f"the plan is {order}")
    check(stats.get("face_restoration") is True
          and stats.get("faces_restored", 0) > 0
          and "face_restoration_error" not in stats
          and "fallback_from" not in stats,
          f"the face stage: {stats.get('face_restoration_error')}")
    check(counts == _only(), f"the face route launched {counts}")
    check(len(out) == 16 and out[0].shape == (720, 1280, 3),
          f"{len(out)} frames of {out[0].shape}")

    router = DegradationRouter(available_models=probe_available())
    sampled = np.stack([frames[i] for i in sample_indices(len(frames))])
    torch.cuda.synchronize()
    route_s, det_s = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        router.analyze_frames(sampled, frame_count=16)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        face_area_ratio(sampled)
        torch.cuda.synchronize()
        route_s.append(t1 - t0)
        det_s.append(time.perf_counter() - t1)
    route_ms = 1e3 * statistics.median(route_s)
    det_ms = 1e3 * statistics.median(det_s)
    print(f"routing 12 sampled 180x320 frames: {route_ms:.3f} ms with the "
          f"detector (median of 5), the detector alone (4 frames) "
          f"{det_ms:.3f} ms, so {route_ms - det_ms:.3f} ms without it "
          f"({device_line})")

    big = list(build_handler("realesrgan").enhance_frames(iter(frames)))
    expert = FaceRestorationExpert()
    cpu = FaceRestorationExpert(device="cpu")
    _face_stage_split(expert, big[:2])                # warm-up, not counted
    (det, stage), stage_counts, _ = _counted(_face_stage_split, expert, big)
    check(stage_counts == _only(), f"the face stage launched {stage_counts}")
    n = len(big)
    print(f"face stage 720x1280, {n} frames: {1e3 * stage / n:.3f} ms a "
          f"frame ({stage:.3f} s): detection {1e3 * det / n:.3f} ms a frame,"
          f" scoring and restoration {1e3 * (stage - det) / n:.3f} "
          f"({device_line})")
    launches, dev, top = _kernel_profile(lambda: expert.detect_faces(big[0]))
    print(f"  one frame's detection: {launches} device kernels, "
          f"{dev:.3f} ms device time; top (ms): {'; '.join(top)}"
          if launches else "  device kernels: not measured")
    box = expert.detect_faces(big[0])[0]
    launches, dev, top = _kernel_profile(
        lambda: expert.restore_face(big[0], box, 0.6))
    print(f"  one face's restoration: {launches} device kernels, "
          f"{dev:.3f} ms device time; top (ms): {'; '.join(top)}"
          if launches else "  device kernels: not measured")
    print(f"  {_tf32_drift(big, expert)}")

    t0 = time.perf_counter()
    card_boxes = [expert.detect_faces(f) for f in big]
    cpu_boxes = [cpu.detect_faces(f) for f in big]
    got, st = expert.process_frames_selective(big)
    ref, st_cpu = cpu.process_frames_selective(big)
    cpu_s = time.perf_counter() - t0
    lsb = max(np.abs(a.astype(np.int16) - b).max() for a, b in zip(got, ref))
    moved = max(np.abs(a.astype(np.int16) - b).max() for a, b in zip(ref,
                                                                      big))
    print(f"face stage, card vs CPU ({cpu_s:.1f} s for both): boxes "
          f"{'equal' if card_boxes == cpu_boxes else 'DIFFER'} on {n} frames"
          f" ({sum(map(len, cpu_boxes))} boxes); faces restored "
          f"{st['faces_restored']} / {st_cpu['faces_restored']}; max "
          f"{lsb} LSB (tol {FACE_MAX_LSB}); the stage moves pixels by up to "
          f"{moved} LSB")
    check(card_boxes == cpu_boxes, "the card's boxes differ from the CPU's")
    check(st["faces_restored"] == st_cpu["faces_restored"] > 0,
          "the card restored other faces than the CPU")
    check(lsb <= FACE_MAX_LSB, "the card's restored frames differ")
    check(moved > 1, "the stage left the frames as they were")
    torch.cuda.empty_cache()
    return {"ms_frame": 1e3 * stage / n, "gfpgan": _gfpgan_face(
        big[0], box, device_line)}


def _gfpgan_face(frame, box, device_line: str) -> float:
    """GFPGANv1Clean at the v1.4 release configuration, seeded weights in a
    ``.pth`` served through ``$VETPU_GFPGAN_CKPT``: one face's ms (the
    bare graph at 512 and the expert's restoration of a box), its bound,
    device kernels, and the card's output against the CPU's."""
    import os
    import tempfile
    from pathlib import Path

    params = gfpgan_official_init(torch.Generator().manual_seed(SEED))
    for conv in params["stylegan_decoder"]["style_convs"] + [
            params["stylegan_decoder"]["style_conv1"]]:
        conv["w"].fill_(0.1)          # noise strengths: the noise counts
    n_params = sum(t.numel() for t in flatten_params(params).values())
    prev = os.environ.get("VETPU_GFPGAN_CKPT")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "GFPGANv1.4.pth"
        torch.save(_torch_state_dict(params), path)
        os.environ["VETPU_GFPGAN_CKPT"] = str(path)
        try:
            expert = FaceRestorationExpert()
        finally:
            if prev is None:
                del os.environ["VETPU_GFPGAN_CKPT"]
            else:
                os.environ["VETPU_GFPGAN_CKPT"] = prev
    check(expert.gfpgan_params is not None,
          "the checkpoint did not load into GFPGANv1Clean")
    served = flatten_params(expert.gfpgan_params)
    check(all(torch.equal(served[k].cpu(), v)
              for k, v in flatten_params(params).items()),
          "the served GFPGAN differs from the checkpoint")
    size = expert._gfpgan_size
    x = (torch.rand((1, size, size, 3), generator=torch.Generator()
                    .manual_seed(SEED)) * 2.0 - 1.0)
    xc = x.cuda()
    with torch.inference_mode(), full_fp32():
        fwd = lambda: gfpgan_official_apply(expert.gfpgan_params, xc)
        y, counts, _ = _counted(fwd)
        ms = time_ms(fwd, 2, 5)
        launches, dev, top = _kernel_profile(fwd)
    check(counts == _only(), f"GFPGAN launched {counts}")
    face_ms = time_ms(lambda: expert.restore_face(frame, box, 0.6), 2, 5)
    convs, linear = gfpgan_flops()
    flops = convs + linear
    nbytes = 4 * (n_params + 2 * x.numel())
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    print(f"GFPGANv1Clean 512 (v1.4 config, {n_params / 1e6:.2f} M "
          f"parameters, seeded .pth via $VETPU_GFPGAN_CKPT), fp32: "
          f"{ms:.3f} ms a face (the bare graph), {face_ms:.3f} ms the "
          f"expert's restoration of a box; bound {bound:.3f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
          f"{flops / 1e9:.1f} GFLOP at fp32, {convs / 1e9:.1f} of it convs;"
          f" {nbytes / 1e6:.0f} MB) ({device_line})")
    if launches:
        print(f"  {launches} device kernels, {dev:.3f} ms device time "
              f"(idle {1 - dev / ms:.3f}); top (ms): {'; '.join(top)}")
    cpu_params = cast_params(expert.gfpgan_params, torch.float32,
                             torch.device("cpu"))
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = gfpgan_official_apply(cpu_params, x)
    cpu_s = time.perf_counter() - t0
    err = (y.cpu() - ref).abs().max().item()
    print(f"GFPGAN 512, card vs CPU ({cpu_s:.1f} s on the CPU): max_abs "
          f"{err:.3e} (tol {GFPGAN_MAX_ABS}) on outputs up to "
          f"{ref.abs().max().item():.3f} (std {ref.std().item():.3f})")
    check(bool(torch.isfinite(y).all()), "GFPGAN's output is not finite")
    check(err <= GFPGAN_MAX_ABS, "the card's GFPGAN differs from the CPU's")
    del expert
    torch.cuda.empty_cache()
    return ms


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
        "ssd_shared:fast_mamba_vsr_ssd": (
            "video_enhancer_tpu_torch/csrc/ssd_shared.cu",
            "video_enhancer_tpu/ops/ssd.py:325"),
        "ssd_shared:b 368640": (
            "video_enhancer_tpu_torch/csrc/ssd_shared.cu",
            "video_enhancer_tpu/ops/ssd.py:325"),
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


def _cli(*args: str) -> tuple[dict, float]:
    """``python -m video_enhancer_tpu_torch.cli *args`` from this checkout:
    its JSON line and its wall seconds; a non-zero exit fails the run."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "video_enhancer_tpu_torch.cli",
                          *args], capture_output=True, text=True,
                         timeout=600, cwd=Path(__file__).resolve().parent)
    secs = time.perf_counter() - t0
    check(out.returncode == 0, f"cli {args[0]} exited {out.returncode}: "
          f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1]), secs


def _http(port: int, path: str, body: bytes | None = None,
          ctype: str | None = None) -> tuple[int, str, bytes]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    if ctype:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _post_clip(port: int, path: str, **fields) -> dict:
    b = uuid.uuid4().hex
    head = "".join(f'--{b}\r\nContent-Disposition: form-data; name="{k}"'
                   f"\r\n\r\n{v}\r\n" for k, v in fields.items())
    body = (f'{head}--{b}\r\nContent-Disposition: form-data; name="file"; '
            f'filename="{Path(path).name}"\r\n\r\n').encode() \
        + Path(path).read_bytes() + f"\r\n--{b}--\r\n".encode()
    status, _, raw = _http(port, "/api/v1/process/auto", body,
                           f"multipart/form-data; boundary={b}")
    check(status == 202, f"upload answered {status}: {raw[:500]!r}")
    return json.loads(raw)


@phase("17 entry points")
def entry_points(device_line: str) -> dict:
    """The CLI as subprocesses and a vsrm job through the REST server, both
    on raw ``.avi`` files of phase 4's clip."""
    n, h, w = 16, 180, 320
    frames = synthetic_clip(n, h, w)
    with tempfile.TemporaryDirectory() as d:
        src = write_video(f"{d}/clip.avi", np.stack(frames), fps=24.0)
        pick = DegradationRouter(
            default_policy(), available_models=probe_available()
        ).analyze_and_route(src, device="cpu")["expert_routing"][
            "primary_model"]
        print(f"the router's pick of phase 4's clip on the CPU: {pick}")
        check(pick == "seedvr2", f"the CPU router picks {pick}")

        meta, _ = _cli("metadata", src)
        check((meta["width"], meta["height"], meta["frame_count"],
               meta["fps"], meta["codec"]) == (w, h, n, 24.0, "\x00" * 4),
              f"metadata {meta}")
        stats, cli_secs = _cli("enhance", src, f"{d}/auto.avi", "--engine",
                               "auto")
        errors = sorted(k for k in stats if k.endswith("_error"))
        check(stats["model"] == pick and "fallback_from" not in stats
              and not errors and stats["frames_processed"] == n,
              f"cli enhance: model {stats['model']}, errors {errors}, "
              f"{stats.get('fallback_error')}")
        ev, _ = _cli("eval", f"{d}/auto.avi", src)
        check(set(ev) == {"psnr", "ssim", "temporal_consistency"}
              and all(math.isfinite(v) for v in ev.values()),
              f"cli eval {ev}")
        print(f"cli: metadata {meta['width']}x{meta['height']}, "
              f"{meta['frame_count']} frames; enhance --engine auto "
              f"({stats['model']}, order "
              f"{stats['routing_plan']['processing_order']}) "
              f"{cli_secs:.3f} s wall as a subprocess; eval psnr "
              f"{ev['psnr']:.3f} dB, ssim {ev['ssim']:.4f} ({device_line})")

        srv = ApiServer(data_dir=f"{d}/srv", start_scheduler=False)
        check(srv.device.type == "cuda", "the server is not on the card")
        httpd = serve(create_app(srv), host="127.0.0.1", port=0,
                      background=True)
        port = httpd.server_address[1]
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t_post = time.time()
            job = _post_clip(port, src, vsr_strategy="vsrm")
            check(job["strategy"] == "vsrm", f"job {job}")
            deadline = time.time() + 300
            while time.time() < deadline:
                rec = json.loads(_http(port, f"/api/v1/job/{job['job_id']}")[2])
                if rec.get("status") in ("completed", "failed"):
                    break
                time.sleep(0.25)            # 60 requests a minute an address
            counts = dict(kernels.launch_counts)
            check(rec.get("status") == "completed", f"job {rec}")
            wall = rec["completed_at"] - t_post
            routed = rec["routing_plan"]["expert_routing"]["primary_model"]
            check(routed == pick, f"the plan at upload names {routed}")
            status, ctype, raw = _http(port, f"/api/v1/job/{job['job_id']}"
                                             "/download")
            check(status == 200 and ctype == "video/x-msvideo",
                  f"download {status} {ctype}")
            Path(f"{d}/got.avi").write_bytes(raw)
            got = read_video(f"{d}/got.avi")
        finally:
            httpd.shutdown()
            httpd.server_close()
    want = _only(ssd_shared=60, fused_bidir_ssm=30)
    print(f"job launches {counts}")
    check(counts == want, f"job launches {counts} != {want}")
    ref = np.stack(list(build_handler("vsrm").enhance_frames(iter(frames))))
    check(got.shape == ref.shape == (n, 4 * h, 4 * w, 3),
          f"job frames {got.shape}")
    lsb = int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max())
    check(lsb == 0, f"job frames {lsb} LSB from the handler's")
    res = rec["result"]
    print(f"REST job, vsrm x4 {h}x{w} -> {4 * h}x{4 * w}, {n} frames: "
          f"upload to completed {wall:.3f} s wall ({n / wall:.2f} frames/s "
          f"end to end); the handler's enhance_video {res['fps']:.2f} "
          f"frames/s ({res['processing_time_sec']:.3f} s); frames equal to "
          f"the in-memory handler's (0 LSB); {len(raw) / 2**20:.1f} MiB "
          f"downloaded ({device_line})")
    return {"counts": counts, "job_wall_s": wall, "cli_enhance_s": cli_secs}


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
    big = path.pop("frames")
    temporal_stage(big, synthetic_clip(16, 180, 320),
                   f"{env['kind']}, {env['smi']}")
    realesrgan_paths(f"{env['kind']}, {env['smi']}")
    fmv_ssd = fmv_ssd_path(f"{env['kind']}, {env['smi']}")
    hfr_stage(big, f"{env['kind']}, {env['smi']}")
    face_path(f"{env['kind']}, {env['smi']}")
    entry_points(f"{env['kind']}, {env['smi']}")
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
              **opt_in,
              # rows 1-2 on fast_mamba_vsr_ssd's path: phase 14
              "ssd_shared:fast_mamba_vsr_ssd":
                  fmv_ssd["counts"]["ssd_shared"],
              "ssd_shared:b 368640": fmv_ssd["wide_counts"]["ssd_shared"]}
    print(json.dumps({"kernels": kernel_record(rec, counts)}))
    print(env["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["kind"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
