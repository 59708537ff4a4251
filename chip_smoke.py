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
   of each frame's 45x80 level, 8 frames), at shapes only several ranks
   give (ditvr's gathered K/V at two ranks, q (1, 6, 1800, 64) against k/v
   (1, 6, 3600, 64); the 3b preset's 24 heads of 96 at 3600 tokens), at
   the 3b forward's (1, 24, 14400, 96) in bf16 against the plain version
   run head by head, also at ragged lengths (one
   across a 128-row tile edge, Dh 48), the
   fused SSM also at fast_mamba_vsr's shape and at a count of sequences
   that is not a multiple of the sequences a block, the SSD (bf16, both
   directions) also at fast_mamba_vsr_ssd's temporal shape (57,600
   sequences of 16 steps, 2 heads of 48, N 8), at 368,640 sequences
   (one launch a call past 65,535) and at the 8 steps a rank scans when
   that window is split over two, each with its plain time and bound,
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
   wall time;
18. measured quality: ``train.evalsuite.write_qualification_report`` on
   the card (6 seeds, every model of ``ALL_MODELS`` on both eval families,
   fp32 with TF32 off, the kernels in their fp32 forms; the report to a
   temporary file): each of the 20 gains beside the committed
   ``weights/QUALIFICATION.json`` (``QUALITY_TOL_DB``), every gate of
   tests/test_bundled_weights.py (``GATES``), the disqualified set equal
   to the committed report's, each model's kernel rows launched
   (``EVAL_KERNELS``) and no plain version of a kernel on a card tensor,
   each kernel's first eval call timed again against its plain version
   on its own inputs (the ``:eval`` rows of the kernels line), the
   report's wall time and each model's share; the eval CLI as a
   subprocess (vsrm on ``alt``, the report's gain); the LPIPS proxy's
   ``severity_ladder_corr`` on the card against the CPU; the coordinator's
   workflow on phase 17's ``.avi`` clip, its quality metrics equal to
   ``assess_clips`` on the same output;
19. the exact sharded restorers and FSDP on a one-rank NCCL mesh
   (``make_mesh()``), bundled weights in bf16, each against the
   single-device model within the window tolerances, with its launches,
   ms, frames/s and peak memory: ``make_exact_sharded_seedvr2`` on one
   window of 8 of phase 11's clip (3 flash launches, as single-device);
   ``make_exact_sharded_ditvr`` on 8 frames of phase 5's clip (14,400
   tokens: the ring, no flash launch against 8) and on 2 (3,600: gathered
   K/V, 8 flash launches); ``make_exact_sharded_fmv`` on
   fast_mamba_vsr_ssd's weights and phase 14's first window (16 SSD
   launches); ``make_sharded_ditvr(preset="3b")`` drawn on the card in
   bf16 (seeded, a live head): its parameter bytes and peak memory, one
   forward on an 8-frame 180x320 window (32 flash launches at (1, 24,
   14400, 96)) against ``ditvr.apply`` on the same tensors;
20. the one-port app, warm start and validation: (a) ``python -m
   video_enhancer_tpu_torch.app --self-test`` as a subprocess on a free
   port, polled until ``/health`` answers (its self-test passed, ``/ui``
   the page as ``text/html``, ``/health`` naming the card), ``validate
   --mode ci --url`` against it with its four probes ok, then stopped; (b)
   ``warm_start`` in this process for each model of ``probe_available()``
   (a seeded 4-frame 64x64 clip in bf16), each ok with its seconds and
   exactly its launches (``WARM_LAUNCHES``), and ``python -m
   video_enhancer_tpu_torch.warm_start`` finding the kernel library built;
   (c) ``validate --mode full`` passing, and each of its five tiny fp32
   forwards on the card against the same forward on the CPU's plain
   versions (the window bounds), launches by kernel (``TINY_LAUNCHES``);
   every kernel call of (b) and (c) at its first shape a model gives held
   against its plain version on its own inputs (the ``phase 20 kernels``
   line, before the kernels line); (d) the FLOPs recorded around a served
   vsrm window (12 SSD + 6 fused SSM) and a ditvr window (8 flash) against
   the sums from the shapes, and ``device_time_per_call`` of the vsrm
   window beside its CUDA-event median; (e) a process whose
   ``$VETPU_POLICY`` disables vsrm routes phase 11's sharp clip (vsrm
   under the committed policy) elsewhere on the card. The processes of
   (a), (b), (c) and (e) start together and run beside the work in this
   process; (d) runs after they have ended;
21. training on the card, in fp32 with TF32 off (JAX trains in fp32), the
   optimizer at ``make_optimizer()``'s defaults: (a) vsrm x4 at full width
   (dim 64, 6 blocks) warm-started from its bundled weights, on a seeded
   batch at the train CLI's defaults (``make_pairs``: batch 4, clip 4, HR
   crop 128); step 1 through the kernels against step 1 through the plain
   forms (the loss within 1e-5 relative, each gradient leaf within 1e-4 of
   its max abs, each updated parameter within 2 x lr; every leaf behind
   the SSD and the fused SSM with a nonzero gradient), then 8 steps on the
   fixed batch under deterministic algorithms: exactly 12 SSD and 6 fused
   SSM launches a step (all in the forward: the backward recomputes the
   plain versions), the loss falling; ms a step (median of steps 3-8),
   peak memory, one step traced by op (forward, backward, optimizer; the
   plain SSD's and fused SSM's share of the backward); (b) one step each
   of fast_mamba_vsr x4 (8 fused SSM launches), ditvr (8 flash, 512 tokens
   a clip at scale 1) and rvrt x4 (4 window) at their served widths and
   bundled weights, checked as (a)'s step 1 (and no leaf with a gradient
   on one path only); (c) the eight autograd Functions (rows 1-6, 8, 10,
   11) at phase 3's and phases 9-10's shapes: each Function's outputs (the
   kernel) within phase 3's fp32 ``TOL`` of the plain version's, and for a
   seeded upstream gradient every input's gradient through the Function
   equal to the plain version's (``VJP_TOL``), one launch and none in the
   backward; rows 7 and 9 raise under grad; (d) (a)'s state saved
   after step 4 and resumed equals the 8 straight steps bit for bit (or,
   for an op with no deterministic form, named, within 1e-6), and its
   ``export_params`` npz, loaded into a fresh ``vsrm.init``, applies bit
   for bit as the trained state; (e) ``run_dryrun`` on a one-rank NCCL
   mesh, printing JAX's ``dryrun ok`` lines.

In phases 5-7, 11, 13 and 14 the route runs the temporal stage wherever its
plan holds ``temporal_consistency`` (all but 11 here): the streamed frames of
window 0 are then held within 1 LSB of the stage run on window 0's rounded
output (the stage is causal), and the stats must say it ran with no error.

22. the train CLI on the card (fp32, TF32 off): (a) ``train.cli.main``
   trains vsrm x4 at its bundled widths from ``--init-npz`` the bundled
   ``vsrm_4x.npz``, ``--through-calibration vsrm``, on the default mixed
   bank and mixture (so the WebP chain family runs), batch 4 x 4 frames at
   crop 128: 8 steps with ``--ckpt-dir``, then 4 more resumed from it with
   ``--export``; exactly 12 SSD and 6 fused SSM launches a step; the
   export, loaded through ``try_load_params``, equals the final
   checkpoint's parameters and enhances one window to finite frames; it
   prints the seconds a step, the data thread's seconds a batch and the
   device's milliseconds a step (CUDA events around each step); (b)
   ``faces.main``, ``face_detector.main`` and ``lpips.main`` a few steps
   each on the card, exporting into a temporary directory, with their
   held-out figures.

23. vsrm's attentive mixer and the last library layers: (a) with
   ``$VETPU_PREFERRED_BACKBONE=mambairv2`` ``build_handler("vsrm")`` serves
   the attentive vsrm x4 (seeded init at full width: no weights of it are
   bundled) on a seeded 10-frame 180x320 clip, 3 windows: exactly 6 flash
   and 6 fused SSM launches a window and no SSD, frames/s; the flash
   kernel at the served q, k, v of a window's first block (7, 2, 57,600,
   64) against the plain form run in blocks of 2,048 queries (the whole
   call's fp32 logits would take 186 GB), with its time beside the plain
   blocks', SDPA's and its bound and exps' floor; the model with a seeded
   head and offset on a 64x96 window, kernels against the plain forms
   (window bounds); the variable cleared, the registry serves the default
   vsrm again (12 SSD + 6 fused SSM a window); (b) ``bimamba2`` at dim 64
   over 7 rasters of 180x320 (2 heads of 64, N 32): 2 SSD launches a call,
   against its plain form; the SSD kernel at that shape, both directions,
   against its plain version with its plan, time and bound; (c)
   ``FramePipeline`` over phase (a)'s clip as ``.avi`` yielding float32
   windows on the card, equal to the frames / 255; the deblur nets and
   resize's lanczos (x4 up) and area (x4 down) on the card against the CPU
   in fp32 (TF32 off), with their times.

Phase 21's and phase 22's launches a step are on lines of their own
before the kernels' record. The line before the card's name and power limit
holds the kernels' JSON record; the last line is ``{"ok": true,
"device": {...}}``. The script
needs a card: without one it exits non-zero and prints no result. It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import functools
import json
import math
import os
import socket
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
from video_enhancer_tpu_torch.agents import CoordinatorAgent
from video_enhancer_tpu_torch.agents.quality import assess_clips
from video_enhancer_tpu_torch.analysis import DegradationRouter, face_net
from video_enhancer_tpu_torch.analysis.faces import (face_area_ratio,
                                                     nn_detector)
from video_enhancer_tpu_torch.config import (DEFAULT_POLICY_PATH, MODELS,
                                             default_policy)
from video_enhancer_tpu_torch.device import full_fp32
from video_enhancer_tpu_torch.io.video import (read_video, sample_indices,
                                               write_video)
from video_enhancer_tpu_torch.io.demo import make_demo_frames
from video_enhancer_tpu_torch.io.pipeline import FramePipeline, iter_windows
from video_enhancer_tpu_torch.models import (deblur, ditvr, fast_mamba_vsr,
                                             official_arch, rvrt, seedvr2,
                                             vsrm)
from video_enhancer_tpu_torch.models.official_gfpgan import (
    gfpgan_channels, gfpgan_official_apply, gfpgan_official_init)
from video_enhancer_tpu_torch.nn import ssm
from video_enhancer_tpu_torch.ops import attention as attn_mod
from video_enhancer_tpu_torch.ops import scan as scan_mod
from video_enhancer_tpu_torch.ops import ssd as ssd_mod
from video_enhancer_tpu_torch.nn.ssm import (bimamba2_apply, bimamba2_init,
                                             bimamba_apply, bimamba_init,
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
from video_enhancer_tpu_torch.ops.resize import resize, resize_video
from video_enhancer_tpu_torch.ops.ssd import (_ssd_plan, ssd_shared_kernel,
                                              ssd_shared_plain)
from video_enhancer_tpu_torch.runtime.calibration import (calibrate_restore,
                                                          calibrate_vsr)
from video_enhancer_tpu_torch.parallel.inference import (
    make_exact_sharded_ditvr, make_exact_sharded_fmv,
    make_exact_sharded_seedvr2, make_exact_sharded_vsrm, make_sharded_clip_fn)
from video_enhancer_tpu_torch.parallel.dryrun import run_dryrun
from video_enhancer_tpu_torch.parallel.mesh import local_mesh, make_mesh
from video_enhancer_tpu_torch.parallel.model_parallel import \
    make_sharded_ditvr
from video_enhancer_tpu_torch.parallel.spatial import \
    make_spatially_sharded_clip_fn
from video_enhancer_tpu_torch.runtime.experts import temporal_smooth
from video_enhancer_tpu_torch.runtime.face_handler import (
    FaceRestorationExpert, _face_net_apply)
from video_enhancer_tpu_torch.runtime.fallback import ModelFallbackManager
from video_enhancer_tpu_torch.runtime.qualification import \
    disqualified_models
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
from video_enhancer_tpu_torch.runtime.weights import (flatten_params,
                                                     try_load_params,
                                                     load_into,
                                                     params_from_jax,
                                                     read_npz)
from video_enhancer_tpu_torch.serving.app import ApiServer, create_app
from video_enhancer_tpu_torch.serving.http import serve
from video_enhancer_tpu_torch.train import cli as train_cli
from video_enhancer_tpu_torch.train import evalsuite, face_detector, faces
from video_enhancer_tpu_torch.train import lpips
from video_enhancer_tpu_torch.train import step as train_step_mod
from video_enhancer_tpu_torch.train.checkpoint import (export_params,
                                                       restore_checkpoint,
                                                       save_checkpoint)
from video_enhancer_tpu_torch.train.data import make_pairs
from video_enhancer_tpu_torch.train.losses import vsr_loss
from video_enhancer_tpu_torch.train.step import (make_optimizer,
                                                 make_train_step, tree_leaves)
from video_enhancer_tpu_torch.utils.flops import accounting
from video_enhancer_tpu_torch.utils.timing import device_time_per_call
from video_enhancer_tpu_torch.validate import TINY_CLIP, tiny_models
from video_enhancer_tpu_torch.warm_start import warm_start

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
# its local scan when the window's 16 frames are split over two ranks
SSD_SHARDED_SHAPE = dict(SSD_FMV_SHAPE, L=8)
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
# shapes only several ranks give (phase 19 runs one): ditvr's gathered K/V
# at two ranks, Lq = L / 2 against Lk = L (L 3600, 6 heads of 64); the 3b
# preset's head width (24 heads of 96, padded to 128) at 3600 tokens, and
# at the 14,400 tokens of the 3b forward on an 8-frame 180x320 window
# (phase 19 (d), held there against the plain version head by head)
FLASH_GATHERED = dict(B=1, H=6, Lq=1800, Lk=3600, Dh=64)
FLASH_3B_SHAPE = dict(B=1, H=24, L=3600, Dh=96)
FLASH_3B_WINDOW = dict(B=1, H=24, L=14400, Dh=96)
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

# phase 23: vsrm's attentive mixer at 180x320, window 7 (dim 64 -> inner
# 128 in 2 heads of 64 over each frame's 57,600 tokens), held against the
# plain form in blocks of queries; bimamba2 at dim 64 over 7 frames'
# rasters (inner 128 in 2 heads of 64, N 32: the SSD's CUDA-core route)
FLASH_ATTENTIVE_SHAPE = dict(B=7, H=2, L=180 * 320, Dh=64)
ATTENTIVE_QUERY_BLOCK = 2048
ATTENTIVE_FRAMES = 10            # 3 windows of 7 every 3
SSD_MAMBA2_SHAPE = dict(b=7, L=180 * 320, H=2, P=64, N=32)
# the card against the CPU in fp32 (TF32 off): the deblur nets, resize
DEVICE_FP32_MAX_ABS = 1e-5

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
    shapes, at the shapes only several ranks give (gathered K/V with Lq !=
    Lk, the 3b head width) and at ragged lengths; at the named shapes its
    time beside the plain version's and SDPA's; then at the 3b window's
    shape."""
    rec = {}
    named = {"flash_attention": FLASH_SHAPE,
             "flash_attention:seedvr2": FLASH_SEEDVR2_SHAPE,
             "flash_attention:3b head width": FLASH_3B_SHAPE}
    cases = [(key, dict(B=s["B"], H=s["H"], Lq=s["L"], Lk=s["L"],
                        Dh=s["Dh"])) for key, s in named.items()]
    cases += [("flash_attention:gathered K/V", FLASH_GATHERED)]
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
                bound = max(nbytes / H100_BYTES_PER_S,
                            flops / H100_BF16_FLOPS) * 1e3
                print(f"{key} shape bf16: plain {plain_ms:.3f} ms, "
                      f"scaled_dot_product_attention {lib_ms:.4f} ms, bound "
                      f"{bound:.4f} ms")
                rec[key] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bytes=nbytes, flops=flops,
                    peak=H100_BF16_FLOPS)
            del got, ref, q, k, v
    rec["flash_attention:3b"] = flash_3b_vs_plain()
    return rec


def _attention_by_head(q, k, v) -> torch.Tensor:
    """attention_ref one head at a time (the whole call's fp32 logits would
    take 20 GB at the 3b window's shape)."""
    return torch.cat([attention_ref(q[:, h:h + 1], k[:, h:h + 1],
                                    v[:, h:h + 1])
                      for h in range(q.shape[1])], dim=1)


def flash_3b_vs_plain() -> dict:
    """The flash kernel at the 3b forward's shape (1, 24, 14400, 96), bf16,
    against attention_ref head by head; its time beside that plain
    version's and SDPA's."""
    s = FLASH_3B_WINDOW
    shp = dict(B=s["B"], H=s["H"], Lq=s["L"], Lk=s["L"], Dh=s["Dh"])
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q, k, v = _flash_inputs(dtype, gen, **shp)
    got = flash_attention(q, k, v)
    ref = _attention_by_head(q, k, v)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()),
          "flash_attention 3b: non-finite")
    err, rel = rel_err(got, ref)
    tol = TOL[("flash_attention", "bfloat16")]
    ms = time_ms(lambda: flash_attention(q, k, v))
    plain_ms = time_ms(lambda: _attention_by_head(q, k, v), warmup=1,
                       iters=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v))
    nbytes, flops = _flash_cost(dtype, **shp)
    bound = max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3
    print(f"flash_attention:3b {shp} bf16: max_abs_err {err:.3e} rel "
          f"{rel:.3e} (tol {tol:g}); kernel {ms:.4f} ms, plain (by head) "
          f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.4f} "
          f"ms, bound {bound:.4f} ms ({flops / 1e12:.3f} TFLOP)")
    check(rel <= tol, f"flash_attention:3b: rel {rel} > {tol}")
    del got, ref, q, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bytes=nbytes, flops=flops, peak=H100_BF16_FLOPS)


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
    temporal shapes, bf16, both directions: at 180x320 (b 57,600), at
    b 368,640 (one launch a call past 65,535 sequences) and at the 8 steps
    a rank scans when the window is split over two; ms, plain ms and the
    bound of each, and the plan (route, one block a sequence)."""
    rec = {}
    for key, shape in (("ssd_shared:fast_mamba_vsr_ssd", SSD_FMV_SHAPE),
                       ("ssd_shared:b 368640", SSD_WIDE_SHAPE),
                       ("ssd_shared:L 8", SSD_SHARDED_SHAPE)):
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
        "flash_attention:3b": ("video_enhancer_tpu_torch/csrc/flash_attn.cu",
                               "video_enhancer_tpu/ops/attention.py:118"),
        "flash_attention:attentive": (
            "video_enhancer_tpu_torch/csrc/flash_attn.cu",
            "video_enhancer_tpu/ops/attention.py:118"),
        "ssd_shared:mamba2": ("video_enhancer_tpu_torch/csrc/ssd_shared.cu",
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


# --- phase 18: measured quality ------------------------------------------

# each card gain against the committed weights/QUALIFICATION.json, in dB
QUALITY_TOL_DB = 0.005
# tests/test_bundled_weights.py GATES: (ind, alt) lower bounds in dB, each
# gain strictly above its gate
GATES = {"vsrm": (0.3, 0.0), "fast_mamba_vsr": (0.3, 0.0),
         "fast_mamba_vsr_ssd": (0.02, 0.02), "rvrt": (0.2, 0.0),
         "realesrgan": (0.5, -0.15), "realesrgan_fast": (0.25, 0.0),
         "cnn_upscaler": (0.06, -0.15), "ditvr": (1.0, -1.6),
         "seedvr2": (0.3, -0.3), "rife": (1.4, -0.45)}
# the kernel rows each model's eval launches (no other)
EVAL_KERNELS = {"vsrm": ("ssd_shared", "fused_bidir_ssm"),
                "fast_mamba_vsr": ("fused_bidir_ssm",),
                "fast_mamba_vsr_ssd": ("ssd_shared",),
                "rvrt": ("window_attention",),
                "ditvr": ("flash_attention",),
                "seedvr2": ("flash_attention",)}
EVAL_SOURCES = {
    "ssd_shared": ("video_enhancer_tpu_torch/csrc/ssd_shared.cu",
                   "video_enhancer_tpu/ops/ssd.py:325"),
    "fused_bidir_ssm": ("video_enhancer_tpu_torch/csrc/fused_bissm.cu",
                        "video_enhancer_tpu/ops/scan.py:941"),
    "flash_attention": ("video_enhancer_tpu_torch/csrc/flash_attn.cu",
                        "video_enhancer_tpu/ops/attention.py:118"),
    "window_attention": ("video_enhancer_tpu_torch/csrc/window_attn.cu",
                         "video_enhancer_tpu/ops/attention.py:232")}
LPIPS_TOL = 1e-4


class _EvalHooks:
    """Inside: each kernel's CUDA entry keeps the arguments of its first
    call for each model (``model`` is set as the report goes), and the
    plain version of every kernel of the eval counts the calls it gets
    with a card tensor (attention_ref only where the flash kernel would
    serve: unbiased, 256 tokens or more on both sides)."""

    CUDA = {"ssd_shared": (ssd_mod, "_ssd_shared_cuda"),
            "fused_bidir_ssm": (scan_mod, "_fused_bidir_ssm_cuda"),
            "flash_attention": (attn_mod, "_flash_cuda"),
            "window_attention": (attn_mod, "_window_cuda")}
    PLAIN = [(ssd_mod, "ssd_shared_plain"),
             (scan_mod, "fused_bidir_ssm_plain"),
             (attn_mod, "window_attention_plain"),
             (rvrt, "window_attention_plain"),
             (attn_mod, "attention_ref")]

    def __init__(self):
        self.model = None
        self.calls: dict = {}
        self.plain_on_card: list = []
        self._saved = []

    def _capture(self, key, fn):
        def run(*args, **kw):
            # the wrappers pass their static arguments (dt_rank, scale) by
            # keyword, in the entry's order
            args += tuple(kw.values())
            self.calls.setdefault((self.model, key), (fn, args))
            return fn(*args)
        return run

    def _guard(self, name, fn):
        def run(q, *args, **kw):
            if q.is_cuda:
                bias = kw.get("bias", args[2] if len(args) > 2 else None)
                long_seq = (name != "attention_ref" or (
                    bias is None and q.shape[2] >= 256
                    and args[0].shape[2] >= 256))
                if long_seq:
                    self.plain_on_card.append((self.model, name,
                                               tuple(q.shape)))
            return fn(q, *args, **kw)
        return run

    def __enter__(self):
        for key, (mod, attr) in self.CUDA.items():
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._capture(key, fn))
        for mod, attr in self.PLAIN:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._guard(attr, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)


def _eval_kernel_row(model: str, key: str, fn, args, tag: str = "eval"
                     ) -> dict:
    """One kernel's first call in a model's run (``tag``: the eval, phase
    20's warm start or tiny forwards), timed again on its own inputs
    against its plain version (and the library call where there is one),
    in the dtype it was called with."""
    dtype = args[0].dtype
    dname = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
    # the scans compute in fp32 in every dtype; attention and the SSD's
    # products run on the tensor cores in bf16
    peak = (H100_BF16_FLOPS if dtype == torch.bfloat16
            and key != "fused_bidir_ssm" else H100_FP32_FLOPS)
    if key == "ssd_shared":
        x, dt, A, Bm, Cm, reverse = args
        b, L, H, P = x.shape
        shp = dict(b=b, L=L, H=H, P=P, N=Bm.shape[-1])

        def plain():
            return ssd_mod.ssd_shared_plain(x, dt, A, Bm, Cm,
                                            reverse=reverse)
        nbytes, flops = _ssd_cost(dtype, ssd_mod._SSD_Q, shp)
        lib = None
    elif key == "fused_bidir_ssm":
        u, cw, Af, r = args[0], args[2], args[9], args[13]
        shp = dict(B=u.shape[0], L=u.shape[1], D=u.shape[2], N=Af.shape[1],
                   dt_rank=r, K=cw.shape[-1])

        def plain():
            return scan_mod.fused_bidir_ssm_plain(*args)
        nbytes, flops = _bissm_cost(dtype, shp)
        lib = None
    elif key == "flash_attention":
        q, k, v, scale = args
        shp = dict(B=q.shape[0], H=q.shape[1], Lq=q.shape[2], Lk=k.shape[2],
                   Dh=q.shape[3])

        def plain():
            return attn_mod.attention_ref(q, k, v, scale=scale)
        nbytes, flops = _flash_cost(dtype, **shp)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def lib():
            return sdpa(q, k, v, scale=scale)
    else:
        q, k, v, bias, scale = args
        shp = dict(nW=q.shape[0], H=q.shape[1], N=q.shape[2], Dh=q.shape[3])

        def plain():
            return attn_mod.window_attention_plain(q, k, v, bias,
                                                   scale=scale)
        nbytes, flops = _window_cost(dtype, **shp)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        mask = bias.float()[None]

        def lib():
            return sdpa(q, k, v, attn_mask=mask, scale=scale)
    with torch.inference_mode(), full_fp32():
        got = fn(*args)
        ref = plain()
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        tol = TOL[(key, str(dtype).split(".")[1])]
        check(bool(torch.isfinite(got).all()) and rel <= tol,
              f"{key} at {model}'s {tag} shape {shp} {dname}: rel {rel} > "
              f"{tol}")
        ms = time_ms(lambda: fn(*args))
        plain_ms = time_ms(plain, warmup=1, iters=3)
        lib_ms = time_ms(lib) if lib is not None else None
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    print(f"{key} at {model}'s {tag} shape {shp} {dname}: max_abs_err "
          f"{err:.3e} rel {rel:.3e} (tol {tol:g}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, library "
          f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
          f"{max(t_bytes, t_ops):.4f} ms")
    source, replaces = EVAL_SOURCES[key]
    return {"name": f"{key}:{tag} {model} {dname}", "route": "cuda",
            "source": source, "replaces": replaces, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}


def _quality_report(d: str, device_line: str) -> tuple[dict, list]:
    """The report on the card with per-model launches, times and the
    unrounded gains; checks them; returns the report and the ``:eval``
    kernel rows."""
    committed = json.loads(
        (evalsuite.WEIGHTS_DIR / "QUALIFICATION.json").read_text())["models"]
    raw: dict = {}
    real_gain = evalsuite.bundled_gain
    marks: list = []
    hooks = _EvalHooks()

    def gain(name, family, n_seeds=8, device=None):
        if not marks or marks[-1][0] != name:     # a model's first family
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter(),
                          dict(kernels.launch_counts)))
            hooks.model = name
        raw[(name, family)] = real_gain(name, family, n_seeds=n_seeds,
                                        device=device)
        return raw[(name, family)]

    kernels.reset_launch_counts()
    evalsuite.bundled_gain = gain
    t0 = time.perf_counter()
    try:
        with hooks:
            report = evalsuite.write_qualification_report(
                path=f"{d}/QUALIFICATION.json", n_seeds=6)
        torch.cuda.synchronize()
    finally:
        evalsuite.bundled_gain = real_gain
    wall = time.perf_counter() - t0
    marks.append((None, time.perf_counter(), dict(kernels.launch_counts)))
    per_model = {}
    for (name, t_a, c_a), (_, t_b, c_b) in zip(marks, marks[1:]):
        per_model[name] = ({k: c_b[k] - c_a[k] for k in c_a}, t_b - t_a)

    check(sorted(report["models"]) == sorted(evalsuite.ALL_MODELS),
          f"report models {sorted(report['models'])}")
    print(f"quality report, 6 seeds, 10 models x 2 families on the card: "
          f"{wall:.2f} s wall ({device_line})")
    worst = 0.0
    for name in evalsuite.ALL_MODELS:
        counts, secs = per_model[name]
        for fam, gate in zip(("ind", "alt"), GATES[name]):
            g, ref = raw[(name, fam)], committed[name][fam]
            worst = max(worst, abs(g - ref))
            print(f"  {name:18s} {fam}: card {g:+.6f} dB (report "
                  f"{report['models'][name][fam]:+.3f}), committed "
                  f"{ref:+.3f}, diff {g - ref:+.6f}; gate > {gate}")
            check(abs(g - ref) <= QUALITY_TOL_DB,
                  f"{name} {fam}: card {g:.6f} vs committed {ref}")
            check(g > gate, f"{name} {fam}: {g:.6f} dB under its gate {gate}")
        launched = {k: v for k, v in counts.items() if v}
        print(f"    {secs:.2f} s ({100 * secs / wall:.1f}% of the report); "
              f"launches {launched}")
        want = EVAL_KERNELS.get(name, ())
        check(set(launched) == set(want),
              f"{name}: launched {sorted(launched)}, expected {sorted(want)}")
    print(f"largest |card - committed|: {worst:.6f} dB (tol "
          f"{QUALITY_TOL_DB})")
    check(not hooks.plain_on_card,
          f"plain versions ran on card tensors: {hooks.plain_on_card[:5]}")

    saved = os.environ.get("VETPU_QUALIFICATION")
    try:
        os.environ["VETPU_QUALIFICATION"] = f"{d}/QUALIFICATION.json"
        card_dq = disqualified_models()
        os.environ.pop("VETPU_QUALIFICATION")
        committed_dq = disqualified_models()
    finally:
        if saved is not None:
            os.environ["VETPU_QUALIFICATION"] = saved
    print(f"disqualified: card {sorted(card_dq)}, committed "
          f"{sorted(committed_dq)}")
    check(card_dq == committed_dq, "the disqualified sets differ")

    rows = [_eval_kernel_row(model, key, fn, args)
            for (model, key), (fn, args) in sorted(hooks.calls.items())]
    for row in rows:
        model = row["name"].split(":eval ")[1].split()[0]
        row["launches"] = per_model[model][0][row["name"].split(":")[0]]
    return report, rows


@phase("18 measured quality")
def measured_quality(device_line: str) -> list:
    """The qualification report on the card, the eval CLI, the LPIPS
    proxy and the coordinator's workflow; returns the ``:eval`` kernel
    rows."""
    with tempfile.TemporaryDirectory() as d:
        report, rows = _quality_report(d, device_line)

        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "video_enhancer_tpu_torch.train.evalsuite",
             "vsrm", "--family", "alt", "--n-seeds", "6"],
            capture_output=True, text=True, timeout=600,
            cwd=Path(__file__).resolve().parent)
        secs = time.perf_counter() - t0
        check(out.returncode == 0, f"eval CLI exited {out.returncode}: "
              f"{out.stderr[-3000:]}")
        cli = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"eval CLI vsrm alt: {cli} in {secs:.2f} s wall as a "
              f"subprocess ({device_line})")
        check(cli["gain_db"] == report["models"]["vsrm"]["alt"],
              f"the CLI's gain {cli['gain_db']} != the report's")

        frames = make_demo_frames(16, (160, 160))
        with full_fp32():
            t0 = time.perf_counter()
            corr = lpips.severity_ladder_corr(lpips.load_proxy(), frames,
                                              n_ladders=8, seed=777)
            card_s = time.perf_counter() - t0
        corr_cpu = lpips.severity_ladder_corr(lpips.load_proxy("cpu"),
                                              frames, n_ladders=8, seed=777)
        print(f"LPIPS proxy severity_ladder_corr: card {corr:.6f} "
              f"({card_s:.2f} s), CPU {corr_cpu:.6f}")
        check(corr >= 0.8 and abs(corr - corr_cpu) <= LPIPS_TOL,
              f"LPIPS correlation {corr} (CPU {corr_cpu})")

        src = write_video(f"{d}/clip.avi", np.stack(synthetic_clip(16, 180,
                                                                   320)),
                          fps=24.0)
        coord = CoordinatorAgent()
        check(coord.assessor.device.type == "cuda", "the agents are not on "
                                                    "the card")
        assess = coord.assessor.process_task

        def snapshot_then_assess(task):
            Path(f"{d}/assessed.avi").write_bytes(
                Path(task.output_path).read_bytes())
            return assess(task)

        coord.assessor.process_task = snapshot_then_assess
        t0 = time.perf_counter()
        wf = coord.run_workflow(src, f"{d}/out.avi", assess_quality=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(wf.status == "completed", f"workflow {wf.status}: "
                                        f"{wf.results.get('error')}")
        enhanced = torch.from_numpy(read_video(f"{d}/assessed.avi")).cuda()
        ref = torch.from_numpy(read_video(src)).cuda().float() / 255.0
        enhanced = enhanced.float() / 255.0
        if enhanced.shape[1:3] != ref.shape[1:3]:
            ref = resize(ref, tuple(enhanced.shape[1:3]))
        again = {k: float(v) for k, v in assess_clips(enhanced, ref).items()}
        q = wf.results["quality"]
        diff = {k: q[k] - v for k, v in again.items() if q[k] != v}
        summary = wf.results["summary"]
        print(f"coordinator workflow on the card: {wf.status}, model "
              f"{summary['model_used']}, {summary['frames']} frames, "
              f"{secs:.2f} s wall; escalated: {'escalation' in wf.results}; "
              f"psnr {q['psnr']:.3f} dB, ssim {q['ssim']:.4f}, lpips_proxy "
              f"{q['lpips_proxy']:.5f}, category {q['category']}; metrics "
              f"recomputed on the same output: differences {diff} "
              f"({device_line})")
        check(not diff, f"workflow metrics differ from assess_clips: {diff}")
    return rows


def _held(name: str, y_s, y_1, c_s, want_s, c_1, want_1, secs: float,
          n: int, device_line: str, note: str = "") -> None:
    """Phase 19's checks of one sharded call against the single-device
    model: launches, shape, finiteness and the window tolerances."""
    diff = (y_s.float() - y_1.float()).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    print(f"{name}: launches {_nonzero(c_s)} (expected {_nonzero(want_s)}), "
          f"single-device {_nonzero(c_1)}; vs single-device max_abs "
          f"{mx:.4e} (tol {WINDOW_MAX_ABS}), mean_abs {mean:.4e} (tol "
          f"{WINDOW_MEAN_ABS}); {secs * 1e3:.2f} ms = {n / secs:.2f} "
          f"frames/s{note} ({device_line})")
    check(c_s == want_s, f"{name}: sharded launches {c_s} != {want_s}")
    check(c_1 == want_1, f"{name}: single launches {c_1} != {want_1}")
    check(tuple(y_s.shape) == tuple(y_1.shape)
          and bool(torch.isfinite(y_s.float()).all()),
          f"{name}: output {tuple(y_s.shape)} not finite or not "
          f"{tuple(y_1.shape)}")
    check(mx <= WINDOW_MAX_ABS and mean <= WINDOW_MEAN_ABS,
          f"{name}: the sharded output differs from the single-device model")


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _clip_of(frames) -> torch.Tensor:
    return (torch.from_numpy(np.stack(frames)).cuda().float()
            / 255.0)[None].to(torch.bfloat16)


def _sharded_vs_single(name, fn, single, params, clip, want_s, want_1,
                       device_line):
    """One warm-up call of the sharded ``fn``, then it and the
    single-device ``single`` counted and held to each other; returns the
    sharded call's counts and its peak memory."""
    with torch.inference_mode():
        fn(params, clip)
        torch.cuda.reset_peak_memory_stats()
        y_s, c_s, t_s = _counted(fn, params, clip)
        peak = torch.cuda.max_memory_allocated()
        y_1, c_1, t_1 = _counted(single, params, clip)
    _held(name, y_s, y_1, c_s, want_s, c_1, want_1, t_s, clip.shape[1],
          device_line, f", peak memory {peak / 1e9:.3f} GB; single-device "
                       f"{t_1 * 1e3:.2f} ms")
    return c_s, peak


@phase("19 exact sharded restorers and FSDP")
def sharded_restorers(device_line: str) -> dict:
    """On a one-rank NCCL mesh: the exact T-sharded seedvr2, ditvr (the
    ring at 8 frames, gathered K/V at 2) and fast_mamba_vsr_ssd against the
    single-device models with the bundled weights in bf16; then ditvr at
    the 3b preset with FSDP-sharded parameters (seeded, bf16, a live head)
    against ``ditvr.apply`` on the same tensors."""
    mesh = make_mesh()
    counts = {}
    try:
        check(mesh.device.type == "cuda" and mesh.num_devices == 1,
              f"mesh {mesh.shape} on {mesh.device}")
        time_axis = mesh.axis("time")

        # (a) seedvr2 on one window of 8 of phase 11's clip
        params = cast_params(load_params("seedvr2"), torch.bfloat16,
                             mesh.device)
        want = _only(flash_attention=3)
        counts["seedvr2"], _ = _sharded_vs_single(
            "seedvr2 8 frames", make_exact_sharded_seedvr2(time_axis),
            lambda p, c: seedvr2.apply(p, c), params,
            _clip_of(blocky_clip(16, 180, 320)[:8]), want, want, device_line)

        # (b) ditvr on 8 frames of phase 5's clip (14,400 tokens: the
        # ring, no flash launch) and on 2 (3,600: gathered K/V, the flash
        # kernel in each block)
        params = cast_params(load_params("ditvr"), torch.bfloat16,
                             mesh.device)
        heads = int(MODELS["ditvr"].extra.get("heads", 6))
        frames = dim_clip(16, 180, 320)
        fn = make_exact_sharded_ditvr(time_axis, heads=heads)
        want = _only(flash_attention=len(params["blocks"]))

        def single(p, c):
            return ditvr.apply(p, c, heads=heads)

        counts["ditvr ring"], counts["ditvr ring peak"] = _sharded_vs_single(
            "ditvr 8 frames (ring)", fn, single, params,
            _clip_of(frames[:8]), _only(), want, device_line)
        counts["ditvr"], _ = _sharded_vs_single(
            "ditvr 2 frames (gathered K/V)", fn, single, params,
            _clip_of(frames[:2]), want, want, device_line)

        # (c) fast_mamba_vsr_ssd on phase 14's first 16-frame window
        params = cast_params(load_params("fast_mamba_vsr_ssd"),
                             torch.bfloat16, mesh.device)
        want = _only(ssd_shared=2 * len(params["layers"]))
        counts["fast_mamba_vsr_ssd"], _ = _sharded_vs_single(
            "fast_mamba_vsr_ssd x4 16 frames",
            make_exact_sharded_fmv(time_axis, scale=4),
            lambda p, c: fast_mamba_vsr.apply(p, c, scale=4), params,
            _clip_of(synthetic_clip(30, 180, 320)[:16]), want, want,
            device_line)
        del params
        torch.cuda.empty_cache()
        counts["3b"] = _fsdp_3b(mesh, frames[:8], device_line)
    finally:
        mesh.destroy()
    return counts


def _fsdp_3b(mesh, frames, device_line: str) -> dict:
    """Phase 19 (d): ``make_sharded_ditvr(preset="3b")`` in bf16 on the
    card, the zero-init head given seeded weights; one forward on an
    8-frame 180x320 window (14,400 tokens, 32 flash launches at (1, 24,
    14400, 96)) against ``ditvr.apply`` on the same tensors."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shards, fn = make_sharded_ditvr(mesh, preset="3b", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 19)
    head = shards["head"]["w"]
    shards["head"]["w"] = (torch.randn(head.shape, generator=gen,
                                       device=mesh.device) * 0.02).to(
                                           head.dtype)
    leaves = flatten_params(shards).values()
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    n_params = sum(t.numel() for t in leaves)
    init_peak = torch.cuda.max_memory_allocated()
    cfg = ditvr.SIZE_PRESETS["3b"]
    print(f"ditvr 3b under FSDP (one rank): {n_params / 1e9:.3f} B "
          f"parameters, {nbytes / 1e9:.3f} GB in bf16; drawn on the card in "
          f"{init_s:.2f} s, peak {init_peak / 1e9:.3f} GB")
    clip = _clip_of(frames)
    with torch.inference_mode():
        fn(shards, clip)
        torch.cuda.reset_peak_memory_stats()
        y_s, c_s, t_s = _counted(fn, shards, clip)
        peak = torch.cuda.max_memory_allocated()
        y_1, c_1, t_1 = _counted(
            lambda: ditvr.apply(shards, clip, heads=cfg["heads"]))
    want = _only(flash_attention=cfg["depth"])
    _held("ditvr 3b FSDP 8 frames", y_s, y_1, c_s, want, c_1, want, t_s,
          clip.shape[1], device_line,
          f", peak memory {peak / 1e9:.3f} GB (parameters {nbytes / 1e9:.3f}"
          f" GB); ditvr.apply on the same tensors {t_1 * 1e3:.2f} ms")
    moved = (y_s.float() - clip.float()).abs().mean().item()
    print(f"ditvr 3b: mean |output - input| {moved:.4e} (the live head)")
    check(moved > 1e-4, "the 3b output is its input: the head is not live")
    del shards, y_s, y_1
    torch.cuda.empty_cache()
    return {"counts": c_s, "bytes": nbytes, "params": n_params,
            "peak": peak}


# --- phase 20: the one-port app, warm start and validation ----------------

# launches of one warm-start clip (4 frames of 64x64: one window, one tile
# of each model); seedvr2's may be none when its gate passes the window
WARM_LAUNCHES = {"vsrm": {"ssd_shared": 12, "fused_bidir_ssm": 6},
                 "fast_mamba_vsr": {"fused_bidir_ssm": 8},
                 "ditvr": {"flash_attention": 8},
                 "seedvr2": {"flash_attention": 3},
                 "rvrt": {"window_attention": 4}}
# launches of validate's tiny forwards (fp32, widths 8-32): ditvr's 16
# tokens and seedvr2's 64 a frame stay under the flash kernel's 256 (the
# JAX package's gate), so both run the plain attention
TINY_LAUNCHES = {"fast_mamba_vsr": {"fused_bidir_ssm": 1},
                 "vsrm": {"ssd_shared": 2, "fused_bidir_ssm": 1},
                 "ditvr": {}, "seedvr2": {}, "rvrt": {"window_attention": 1}}
# the vsrm window's spatial SSD runs in chunks of 256 (``bissd_apply``'s),
# the chunk the JAX package's count takes
VSRM_SSD_CHUNK = 256


def _spawn(d: str, tag: str, argv: list[str], env: dict | None = None):
    """``python *argv`` from this checkout, started now, its output (both
    streams) in ``d/<tag>.log``; returns the process and that path."""
    path = Path(d) / f"{tag}.log"
    with open(path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT,
            cwd=Path(__file__).resolve().parent,
            env=None if env is None else {**os.environ, **env})
    return proc, path


def _finish(proc, path: Path, what: str, timeout: int = 600) -> list[str]:
    """Waits for a process of ``_spawn`` (killing it past ``timeout``);
    fails unless it exited 0; returns its output's lines."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at its time limit"
    text = path.read_text()
    check(rc == 0, f"{what} exited {rc}: {text[-3000:]}")
    return text.strip().splitlines()


def _json_of(lines: list[str]) -> dict:
    """The indented JSON report that ends a process's output."""
    start = max(i for i, x in enumerate(lines) if x == "{")
    return json.loads("\n".join(lines[start:]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_port_app(d: str, kind: str, app, device_line: str) -> None:
    """(a) The app (started by the caller with ``_spawn``, on ``port``):
    its UI, /health, and validate --url as a subprocess; stops it."""
    proc, log_path, port = app
    try:
        deadline = time.time() + 300
        while True:
            check(proc.poll() is None, f"the app exited {proc.returncode}: "
                  f"{log_path.read_text()[-3000:]}")
            try:
                if _http(port, "/health")[0] == 200:
                    break
            except (urllib.error.URLError, OSError):
                pass
            check(time.time() < deadline, "the app did not answer /health "
                                          "in 300 s")
            time.sleep(0.5)
        status, ctype, page = _http(port, "/ui")
        check(status == 200 and ctype == "text/html"
              and b"Enhance a video" in page, f"/ui answered {status} "
              f"{ctype}")
        health = json.loads(_http(port, "/health")[2])
        check(f"cuda:0 {kind}" in health["devices"], f"/health {health}")
        t1 = time.perf_counter()
        report = _json_of(_finish(*_spawn(
            d, "validate_ci", ["-m", "video_enhancer_tpu_torch.validate",
                               "--mode", "ci", "--url",
                               f"http://127.0.0.1:{port}", "--data-dir",
                               f"{d}/v"]), "validate --url"))
        val_s = time.perf_counter() - t1
        probes = {k: v["ok"] for k, v in report["server"].items()}
        check(report["status"] == "pass" and len(probes) == 4
              and all(probes.values()), f"validate --url: {report}")
        check("self-test passed" in log_path.read_text(),
              "the app's self-test did not pass")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    print(f"app: self-test passed; /ui {len(page)} B text/html; /health "
          f"devices "
          f"{health['devices']}; validate --mode ci --url: {probes} in "
          f"{val_s:.2f} s as a subprocess; imports {report['imports']} "
          f"({device_line})")


def _warm(hooks) -> dict:
    """(b) warm_start in this process, model by model, launches
    counted."""
    counts_by_model = {}
    for name in sorted(probe_available()):
        hooks.model = f"warm {name}"
        res, counts, secs = _counted(warm_start, [name])
        r = res[name]
        check(r["ok"], f"warm start of {name}: {r}")
        launched = _nonzero(counts)
        want = WARM_LAUNCHES.get(name, {})
        gated = name == "seedvr2" and not launched
        print(f"warm {name}: {r['sec']} s ({secs:.2f} s counted), out "
              f"{r['out_shape']}, launches {launched}"
              + (" (its gate passed the window through)" if gated else ""))
        check(launched == want or gated,
              f"warm {name} launched {launched}, expected {want}")
        counts_by_model[name] = counts
    return counts_by_model


def _warm_process(proc) -> None:
    """(b) ``python -m video_enhancer_tpu_torch.warm_start``: every model
    ready, the kernel library found built."""
    lines = _finish(*proc, "warm_start")
    info = ast.literal_eval(next(x for x in lines if x.startswith(
        "warm kernels: ")).split(": ", 1)[1])
    check(info["prebuilt"], f"the kernel library was not found built: {info}")
    print(f"warm_start as a subprocess: {lines[-1]}; kernels {info}")


def _validate_process(proc) -> None:
    """(c) ``validate --mode full``: passed, the five tiny forwards ok on
    the card."""
    report = _json_of(_finish(*proc, "validate --mode full"))
    structures = report["model_structures"]
    check(report["status"] == "pass" and len(structures) == 5
          and all(r["ok"] for r in structures.values())
          and report["device"]["backend"] == "cuda", f"validate: {report}")
    print(f"validate --mode full as a subprocess: {report['status']}; "
          f"{structures}")


def _live(tree, gen: torch.Generator):
    """``tree`` with each all-zero float tensor drawn from ``gen`` (N(0,
    0.02^2)): the zero-initialised heads would hide the backbones from
    the output."""
    if isinstance(tree, dict):
        return {k: _live(v, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_live(v, gen) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point() and not tree.any():
        return torch.randn(tree.shape, generator=gen) * 0.02
    return tree


def _validation(hooks) -> dict:
    """(c) Each of validate's tiny backbones on the card against the same
    forward on the CPU's plain versions, launches counted: its seeded
    parameters with every zero leaf drawn from the seed, on a seeded clip
    in [0, 1] (validate's own forward, zero heads on a zero clip, gives
    zeros)."""
    counts_by_model = {}
    for name, (init, apply) in tiny_models().items():
        hooks.model = f"tiny {name}"
        gen = torch.Generator().manual_seed(SEED)
        params = _live(init(gen), gen)
        clip = torch.rand(TINY_CLIP, generator=gen)
        with full_fp32(), torch.inference_mode():
            y, counts, secs = _counted(
                apply, cast_params(params, torch.float32, "cuda"),
                clip.cuda())
            ref = apply(params, clip)
        diff = (y.float().cpu() - ref.float()).abs()
        mx, mean = diff.max().item(), diff.mean().item()
        launched = _nonzero(counts)
        print(f"tiny {name} {tuple(y.shape)} fp32, card against the CPU's "
              f"plain versions: max_abs {mx:.3e}, mean_abs {mean:.3e} "
              f"(mean |output - input| on the CPU "
              f"{(ref - _resized(clip, ref)).abs().mean().item():.4f}); "
              f"launches {launched}; {1e3 * secs:.1f} ms")
        check(bool(torch.isfinite(y).all()) and mx <= WINDOW_MAX_ABS
              and mean <= WINDOW_MEAN_ABS, f"tiny {name} differs from the "
                                           f"CPU: {mx}, {mean}")
        check(launched == TINY_LAUNCHES[name],
              f"tiny {name} launched {launched}, expected "
              f"{TINY_LAUNCHES[name]}")
        counts_by_model[name] = counts
    return counts_by_model


def _resized(clip: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``clip`` (B, T, H, W, 3) at ``like``'s size (cubic), to show that an
    output is not just its upscaled input."""
    b, t = clip.shape[:2]
    out = resize(clip.reshape(b * t, *clip.shape[2:]), tuple(like.shape[2:4]))
    return out.reshape(like.shape)


def _accounting_and_timing(device_line: str) -> None:
    """(d) FLOPs recorded in a served vsrm and ditvr window against the
    sums from the shapes; the vsrm window's time per call by the chained
    slope beside its CUDA-event median."""
    handler = build_handler("vsrm")
    frames = synthetic_clip(16, 180, 320)
    first = torch.from_numpy(np.stack(frames[:handler.chunk])).cuda()
    first = first.float() / 255.0
    blocks = len(handler.params["blocks"])
    with accounting() as acc, torch.inference_mode():
        handler.process_clip(first)
    ssd_one = _ssd_cost(torch.bfloat16, VSRM_SSD_CHUNK)[1]
    fused_one = _bissm_cost(torch.bfloat16)[1]
    want = 2 * blocks * ssd_one + blocks * fused_one
    print(f"vsrm window FLOPs recorded {acc[0]:.6e}; from the shapes "
          f"{2 * blocks} x SSD {ssd_one:.6e} + {blocks} x fused SSM "
          f"{fused_one:.6e} = {want:.6e}")
    check(math.isclose(acc[0], want, rel_tol=1e-12),
          f"vsrm window: recorded {acc[0]} != {want}")

    entry = MODELS["ditvr"]
    d_handler = build_handler("ditvr")
    clip = torch.from_numpy(np.stack(dim_clip(entry.window, 180, 320)))
    clip = clip.cuda().float() / 255.0
    with accounting() as d_acc, torch.inference_mode():
        d_handler.process_clip(clip)
    s = FLASH_SHAPE
    flash_one = _flash_cost(torch.bfloat16, s["B"], s["H"], s["L"], s["L"],
                            s["Dh"])[1]
    depth = entry.extra["depth"]
    print(f"ditvr window FLOPs recorded {d_acc[0]:.6e}; from the shapes "
          f"{depth} x flash {flash_one:.6e} = {depth * flash_one:.6e}")
    check(math.isclose(d_acc[0], depth * flash_one, rel_tol=1e-12),
          f"ditvr window: recorded {d_acc[0]} != {depth * flash_one}")

    with torch.inference_mode():
        est = device_time_per_call(handler.process_clip, first, n_small=2,
                                   n_large=8, repeats=3, max_flops=acc[0])
        ev = time_ms(lambda: handler.process_clip(first), warmup=1, iters=5)
    print(f"vsrm window (7 frames of 180x320): device_time_per_call "
          f"{1e3 * est:.3f} ms (slope of chains of 2/5/8), CUDA-event median "
          f"{ev:.3f} ms, ratio {1e3 * est / ev:.3f}; the kernels' recorded "
          f"{acc[0] / 1e9:.3f} GFLOP / slope = "
          f"{acc[0] / est / 1e12:.3f} TFLOP/s = "
          f"{100 * acc[0] / est / H100_BF16_FLOPS:.3f}% of 989 TFLOP/s "
          f"({device_line})")


_POLICY_CODE = (
    "import json, sys, numpy as np, torch\n"
    "from video_enhancer_tpu_torch.analysis import DegradationRouter\n"
    "from video_enhancer_tpu_torch.config import default_policy\n"
    "from video_enhancer_tpu_torch.runtime.registry import probe_available\n"
    "pol = default_policy()\n"
    "plan = DegradationRouter(pol, available_models=probe_available(pol)"
    ").analyze_frames(np.load(sys.argv[1]), fps=24.0, frame_count=16)\n"
    "print(json.dumps({'vsrm_enabled': pol.models['vsrm'].enabled,\n"
    "    'primary': plan['expert_routing']['primary_model'],\n"
    "    'order': plan['processing_order'],\n"
    "    'card': torch.cuda.get_device_name(0)}))\n")


def _policy_spawn(d: str):
    """(e) Starts the router on the card in a process whose $VETPU_POLICY
    is a copy of the policy with vsrm disabled, on a clip that the
    committed policy sends to vsrm (phase 11's sharp clip: phase 4's goes
    to seedvr2, phase 17); returns the process and the clip."""
    frames = np.stack(sharp_clip(16, 180, 320))
    np.save(f"{d}/clip.npy", frames)
    text = DEFAULT_POLICY_PATH.read_text()
    on = "  vsrm:\n    license: apache-2.0\n    enabled: true"
    check(text.count(on) == 1, "vsrm's entry moved in the policy file")
    Path(f"{d}/policy.yaml").write_text(
        text.replace(on, on.replace("true", "false")))
    proc = _spawn(d, "policy", ["-c", _POLICY_CODE, f"{d}/clip.npy"],
                  env={"VETPU_POLICY": f"{d}/policy.yaml"})
    return proc, frames


def _policy_route(spawned, device_line: str) -> None:
    """(e) The committed policy sends the clip to vsrm in this process;
    the process under $VETPU_POLICY sends it elsewhere."""
    proc, frames = spawned
    control = DegradationRouter(
        default_policy(), available_models=probe_available()
    ).analyze_frames(frames, fps=24.0, frame_count=16)
    check(control["expert_routing"]["primary_model"] == "vsrm",
          f"the committed policy routes the sharp clip to "
          f"{control['expert_routing']['primary_model']}")
    plan = json.loads(_finish(*proc, "the $VETPU_POLICY process")[-1])
    print(f"$VETPU_POLICY with vsrm disabled: {plan}; the committed policy: "
          f"primary vsrm, order {control['processing_order']} "
          f"({device_line})")
    check(not plan["vsrm_enabled"] and plan["primary"] != "vsrm",
          f"the policy in $VETPU_POLICY was not honoured: {plan}")


@phase("20 the one-port app, warm start and validation")
def scaffolding(kind: str, device_line: str) -> list:
    """The app, warm start and validation on the card, each kernel call
    at a shape new to this phase held against its plain version, the FLOP
    records and the timing helper, and $VETPU_POLICY; returns the kernel
    rows of the new shapes (printed on a line of their own)."""
    hooks = _EvalHooks()
    with tempfile.TemporaryDirectory() as d:
        # the processes start together and run beside the in-process work;
        # the timing in (d) runs after all of them have ended
        port = _free_port()
        app = (*_spawn(d, "app", [
            "-m", "video_enhancer_tpu_torch.app", "--self-test", "--host",
            "127.0.0.1", "--port", str(port), "--data-dir", f"{d}/app"]),
            port)
        warm_proc = _spawn(d, "warm", ["-m",
                                       "video_enhancer_tpu_torch.warm_start"])
        validate_proc = _spawn(d, "validate", [
            "-m", "video_enhancer_tpu_torch.validate", "--mode", "full",
            "--data-dir", f"{d}/full"])
        policy = _policy_spawn(d)
        try:
            with hooks:
                warm = _warm(hooks)
                tiny = _validation(hooks)
            check(not hooks.plain_on_card,
                  f"plain versions ran on card tensors: "
                  f"{hooks.plain_on_card}")
            _one_port_app(d, kind, app, device_line)
            _warm_process(warm_proc)
            _validate_process(validate_proc)
            _policy_route(policy, device_line)
        finally:
            for proc in (app[0], warm_proc[0], validate_proc[0],
                         policy[0][0]):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        _accounting_and_timing(device_line)
    rows = []
    for (model, key), (fn, args) in sorted(hooks.calls.items()):
        tag, name = model.split()
        row = _eval_kernel_row(name, key, fn, args, tag=tag)
        row["launches"] = (warm if tag == "warm" else tiny)[name][key]
        rows.append(row)
    return rows


# Phase 21: training on the card. fp32 with TF32 off throughout, as JAX
# trains; make_optimizer's defaults (lr 2e-4).
TRAIN_STEPS = 8
TRAIN_LR = 2e-4
# step 1 through the kernels against the plain forms: the loss (relative),
# each gradient leaf (of its own max abs), each updated parameter (absolute:
# Adam's first step moves a weight by about lr x sign(g), and a gradient
# near zero may flip sign on rounding alone)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_PARAM_TOL = 2 * TRAIN_LR
# the eight autograd Functions: their gradients (the plain backward's, on
# the kernel's residuals) against the plain version's own, max abs of the
# max abs
VJP_TOL = 1e-6
# one step of each model: (apply's keywords, the train pair's scale and HR
# crop, the launches of a step, the subtree behind the kernels).
# ditvr restores at scale 1; its crop gives 2 x 16 x 16 = 512 tokens a clip,
# past the 256 from which JAX takes flash
TRAIN_MODELS = {
    "vsrm": (dict(scale=4, heads=4), 4, 128,
             dict(ssd_shared=12, fused_bidir_ssm=6),
             ("blocks", ("spatial_ssm", "temporal_ssm"))),
    "fast_mamba_vsr": (dict(scale=4), 4, 128, dict(fused_bidir_ssm=8),
                       ("layers", ("bimamba",))),
    "ditvr": (dict(heads=3), 1, 64, dict(flash_attention=8),
              ("blocks", ("qkv",))),
    "rvrt": (dict(scale=4), 4, 128, dict(window_attention=4),
             ("blocks", ("qkv", "bias_table"))),
}
TRAIN_APPLY = {"vsrm": vsrm.apply, "fast_mamba_vsr": fast_mamba_vsr.apply,
               "ditvr": ditvr.apply, "rvrt": rvrt.apply}


def _train_batch(scale: int, crop: int) -> dict:
    """The train CLI's defaults (video_enhancer_tpu/train/cli.py:173-175:
    batch 4, clip 4) from the port's demo frames, seeded."""
    frames = make_demo_frames(16, (240, 320), seed=SEED)
    return make_pairs(frames, batch=4, clip_len=4, crop=crop, scale=scale,
                      seed=SEED, compound_p=0.25, wide_p=0.2, chain_p=0)


def _loss_and_grads(apply_fn, params, batch) -> tuple:
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss = vsr_loss(apply_fn(params, batch["lr"]), batch["hr"])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads


def _behind_kernels(params, where) -> list[str]:
    """Dotted keys of the leaves behind the kernels: ``where`` is (the list
    of blocks, the names in each)."""
    blocks, names = where
    return [f"{blocks}.{i}.{name}.{k}" for i, blk in
            enumerate(params[blocks]) for name in names
            for k in flatten_params(blk[name])]


def _step1_kernels_vs_plain(name: str, steps: dict, state, batch) -> dict:
    """Step 1 through the kernels (counted) against step 1 through the plain
    forms on the same card: the loss, every gradient leaf, every updated
    parameter; no leaf behind a kernel with a zero or missing gradient."""
    kw, _, _, want, where = TRAIN_MODELS[name]
    apply = TRAIN_APPLY[name]
    (loss_k, g_k), counts, _ = _counted(
        lambda: _loss_and_grads(lambda p, x: apply(p, x, kernels=True, **kw),
                                state.params, batch))
    loss_p, g_p = _loss_and_grads(
        lambda p, x: apply(p, x, kernels=False, **kw), state.params, batch)
    check(counts == _only(**want), f"{name}: a forward and backward through "
          f"the kernels launched {_nonzero(counts)}, expected {want} (the "
          f"backward none)")
    keys = list(flatten_params(state.params))
    lost = [k for k, a, b in zip(keys, g_k, g_p) if (a is None) != (b is None)]
    check(not lost, f"{name}: leaves with a gradient on one path only "
          f"(kernels vs plain forms): {lost[:4]}")
    none = [k for k, g in zip(keys, g_k) if g is None]
    zero = [k for k, g in zip(keys, g_k)
            if g is not None and not bool(g.abs().max() > 0)]
    behind = set(_behind_kernels(state.params, where))
    check(not (behind & set(none + zero)), f"{name}: leaves behind a kernel "
          f"with no gradient {sorted(behind & set(none))[:4]} or a zero one "
          f"{sorted(behind & set(zero))[:4]}")
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_err = max((a - b).abs().max().item()
                   / max(b.abs().max().item(), 1e-30)
                   for a, b in zip(g_k, g_p) if a is not None)
    s_k, _ = steps[True](state, batch)
    s_p, _ = steps[False](state, batch)
    param_err = max((a - b).abs().max().item() for a, b in
                    zip(tree_leaves(s_k.params), tree_leaves(s_p.params)))
    print(f"{name} step 1, kernels vs plain forms (fp32): loss "
          f"{loss_k.item():.7f} vs {loss_p.item():.7f} (rel {rel_loss:.2e}, "
          f"tol {TRAIN_LOSS_RTOL}); gradients max|d| / max|plain| "
          f"{grad_err:.2e} (tol {TRAIN_GRAD_TOL}) over {len(keys)} leaves, "
          f"{len(behind)} behind the kernels, all nonzero ({len(zero)} zero "
          f"and {len(none)} missing elsewhere); updated parameters max|d| "
          f"{param_err:.2e} (tol {TRAIN_PARAM_TOL}); launches "
          f"{_nonzero(counts)}")
    check(rel_loss <= TRAIN_LOSS_RTOL, f"{name}: step-1 loss {rel_loss}")
    check(grad_err <= TRAIN_GRAD_TOL, f"{name}: step-1 gradients {grad_err}")
    check(param_err <= TRAIN_PARAM_TOL, f"{name}: step-1 params {param_err}")
    return _nonzero(counts)


def _train_steps(name: str, device_line: str):
    """init_state on the bundled weights and the kernels' and the plain
    forms' train steps on a one-rank mesh."""
    kw, scale, crop, _, _ = TRAIN_MODELS[name]
    apply = TRAIN_APPLY[name]
    mesh = local_mesh("cuda")
    opt = make_optimizer()
    steps, shard = {}, None
    for k in (True, False):
        init_state, steps[k], shard = make_train_step(
            functools.partial(lambda p, x, k: apply(p, x, kernels=k, **kw),
                              k=k), opt, mesh)
    # its own parameters, read outside inference mode (the handlers' cached
    # ones cannot be saved for backward)
    check(bundled_weights(name) is not None, f"{name}: no bundled weights")
    state = init_state(load_params(name))
    return steps, state, shard(_train_batch(scale, crop)), init_state


def _step_profile(step, state, batch) -> dict:
    """One step traced by op: the device time of its kernels, and of those
    that start within the device span of each range (``train_step:forward``,
    ``:optimizer``, and each kernel row's plain backward, ``vjp:<plain>``;
    the backward is the rest), beside the spans' own length; the ops that
    take most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    names = ("train_step:", "vjp:")
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e for e in dev if e.name.startswith(names)]
    kern = [e for e in dev if not e.name.startswith(names)]
    busy = sum(k.time_range.elapsed_us() for k in kern) / 1e3
    ranges = {}
    for sp in spans:
        r = ranges.setdefault(sp.name, [0.0, 0.0])
        r[0] += sum(k.time_range.elapsed_us() for k in kern
                    if sp.time_range.start <= k.time_range.start
                    < sp.time_range.end) / 1e3
        r[1] += sp.time_range.elapsed_us() / 1e3
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)
    top = [(a.key[:60], round(a.self_device_time_total / 1e3, 3))
           for a in ops if a.self_device_time_total > 0
           and not a.key.startswith(names)][:8]
    return {"busy_ms": busy, "ranges": ranges, "top": top}


def _train_vsrm(device_line: str, tmp: Path) -> dict:
    """(a) and (d): vsrm x4 at full width, 8 steps on a fixed batch, the
    state saved after step 4 and resumed; the export loaded back."""
    name = "vsrm"
    steps, state0, batch, init_state = _train_steps(name, device_line)
    _, _, _, want, _ = TRAIN_MODELS[name]
    launches = _step1_kernels_vs_plain(name, steps, state0, batch)

    # 8 straight steps, the state saved after the fourth, under
    # deterministic algorithms (an op with none is named by its warning)
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, losses, ms = state0, [], []
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for i in range(TRAIN_STEPS):
                kernels.reset_launch_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, m = steps[True](state, batch)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
                losses.append(m["loss"].item())
                got = _nonzero(dict(kernels.launch_counts))
                check(got == want, f"step {i + 1} launched {got}")
                if i == TRAIN_STEPS // 2 - 1:
                    check(save_checkpoint(tmp / "ckpt", state) == i + 1,
                          "save_checkpoint's step")
            peak = torch.cuda.max_memory_allocated() - base
            fresh = init_state(load_params(name))
            resumed = restore_checkpoint(tmp / "ckpt", fresh)
            check(resumed is not None and int(resumed.step) == 4,
                  "restore_checkpoint: no state at step 4")
            for _ in range(TRAIN_STEPS // 2):
                resumed, _ = steps[True](resumed, batch)
        nondet = sorted({str(w.message).split(" does not have")[0]
                         for w in caught if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
    check(losses[-1] < losses[0], f"vsrm: the loss did not fall: {losses}")
    pairs = [(a, b) for t in ("params", "opt_state") for a, b in zip(
        tree_leaves(getattr(state, t)), tree_leaves(getattr(resumed, t)))]
    resume_err = max((a.float() - b.float()).abs().max().item()
                     for a, b in pairs)
    exact = all(torch.equal(a, b) for a, b in pairs) and \
        int(state.step) == int(resumed.step) == TRAIN_STEPS
    print(f"vsrm x4 train step (dim 64, 6 blocks; batch 4 x 4 frames, LR "
          f"32x32 -> HR 128x128; fp32, deterministic algorithms): losses "
          f"{[round(x, 6) for x in losses]}; ms a step "
          f"{statistics.median(ms[2:]):.2f} "
          f"(median of steps 3-8; all {[round(x, 2) for x in ms]}); peak "
          f"memory of the steps {peak / 1e9:.3f} GB above "
          f"{base / 1e9:.3f} GB held ({device_line})")
    print(f"vsrm resume after step 4: "
          f"{'bit for bit' if exact else 'not exact'}"
          f" (max|d| {resume_err:.3e}); ops without a deterministic form: "
          f"{nondet or 'none'}")
    check(exact or (nondet and resume_err <= 1e-6),
          f"resumed run differs from the straight one by {resume_err}")

    prof = _step_profile(steps[True], state, batch)
    r = prof["ranges"]
    fwd, opt = (r.get(f"train_step:{k}", [0.0, 0.0])
                for k in ("forward", "optimizer"))
    bwd = prof["busy_ms"] - fwd[0] - opt[0]
    ssd_b = r.get("vjp:ssd_shared_plain", [0.0, 0.0])
    fused_b = r.get("vjp:fused_bidir_ssm_plain", [0.0, 0.0])
    print(f"vsrm step traced (device ms of kernels / of the range's span): "
          f"{prof['busy_ms']:.2f} busy = forward {fwd[0]:.2f} / "
          f"{fwd[1]:.2f} + backward {bwd:.2f} + optimizer {opt[0]:.2f} / "
          f"{opt[1]:.2f}; in the backward the plain SSD {ssd_b[0]:.2f} / "
          f"{ssd_b[1]:.2f} ({ssd_b[0] / max(bwd, 1e-9):.3f} of the "
          f"backward's kernel time) and the plain fused SSM {fused_b[0]:.2f} "
          f"/ {fused_b[1]:.2f} ({fused_b[0] / max(bwd, 1e-9):.3f}); top ops "
          f"by device ms {prof['top']}")

    # (d) the export, loaded into a fresh template, applies bit for bit
    path = export_params(tmp / "vsrm_trained.npz", state)
    flat = read_npz(path)
    loaded, matched, skipped = load_into(
        vsrm.init(torch.Generator().manual_seed(1)), params_from_jax(flat))
    check(len(matched) == len(flat) and not skipped,
          f"export: {len(matched)} of {len(flat)} keys taken, {skipped[:4]}")
    loaded = cast_params(loaded, torch.float32, "cuda")
    with torch.no_grad():
        y_e = vsrm.apply(loaded, batch["lr"], scale=4)
        y_s = vsrm.apply(state.params, batch["lr"], scale=4)
    check(torch.equal(y_e, y_s), "the exported parameters apply differently")
    print(f"export: {len(flat)} keys, every one taken by a fresh vsrm.init; "
          f"apply on them equals apply on the trained state bit for bit")
    return {"launches a step": launches, "steps": TRAIN_STEPS,
            "ms": statistics.median(ms[2:]), "peak_gb": peak / 1e9,
            "bwd_share": {"ssd": ssd_b[0] / max(bwd, 1e-9),
                          "fused": fused_b[0] / max(bwd, 1e-9)}}


def _vjp_cases() -> list:
    """(name, counts key, the Function's call, the plain version, inputs):
    phase 3's shapes for rows 1-5, phases 9-10's for rows 6, 8, 10, 11."""
    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s = SCAN_SHAPES["selective_scan_bidir"]
    bidir = _scan_inputs(f32, gen, **s)
    s8 = SCAN_SHAPES["selective_scan_short_nostate"]
    s10 = SHARED_SHAPES[0]
    x10, dtf, Af, Bm, Cm, Df = _scan_inputs(f32, gen, s10["B"], s10["L"],
                                            s10["D"], s10["N"])
    _, dtb, Ab, _, _, Db = _scan_inputs(f32, gen, s10["B"], s10["L"],
                                        s10["D"], s10["N"])
    *fused, rank = _bissm_inputs(f32, gen)
    return [
        ("ssd_shared", "ssd_shared", ssd_shared_kernel, ssd_shared_plain,
         _ssd_inputs(f32, gen)),
        ("ssd_shared reverse", "ssd_shared",
         functools.partial(ssd_shared_kernel, reverse=True),
         functools.partial(ssd_shared_plain, reverse=True),
         _ssd_inputs(f32, gen)),
        ("fused_bidir_ssm", "fused_bidir_ssm",
         functools.partial(fused_bidir_ssm_kernel, dt_rank=rank),
         functools.partial(fused_bidir_ssm_plain, dt_rank=rank), fused),
        ("flash_attention", "flash_attention", flash_attention, attention_ref,
         _flash_inputs(f32, gen, FLASH_SHAPE["B"], FLASH_SHAPE["H"],
                       FLASH_SHAPE["L"], FLASH_SHAPE["L"], FLASH_SHAPE["Dh"])),
        ("window_attention", "window_attention", window_attention,
         window_attention_plain, _window_inputs(f32, gen, **WINDOW_SHAPE)),
        ("selective_scan_bidir", "selective_scan_bidir", selective_scan_bidir,
         selective_scan_bidir_plain, bidir + bidir),
        ("selective_scan_short_nostate", "selective_scan_short_nostate",
         lambda *a: selective_scan_pallas_short(*a, need_state=False)[0],
         lambda *a: selective_scan_plain(*a)[0],
         _scan_inputs(f32, gen, **s8)),
        ("selective_scan_bidir_shared", "selective_scan_bidir_shared",
         functools.partial(selective_scan_bidir_shared, impl="bmajor"),
         selective_scan_bidir_shared_plain,
         (x10, dtf, dtb, Af, Ab, Bm, Cm, Df, Db)),
        ("dwconv_silu", "dwconv_silu", depthwise_conv1d_silu,
         depthwise_conv1d_silu_plain, _dwconv_inputs(f32, gen, 5)),
    ]


def _grads_of(fn, inputs, gys):
    xs = [t.detach().requires_grad_() for t in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    return outs, torch.autograd.grad(outs, xs, gys)


def vjp_checks() -> dict:
    """(c) For one seeded upstream gradient, each Function's gradients (the
    kernel forward) against the plain version's, every input; rows 7 and 9
    raise under grad."""
    out = {}
    for name, key, fn, plain, inputs in _vjp_cases():
        with torch.no_grad():
            shapes = fn(*inputs)
        shapes = shapes if isinstance(shapes, tuple) else (shapes,)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        gys = [torch.randn(o.shape, generator=gen, device="cuda")
               for o in shapes]
        kernels.reset_launch_counts()
        outs, g_k = _grads_of(fn, inputs, gys)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)
        check(all(o.grad_fn is not None for o in outs),
              f"{name}: the kernel's output has no grad_fn")
        check(counts == _only(**{key: 1}), f"{name}: launches {counts}")
        outs_p, g_p = _grads_of(plain, inputs, gys)
        fwd = max(rel_err(a, b)[1] for a, b in zip(outs, outs_p))
        tol = TOL[(key, "float32")]
        err = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                  for a, b in zip(g_k, g_p))
        check(all(a.dtype == t.dtype and a.shape == t.shape
                  for a, t in zip(g_k, inputs)),
              f"{name}: a gradient not in its input's dtype and shape")
        print(f"vjp {name}: the Function's forward (the kernel) vs the plain "
              f"version max|d| / max|plain| {fwd:.2e} (tol {tol}); "
              f"{len(inputs)} gradients {err:.2e} (tol {VJP_TOL}); 1 launch, "
              f"none in the backward")
        check(fwd <= tol, f"{name}: the Function's forward differs by {fwd}")
        check(err <= VJP_TOL, f"{name}: gradients differ by {err}")
        out[name] = err
        del outs, g_k, outs_p, g_p
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s7 = SCAN_SHAPES["selective_scan_short"]
    args = [t.detach().requires_grad_() for t in _scan_inputs(
        torch.float32, gen, 64, s7["L"], s7["D"], s7["N"])]
    h0 = torch.zeros((64, s7["D"], s7["N"]), device="cuda")
    for row, call in ((7, lambda: selective_scan_pallas_short(*args, h0=h0)),
                      (9, lambda: selective_scan_pallas(*args))):
        try:
            call()
        except RuntimeError as e:
            check(f"row {row}" in str(e), f"row {row}: {e}")
        else:
            raise Failure(f"row {row} did not raise under grad")
    print("vjp rows 7 and 9: raise under grad (no VJP in the JAX package)")
    return out


@phase("21 training on the card")
def training(device_line: str) -> dict:
    """(a) vsrm x4 trained 8 steps, step 1 against the plain forms; (b) one
    step each of fast_mamba_vsr, ditvr and rvrt against the plain forms;
    (c) the eight autograd Functions' gradients; (d) checkpoint, resume and
    export; (e) the dry run on a one-rank NCCL mesh."""
    out = {}
    with full_fp32(), tempfile.TemporaryDirectory() as d:
        out["vsrm"] = _train_vsrm(device_line, Path(d))
        for name in ("fast_mamba_vsr", "ditvr", "rvrt"):
            steps, state, batch, _ = _train_steps(name, device_line)
            t0 = time.perf_counter()
            out[name] = _step1_kernels_vs_plain(name, steps, state, batch)
            print(f"{name}: step 1 checked in "
                  f"{time.perf_counter() - t0:.2f} s")
            del steps, state, batch
            torch.cuda.empty_cache()
        out["vjp"] = vjp_checks()
        torch.cuda.empty_cache()
        mesh = make_mesh()
        try:
            run_dryrun(mesh)
        finally:
            mesh.destroy()
    return out


CLI_STEPS, CLI_MORE = 8, 4
CLI_WANT = {"ssd_shared": 12, "fused_bidir_ssm": 6}


def _quiet(fn, argv: list[str]) -> tuple[int, list[str]]:
    """``fn(argv)``'s exit code and the lines it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue().splitlines()


def _cli_run(argv: list[str], per_step: list, device_ms: list) -> list[str]:
    """``train.cli.main(argv)`` with each step's launches and device time
    recorded; returns its output lines."""
    make = train_step_mod.make_train_step

    def counted(*a, **kw):
        init_state, step, shard = make(*a, **kw)

        def run(state, batch):
            kernels.reset_launch_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step(state, batch)
            ev[1].record()
            per_step.append(_nonzero(dict(kernels.launch_counts)))
            device_ms.append(ev)
            return out
        return init_state, run, shard

    train_step_mod.make_train_step = counted
    try:
        rc, lines = _quiet(train_cli.main, argv)
    finally:
        train_step_mod.make_train_step = make
    print("\n".join("  " + line for line in lines))
    check(rc == 0, f"train CLI {argv[:2]} exited {rc}")
    return lines


@phase("22 train CLI")
def train_cli_path(device_line: str) -> dict:
    """Phase 22 (a): vsrm x4 through the train CLI, resumed and exported;
    (b) the three small trainers' mains."""
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        init = (Path(__file__).resolve().parent / "video_enhancer_tpu"
                / "weights" / "vsrm_4x.npz")
        argv = ["--model", "vsrm", "--scale", "4", "--init-npz", str(init),
                "--through-calibration", "vsrm", "--batch", "4",
                "--clip-len", "4", "--crop", "128", "--log-every", "4",
                "--ckpt-dir", f"{d}/ck"]
        per_step, events = [], []
        first = _cli_run(argv + ["--steps", str(CLI_STEPS)], per_step,
                         events)
        check(any(line.startswith("warm-started") for line in first),
              "the CLI did not warm-start from vsrm_4x.npz")
        more = _cli_run(argv + ["--steps", str(CLI_STEPS + CLI_MORE),
                                "--export", f"{d}/vsrm.npz"], per_step,
                        events)
        check(f"resumed from step {CLI_STEPS}" in more,
              "the second run did not resume from the checkpoint")
        check(len(per_step) == CLI_STEPS + CLI_MORE,
              f"{len(per_step)} steps ran")
        check(all(c == CLI_WANT for c in per_step),
              f"launches a step {per_step} != {CLI_WANT}")
        torch.cuda.synchronize()
        dev_ms = [a.elapsed_time(b) for a, b in events]
        timings = [json.loads(line)["timing"] for line in first + more
                   if line.startswith('{"timing"')]
        losses = [json.loads(line)["loss"] for line in first + more
                  if line.startswith('{"step"')]
        check(all(math.isfinite(v) for v in losses), f"losses {losses}")

        # the export through the port's weight loading, one window
        params = try_load_params(f"{d}/vsrm.npz", vsrm.init(
            torch.Generator().manual_seed(1), dim=64, num_blocks=6, scale=4))
        check(params is not None, "the export did not load")
        saved = torch.load(Path(d) / "ck" / str(CLI_STEPS + CLI_MORE)
                           / "state.pt", map_location="cpu",
                           weights_only=True)["params"]
        flat_e, flat_s = flatten_params(params), flatten_params(saved)
        check(flat_e.keys() == flat_s.keys() and all(
            torch.equal(flat_e[k].cpu(), flat_s[k].cpu()) for k in flat_e),
            "the export differs from the final checkpoint")
        clip = torch.from_numpy(np.stack(synthetic_clip(8, 64, 96))[None]
                                ).cuda().float() / 255.0
        with torch.inference_mode():
            y = vsrm.apply(cast_params(params, torch.float32, "cuda"), clip,
                           scale=4)
        check(tuple(y.shape) == (1, 8, 256, 384, 3)
              and bool(torch.isfinite(y).all()), "the export's window")
        a_secs = time.perf_counter() - t0
        data_s = [t["data_sec_per_batch"] for t in timings]
        step_s = [t["sec_per_step"] for t in timings]
        print(f"train CLI vsrm x4 ({device_line}): {len(per_step)} steps, "
              f"{per_step[0]} launches a step; s/step {step_s}; data "
              f"thread s/batch {data_s}; wait s/step "
              f"{[t['wait_sec_per_step'] for t in timings]}; device ms/step "
              f"median {statistics.median(dev_ms[2:]):.1f} "
              f"({', '.join(f'{v:.1f}' for v in dev_ms)}); losses {losses}; "
              f"(a) {a_secs:.1f} s")

        # (b) the three small trainers on the card
        t1 = time.perf_counter()
        held = {}
        for name, fn, argv_b in (
                ("faces", faces.main, ["--steps", "4"]),
                ("face_detector", face_detector.main,
                 ["--steps", "4", "--eval-n", "16"]),
                ("lpips", lpips.main, ["--steps", "4"])):
            rc, lines = _quiet(fn, argv_b + ["--export", f"{d}/{name}.npz"])
            check(rc == 0 and (Path(d) / f"{name}.npz").stat().st_size > 0,
                  f"{name}.main")
            held[name] = [line for line in lines if "held-out" in line]
            check(len(held[name]) == 1, f"{name}: {lines}")
            print(f"{name} ({device_line}): {held[name][0]}")
        print(f"phase 22: (a) {a_secs:.1f} s, (b) "
              f"{time.perf_counter() - t1:.1f} s")
    return {"vsrm": per_step[0], "device_ms": dev_ms, "timing": timings,
            "held": held}

def _attentive(handler) -> bool:
    return all("qkv" in blk["spatial_ssm"] for blk in handler.params["blocks"])


def _served_qkv(handler, clip: torch.Tensor) -> tuple:
    """q, k, v of the first flash launch of one served window of
    ``clip``: the views the mixer hands the kernel (strided column slices
    of its qkv projection), kept alive."""
    seen = []
    real = attn_mod.flash_attention

    def spy(q, k, v, scale=None):
        if not seen:
            seen.append((q, k, v))
        return real(q, k, v, scale=scale)

    attn_mod.flash_attention = spy
    try:
        handler.process_clip(clip)
    finally:
        attn_mod.flash_attention = real
    check(len(seen) == 1, "the served window launched no flash kernel")
    return seen[0]


def _plain_by_query_block(q, k, v):
    """attention_ref over blocks of ``ATTENTIVE_QUERY_BLOCK`` queries, one
    (b, h) at a time: yields (b, h, first query, output)."""
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            kk, vv = k[b:b + 1, h:h + 1], v[b:b + 1, h:h + 1]
            for s0 in range(0, q.shape[2], ATTENTIVE_QUERY_BLOCK):
                qq = q[b:b + 1, h:h + 1, s0:s0 + ATTENTIVE_QUERY_BLOCK]
                yield b, h, s0, attention_ref(qq, kk, vv)


def _held_by_query_block(got, q, k, v) -> dict:
    """The kernel's output ``got`` against the plain form in blocks of
    queries: the largest error and its share of max|plain| (``rel``), the
    same share for the uniform answer mean(v) over the keys, which a kernel
    that lost the logits' weighting would give (``uniform_rel``), and the
    logits' spread across keys (their std, averaged over the first block's
    queries)."""
    err = ref_max = uniform = 0.0
    mean_v = v.float().mean(dim=2, keepdim=True)
    for b, h, s0, ref in _plain_by_query_block(q, k, v):
        ref = ref.float()
        blk = got[b:b + 1, h:h + 1, s0:s0 + ref.shape[2]].float()
        err = max(err, (blk - ref).abs().max().item())
        uniform = max(uniform,
                      (mean_v[b:b + 1, h:h + 1] - ref).abs().max().item())
        ref_max = max(ref_max, ref.abs().max().item())
    q0 = q[0, 0, :ATTENTIVE_QUERY_BLOCK].float()
    logits = q0 @ k[0, 0].float().T * q.shape[-1] ** -0.5
    ref_max = max(ref_max, 1e-30)
    return dict(err=err, rel=err / ref_max, uniform_rel=uniform / ref_max,
                logit_std=logits.std(dim=-1).mean().item())


def _randn_strided(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """Seeded unit normals of ``t``'s shape, dtype and strides."""
    out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                              device=t.device)
    return out.copy_(torch.randn(t.shape, generator=g, device=t.device))


def _flash_attentive(q, k, v, device_line: str) -> dict:
    """Row 4 at the attentive mixer's served q, k, v against the plain
    form in blocks of queries, and again at that shape and those strides on
    seeded unit-normal q, k, v, whose logits spread far enough that the
    uniform answer fails the limit; its time beside the plain blocks',
    SDPA's, the bound and the exps' floor."""
    tol = TOL[("flash_attention", "bfloat16")]
    got = flash_attention(q, k, v)
    check(bool(torch.isfinite(got.float()).all()),
          "flash_attention:attentive: non-finite")
    served = _held_by_query_block(got, q, k, v)
    del got
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    qu, ku, vu = (_randn_strided(t, g) for t in (q, k, v))
    got = flash_attention(qu, ku, vu)
    check(bool(torch.isfinite(got.float()).all()),
          "flash_attention:attentive, unit normals: non-finite")
    unit = _held_by_query_block(got, qu, ku, vu)
    del got, qu, ku, vu
    ms = time_ms(lambda: flash_attention(q, k, v))
    dev = device_ms(lambda: flash_attention(q, k, v), ("flash",), iters=3)
    plain_ms = time_ms(lambda: [o for *_, o in _plain_by_query_block(
        q, k, v)], warmup=0, iters=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v))
    B, H, L, Dh = q.shape
    nbytes, flops = _flash_cost(q.dtype, B=B, H=H, Lq=L, Lk=L, Dh=Dh)
    bound = max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3
    for name, held in (("served q, k, v", served),
                       ("seeded unit normals", unit)):
        print(f"flash_attention:attentive {tuple(q.shape)} bf16, strides "
              f"{q.stride()}, {name} ({device_line}): max_abs_err "
              f"{held['err']:.3e} rel {held['rel']:.3e} (tol {tol:g}; plain "
              f"in blocks of {ATTENTIVE_QUERY_BLOCK} queries); logits' std "
              f"across keys {held['logit_std']:.4f}; the uniform answer "
              f"mean(v) would be off by rel {held['uniform_rel']:.3e}")
    print(f"flash_attention:attentive {tuple(q.shape)} bf16 "
          f"({device_line}): kernel {ms:.4f} ms (device {dev}), "
          f"{flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.1f} ms; "
          f"scaled_dot_product_attention {lib_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({flops / 1e12:.3f} TFLOP), exps' floor "
          f"{ex2_floor_ms(B * H * L * L):.4f} ms")
    check(served["rel"] <= tol,
          f"flash_attention:attentive: rel {served['rel']} > {tol}")
    check(unit["rel"] <= tol, f"flash_attention:attentive, unit normals: "
          f"rel {unit['rel']} > {tol}")
    check(unit["uniform_rel"] > tol, "flash_attention:attentive: the unit "
          f"normals' check would pass the uniform answer "
          f"(rel {unit['uniform_rel']})")
    return dict(max_abs_err=max(served["err"], unit["err"]), ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                flops=flops, peak=H100_BF16_FLOPS)


def _attentive_vsrm(device_line: str, rec: dict) -> int:
    """Phase 23 (a); returns the flash launches of the served run."""
    os.environ["VETPU_PREFERRED_BACKBONE"] = "mambairv2"
    try:
        handler = build_handler("vsrm")
    finally:
        os.environ.pop("VETPU_PREFERRED_BACKBONE")
    check(handler.device.type == "cuda" and _attentive(handler),
          "the variable did not select the attentive mixer")
    blocks = len(handler.params["blocks"])
    n, h, w = ATTENTIVE_FRAMES, 180, 320
    frames = synthetic_clip(n, h, w)
    stride = handler.chunk - handler.overlap
    windows = sum(1 for _ in iter_windows(frames, handler.chunk, stride))
    first = torch.from_numpy(np.stack(frames[:handler.chunk])).cuda()
    first = first.float() / 255.0
    handler.process_clip(first)                       # warm-up, not counted
    out, counts, secs = _counted(
        lambda: list(handler.enhance_frames(iter(frames))))
    check(len(out) == n and all(f.shape == (4 * h, 4 * w, 3) for f in out),
          "attentive vsrm: bad frames")
    want = _only(flash_attention=blocks * windows,
                 fused_bidir_ssm=blocks * windows)
    print(f"attentive vsrm x4 {h}x{w} ({device_line}): {n} frames, "
          f"{windows} windows in {secs:.3f} s, {n / secs:.2f} frames/s, "
          f"{1000 * secs / windows:.1f} ms/window; launches "
          f"{_nonzero(counts)}; expected {_nonzero(want)}")
    check(counts == want, f"launch counts {counts} != {want}")
    q, k, v = _served_qkv(handler, first)
    s = FLASH_ATTENTIVE_SHAPE
    check(tuple(q.shape) == (s["B"], s["H"], s["L"], s["Dh"])
          and q.dtype == torch.bfloat16, f"served q {tuple(q.shape)}")
    rec["flash_attention:attentive"] = _flash_attentive(q, k, v, device_line)
    del q, k, v
    torch.cuda.empty_cache()

    # the model with a seeded head and offset, kernels against plain forms
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    params = dict(handler.params)
    for name in ("head", "offset"):
        wt = handler.params[name]["w"]
        params[name] = {
            "w": (torch.randn(wt.shape, generator=g, device="cuda")
                  * (0.1 / math.sqrt(wt[0].numel()))).to(wt.dtype),
            "b": (torch.randn(wt.shape[:1], generator=g, device="cuda")
                  * 0.01).to(wt.dtype)}
    small = (torch.from_numpy(np.stack(synthetic_clip(7, 64, 96))).cuda()
             .float()[None] / 255.0).to(handler.dtype)
    y_k, c_k, _ = _counted(lambda: vsrm.apply(params, small, scale=4,
                                               mixer="attentive"))
    y_p = vsrm.apply(params, small, scale=4, mixer="attentive",
                     kernels=False)
    y_0 = vsrm.apply(handler.params, small, scale=4, mixer="attentive")
    check(c_k == _only(flash_attention=blocks, fused_bidir_ssm=blocks),
          f"64x96 window: launches {c_k}")
    diff = (y_k.float() - y_p.float()).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    moved = (y_k.float() - y_0.float()).abs().max().item()
    print(f"attentive vsrm 64x96, seeded head, kernels vs plain (bf16): "
          f"max_abs {mx:.4e} (tol {WINDOW_MAX_ABS}), mean_abs {mean:.4e} "
          f"(tol {WINDOW_MEAN_ABS}); the head moves the output by "
          f"{moved:.3f}")
    check(mx <= WINDOW_MAX_ABS and mean <= WINDOW_MEAN_ABS,
          "the attentive window differs from the plain forms")
    check(moved > 1e-2, "the seeded head does not reach the frame")

    # the variable cleared: the default vsrm again
    default = build_handler("vsrm")
    _, c_d, _ = _counted(lambda: default.process_clip(first))
    check(default is not handler and not _attentive(default)
          and c_d == _only(ssd_shared=2 * blocks, fused_bidir_ssm=blocks),
          f"the default vsrm after clearing the variable: {c_d}")
    print(f"variable cleared: the default vsrm, launches {_nonzero(c_d)}")
    return counts["flash_attention"]


def _mamba2_layers(device_line: str, rec: dict) -> int:
    """Phase 23 (b); returns the SSD launches of one ``bimamba2`` call."""
    s = SSD_MAMBA2_SHAPE
    dtype = torch.bfloat16
    params = cast_params(bimamba2_init(torch.Generator().manual_seed(SEED),
                                       64), dtype, "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    x = torch.randn((s["b"], s["L"], 64), generator=g, device="cuda").to(
        dtype)
    y, counts, _ = _counted(lambda: bimamba2_apply(params, x))
    y_p = bimamba2_apply(params, x, use_kernel=False)
    err, rel = rel_err(y, y_p)
    tol = TOL[("ssd_shared", "bfloat16")]
    layer_ms = time_ms(lambda: bimamba2_apply(params, x))
    print(f"bimamba2 dim 64 over {s['b']} rasters of {s['L']} "
          f"({device_line}): launches {_nonzero(counts)}; vs plain "
          f"max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}); "
          f"{layer_ms:.3f} ms a call")
    check(counts == _only(ssd_shared=2), f"bimamba2: launches {counts}")
    check(bool(torch.isfinite(y.float()).all()) and rel <= tol,
          f"bimamba2: rel {rel} > {tol}")
    del y, y_p, x

    Q = kernels.library().vetk_ssd_chunk()
    args = _ssd_inputs(dtype, g, s)
    plan = _ssd_plan(*args[0].shape, args[-1].shape[-1], dtype,
                     kernels.sm_count(args[0].device))
    nbytes, flops = _ssd_cost(dtype, Q, s)
    bound = max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3
    for reverse in (False, True):
        got = ssd_shared_kernel(*args, reverse=reverse)
        ref = ssd_shared_plain(*args, reverse=reverse)
        err, rel = rel_err(got, ref)
        d = "reverse" if reverse else "forward"
        ms = time_ms(lambda: ssd_shared_kernel(*args, reverse=reverse))
        plain_ms = time_ms(lambda: ssd_shared_plain(*args, reverse=reverse),
                           warmup=1, iters=3)
        print(f"ssd_shared:mamba2 {s} {d} bf16: max_abs_err {err:.3e} rel "
              f"{rel:.3e} (tol {tol:g}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} "
              f"MB, {flops / 1e9:.2f} GFLOP); plan {plan['route']}, grid "
              f"{plan['grid']}")
        check(bool(torch.isfinite(got.float()).all()) and rel <= tol,
              f"ssd_shared:mamba2 {d}: rel {rel} > {tol}")
        if not reverse:
            rec["ssd_shared:mamba2"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                flops=flops, peak=H100_BF16_FLOPS)
        del got, ref
    del args
    torch.cuda.empty_cache()
    return counts["ssd_shared"]


def _last_on_card(device_line: str) -> None:
    """Phase 23 (c): FramePipeline on the card; the deblur nets and the
    lanczos and area resizes against the CPU."""
    frames = synthetic_clip(ATTENTIVE_FRAMES, 180, 320)
    with tempfile.TemporaryDirectory() as d:
        path = write_video(f"{d}/clip.avi", np.stack(frames))
        t0 = time.perf_counter()
        items = list(FramePipeline(path, window=7, stride=3))
        secs = time.perf_counter() - t0
    check([(i["start"], i["valid"]) for i in items]
          == [(0, 7), (3, 7), (6, 4)], "FramePipeline: windows")
    for it in items:
        f = it["frames"]
        want = np.stack([frames[min(j, len(frames) - 1)] for j in range(
            it["start"], it["start"] + 7)]).astype(np.float32) / 255.0
        check(f.device.type == "cuda" and f.dtype == torch.float32
              and torch.equal(f.cpu(), torch.from_numpy(want)),
              "FramePipeline: a window differs from the frames / 255")
    print(f"FramePipeline over a 10-frame 180x320 .avi: 3 windows on "
          f"{items[0]['frames'].device} in {secs:.3f} s")
    clip = torch.from_numpy(np.stack(frames[:7])).float() / 255.0
    gen = torch.Generator().manual_seed(SEED)
    with full_fp32():
        for name in ("bsstnet", "vddiff"):
            p = getattr(deblur, f"{name}_init")(gen)
            p["c3"]["w"] = torch.randn(p["c3"]["w"].shape, generator=gen) * 0.01
            fn = getattr(deblur, f"{name}_apply")
            want = fn(p, clip)
            pc, xc = cast_params(p, torch.float32, "cuda"), clip.cuda()
            got = fn(pc, xc)
            err = (got.cpu() - want).abs().max().item()
            ms = time_ms(lambda: fn(pc, xc))
            print(f"{name} on 7 frames of 180x320 fp32 ({device_line}): "
                  f"{ms:.3f} ms; card vs CPU max_abs {err:.3e} (tol "
                  f"{DEVICE_FP32_MAX_ABS:g}); the residual "
                  f"{(want - clip).abs().max().item():.3f}")
            check(err <= DEVICE_FP32_MAX_ABS, f"{name}: card vs CPU {err}")
        up = resize_video(clip, (720, 1280), method="lanczos")
        for method, x, hw in (("lanczos", clip, (720, 1280)),
                              ("area", up, (180, 320))):
            want = resize_video(x, hw, method=method)
            xc = x.cuda()
            got = resize_video(xc, hw, method=method)
            err = (got.cpu() - want).abs().max().item()
            ms = time_ms(lambda: resize_video(xc, hw, method=method))
            ms16 = time_ms(lambda: resize_video(xc.bfloat16(), hw,
                                                method=method))
            print(f"resize {method} {tuple(x.shape[1:3])} -> {hw} on 7 "
                  f"frames ({device_line}): fp32 {ms:.3f} ms, bf16 "
                  f"{ms16:.3f} ms; card vs CPU (fp32) max_abs {err:.3e} "
                  f"(tol {DEVICE_FP32_MAX_ABS:g})")
            check(err <= DEVICE_FP32_MAX_ABS, f"resize {method}: {err}")


@phase("23 attentive vsrm and the last library layers")
def attentive_and_library(device_line: str) -> dict:
    """(a) the attentive vsrm served, row 4 at its shape; (b) bimamba2 and
    the SSD at its shape; (c) FramePipeline, deblur and resize."""
    rec = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        flash = _attentive_vsrm(device_line, rec)
        t1 = time.perf_counter()
        ssd = _mamba2_layers(device_line, rec)
        t2 = time.perf_counter()
        _last_on_card(device_line)
    print(f"phase 23: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{time.perf_counter() - t2:.1f} s")
    return {"rec": rec, "counts": {"flash_attention:attentive": flash,
                                   "ssd_shared:mamba2": ssd}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card",
              file=sys.stderr)
        return 1
    # cuBLAS reads its workspace size once, at its first call, so this is
    # set before any work on the card; torch's deterministic mode (phase
    # 21) wants it fixed. 32 MiB, torch's own default on sm_90, so that
    # phases 1-20 see the same workspace as without it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    eval_rows = measured_quality(f"{env['kind']}, {env['smi']}")
    restorers = sharded_restorers(f"{env['kind']}, {env['smi']}")
    scaffold_rows = scaffolding(env["kind"], f"{env['kind']}, {env['smi']}")
    trained = training(f"{env['kind']}, {env['smi']}")
    cli_run = train_cli_path(f"{env['kind']}, {env['smi']}")
    last = attentive_and_library(f"{env['kind']}, {env['smi']}")
    rec.update(last["rec"])
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
              "ssd_shared:b 368640": fmv_ssd["wide_counts"]["ssd_shared"],
              # the 3b head width: phase 19 (d)
              "flash_attention:3b":
                  restorers["3b"]["counts"]["flash_attention"],
              # phase 23: the attentive vsrm's served run, one bimamba2 call
              **last["counts"]}
    # phase 20's kernel calls at the shapes new to it, on their own line
    print("phase 20 kernels: " + json.dumps(scaffold_rows))
    # phase 21's launches a train step, by model, on their own line
    print("phase 21 launches: " + json.dumps(
        {name: trained[name] for name in TRAIN_MODELS}))
    # phase 22's launches a train CLI step (vsrm x4), on their own line
    print("phase 22 launches: " + json.dumps({"vsrm": cli_run["vsrm"]}))
    print(json.dumps({"kernels": kernel_record(rec, counts) + eval_rows}))
    print(env["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["kind"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
