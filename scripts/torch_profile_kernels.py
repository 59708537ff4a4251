#!/usr/bin/env python3
"""The redesigned kernels of the PyTorch/CUDA port at the paths' shapes:
flash attention (TPU kernel row 4), the fused bidirectional SSM (row 3),
the SSD chunked scan (rows 1-2), the short scan with and without state
(rows 7-8), the long scan (row 9), window attention (row 5), the
depthwise conv + SiLU (row 11), the bidirectional scan (row 6) and the
shared bidirectional scan (row 10), for an A/B of two checkouts in one
call.

    python3 scripts/torch_profile_kernels.py [--root DIR] [--tag NAME]
        [--only flash,fused,ssd,short,long,window,conv,bidir,shared,blocks]

Imports ``chip_smoke`` and ``video_enhancer_tpu_torch`` from ``--root``
(this checkout by default), builds the kernels with ``ptxas -v`` and
prints the registers, shared memory and spills of these sources' kernels.
Then each case: the kernel against its plain version (max |kernel -
plain| / max |plain|, held to ``chip_smoke.TOL``), and the median
CUDA-event time of 10 runs after 3 warm-ups; beside flash at ditvr's and
seedvr2's shapes, ``scaled_dot_product_attention`` on the same inputs,
and the device time of both (``torch.profiler``, all of a call's
kernels). Cases: flash in bf16 at ditvr's shape (B 2, H 3, L 10080, Dh
128, views of one qkv projection), at seedvr2's (B*T 8, H 1, L 3600, Dh
128) and at ragged lengths; the fused SSM in fp32 and bf16 at
vsrm's (57600, 7, 128, N 4) and fast_mamba_vsr's (57600, 16, 96, N 8)
shapes; the SSD forward and reverse in bf16 at vsrm's shape (b 7, L
57600, H 2, P 64, N 16, column slices of one conv output); rows 7 and 8
at the sharded fast_mamba_vsr's (57600, 16, 96, N 8, h0) and the
per-pixel (57600, 7, 128, N 16) shapes in bf16 (row 8 with its route,
bound and exps' floor), and row 7 at D 95 and on x and dt sliced 3 columns
in (operands the tile kernel leaves to the walking kernel); row 9 in bf16 and fp32 at one window's rasters (B 7, L
57600, D 128, N 16, h0 in), y and h_last against ``selective_scan_assoc``;
row 5 in bf16 at rvrt's shape (nW 3680, H 4, N 128, Dh 16, views of one
qkv projection) against ``window_attention_plain``, beside
``scaled_dot_product_attention`` with the bias as a mask; row 11 at vsrm's
strided in_proj slice (7, 57600, 160, rows of 290) with K 5 and 4 in bf16
and K 5 in fp32, beside ``F.conv1d(groups=C)`` then ``F.silu``; row 6 at
vsrm's composed bissm shape (57600, 7, 128, N 4) with u, B and C shared by
the two streams (bf16 and fp32) and with separate streams, and at the
per-pixel bimamba's (57600, 7, 128, N 16), separate streams; row 10
(``impl="bmajor"``) in bf16 at vsrm's composed shape (57600, 7, 128, N 4)
and fast_mamba_vsr's (57600, 16, 96, N 8), B and C column slices of one
projection, beside ``impl="bidir"`` (row 6 and a sum) on the same inputs.
Beside each SSD, scan, window, conv and bidirectional time, the device
time a call of each kernel it launches, from ``torch.profiler`` (each
kernel under its own name), and for rows 11, 6, 8 and 10 the bound (bytes
at 3.35 TB/s; rows 8 and 10 the larger of that and the fp32 operations at
67 TFLOP/s) and, where the checkout has its plan, the route; for rows 8
and 10 also the exps' floor (16 ex2 an SM a clock at the card's highest SM
clock). ``blocks`` (checkouts that have row 10's plan): rows 8 and 10 at
their served shapes with the sequences a block overridden, device ms over
20 calls and the error: row 8 with 0 (the walking kernel), 1 and 2, row
10 with 1, 2 and 4 at vsrm's shape and 2 and 4 at fast_mamba_vsr's, beside
``impl="bidir"``; a copy of the port with one kernel changed, under the
git-ignored ``build/``, times the same way, so variants of one design
compare in one call. The last line is one JSON object: the tag, the card,
each case's ms and error.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
ap.add_argument("--tag", default="")
ap.add_argument("--only",
                default="flash,fused,ssd,short,long,window,conv,bidir,shared,"
                "blocks")
args = ap.parse_args()
ONLY = set(args.only.split(","))
sys.path.insert(0, str(Path(args.root).resolve()))

import chip_smoke  # noqa: E402
from video_enhancer_tpu_torch import kernels  # noqa: E402
from video_enhancer_tpu_torch.ops.attention import (  # noqa: E402
    attention_ref, flash_attention, window_attention, window_attention_plain)
from video_enhancer_tpu_torch.ops import conv as conv_ops  # noqa: E402
from video_enhancer_tpu_torch.ops import scan as scan_ops  # noqa: E402
from video_enhancer_tpu_torch.ops import ssd as ssd_ops  # noqa: E402
from video_enhancer_tpu_torch.ops.scan import (  # noqa: E402
    fused_bidir_ssm_kernel, fused_bidir_ssm_plain)

SOURCES = {"flash": "flash", "fused_bissm": "fused", "ssd_": "ssd",
           "scan_short": "short", "scan_chunk": "long",
           "scan_state_pass": "long", "window_attn": "window",
           "dwconv_silu": "conv", "scan_bidir_kernel": "bidir",
           "scan_bidir_tile": "bidir", "scan_bidir_sum": "shared",
           "scan_bidir_shared": "shared"}

FLASH_CASES = [dict(B=2, H=3, Lq=10080, Lk=10080, Dh=128),
               dict(B=8, H=1, Lq=3600, Lk=3600, Dh=128),
               dict(B=2, H=3, Lq=300, Lk=1000, Dh=128),
               dict(B=2, H=3, Lq=129, Lk=1000, Dh=48)]
FUSED_CASES = [("vsrm", chip_smoke.BISSM_SHAPE),
               ("fast_mamba_vsr", chip_smoke.BISSM_FMV_SHAPE)]


def device_ms(fn, keys, iters: int = 10) -> dict:
    """Device time a call of each kernel whose name holds one of ``keys``,
    from ``torch.profiler`` (CUPTI), over ``iters`` calls after one, and
    their sum (its own copy of ``chip_smoke.device_ms``, so that it times
    checkouts whose ``chip_smoke`` has none)."""
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
            out[name] = out.get(name, 0.0) + t / 1e3 / iters
    out["sum"] = sum(out.values())
    return out


def ex2_floor_ms(n: float) -> float:
    """The least time ``n`` ex2 take: 16 an SM a clock at the card's
    highest SM clock (nvidia-smi)."""
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n / (16 * sms * clock) * 1e3


def scan_bound_ms(nbytes: float, flops: float) -> float:
    """The larger of the bytes at 3.35 TB/s and the fp32 operations at 67
    TFLOP/s, in ms."""
    return max(nbytes / chip_smoke.H100_BYTES_PER_S,
               flops / chip_smoke.H100_FP32_FLOPS) * 1e3


def ssd_cases(out: dict) -> bool:
    """The SSD at vsrm's shape in bf16, forward and reverse, with the
    device time of each of a call's launches."""
    ok = True
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    a = chip_smoke._ssd_inputs(torch.bfloat16, gen)
    tol = chip_smoke.TOL[("ssd_shared", "bfloat16")]
    for reverse in (False, True):
        got = ssd_ops.ssd_shared_kernel(*a, reverse=reverse)
        ref = ssd_ops.ssd_shared_plain(*a, reverse=reverse)
        torch.cuda.synchronize()
        err, rel = chip_smoke.rel_err(got, ref)
        ms = chip_smoke.time_ms(
            lambda: ssd_ops.ssd_shared_kernel(*a, reverse=reverse))
        good = rel <= tol and bool(torch.isfinite(got.float()).all())
        ok &= good
        key = f"ssd vsrm bf16 {'reverse' if reverse else 'forward'}"
        out[key] = {"ms": ms, "rel": rel, "max_abs_err": err,
                    "device": device_ms(
                        lambda: ssd_ops.ssd_shared_kernel(*a, reverse=reverse),
                        ("ssd_",))}
        print(f"{key}: {out[key]} {'ok' if good else 'FAILED'}", flush=True)
        del got, ref
    return ok


def short_cases(out: dict) -> bool:
    """Rows 7 (h0 in, h_last out) and 8 at their paths' shapes in bf16;
    row 7 also at D 95 and with x and dt column slices 3 columns in."""
    ok = True
    tol = 1e-2
    fmv = chip_smoke.SCAN_SHAPES["selective_scan_short"]
    cases = [("selective_scan_short", True, fmv, 0),
             ("selective_scan_short_nostate", False,
              chip_smoke.SCAN_SHAPES["selective_scan_short_nostate"], 0),
             ("selective_scan_short D 95", True, dict(fmv, D=95), 0),
             ("selective_scan_short offset 3", True, fmv, 3)]
    for key, state, s, off in cases:
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 7)
        x, dt, A, Bm, Cm, Dv = chip_smoke._scan_inputs(
            torch.bfloat16, gen, **dict(s, D=s["D"] + off))
        x, dt, A, Dv = x[..., off:], dt[..., off:], A[off:], Dv[off:]
        h0 = (torch.randn((s["B"], s["D"], s["N"]), generator=gen,
                          device="cuda") if state else None)
        args_ = (x, dt, A, Bm, Cm, Dv)
        y, h = scan_ops.selective_scan_pallas_short(*args_, h0=h0,
                                                    need_state=state)
        y_p, h_p = scan_ops.selective_scan_plain(*args_, h0=h0)
        torch.cuda.synchronize()
        rel = max(chip_smoke.rel_err(y, y_p)[1],
                  chip_smoke.rel_err(h, h_p)[1] if state else 0.0)
        good = rel <= tol and bool(torch.isfinite(y.float()).all())
        ok &= good
        rec = {"ms": chip_smoke.time_ms(
            lambda: scan_ops.selective_scan_pallas_short(
                *args_, h0=h0, need_state=state)), "rel": rel}
        rec["device"] = device_ms(
            lambda: scan_ops.selective_scan_pallas_short(
                *args_, h0=h0, need_state=state), ("scan_short",))
        if not state:
            # row 8: bound, the exps' floor and, where the checkout's plan
            # tells the rows apart, its route
            nbytes = (chip_smoke._nbytes(*args_)
                      + x.numel() * x.element_size())
            rec["bound_ms"] = scan_bound_ms(
                nbytes, scan_ops.scan_flops(*x.shape, s["N"]))
            rec["ex2_floor_ms"] = ex2_floor_ms(x.numel() * s["N"])
            plan_of = scan_ops._short_scan_plan
            if "state" in inspect.signature(plan_of).parameters:
                rec["route"] = plan_of(
                    *x.shape, s["N"], 2,
                    scan_ops._on_16_byte_grid(x, dt), state=False)["route"]
        name = f"{key} {tuple(s.values())} bf16"
        out[name] = rec
        print(f"{name}: {rec} {'ok' if good else 'FAILED'}", flush=True)
        del x, dt, Bm, Cm, y, y_p, h, h_p
    return ok


def long_cases(out: dict) -> bool:
    """Row 9 at one window's rasters with h0, bf16 and fp32: y and h_last
    against the associative scan, and the device time a call of each
    kernel it launches."""
    ok = True
    s = chip_smoke.SCAN_SHAPES["selective_scan_long"]
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 7)
        a = chip_smoke._scan_inputs(dtype, gen, **s)
        h0 = torch.randn((s["B"], s["D"], s["N"]), generator=gen,
                         device="cuda")
        y, h = scan_ops.selective_scan_pallas(*a, h0=h0)
        y_p, h_p = scan_ops.selective_scan_assoc(*a, h0=h0)
        torch.cuda.synchronize()
        dt = str(dtype).split(".")[1]
        tol = chip_smoke.TOL[("selective_scan_long", dt)]
        rel = max(chip_smoke.rel_err(y, y_p)[1], chip_smoke.rel_err(h, h_p)[1])
        good = rel <= tol and bool(torch.isfinite(y.float()).all())
        ok &= good
        del y_p, h_p
        torch.cuda.empty_cache()
        run = lambda: scan_ops.selective_scan_pallas(*a, h0=h0)  # noqa: E731
        rec = {"ms": chip_smoke.time_ms(run), "rel": rel,
               "device": device_ms(run, ("scan_chunk", "scan_state_pass"))}
        key = f"selective_scan_long {tuple(s.values())} {dt} h0"
        out[key] = rec
        print(f"{key}: {rec} {'ok' if good else 'FAILED'}", flush=True)
        del a, h0, y, h
        torch.cuda.empty_cache()
    return ok


def window_cases(out: dict) -> bool:
    """Row 5 at rvrt's shape in bf16 against its plain version, beside
    SDPA with the bias as a mask, with the kernel's device time."""
    s = chip_smoke.WINDOW_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 5)
    q, k, v, bias = chip_smoke._window_inputs(torch.bfloat16, gen, **s)
    got = window_attention(q, k, v, bias)
    ref = window_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    err, rel = chip_smoke.rel_err(got, ref)
    good = (rel <= chip_smoke.TOL[("window_attention", "bfloat16")]
            and bool(torch.isfinite(got.float()).all()))
    run = lambda: window_attention(q, k, v, bias)  # noqa: E731
    mask = bias[None].expand(s["nW"], -1, -1, -1).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = {"ms": chip_smoke.time_ms(run), "rel": rel, "max_abs_err": err,
           "sdpa_ms": chip_smoke.time_ms(lambda: sdpa(q, k, v,
                                                      attn_mask=mask)),
           "device": device_ms(run, ("window_attn",))}
    key = f"window_attention {tuple(s.values())} bf16"
    out[key] = rec
    print(f"{key}: {rec} {'ok' if good else 'FAILED'}", flush=True)
    return good


def conv_cases(out: dict) -> bool:
    """Row 11 at vsrm's strided in_proj slice: K 5 and 4 in bf16, K 5 in
    fp32, against its plain version, beside ``F.conv1d(groups=C)`` then
    ``F.silu`` on the channels-first view, with the kernel's device time
    and bound."""
    ok = True
    s = chip_smoke.DWCONV_SHAPE
    F = torch.nn.functional
    plan_of = getattr(conv_ops, "_dwconv_plan", None)
    for K, dtype in ((5, torch.bfloat16), (4, torch.bfloat16),
                     (5, torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 20
                                                         + K)
        x, w, b = chip_smoke._dwconv_inputs(dtype, gen, K)
        got = conv_ops.depthwise_conv1d_silu(x, w, b)
        ref = conv_ops.depthwise_conv1d_silu_plain(x, w, b)
        torch.cuda.synchronize()
        dt = str(dtype).split(".")[1]
        err, rel = chip_smoke.rel_err(got, ref)
        good = (rel <= chip_smoke.TOL[("dwconv_silu", dt)]
                and bool(torch.isfinite(got.float()).all()))
        ok &= good
        run = lambda: conv_ops.depthwise_conv1d_silu(x, w, b)  # noqa: E731
        nbytes = 2 * x.numel() * x.element_size()
        rec = {"ms": chip_smoke.time_ms(run), "rel": rel, "max_abs_err": err,
               "bound_ms": nbytes / chip_smoke.H100_BYTES_PER_S * 1e3,
               "device": device_ms(run, ("dwconv",))}
        if plan_of:
            rec["plan"] = {k: v for k, v in plan_of(
                s["B"], s["L"], s["C"], K, s["ld"], x.element_size(),
                x.data_ptr(), kernels.sm_count(x.device)).items()
                if k in ("vec", "runs", "smem", "grid")}
        if K % 2:
            xt = x.transpose(1, 2)
            bd = b.to(dtype)
            rec["library_ms"] = chip_smoke.time_ms(lambda: F.silu(F.conv1d(
                xt, w, bd, padding=(K - 1) // 2, groups=s["C"])))
        key = f"dwconv_silu (7, 57600, 160) ld 290 K {K} {dt}"
        out[key] = rec
        print(f"{key}: {rec} {'ok' if good else 'FAILED'}", flush=True)
        del x, w, b, got, ref
    return ok


def bidir_cases(out: dict) -> bool:
    """Row 6 against its plain version: at vsrm's composed shape with u, B
    and C shared by the streams (bf16, fp32) and with separate streams
    (bf16), and at the per-pixel bimamba's N 16 with separate streams;
    device time, bound and, where the checkout has its plan, the route."""
    ok = True
    s4 = chip_smoke.SCAN_SHAPES["selective_scan_bidir"]
    cases = [("shared", s4, torch.bfloat16), ("shared", s4, torch.float32),
             ("separate", s4, torch.bfloat16),
             ("separate", dict(s4, N=16), torch.bfloat16)]
    plan_of = getattr(scan_ops, "_bidir_plan", None)
    for kind, s, dtype in cases:
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 7)
        f = chip_smoke._scan_inputs(dtype, gen, **s)
        b = chip_smoke._scan_inputs(dtype, gen, **s)
        if kind == "shared":
            b = (f[0], b[1], f[2].flip(1), f[3], f[4], f[5].flip(0))
        a = (*f, *b)
        got = scan_ops.selective_scan_bidir(*a)
        ref = scan_ops.selective_scan_bidir_plain(*a)
        torch.cuda.synchronize()
        dt = str(dtype).split(".")[1]
        rel = max(chip_smoke.rel_err(g, r)[1] for g, r in zip(got, ref))
        good = (rel <= chip_smoke.TOL[("selective_scan_bidir", dt)]
                and all(bool(torch.isfinite(g.float()).all()) for g in got))
        ok &= good
        run = lambda: scan_ops.selective_scan_bidir(*a)  # noqa: E731
        nbytes = chip_smoke._nbytes(*a) + 2 * f[0].numel() * f[0].element_size()
        rec = {"ms": chip_smoke.time_ms(run), "rel": rel,
               "bound_ms": nbytes / chip_smoke.H100_BYTES_PER_S * 1e3,
               "device": device_ms(run, ("scan_bidir",))}
        if plan_of:
            rec["route"] = plan_of(s["B"], s["L"], s["D"], s["N"],
                                   f[0].element_size(), True,
                                   kind == "shared")["route"]
        key = f"selective_scan_bidir {kind} {tuple(s.values())} {dt}"
        out[key] = rec
        print(f"{key}: {rec} {'ok' if good else 'FAILED'}", flush=True)
        del f, b, a, got, ref
        torch.cuda.empty_cache()
    return ok


def shared_cases(out: dict) -> bool:
    """Row 10 (``impl="bmajor"``) in bf16 at vsrm's composed shape and at
    fast_mamba_vsr's, against its plain version, with device time, bound,
    the exps' floor and, where the checkout has its plan, the route; beside
    it ``impl="bidir"`` (row 6 and a sum) on the same inputs."""
    ok = True
    plan_of = getattr(scan_ops, "_shared_scan_plan", None)
    F = torch.nn.functional
    for si, s in enumerate(chip_smoke.SHARED_SHAPES[:2]):
        shape = {k: s[k] for k in ("B", "L", "D", "N")}
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 10
                                                         + si)
        u, dtf, Af, Bm, Cm, Df = chip_smoke._scan_inputs(torch.bfloat16, gen,
                                                         **s)
        dtb = F.softplus(torch.randn(u.shape, generator=gen, device="cuda")
                         * 0.5 - 2.0).to(torch.bfloat16)
        a = (u, dtf, dtb, Af, Af.flip(1), Bm, Cm, Df, Df.flip(0))
        run = lambda: scan_ops.selective_scan_bidir_shared(  # noqa: E731
            *a, impl="bmajor")
        bidir = lambda: scan_ops.selective_scan_bidir_shared(  # noqa: E731
            *a, impl="bidir")
        got = run()
        ref = scan_ops.selective_scan_bidir_shared_plain(*a)
        torch.cuda.synchronize()
        rel = max(chip_smoke.rel_err(got, ref)[1],
                  chip_smoke.rel_err(got, bidir())[1])
        good = (rel <= chip_smoke.TOL[("selective_scan_bidir_shared",
                                       "bfloat16")]
                and bool(torch.isfinite(got.float()).all()))
        ok &= good
        nbytes = chip_smoke._nbytes(*a) + u.numel() * u.element_size()
        rec = {"ms": chip_smoke.time_ms(run), "rel": rel,
               "bound_ms": scan_bound_ms(
                   nbytes, scan_ops.scan_flops(**shape, streams=2)),
               "ex2_floor_ms": ex2_floor_ms(2 * u.numel() * s["N"]),
               "device": device_ms(run, ("scan_bidir",)),
               "bidir_ms": chip_smoke.time_ms(bidir),
               "bidir_device": device_ms(bidir, ("scan_bidir",
                                                 "elementwise"))}
        if plan_of:
            rec["route"] = plan_of(*shape.values(), 2,
                                   scan_ops._on_16_byte_grid(u, dtf, dtb)
                                   )["route"]
        key = f"selective_scan_bidir_shared {tuple(shape.values())} bf16"
        out[key] = rec
        print(f"{key}: {rec} {'ok' if good else 'FAILED'}", flush=True)
        del u, dtf, dtb, Bm, Cm, a, got, ref
        torch.cuda.empty_cache()
    return ok


def blocks_cases(out: dict) -> bool:
    """Rows 8 and 10 at their served shapes in bf16 with the sequences a
    block overridden (the plans patched), device ms over 20 calls and the
    error against the plain version; skipped for a checkout without row
    10's plan."""
    short = scan_ops._short_scan_plan
    shared = getattr(scan_ops, "_shared_scan_plan", None)
    if shared is None:
        return True
    ok, tol = True, 1e-2
    rec = {}
    s = chip_smoke.SCAN_SHAPES["selective_scan_short_nostate"]
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 7)
    a = chip_smoke._scan_inputs(torch.bfloat16, gen, **s)
    ref, _ = scan_ops.selective_scan_plain(*a)
    run = lambda: scan_ops.selective_scan_pallas_short(  # noqa: E731
        *a, need_state=False)
    try:
        for seqs in (0, 1, 2):
            scan_ops._short_scan_plan = (lambda *x, seqs=seqs, **k:
                                         dict(short(*x, **k), seqs=seqs))
            rel = chip_smoke.rel_err(run()[0], ref)[1]
            ok &= rel <= tol
            rec[f"row8 seqs{seqs}"] = (
                round(device_ms(run, ("scan_short",), iters=20)["sum"], 4),
                rel)
    finally:
        scan_ops._short_scan_plan = short
    del a, ref
    for si, cands in ((0, (1, 2, 4)), (1, (2, 4))):
        sh = chip_smoke.SHARED_SHAPES[si]
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 10
                                                         + si)
        u, dtf, Af, Bm, Cm, Df = chip_smoke._scan_inputs(torch.bfloat16, gen,
                                                         **sh)
        dtb = torch.nn.functional.softplus(
            torch.randn(u.shape, generator=gen, device="cuda") * 0.5
            - 2.0).to(torch.bfloat16)
        sa = (u, dtf, dtb, Af, Af.flip(1), Bm, Cm, Df, Df.flip(0))
        ref = scan_ops.selective_scan_bidir_shared_plain(*sa)
        run = lambda: scan_ops.selective_scan_bidir_shared(  # noqa: E731
            *sa, impl="bmajor")
        try:
            for seqs in cands:
                scan_ops._shared_scan_plan = (lambda *x, seqs=seqs:
                                              dict(shared(*x), seqs=seqs))
                rel = chip_smoke.rel_err(run(), ref)[1]
                ok &= rel <= tol
                rec[f"row10 N{sh['N']} seqs{seqs}"] = (
                    round(device_ms(run, ("scan_bidir",), iters=20)["sum"],
                          4), rel)
        finally:
            scan_ops._shared_scan_plan = shared
        rec[f"row6+add N{sh['N']}"] = round(device_ms(
            lambda: scan_ops.selective_scan_bidir_shared(*sa, impl="bidir"),
            ("scan_bidir", "elementwise"), iters=20)["sum"], 4)
        del u, dtf, dtb, Bm, Cm, sa, ref
        torch.cuda.empty_cache()
    out["blocks"] = rec
    print(f"blocks: {rec} {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    _, log = kernels.build(ptxas_verbose=True)
    src = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            src = next((v for k, v in SOURCES.items() if k in line), None)
        if src and any(w in line for w in ("Compiling entry", "Used", "spill")):
            print(f"  ptxas {src}: {line.strip()}")
    kernels.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, ok = {}, True
    with torch.inference_mode():
        for ci, shp in enumerate(FLASH_CASES if "flash" in ONLY else []):
            gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2
                                                             + ci)
            q, k, v = chip_smoke._flash_inputs(torch.bfloat16, gen, **shp)
            got = flash_attention(q, k, v)
            ref = attention_ref(q, k, v)
            torch.cuda.synchronize()
            err, rel = chip_smoke.rel_err(got, ref)
            ms = chip_smoke.time_ms(lambda: flash_attention(q, k, v))
            key = "flash {B}x{H} {Lq}x{Lk} Dh{Dh}".format(**shp)
            rec = {"ms": ms, "rel": rel, "max_abs_err": err}
            if ci < 2:                       # ditvr's and seedvr2's shapes
                sdpa = torch.nn.functional.scaled_dot_product_attention
                rec["sdpa_ms"] = chip_smoke.time_ms(lambda: sdpa(q, k, v))
                for name, fn in (("device_ms", flash_attention),
                                 ("sdpa_device_ms", sdpa)):
                    rec[name] = round(sum(chip_smoke.device_ms(
                        lambda: fn(q, k, v), ("",)).values()), 4)
            good = rel <= chip_smoke.TOL[("flash_attention", "bfloat16")]
            ok &= good and bool(torch.isfinite(got.float()).all())
            print(f"{key} bf16: {rec} {'ok' if good else 'FAILED'}",
                  flush=True)
            out[key] = rec
            del q, k, v, got, ref
        for name, shape in (FUSED_CASES if "fused" in ONLY else []):
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device="cuda").manual_seed(
                    chip_smoke.SEED + 1)
                a = chip_smoke._bissm_inputs(dtype, gen, shape)
                got = fused_bidir_ssm_kernel(*a)
                ref = fused_bidir_ssm_plain(*a)
                torch.cuda.synchronize()
                err, rel = chip_smoke.rel_err(got, ref)
                ms = chip_smoke.time_ms(lambda: fused_bidir_ssm_kernel(*a))
                dt = str(dtype).split(".")[1]
                good = rel <= chip_smoke.TOL[("fused_bidir_ssm", dt)]
                ok &= good and bool(torch.isfinite(got.float()).all())
                key = f"fused {name} {dt}"
                out[key] = {"ms": ms, "rel": rel, "max_abs_err": err}
                print(f"{key}: {out[key]} {'ok' if good else 'FAILED'}",
                      flush=True)
                del a, got, ref
        if "ssd" in ONLY:
            ok &= ssd_cases(out)
        if "short" in ONLY:
            ok &= short_cases(out)
        if "long" in ONLY:
            ok &= long_cases(out)
        if "window" in ONLY:
            ok &= window_cases(out)
        if "conv" in ONLY:
            ok &= conv_cases(out)
        if "bidir" in ONLY:
            ok &= bidir_cases(out)
        if "shared" in ONLY:
            ok &= shared_cases(out)
        if "blocks" in ONLY:
            ok &= blocks_cases(out)
    print(json.dumps({"tag": args.tag, "device": smi, "ok": ok,
                      "cases": out}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
