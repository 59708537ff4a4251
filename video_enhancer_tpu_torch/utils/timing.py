"""Device time per call, with the host's overhead cancelled by a slope.

Counterpart of video_enhancer_tpu/utils/timing.py, with the same
estimator: ``fn`` is run in chains of three lengths, each iteration fed a
zero-scaled element of the previous output (data dependence, so no call can
be skipped or overlapped with the next), each chain timed ``repeats``
times, and the time per call is the slope of the per-length medians. On
the card a chain is timed with CUDA events around it, on the CPU with the
host's clock; either way the fixed cost of a chain (the first launch, the
synchronisation) cancels in the slope.

PyTorch runs eagerly: there is no jit to fuse a chain into one program,
so each call's host time (Python, the wrapper, the launch) is in the slope
as far as the card waits for it. A kernel shorter than its launch path
reads as that path's time. ``max_flops`` bounds the estimate from below
by the card's peak, H100 SXM dense bf16.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["device_time_per_call", "chain_n", "H100_BF16_PEAK_FLOPS"]

# NVIDIA's data sheet, H100 SXM, dense bf16 on the tensor cores at 700 W
H100_BF16_PEAK_FLOPS = 989e12


def chain_n(fn: Callable, n: int) -> Callable:
    """A function running ``fn(*args)`` ``n`` times with data dependence.

    ``fn(*args) -> tensor``; iteration ``i + 1`` takes ``args[0]`` plus a
    zero-scaled element of iteration ``i``'s output. Returns the last
    output's first element plus that carry, as a 0-d tensor."""

    def run(*args):
        out = fn(*args)
        carry = (out.reshape(-1)[0] * 0).to(args[0].dtype)
        for _ in range(n - 1):
            out = fn(args[0] + carry, *args[1:])
            carry = (out.reshape(-1)[0] * 0).to(args[0].dtype)
        return out.reshape(-1)[0] + carry

    return run


def _median(xs):
    s = sorted(xs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def _seconds(f, args, on_card: bool) -> float:
    """Seconds of one ``f(*args)``, its result consumed."""
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        f(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    float(f(*args))
    return time.perf_counter() - t0


def device_time_per_call(
    fn: Callable,
    *args,
    n_small: int = 5,
    n_large: int = 25,
    repeats: int = 4,
    max_flops: float | None = None,
) -> float:
    """Seconds per call of ``fn(*args)``, overhead-cancelled.

    - three chain lengths (small / mid / large), ``repeats`` timings each,
      the **median** per length, so one spike cannot set the result;
    - the slope from the medians, with a monotonicity check (the medians
      must grow with the length) and a cross-check of the (small, large)
      and (mid, large) slopes: on a disagreement over 2x the round is run
      once more with twice the repeats;
    - ``max_flops``, the call's analytic FLOPs: a time below ``max_flops``
      at the card's peak is impossible and triggers the same retry, after
      which the estimate is clamped to that floor.

    The chains run on the device of ``args[0]`` (CUDA events on the card,
    the host's clock on the CPU)."""
    on_card = args[0].device.type == "cuda"
    n_mid = (n_small + n_large) // 2
    fns = [(n, chain_n(fn, n)) for n in (n_small, n_mid, n_large)]
    for _, f in fns:                    # warm-up: builds, caches, allocator
        float(f(*args))

    def medians(chains, reps: int) -> dict:
        return {n: _median([_seconds(f, args, on_card) for _ in range(reps)])
                for n, f in chains}

    def one_round(reps: int) -> float | None:
        med = medians(fns, reps)
        if not (med[n_small] < med[n_mid] < med[n_large]):
            return None
        slope_sl = (med[n_large] - med[n_small]) / (n_large - n_small)
        slope_ml = (med[n_large] - med[n_mid]) / (n_large - n_mid)
        if slope_sl <= 0 or slope_ml <= 0:
            return None
        if max(slope_sl, slope_ml) > 2.0 * min(slope_sl, slope_ml):
            return None
        per = 0.5 * (slope_sl + slope_ml)
        if max_flops is not None and per * H100_BF16_PEAK_FLOPS < max_flops:
            return None  # implies more than the card's peak
        return per

    est = one_round(repeats)
    if est is None:
        est = one_round(2 * repeats)
    if est is None:
        # the most conservative defensible number: the (mid, large) slope of
        # a last round, floored at the physical limit
        med = medians(fns[1:], 2 * repeats)
        est = max((med[n_large] - med[n_mid]) / (n_large - n_mid), 1e-9)
        if max_flops is not None:
            est = max(est, max_flops / H100_BF16_PEAK_FLOPS)
    return est
