"""The program's profiler spans (utils/perf.py ``span``): the streaming
handler's ``vsr_handler:*`` and ``pipeline:assemble`` under a CPU profiler,
nested per window, as many model spans as model calls, outputs unchanged
by the profiler; a shared no-op with no profiler; the train step's and
the kernel VJP's range names."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from video_enhancer_tpu_torch.ops.vjp import kernel_vjp
from video_enhancer_tpu_torch.parallel.mesh import local_mesh
from video_enhancer_tpu_torch.runtime.vsr_handler import VSRHandler
from video_enhancer_tpu_torch.train.step import make_optimizer, make_train_step
from video_enhancer_tpu_torch.utils import perf

HANDLER = ("vsr_handler:upload", "vsr_handler:gate", "vsr_handler:tiles",
           "vsr_handler:model", "vsr_handler:blend", "vsr_handler:round",
           "vsr_handler:download")


def _handler(scale, tile, threshold=None):
    calls = []

    def apply_fn(p, x):
        calls.append(x.shape[0])
        if scale > 1:
            x = x.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
        return x * p["w"] + p["b"]

    params = {"w": torch.tensor(0.9), "b": torch.tensor(0.03)}
    h = VSRHandler("tiny", apply_fn, params, scale=scale, chunk=4, overlap=1,
                   tile=tile, tile_overlap=4, dtype=torch.float32,
                   device="cpu", quality_threshold=threshold)
    return h, calls


# (scale, frames, height, width, tile, quality threshold, windows, model
# calls, span names): 16x60 at tile 16 is 5 tiles, two calls of 4 a window
# (the second padded); 8 frames at chunk 4 / stride 3 end in a tail of 2
# real frames; 6 frames untiled end in a padded tail of 3; a gated window
# of noise is sharp, so no model runs.
CASES = {
    "tiled": (2, 8, 16, 60, 16, None, 3, 6,
              {"pipeline:assemble", "vsr_handler:window",
               "vsr_handler:upload", "vsr_handler:tiles", "vsr_handler:model",
               "vsr_handler:blend", "vsr_handler:round",
               "vsr_handler:download"}),
    "untiled_tail": (2, 6, 8, 12, 16, None, 2, 2,
                     {"pipeline:assemble", "vsr_handler:window",
                      "vsr_handler:upload", "vsr_handler:model",
                      "vsr_handler:round", "vsr_handler:download"}),
    "gated": (1, 6, 8, 12, 16, 0.01, 2, 0,
              {"pipeline:assemble", "vsr_handler:window",
               "vsr_handler:upload", "vsr_handler:gate",
               "vsr_handler:download"}),
}


def _frames(n, h, w):
    g = np.random.default_rng(3)
    return [g.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _program_spans(prof):
    """``(start_ns, end_ns, name)`` of each range named ``<layer>:<stage>``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.count(":") == 1:
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    return sorted(out)


@pytest.mark.parametrize("case", list(CASES))
def test_handler_spans_nest_per_window_and_count_model_calls(case):
    scale, n, hh, ww, tile, thr, windows, n_calls, names = CASES[case]
    frames = _frames(n, hh, ww)
    h, calls = _handler(scale, tile, thr)
    plain = list(h.enhance_frames(iter(frames)))
    assert len(calls) == n_calls
    calls.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = list(h.enhance_frames(iter(frames)))
    assert len(calls) == n_calls
    assert len(traced) == len(plain) == n
    for a, b in zip(traced, plain):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    if tile >= max(hh, ww):          # frame by frame, as the handler rounds
        for f, got in zip(frames, traced):
            want = f
            if not thr:
                x = torch.from_numpy(f).float() / 255.0
                x = x.repeat_interleave(scale, 0).repeat_interleave(scale, 1)
                want = torch.clamp(torch.round((x * torch.tensor(0.9)
                                                + torch.tensor(0.03)) * 255.0),
                                   0, 255).to(torch.uint8).numpy()
            np.testing.assert_array_equal(got, want)

    spans = _program_spans(prof)
    assert {s[2] for s in spans} == names
    assert all("::" not in s[2] and not s[2].startswith("bench.")
               for s in spans)
    wins = [s for s in spans if s[2] == "vsr_handler:window"]
    assert len(wins) == windows
    assert sum(s[2] == "pipeline:assemble" for s in spans) == windows
    assert sum(s[2] == "vsr_handler:model" for s in spans) == n_calls
    for s in spans:
        if s[2] in HANDLER:          # every handler stage inside one window
            assert sum(w[0] <= s[0] and s[1] <= w[1] for w in wins) == 1
        if s[2] == "pipeline:assemble":
            assert not any(w[0] <= s[0] < w[1] for w in wins)
    for w in wins:
        inside = [s[2] for s in spans if w[0] <= s[0] and s[1] <= w[1]]
        assert inside.count("vsr_handler:download") == 1
        assert inside.count("vsr_handler:upload") == (1 if thr else 2)


def test_span_is_a_shared_noop_without_a_profiler():
    assert perf.span("vsr_handler:window") is perf.span("a:b")
    with perf.span("vsr_handler:window") as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(perf.span("a:b"),
                          torch.autograd.profiler.record_function)
    assert perf.span("a:b") is perf.span("c:d")


def test_train_step_and_vjp_range_names():
    mesh = local_mesh("cpu")
    init_state, train_step, _ = make_train_step(
        lambda p, x: x * p["w"], make_optimizer(), mesh,
        loss_fn=lambda pred, hr: ((pred - hr) ** 2).mean())
    state = init_state({"w": torch.ones(3)})
    batch = {"lr": torch.rand(1, 2, 4, 4, 3), "hr": torch.rand(1, 2, 4, 4, 3)}

    def square(x):
        return x * x

    x = torch.rand(5, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, batch)
        kernel_vjp("square", square, square, x).sum().backward()
    names = {s[2] for s in _program_spans(prof)}
    assert {"train_step:forward", "train_step:backward",
            "train_step:optimizer", "vjp:square"} <= names
    assert torch.allclose(x.grad, 2 * x.detach())
