"""One run of one cell, in its stages: set-up (the inputs, the program,
the warm windows), the measured window, then the reference and the counts,
and the check.

``Run`` carries what the metric readers (``metrics/<name>.py``) read:
``setup_s``; ``delivery`` (drive.py); ``trace`` (trace.py, in a traced
run); ``calls``, the model calls made in the window, and ``count``
(counting.py); ``kernels``, the frozen kernel counts; ``itemsize``, the
served dtype's; ``windows``, the stream's windows; ``cell``, ``config``
and ``mix``.
"""

from __future__ import annotations

import gc
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, counting, drive, frames, manifest
from .program import Program

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass
class Run:
    cell: dict
    config: dict
    mix: dict
    seed: int
    device: str
    setup_s: float = 0.0
    pool: list = field(default_factory=list)
    stream_frames: list | None = None
    context: dict | None = None
    windows: list | None = None
    keep: object = None
    program: Program | None = None
    reference: object = None
    params: dict | None = None
    kernels: dict = field(default_factory=dict)
    count: counting.CallCount | None = None
    itemsize: int = 2
    calls: int = 0
    delivery: drive.Delivery | None = None
    trace: object = None
    parts: dict = field(default_factory=dict)   # set-up seconds by stage


def _keep_windows(windows, rng, extra: int) -> set:
    """Frames to keep: those of the first and last window and of ``extra``
    more drawn by ``rng``."""
    picks = {0, len(windows) - 1}
    picks |= set(rng.choice(len(windows), size=min(extra, len(windows)),
                            replace=False).tolist())
    return {f for i in picks for f in windows[i][2]}


def prepare(m: dict, workload: str, seed: int, seconds: float,
            device: str, program: Program | None = None) -> Run:
    """Set-up but the warm-up: the inputs from the seed and the program
    (``program`` where one is built already)."""
    import plain

    t = time.perf_counter()
    cell = manifest.cell(m, workload)
    config = manifest.config(m, cell["config"])
    mix = manifest.traffic(cell["traffic"])
    run = Run(cell, config, mix, seed, device)
    run.itemsize = _ITEMSIZE[config["dtype"]]
    run.pool = frames.make_pool(mix, seed)
    t = _lap(run, "frames", t)
    window, stride = config["window"], config["stride"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1 << 20]))
    if mix["loop"] == "open":
        n = int(round(mix["rate_fps"] * seconds))
        per = mix["clip_frames"]
        run.stream_frames = [run.pool[(i // per) % len(run.pool)].frames[
            i % per] for i in range(n)]
        run.context = run.pool[0].context()
        run.windows = plain.windows(n, window, stride)
        run.keep = _keep_windows(run.windows, rng, mix["check_windows"])
    else:
        wins = plain.windows(mix["clip_frames"], window, stride)

        def keep(occ):
            r = np.random.default_rng(np.random.SeedSequence([seed, occ]))
            return _keep_windows(wins, r, 1)

        run.keep = keep
    run.program = program or Program(config, device)
    _lap(run, "program", t)
    return run


def load_reference(run: Run) -> None:
    """The plain reference, its parameters read from the checkpoint, the
    frozen kernel counts and the count of one model call: all after the
    window, for the check and the readers, and none of it set-up."""
    run.reference = manifest.reference(run.config["name"])
    run.params = run.reference.load(run.config, "cpu")
    run.kernels = manifest.all_counts()
    run.count = counting.count(run.reference, run.params, run.config,
                               run.mix["height"], run.mix["width"],
                               run.pool[0].context(), run.kernels)


def _lap(run: Run, stage: str, t: float) -> float:
    now = time.perf_counter()
    run.parts[stage] = now - t
    return now


def warm(run: Run) -> None:
    """The cell's own shapes once: a first window, a steady window and a
    padded tail, at the cell's tiling."""
    t = time.perf_counter()
    n = run.config["window"] + run.config["stride"] + 1
    clip = run.pool[0]
    run.program.set_context(clip.context())
    for _ in run.program.stream(iter(clip.frames[:n])):
        pass
    if run.device == "cuda":
        torch.cuda.synchronize()
    _lap(run, "warm", t)


def measure(run: Run, seconds: float, traced: bool) -> None:
    from . import trace as tr

    prog = run.program
    prog.traced = traced
    prof = tr.profiler() if traced else None
    if prof is not None:
        prof.start()
    calls0 = prog.calls
    with (torch.profiler.record_function(tr.WINDOW) if traced
          else nullcontext()):
        if run.stream_frames is not None:
            run.delivery = drive.open_loop(
                prog, run.stream_frames, run.context, run.mix["rate_fps"],
                seconds, run.keep, traced)
        else:
            run.delivery = drive.closed_loop(prog, run.pool, seconds,
                                             run.keep, traced)
        if run.device == "cuda":
            torch.cuda.synchronize()
    run.calls = prog.calls - calls0
    if prof is not None:
        prof.stop()
        run.trace = tr.reduce(prof)


def free_program(run: Run) -> None:
    run.program.close()
    run.program = None
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()


def candidates(run: Run) -> list:
    """``(frames of the clip, window, is first, is tail, program frames,
    context)`` for each window delivered in full whose frames were
    kept."""
    import plain

    d, out = run.delivery, []
    if run.stream_frames is not None:
        wins = run.windows
        for i, w in enumerate(wins):
            if w[2] and w[2][-1] < d.delivered[0] and all(
                    (0, f) in d.kept for f in w[2]):
                src = np.stack([run.stream_frames[f] for f in
                                range(w[0], max(w[1]) + 1)])
                local = (0, [f - w[0] for f in w[1]],
                         [f - w[0] for f in w[2]])
                out.append((src, local, i == 0, i == len(wins) - 1,
                            [d.kept[(0, f)] for f in w[2]], run.context))
        return out
    for occ, (clip_i, got) in enumerate(zip(d.occurrences, d.delivered)):
        clip = run.pool[clip_i].frames
        wins = plain.windows(len(clip), run.config["window"],
                             run.config["stride"])
        for i, w in enumerate(wins):
            if w[2] and w[2][-1] < got and all((occ, f) in d.kept
                                               for f in w[2]):
                out.append((clip, w, i == 0, i == len(wins) - 1,
                            [d.kept[(occ, f)] for f in w[2]],
                            run.pool[clip_i].context()))
    return out


def pick(cands: list, rng, n: int) -> list:
    """Up to ``n`` candidates: a first window and a tail where there are
    such, the rest drawn by ``rng``."""
    if len(cands) <= n:
        return cands
    chosen = []
    for flag in (2, 3):
        hit = [i for i, c in enumerate(cands) if c[flag] and i not in chosen]
        if hit:
            chosen.append(hit[int(rng.integers(len(hit)))])
    rest = [i for i in range(len(cands)) if i not in chosen]
    chosen += rng.choice(rest, size=n - len(chosen), replace=False).tolist()
    return [cands[i] for i in sorted(chosen)]


def check_outputs(run: Run, against: str | None = None) -> dict:
    """The compared numbers of the sampled windows: the program's frames
    (or, with ``against``, a control: the reference's in that mode of
    ``plain.Ops``) against the reference in float32."""
    return compare(run, [against])[0]


def compare(run: Run, sides: list) -> list[dict]:
    """``check_outputs`` for each of ``sides`` (``None`` for the program,
    else a mode of ``plain.Ops``), on the same sampled windows, the
    reference in float32 computed once a window."""
    import plain

    rng = np.random.default_rng(np.random.SeedSequence([run.seed, 1 << 21]))
    chosen = pick(candidates(run), rng, run.mix["check_windows"])
    params = plain.to_device(run.params, run.device)

    def reference(src, win, ctx, mode):
        return check.reference_window(run.reference, params, src, win,
                                      plain.Ops(mode), run.config, ctx,
                                      run.device)

    tallies = [check.Tally() for _ in sides]
    for src, win, _, _, kept, ctx in chosen:
        want = reference(src, win, ctx, "fp32")
        for side, tally in zip(sides, tallies):
            got = (torch.from_numpy(np.stack(kept)) if side is None
                   else reference(src, win, ctx, side))
            tally.add(want, got)
    out = []
    for tally in tallies:
        numbers = tally.numbers()
        numbers["windows"] = len(chosen)
        numbers["frames"] = tally.frames
        out.append(numbers)
    return out


def missing(run: Run) -> int:
    """Frames due in the window and never delivered (open loop)."""
    d = run.delivery
    if d.out is None:
        return 0
    return int(np.isnan(d.out).sum())
