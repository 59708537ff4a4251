"""The measured loops: clips back to back in a closed loop, or one stream
of frames each due at a fixed rate in an open loop.

Both hand the program uint8 frames already in memory, through its
streaming loop, and take every output frame it yields; each ``next()`` on
the loop is marked ``bench.next`` and each frame the open loop hands over
``bench.source``, when traced. Both keep the output frames of the
windows named in ``keep`` for the check after the window.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch


def _range(name: str, traced: bool):
    return torch.profiler.record_function(name) if traced else nullcontext()


@dataclass
class Delivery:
    """What one run's window delivered.

    ``t0``: the window's start (host clock, s); ``seconds``: its length;
    ``frames``: output frames delivered in it; ``t_last``: when the last of
    them was yielded; ``kept``: ``{(occurrence, frame): uint8 array}``;
    ``occurrences``: the clip (pool index) of each occurrence begun, and
    ``delivered``: the frames delivered of each. Open loop only: ``due``,
    ``taken`` and ``out`` times of every frame of the stream (``out`` NaN
    where never yielded)."""

    t0: float
    seconds: float
    frames: int = 0
    t_last: float = 0.0
    kept: dict = field(default_factory=dict)
    occurrences: list = field(default_factory=list)
    delivered: list = field(default_factory=list)
    due: np.ndarray | None = None
    taken: np.ndarray | None = None
    out: np.ndarray | None = None


def closed_loop(program, pool, seconds: float, keep,
                traced: bool = False) -> Delivery:
    """Clips of ``pool`` in turn, each through its own streaming loop,
    until ``seconds`` have passed; ``keep(occurrence)`` is the set of
    frames of that occurrence to keep."""
    t0 = time.perf_counter()
    d = Delivery(t0, seconds)
    deadline = t0 + seconds
    occ = 0
    while True:
        clip = pool[occ % len(pool)]
        program.set_context(clip.context())
        wanted = keep(occ)
        d.occurrences.append(occ % len(pool))
        d.delivered.append(0)
        loop = program.stream(iter(clip.frames))
        i = 0
        while True:
            with _range("bench.next", traced):
                out = next(loop, None)
            now = time.perf_counter()
            if out is None or now > deadline:
                break
            if i in wanted:
                d.kept[(occ, i)] = out
            i += 1
            d.frames += 1
            d.t_last = now
        d.delivered[-1] = i
        loop.close()
        if now > deadline:
            return d
        occ += 1


def open_loop(program, frames, context, rate: float, seconds: float, keep,
              traced: bool = False, grace: float = 60.0) -> Delivery:
    """``frames`` (a sequence of uint8 frames, ``rate * seconds`` of them)
    as one stream, frame i handed over no earlier than ``t0 + i / rate``;
    the output of each frame is awaited up to ``grace`` seconds past the
    window's close. ``keep``: the set of frames to keep."""
    n = len(frames)
    program.set_context(context)
    d = Delivery(0.0, seconds, occurrences=[0], delivered=[0])
    d.taken = np.full(n, np.nan)
    d.out = np.full(n, np.nan)

    def source():
        for i in range(n):
            with _range("bench.source", traced):
                wait = d.due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                d.taken[i] = time.perf_counter()
            yield frames[i]

    d.t0 = time.perf_counter()
    d.due = d.t0 + np.arange(n) / rate
    cutoff = d.t0 + seconds + grace
    loop = program.stream(source())
    i = 0
    while i < n:
        with _range("bench.next", traced):
            out = next(loop, None)
        now = time.perf_counter()
        if out is None or now > cutoff:
            break
        d.out[i] = now
        if i in keep:
            d.kept[(0, i)] = out
        i += 1
    loop.close()
    d.frames = d.delivered[0] = i
    d.t_last = now
    return d
