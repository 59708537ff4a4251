"""The program's spans in a traced window, and the device's idle time put
down to them.

A program span is a host range that the port opens with its ``span``
helper (``video_enhancer_tpu_torch/utils/perf.py``): a name of the form
``<layer>:<stage>``, one ``:``, so never torch's ``aten::`` operations,
and no ``bench.`` prefix, so never the benchmark's own ranges. From the
profiler's events of the window ``bench.window``, ``reduce`` keeps one
``Span`` for each instance on the thread that opened the window, in the
order they began:

- ``start_s`` (from the window's start) and ``dur_s``;
- ``self_s``: the duration less what its child spans cover;
- ``device_s``: device seconds of the operations launched while it was
  the innermost span under way (linked to their host launch as trace.py
  links them);
- ``idle_s``: device idle seconds put down to it. Each instant of each
  idle gap of the device inside the window goes to the innermost program
  span under way then, so a gap that crosses a span's edge is split there.
  Idle under no program span goes to the innermost ``bench.*`` range under
  way, or to ``bench.window`` (``Spans.rest``, by name).

So the idle of every instance and of ``rest`` add up to the window's idle
(``window_s - busy_s`` of trace.py). The gaps and the launch links are
found by trace.py's own arithmetic, repeated here on the same events:
this module changes none of ``trace.reduce``'s numbers.

Per-layer quantities of the streaming handler's spans, read from a
``Spans``: ``handler_idle_share``, ``model_call_idle_share``,
``window_idle_ms_p50``, ``handler_window_ms_p50``. Each is None where the
program opened no ``vsr_handler:window`` span.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
from torch.autograd import DeviceType

WINDOW = "bench.window"
WINDOW_SPAN = "vsr_handler:window"
MODEL_SPAN = "vsr_handler:model"
HANDLER_LAYERS = ("pipeline:", "vsr_handler:")


def is_program(name: str) -> bool:
    return name.count(":") == 1 and not name.startswith("bench.")


@dataclass
class Span:
    name: str
    start_s: float
    dur_s: float
    self_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0
    parent: int = -1      # the enclosing instance's index, -1 for none


@dataclass
class Spans:
    instances: list = field(default_factory=list)
    rest: dict = field(default_factory=dict)    # bench range -> idle s

    def within(self, i: int, name: str) -> bool:
        """Instance ``i`` is a ``name`` span or lies inside one."""
        while i >= 0:
            if self.instances[i].name == name:
                return True
            i = self.instances[i].parent
        return False

    def inclusive(self, attr: str) -> list[float]:
        """``attr`` of each instance together with all nested in it."""
        total = [getattr(s, attr) for s in self.instances]
        for i in range(len(total) - 1, -1, -1):    # children after parents
            p = self.instances[i].parent
            if p >= 0:
                total[p] += total[i]
        return total

    def total_idle_s(self) -> float:
        return (sum(s.idle_s for s in self.instances)
                + sum(self.rest.values()))


def reduce(prof) -> Spans:
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((start, end, e.linked_correlation_id(),
                            e.correlation_id()))
        else:
            host.append((start, end, e.name(), e.correlation_id(),
                         e.start_thread_id()))
    windows = [h for h in host if h[2] == WINDOW]
    if not windows:
        raise RuntimeError(f"no {WINDOW} range in the trace")
    ws, we, _, _, tid = windows[0]
    # trace.py's links: a device operation to the host operation or range
    # that launched it, else to its runtime call
    by_op = {cid: s for s, _, name, cid, _ in host
             if cid and ("::" in name or name.startswith("bench."))}
    by_call = {cid: s for s, _, name, cid, _ in host
               if cid and name.startswith("cu")}
    ours = [(s, t, name) for s, t, name, _, th in host
            if th == tid and t > ws and s < we]
    prog = sorted((s, t, name) for s, t, name in ours if is_program(name))
    bench = [(s, t, name) for s, t, name in ours
             if name.startswith("bench.") and name != WINDOW]

    out = Spans()
    stack: list[int] = []
    for i, (s, t, name) in enumerate(prog):
        while stack and prog[stack[-1]][1] <= s:
            stack.pop()
        parent = stack[-1] if stack else -1
        out.instances.append(Span(name, (s - ws) / 1e9, (t - s) / 1e9,
                                  (t - s) / 1e9, parent=parent))
        if parent >= 0:
            out.instances[parent].self_s -= (t - s) / 1e9
        stack.append(i)
    segs = _innermost([(s, t, i) for i, (s, t, _) in enumerate(prog)])
    seg_starts = [a for a, _, _ in segs]
    bsegs = _innermost(bench)
    bseg_starts = [a for a, _, _ in bsegs]

    launched = []
    for s, t, link, corr in dev:
        s, t = max(s, ws), min(t, we)
        if t <= s:
            continue
        launched.append((s, t))
        at = by_op.get(link) if link else by_call.get(corr)
        if at is None:
            continue
        j = bisect.bisect_right(seg_starts, at) - 1
        if j >= 0 and segs[j][1] > at:
            out.instances[segs[j][2]].device_s += (t - s) / 1e9

    rest: dict = defaultdict(float)
    for a, b in _gaps(launched, ws, we):
        for x, y, i in _cover(a, b, segs, seg_starts):
            if i is not None:
                out.instances[i].idle_s += (y - x) / 1e9
                continue
            for u, v, name in _cover(x, y, bsegs, bseg_starts):
                rest[name or WINDOW] += (v - u) / 1e9
    out.rest = dict(rest)
    return out


def _gaps(launched, ws, we) -> list:
    """The stretches of [ws, we] that no device operation covers (as
    trace.py finds them)."""
    gaps, cursor = [], ws
    for s, t in sorted(launched):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if we > cursor:
        gaps.append((cursor, we))
    return gaps


def _innermost(intervals) -> list:
    """``(a, b, key)``, in order: over each stretch of time the key of the
    latest-begun of ``intervals`` (``(start, end, key)``) under way, which
    for nested ranges is the innermost. Stretches under none are left
    out."""
    out, stack, cursor = [], [], None

    def close(until):
        nonlocal cursor
        while stack and stack[-1][1] <= until:
            _, t, key = stack.pop()
            if t > cursor:
                out.append((cursor, t, key))
                cursor = t

    for s, t, key in sorted(intervals, key=lambda v: (v[0], -v[1])):
        close(s)
        if stack and s > cursor:
            out.append((cursor, s, stack[-1][2]))
        stack.append((s, t, key))
        cursor = s
    close(float("inf"))
    return out


def _cover(a, b, segs, starts):
    """[a, b) in pieces ``(x, y, key)``: the key of the stretch of ``segs``
    over each piece, None where none is."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    t = a
    while t < b and i < len(segs):
        s, e, key = segs[i]
        if e <= t:
            i += 1
        elif s > t:
            yield t, min(s, b), None
            t = min(s, b)
        else:
            yield t, min(e, b), key
            t = min(e, b)
            i += 1
    if t < b:
        yield t, b, None


def _has_handler(sp: Spans) -> bool:
    return any(s.name == WINDOW_SPAN for s in sp.instances)


def handler_idle_share(sp: Spans, window_s: float) -> float | None:
    """Idle put down to the window's assembly and the handler's spans
    outside the model calls, over the window (a fraction)."""
    if not _has_handler(sp) or window_s <= 0:
        return None
    idle = sum(s.idle_s for i, s in enumerate(sp.instances)
               if s.name.startswith(HANDLER_LAYERS)
               and not sp.within(i, MODEL_SPAN))
    return idle / window_s


def model_call_idle_share(sp: Spans, window_s: float) -> float | None:
    """Idle put down to the model calls (``vsr_handler:model`` and what is
    nested in it), over the window (a fraction)."""
    if not _has_handler(sp) or window_s <= 0:
        return None
    idle = sum(s.idle_s for i, s in enumerate(sp.instances)
               if sp.within(i, MODEL_SPAN))
    return idle / window_s


def window_idle_ms_p50(sp: Spans) -> float | None:
    """The median over the handler's windows of the device idle inside
    each, ms."""
    idle = sp.inclusive("idle_s")
    got = [idle[i] for i, s in enumerate(sp.instances)
           if s.name == WINDOW_SPAN]
    return float(np.median(got)) * 1e3 if got else None


def handler_window_ms_p50(sp: Spans) -> float | None:
    """The median duration of the handler's windows, ms."""
    got = [s.dur_s for s in sp.instances if s.name == WINDOW_SPAN]
    return float(np.median(got)) * 1e3 if got else None
