"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer readers need.

From the profiler's events (host and device on one clock):

- the window: the host range ``bench.window``;
- ``busy_s``: the union of the device's kernels, copies and fills inside
  the window; ``window_s``: its length;
- by device operation, its seconds and launches (``ops``);
- ``outside_apply_s``: device seconds of the operations launched from the
  host outside every ``bench.apply_fn`` range (the handler's own work
  around the model calls: copies, casts, blends, rounding);
- the idle gaps of the device inside the window, named by the innermost
  host operation or range under way at each gap's middle (``gaps``).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

WINDOW = "bench.window"
APPLY = "bench.apply_fn"
_WALK = 5000          # host events looked back over for a gap's label


def profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclass
class Trace:
    busy_s: float
    window_s: float
    ops: dict = field(default_factory=dict)       # name -> [seconds, count]
    outside_apply_s: float = 0.0
    gaps: dict = field(default_factory=dict)      # host name -> seconds
    unlinked: int = 0

    def op_seconds(self, names) -> tuple[float, int]:
        """Seconds and launches of the device operations whose name holds
        any of ``names``."""
        s, n = 0.0, 0
        for op, (sec, cnt) in self.ops.items():
            if any(k in op for k in names):
                s += sec
                n += cnt
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v[0]] for n, v in ops],
                "idle_gaps": [[n[:160], v] for n, v in gaps]}


def reduce(prof) -> Trace:
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # the device's copies of host ranges are no device work
            if not e.is_user_annotation():
                dev.append((start, end, e.name(), e.linked_correlation_id(),
                            e.correlation_id()))
        else:
            host.append((start, end, e.name(), e.correlation_id()))
    windows = [(s, t) for s, t, name, _ in host if name == WINDOW]
    if not windows:
        raise RuntimeError(f"no {WINDOW} range in the trace")
    ws, we = windows[0]
    # A device operation is linked to the host operation or range that
    # launched it; one launched outside any (a kernel of the program's own
    # library, launched through ctypes) only to its runtime call, by the
    # runtime's correlation id. The two ids are of different counters.
    by_op = {cid: s for s, _, name, cid in host
             if cid and ("::" in name or name.startswith("bench."))}
    by_call = {cid: s for s, _, name, cid in host
               if cid and name.startswith("cu")}
    applies = sorted((s, t) for s, t, name, _ in host if name == APPLY)
    apply_starts = [s for s, _ in applies]

    def in_apply(t):
        i = bisect.bisect_right(apply_starts, t) - 1
        return i >= 0 and applies[i][1] >= t

    ops: dict = defaultdict(lambda: [0.0, 0])
    outside, unlinked, spans = 0.0, 0, []
    for s, t, name, link, corr in dev:
        s, t = max(s, ws), min(t, we)
        if t <= s:
            continue
        sec = (t - s) / 1e9
        ops[name][0] += sec
        ops[name][1] += 1
        spans.append((s, t))
        at = by_op.get(link) if link else by_call.get(corr)
        if at is None:
            unlinked += 1
        if at is None or not in_apply(at):
            outside += sec
    spans.sort()
    busy, gaps_ns, cursor = 0, [], ws
    for s, t in spans:
        if s > cursor:
            gaps_ns.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if we > cursor:
        gaps_ns.append((cursor, we))
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict = defaultdict(float)
    for a, b in gaps_ns:
        gaps[_innermost(host, starts, (a + b) // 2)] += (b - a) / 1e9
    return Trace(busy / 1e9, (we - ws) / 1e9, dict(ops), outside,
                 dict(gaps), unlinked)


def _innermost(host, starts, t) -> str:
    """The name of the latest-begun host event that is under way at t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - _WALK, -1), -1):
        if host[j][1] >= t and host[j][2] != WINDOW:
            return host[j][2]
    return WINDOW
