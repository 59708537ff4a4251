#!/usr/bin/env python3
"""Where the card waits in a cell: one traced window, its device idle put
down to the program's spans (vebench/spans.py).

    python3 benchmark/idle_split.py --workload <name> --seed <n> \
        --seconds <s>

Set-up and the traced window are run.py's, through the same stages; the
outputs are not checked. One JSON line: the cell's end-to-end metric read
on the traced window, ``busy_s`` and ``window_s``, the device operations
not linked to a launch, the model calls; the handler's four quantities of
vebench/spans.py; and by span name its instances, instances a window,
and seconds of idle, launched device work, self time and duration, with
the idle under no program span by ``bench.*`` range. Where the program
opens no spans the span figures are empty and the rest still reads. Not
part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH), str(BENCH / "reference")]


def _power() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from vebench import manifest, runner, spans, trace

    m = manifest.load()
    run = runner.prepare(m, args.workload, args.seed, args.seconds, device)
    runner.warm(run)
    got = {}
    reduce_trace = trace.reduce

    def reduce_both(prof):          # the run's own reduction, and the spans
        t = time.perf_counter()
        got["spans"] = spans.reduce(prof)
        got["reduce_s"] = time.perf_counter() - t
        return reduce_trace(prof)

    trace.reduce = reduce_both
    try:
        runner.measure(run, args.seconds, traced=True)
    finally:
        trace.reduce = reduce_trace
    sp, t = got["spans"], run.trace
    windows = sum(s.name == spans.WINDOW_SPAN for s in sp.instances)
    by_name: dict = defaultdict(lambda: [0, 0.0, 0.0, 0.0, 0.0])
    for s in sp.instances:
        row = by_name[s.name]
        row[0] += 1
        row[1] += s.idle_s
        row[2] += s.device_s
        row[3] += s.self_s
        row[4] += s.dur_s
    e2e = {}
    for spec in manifest.metrics_of(m, args.workload, False):
        if spec["name"] != "setup_s":
            e2e[spec["name"]] = manifest.reader(spec["name"])(run)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "power": _power(),
        "traced": e2e, "busy_s": t.busy_s, "window_s": t.window_s,
        "device_idle_share": 1.0 - t.busy_s / t.window_s,
        "unlinked": t.unlinked, "model_calls": run.calls,
        "frames": run.delivery.frames, "windows": windows,
        "spans_reduce_s": got["reduce_s"],
        "handler_idle_share": spans.handler_idle_share(sp, t.window_s),
        "model_call_idle_share": spans.model_call_idle_share(sp, t.window_s),
        "window_idle_ms_p50": spans.window_idle_ms_p50(sp),
        "handler_window_ms_p50": spans.handler_window_ms_p50(sp),
        "idle_put_down_s": sp.total_idle_s(),
        "rest_s": sp.rest,
        "spans": {name: {"n": r[0], "per_window": r[0] / max(windows, 1),
                         "idle_s": r[1], "device_s": r[2], "self_s": r[3],
                         "dur_s": r[4]}
                  for name, r in sorted(by_name.items())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
