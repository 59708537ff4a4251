#!/usr/bin/env python3
"""The knee of a stream cell: its open loop at several fixed rates, in one
process, the program built once.

    python3 benchmark/sweep.py --workload <stream cell> --seed <n> \
        --seconds <s> --rates 10,20,30

For each rate: the 95th percentile of the frames' latency from their due
time, the 95th percentile of the input lag, and the lag's growth (its
median over the last tenth of the frames less that over the first tenth),
which stays near zero while the program keeps up. One JSON line a rate.
The knee is the highest rate whose lag does not grow. Run once, when a
stream cell is defined; the cell's ``rate_fps`` is then fixed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH), str(BENCH / "reference")]


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)

    import numpy as np

    from vebench import manifest, runner

    m = manifest.load()
    program = None
    for rate in (float(r) for r in args.rates.split(",")):
        run = runner.prepare(m, args.workload, args.seed, args.seconds,
                             device, program=program)
        if program is None:
            runner.warm(run)
            program = run.program
        run.mix["rate_fps"] = rate
        n = int(round(rate * args.seconds))
        per = run.mix["clip_frames"]
        run.stream_frames = [run.pool[(i // per) % len(run.pool)].frames[
            i % per] for i in range(n)]
        run.windows = []
        run.keep = set()
        runner.measure(run, args.seconds, traced=False)
        d = run.delivery
        lag = (d.taken - d.due) * 1e3
        late = (np.where(np.isnan(d.out), d.t_last, d.out) - d.due) * 1e3
        tenth = max(n // 10, 1)
        print(json.dumps({
            "workload": args.workload, "rate_fps": rate, "frames": n,
            "delivered": d.frames,
            "latency_p50_ms": float(np.percentile(late, 50)),
            "latency_p95_ms": float(np.percentile(late, 95)),
            "lag_p95_ms": float(np.nanpercentile(lag, 95)),
            "lag_growth_ms": float(np.nanmedian(lag[-tenth:])
                                   - np.nanmedian(lag[:tenth]))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
