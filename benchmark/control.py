#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell,
in one process.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--control 3] [--modes fp8,fp8_products]

For each seed: the cell's inputs from the seed, a short window of the
cell's own traffic through the program (built once), and the compared
numbers of the program's frames against the plain reference (float32,
TF32 off): the lower readings. For the first ``--control`` seeds also the
numbers of each control in ``--modes``: the reference itself in the
program's place in that mode of ``plain.Ops``, against the same
reference: ``fp8``, every tensor the program holds in bfloat16 rounded to
float8 e4m3 (the step below the configuration's bfloat16);
``fp8_products``, only the operands of the learned products (linears and
convs) so rounded. The upper readings. One JSON line a seed. Not part of a benchmark run.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--modes", default="fp8")
    args = ap.parse_args(argv)

    from vebench import manifest, runner

    m = manifest.load()
    program = None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = runner.prepare(m, args.workload, seed, args.seconds, device,
                             program=program)
        if program is None:
            runner.warm(run)
            program = run.program
        runner.measure(run, args.seconds, traced=False)
        runner.load_reference(run)
        modes = args.modes.split(",") if i < args.control else []
        numbers = runner.compare(run, [None, *modes])
        line = {"workload": args.workload, "seed": seed,
                "delivered": run.delivery.frames,
                "missing": runner.missing(run), "program": numbers[0]}
        for mode, got in zip(modes, numbers[1:]):
            line["control" if mode == "fp8" else mode] = got
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
