#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. Set-up makes the cell's input frames from the seed, builds the
port's streaming handler for the cell's configuration and warms the
cell's own shapes; then the window runs for ``--seconds`` (clips back to
back, or one stream at the cell's frame rate); then the program is freed
and a sample of its delivered frames is checked against the plain
reference. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number with its limit, which also end standard error.

Without a CUDA device, or with fewer than the cell asks for, or where the
run loaded JAX or the JAX package, it prints no result and exits with a
code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT), str(BENCH), str(BENCH / "reference")]

# top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "video_enhancer_tpu")


def loaded_forbidden() -> list[str]:
    return sorted({name.partition(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _power_limit() -> str:
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
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from vebench import check, manifest, runner

    t_import = time.perf_counter() - T_START

    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell asks for {cell['chips']} CUDA device(s); {have} "
              f"available", file=sys.stderr)
        return 3
    traced = bool(args.trace)
    run = runner.prepare(m, args.workload, args.seed, args.seconds, device)
    runner.warm(run)
    run.setup_s = time.perf_counter() - T_START
    parts = {"imports": t_import, **run.parts}
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f" total {run.setup_s:.3f} s", file=sys.stderr)
    runner.measure(run, args.seconds, traced)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    runner.free_program(run)
    runner.load_reference(run)

    metrics = {}
    for spec in manifest.metrics_of(m, args.workload, traced):
        value = manifest.reader(spec["name"])(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}

    limits = run.config["limits"]
    numbers = runner.check_outputs(run)
    lost = runner.missing(run)
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    checks["missing_frames"] = {"value": lost, "limit": 0}
    correct = (numbers["windows"] > 0 and lost == 0
               and check.judge(numbers, limits))
    d = run.delivery
    result = {
        "correct": correct,
        "attempted": d.frames + lost,
        "failed": lost,
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": peak,
                   "power": _power_limit() if device == "cuda" else "none"},
    }
    if traced:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    found = loaded_forbidden()
    if found:
        print(f"the run loaded {found}: the benchmark and the port may not "
              f"import JAX or the JAX package", file=sys.stderr)
        return 4
    if traced:
        print(f"trace: {run.trace.unlinked} device operations not linked to "
              f"a host launch", file=sys.stderr)
    print(f"checked {numbers['frames']} frames of {numbers['windows']} "
          f"windows", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
