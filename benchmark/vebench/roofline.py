"""A kernel's share of its roofline over the traced window."""

from __future__ import annotations

from . import peaks


def share(run, kernel: str) -> float | None:
    """Percent: the bound of the kernel's calls in the window (its calls
    in one model call, times the model calls made) over the device seconds
    of its launches; None where it did not run."""
    t = run.trace
    counts = run.kernels[kernel]
    shapes = [s for k, s in run.count.kernel_calls if k == kernel]
    if t is None or not shapes or run.calls == 0:
        return None
    seconds, launches = t.op_seconds(counts.NAMES)
    if launches == 0:
        return None
    bound = run.calls * sum(
        peaks.bound_s(counts.flops(s), counts.bytes(s, run.itemsize),
                      counts.rate(run.itemsize)) for s in shapes)
    return 100.0 * bound / seconds
