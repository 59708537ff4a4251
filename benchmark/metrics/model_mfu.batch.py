"""The model step's share of the card's bf16 peak, in percent: the
operations of one model call counted from its shapes in set-up (the
products the reference runs as library calls, plus the frozen formulas of
the kernels), times the model calls made in the traced window, over the
window's seconds times 989 TFLOP/s. Device trace for the window."""

from vebench import peaks


def read(run):
    t = run.trace
    if t is None or run.calls == 0:
        return None
    return 100.0 * run.count.flops * run.calls / (t.window_s
                                                  * peaks.FLOPS["bf16"])
