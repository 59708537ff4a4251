"""Device milliseconds a delivered frame of the kernels and copies
launched outside the model calls (the handler's uploads, casts, tiles,
blend, rounding and downloads). Device trace."""


def read(run):
    t = run.trace
    if t is None or run.delivery.frames == 0:
        return None
    return 1e3 * t.outside_apply_s / run.delivery.frames
