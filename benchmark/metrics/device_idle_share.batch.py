"""The share of the traced window in which no kernel, copy or fill ran
on the device (a fraction of 1). Device trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
