"""The 95th percentile, over every frame of the stream, of the time from
when the frame was due to when its output was yielded; a frame never
yielded counts as waiting until the end of the run. Host clock."""

import numpy as np


def read(run):
    d = run.delivery
    if d.due is None:
        return None
    out = np.where(np.isnan(d.out), d.t_last, d.out)
    return float(np.percentile((out - d.due) * 1e3, 95))
