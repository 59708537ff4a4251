"""The median, over the stream's windows delivered, of the milliseconds
from when the window's last input frame was taken to when its output
frames were yielded. Host clock."""

import numpy as np


def read(run):
    d = run.delivery
    if d.due is None:
        return None
    spans = [d.out[w[2][-1]] - d.taken[max(w[1])] for w in run.windows
             if w[2] and not np.isnan(d.out[w[2][-1]])]
    return float(np.median(spans)) * 1e3 if spans else None
