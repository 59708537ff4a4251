"""The 95th percentile, over the stream's frames taken, of how late the
program took each frame from the source against its due time: the
backlog in front of the handler. Host clock."""

import numpy as np


def read(run):
    d = run.delivery
    if d.taken is None:
        return None
    lag = (d.taken - d.due)[~np.isnan(d.taken)]
    return float(np.percentile(lag * 1e3, 95)) if lag.size else None
