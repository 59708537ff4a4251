"""The ssd_shared kernel's share of its roofline, in percent: the least time
its calls of the traced window could take (for each, the larger of its
operations over the peak at its rate and its bytes over 3.35 TB/s, by
counts/ssd_shared.py at the shapes the model calls it with) over the device
time of its launches. Device trace."""

from vebench import roofline


def read(run):
    return roofline.share(run, "ssd_shared")
