"""Least time of the forward's lazy sampling calls over their kernels' device time."""

from portbench import readers


def read(s):
    return readers.sampling_roofline_pct(s, ["lazy_deform_sample"])
