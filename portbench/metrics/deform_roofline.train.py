"""Least time of the step's lazy sampling calls, forward and backward, over their kernels' device time."""

from portbench import readers


def read(s):
    return readers.sampling_roofline_pct(s, ["lazy_deform_sample", "lazy_deform_sample_bwd"])
