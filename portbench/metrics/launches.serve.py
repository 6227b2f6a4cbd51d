"""Device kernels, copies and sets an item, counted in the trace."""

from portbench import readers


def read(s):
    return readers.launches(s)
