"""Peak allocated device memory over the traced window's steps."""

from portbench import readers


def read(s):
    return readers.peak_gib(s)
