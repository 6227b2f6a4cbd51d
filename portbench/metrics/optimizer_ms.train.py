"""Device ms a step launched after the backward: clipping and the AdamW update."""

from portbench import readers


def read(s):
    return readers.device_ms(s, phase="optimizer")
