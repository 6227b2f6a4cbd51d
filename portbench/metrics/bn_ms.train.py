"""Device ms a step in BatchNorm: its forward (module scope) and its backward (autograd nodes of that scope)."""

from portbench import readers


def read(s):
    return readers.device_ms(s, "bn")
