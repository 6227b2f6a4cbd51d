"""Device ms a step launched by the autograd engine."""

from portbench import readers


def read(s):
    return readers.device_ms(s, phase="backward")
