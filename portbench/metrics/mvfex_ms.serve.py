"""Device ms a batch under the scope of the MVFex refiners."""

from portbench import readers


def read(s):
    return readers.device_ms(s, "mvfex")
