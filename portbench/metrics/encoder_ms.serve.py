"""Device ms a batch under the scope of the two stereo encoders (ResNet18+FPN) and their conv-stack heads."""

from portbench import readers


def read(s):
    return readers.device_ms(s, "encoder")
