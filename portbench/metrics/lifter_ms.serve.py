"""Device ms a batch under the scope of pose3d_estimator (proposal, projection, lifting layers)."""

from portbench import readers


def read(s):
    return readers.device_ms(s, "lifter")
