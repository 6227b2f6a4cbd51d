"""Required FLOPs an item (counted on the reference, in the lazy order) times items a second in the untraced stretch, over the configuration's precision peak."""

from portbench import readers


def read(s):
    return readers.mfu_pct(s)
