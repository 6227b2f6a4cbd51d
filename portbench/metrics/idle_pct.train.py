"""Share of the traced window in which the card ran no kernel, copy or set."""

from portbench import readers


def read(s):
    return readers.idle_pct(s)
