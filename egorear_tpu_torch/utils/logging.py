"""Console logging (the JAX package's ``utils/logging.py``): one stderr
handler on the ``egorear_torch`` logger, INFO and above."""

import logging
import sys

_CONFIGURED = False


def get_logger(name: str = "egorear_torch") -> logging.Logger:
    """The ``egorear_torch.<name>`` logger; the first call installs the
    handler."""
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)-7s | %(name)s - %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S"))
        root = logging.getLogger("egorear_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(f"egorear_torch.{name}")
