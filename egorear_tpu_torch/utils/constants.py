"""Small constants of the hot path, made once and kept on the device.

``torch.tensor(values, device="cuda")`` copies from pageable host memory,
and PyTorch follows such a copy with a stream synchronise: the host waits
until the card has run every kernel it queued. A constant that a forward
or a train step builds from host values on every call (a location
normaliser, a stereo baseline, a list of thresholds) so drains the launch
queue each time. :func:`device_constant` makes it once per (values,
dtype, device); later calls get the same tensor back and copy nothing.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=256)
def _made(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # A normal (not inference-mode) tensor, so a constant first made under
    # torch.inference_mode() still serves autograd later.
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made at the
    first call with these arguments and shared by every later one: callers
    read it and never write to it. ``values`` is a number or a (nested)
    tuple of numbers; entries are keyed by value, so ``(64, 64)`` and
    ``(64.0, 64.0)`` share one."""
    return _made(values, dtype, torch.device(device))
