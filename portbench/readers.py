"""What the per-layer metrics' readers (``metrics/<name>.py``) share: each
takes the traced run's summary (:meth:`portbench.window.Traced.summary`
plus the traffic kind's ``flops_per_item``, ``peak_flops`` and
``sampling_bound_ms``; ``rate`` is items a second in an untraced stretch
before the traced window) and returns a number, or None when the trace holds
nothing for it to read."""

from __future__ import annotations

from portbench.reference.trace import kernel_pattern


def idle_pct(s):
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu_pct(s):
    """The required FLOPs at the untraced rate, over the peak."""
    return 100.0 * s["flops_per_item"] * s["rate"] / s["peak_flops"]


def idle_untraced_pct(s):
    """The idle share the traced device time an item leaves at the
    untraced rate (the traced window's host is slowed by the profiler)."""
    return 100.0 * (1.0 - s["busy_s"] / s["items"] * s["rate"])


def launches(s):
    return s["launches"] / s["items"]


def device_ms(s, scope=None, phase=None):
    """Device ms an item of the kernels launched under ``scope`` (and in
    ``phase``); None when there are none."""
    us = [d for _, d, scopes, ph in s["work"]
          if (scope is None or scope in scopes) and (phase is None or ph == phase)]
    return sum(us) / s["items"] / 1e3 if us else None


def sampling_roofline_pct(s, sources):
    """Least time of the lazy sampling calls over their kernels' device
    time, in percent."""
    patterns = [kernel_pattern(n) for n in sources]
    us = sum(d for name, d, _, _ in s["work"] if any(p.search(name) for p in patterns))
    if not us or not s.get("sampling_bound_ms"):
        return None
    return 100.0 * s["sampling_bound_ms"] * 1e3 / us


def peak_gib(s):
    return s["peak_bytes"] / 2 ** 30
