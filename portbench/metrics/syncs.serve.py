"""The program's blocking host-device syncs a batch: its ``syncs`` counter
under its top-level ``forward`` spans, over the traced window's batches."""


def read(s):
    try:
        from egorear_tpu_torch.utils import trace
    except ImportError:  # a program without spans of its own
        return None
    got = trace.under(trace.collected(), "forward")
    return None if got is None else got[1].get("syncs", 0) / s["items"]
