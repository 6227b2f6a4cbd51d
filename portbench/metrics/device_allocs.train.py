"""The caching allocator's device allocations a step: the program's
``device_allocs`` counter under its ``train.step`` spans, over the traced
window's steps."""


def read(s):
    try:
        from egorear_tpu_torch.utils import trace
    except ImportError:  # a program without spans of its own
        return None
    got = trace.under(trace.collected(), "train.step")
    return None if got is None else got[1].get("device_allocs", 0) / s["items"]
