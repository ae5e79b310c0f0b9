"""The whole decode's share of the card's float32 peak: the decode's
operations counted from the shapes times the calls traced, over the
traced window's seconds."""


def read(trace):
    if trace.task != "decode":
        return None
    flops = trace.work["decode_flops"] * trace.calls
    return 100.0 * flops / trace.window_s / trace.peaks["float32_flops"]
