"""The whole VB step's share of the card's float32 peak: the E-step's
operations counted from the shapes (the conjugate update's are
parameter-sized and left out) times the steps traced, over the traced
window's seconds."""


def read(trace):
    if trace.task != "train":
        return None
    flops = trace.work["step_flops"] * trace.calls
    return 100.0 * flops / trace.window_s / trace.peaks["float32_flops"]
