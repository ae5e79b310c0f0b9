"""The whole hybrid step's share of the card's float32 peak: the step's
operations counted from the shapes over the valid frames (the nnets'
GEMMs forward and backward, the latent phone loop's K1 + K11, the
emission moments and the Fisher backward; Adam's and the conjugate
update's are parameter-sized and left out) times the steps traced, over
the traced window's seconds."""


def read(trace):
    if trace.task != "svae_train":
        return None
    flops = trace.work["step_flops"] * trace.calls
    return 100.0 * flops / trace.window_s / trace.peaks["float32_flops"]
