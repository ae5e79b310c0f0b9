"""The hybrid step's forward (``elbo_and_stats``: the encoder, the latent
phone loop, the decoder, the statistics) at its least time on the card
(the larger of its operations over the float32 peak and its bytes over
the memory rate, counted from the shapes) over the device time of every
operation inside the benchmark's ``forward`` spans."""


def read(trace):
    ops = trace.device_in("forward")
    if trace.task != "svae_train" or not ops:
        return None
    least = trace.least_s(trace.work["forward_flops"], trace.work["forward_bytes"]) * trace.calls
    return 100.0 * least / sum(op.seconds for op in ops)
