"""The E-step's least time on the card (the larger of its operations over
the float32 peak and its bytes over the memory rate, counted from the
shapes) over the device time of every operation inside the ``estep``
spans, whatever kernels they are."""


def read(trace):
    ops = trace.device_in("estep")
    if trace.task != "train" or not ops:
        return None
    least = trace.least_s(trace.work["estep_flops"], trace.work["estep_bytes"]) * trace.calls
    return 100.0 * least / sum(op.seconds for op in ops)
