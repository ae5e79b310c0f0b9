"""The decode's least time on the card (the larger of its operations over
the float32 peak and its bytes over the memory rate, counted from the
shapes) over the device time of every operation inside the ``decode``
spans, whatever kernels they are."""


def read(trace):
    ops = trace.device_in("decode")
    if trace.task != "decode" or not ops:
        return None
    least = trace.least_s(trace.work["decode_flops"], trace.work["decode_bytes"]) * trace.calls
    return 100.0 * least / sum(op.seconds for op in ops)
