"""The hybrid step's backward (through both nnets and the Fisher backward
of ``PhoneLoopLogZ``) at its least time on the card (the larger of its
operations over the float32 peak and its bytes over the memory rate,
counted from the shapes) over the device time of every operation inside
the benchmark's ``backward`` spans."""


def read(trace):
    ops = trace.device_in("backward")
    if trace.task != "svae_train" or not ops:
        return None
    least = trace.least_s(trace.work["backward_flops"], trace.work["backward_bytes"]) * trace.calls
    return 100.0 * least / sum(op.seconds for op in ops)
