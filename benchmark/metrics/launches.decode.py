"""Device operations (kernels, copies, fills) a decode call, the copy of
the labels to the host included, from the trace."""


def read(trace):
    ops = trace.device_in("call")
    if trace.task != "decode" or not ops:
        return None
    return len(ops) / trace.calls
