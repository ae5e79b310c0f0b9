"""Device operations (kernels, copies, fills) a step, from the trace."""


def read(trace):
    ops = trace.device_in("step")
    if trace.task != "train" or not ops:
        return None
    return len(ops) / trace.calls
