"""The conjugate update's wall time a step, in milliseconds: in a traced
run every step of the window synchronises before and after its update,
and the update's seconds are summed over the whole window (hundreds of
steps, so the sum spans hundreds of milliseconds of the host's clock)."""


def read(trace):
    calls = trace.totals.get("mstep_calls", 0)
    if trace.task != "train" or not calls:
        return None
    return 1e3 * trace.totals["mstep_s"] / calls
