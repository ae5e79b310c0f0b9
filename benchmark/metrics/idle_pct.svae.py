"""The share of the traced window in which no device operation ran: one
less the union of the device operations' intervals over the window."""


def read(trace):
    if trace.task != "svae_train":
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
