"""The conjugate update's host time a step, in milliseconds: the union of
the program's ``beer.vb_update`` spans inside the traced window, less any
wait on the card inside a ``beer.sync.*`` span, over the steps traced.  The program-side twin of ``mstep_ms``, read from spans
that open and close with no synchronise."""

from benchmark import program_spans


def read(trace):
    s = program_spans.host_s(trace, {"beer.vb_update"})
    if trace.task != "train" or s is None:
        return None
    return 1e3 * s / trace.calls
