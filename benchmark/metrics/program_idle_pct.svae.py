"""The share of the traced window in which no device operation ran while
the host was inside one of the program's own spans (``beer.*``, the
``beer.svae.*`` spans of the hybrid step among them; their union): the
idle time the program's host work leaves, the part of ``idle_pct.svae``
that is not the caller's."""

from benchmark import program_spans


def read(trace):
    ivs = program_spans.union(trace)
    if trace.task != "svae_train" or not ivs:
        return None
    return 100.0 * program_spans.idle_s(trace, ivs) / trace.window_s
