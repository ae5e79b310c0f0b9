"""The host's preparation a call, in milliseconds: the union of the
program's ``beer.operands`` spans (the effective graph, E[T] by
``torch.func.grad``, the bands, the Viterbi's lengths and log-bands) and
``beer.kl`` spans (none in a decode) inside the traced window, less the
seconds in which the host waited on the card inside a ``beer.sync.*``
span, over the calls traced."""

from benchmark import program_spans


def read(trace):
    s = program_spans.host_s(trace, {"beer.operands", "beer.kl"})
    if trace.task != "decode" or s is None:
        return None
    return 1e3 * s / trace.calls
