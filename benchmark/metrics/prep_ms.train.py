"""The host's preparation a step, in milliseconds: the union of the
program's ``beer.operands`` spans (the graph, E[T] by ``torch.func.grad``,
the bands, the lengths, the transitions) and ``beer.kl`` spans inside the
traced window, less the seconds in which the host waited on the card
inside a ``beer.sync.*`` span, over the steps traced."""

from benchmark import program_spans


def read(trace):
    s = program_spans.host_s(trace, {"beer.operands", "beer.kl"})
    if trace.task != "train" or s is None:
        return None
    return 1e3 * s / trace.calls
