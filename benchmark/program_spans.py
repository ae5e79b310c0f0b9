"""The program's own spans in a traced stretch.

``beer_tpu_torch`` names its layers with ``torch.profiler.record_function``
spans whose names start with ``beer.`` (``beer.estep``, ``beer.operands``,
``beer.vb_update``, ``beer.decode``, ``beer.kernel.<kernel>``, ...): host
intervals on the profiler's clock, the clock of the device operations,
opened by the program itself and never synchronised.  The readers under
``benchmark/metrics`` that read them take the union of a set of these
intervals clipped to the traced window, so a span nested in another of
the set, or repeated, counts once; on a program that opens no such span
the union is empty and the reader returns None.  Where the program
waits on the card, it says so with a ``beer.sync.<site>`` span: the
readers of host time leave those seconds out.
"""

from __future__ import annotations

PREFIX = "beer."
SYNC = "beer.sync."   # the program's own waits on the card


def _merge(ivs) -> list:
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union(trace, keep=None) -> list:
    """The union of the intervals of the program's spans whose names
    ``keep(name)`` accepts (every ``beer.*`` span when None), clipped to
    the window, as sorted disjoint [start, end] pairs in seconds."""
    lo, hi = trace.window.start, trace.window.end
    return _merge((max(op.start, lo), min(op.end, hi))
                  for name, ops in trace.spans.items()
                  if name.startswith(PREFIX) and (keep is None or keep(name))
                  for op in ops if min(op.end, hi) > max(op.start, lo))


def seconds(ivs) -> float:
    return sum(e - s for s, e in ivs)


def overlap_s(a, b) -> float:
    """The seconds two lists of sorted disjoint intervals share."""
    out, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            out += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return out


def idle_s(trace, ivs) -> float:
    """The seconds of ``ivs`` in which no device operation ran."""
    return seconds(ivs) - overlap_s(ivs, trace.busy_intervals())


def host_s(trace, names) -> float:
    """The host's seconds in the spans named in ``names`` (their union),
    less those in which it waited on the card inside a ``beer.sync.*``
    span; None where the window holds none of them."""
    ivs = union(trace, lambda name: name in names)
    if not ivs:
        return None
    return seconds(ivs) - overlap_s(ivs, union(trace, lambda name: name.startswith(SYNC)))
