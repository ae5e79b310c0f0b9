"""The numbers that decide ``correct``, each the gap between what the
timed path produced and what the plain reference works out again.

Training (full-batch VB-EM, learning rate 1; the first three steps of the
one model object that set-up builds and hands to the window):

* ``elbo_gap`` — the widest |ELBO − reference ELBO| over the three
  steps, in nats a valid frame;
* ``stats_gap`` — the first step's statistics, as the update gets them,
  worked out from the posterior after one step (posterior − prior), by
  the worst leaf: |‖program‖ − ‖reference‖| over the larger of the
  reference's norm of that leaf and the median leaf's;
* ``change_gap`` — the same of the posterior's change over the three
  steps.

A leaf whose reference statistics are under a thousandth of the median
leaf's is left out of both leaf gaps (none is, in the configurations of
this benchmark).

Decoding (a sample of rows drawn from the seed, a longest among them):

* ``score_gap`` — the widest |best-path score − the reference's best
  score| over the sampled rows, in nats a valid frame;
* ``path_gap`` — the widest amount by which the best path through the
  program's labels scores below the reference's best path, in nats a
  valid frame (infinite where the labels admit no path).
"""

from __future__ import annotations

import math
import statistics

import torch


def leaf_gaps(got: dict, want: dict) -> dict:
    """leaf → |‖got‖ − ‖want‖| / max(‖want‖, the median leaf's ‖want‖),
    leaves under a thousandth of the median left out."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in want}
    med = statistics.median(norms.values())
    return {k: abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k]) / max(norms[k], med)
            for k in want if norms[k] >= 1e-3 * med}


def worst_leaf_gap(got: dict, want: dict) -> float:
    return max(leaf_gaps(got, want).values())


def train_gaps(got: dict, want: dict, n_frames: int) -> dict:
    """``got`` / ``want``: ``elbos`` (three floats), ``stats`` and
    ``change`` (leaf → tensor)."""
    return {"elbo_gap": max(abs(a - b) for a, b in zip(got["elbos"], want["elbos"])) / n_frames,
            "stats_gap": worst_leaf_gap(got["stats"], want["stats"]),
            "change_gap": worst_leaf_gap(got["change"], want["change"])}


def decode_gaps(scores, best, path_best, lens) -> dict:
    """Per sampled row: the program's ``scores``, the reference's ``best``
    scores and the reference's best scores through the program's labels
    ``path_best``; ``lens`` the rows' valid frames."""
    lens = lens.double().cpu()
    scores, best, path_best = (v.double().cpu() for v in (scores, best, path_best))
    return {"score_gap": float(((scores - best).abs() / lens).max()),
            "path_gap": float(((best - path_best) / lens).max())}


def verdict(readings: dict, limits: dict) -> dict:
    """name → {"value", "limit"}; a missing or non-finite value fails."""
    return {k: {"value": readings.get(k, math.nan), "limit": limits[k]} for k in limits}


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
