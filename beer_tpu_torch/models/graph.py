"""HMM state graphs (PyTorch).

Counterpart of ``beer_tpu/models/graph.py``: an FST-like builder —
states, weighted arcs, start/end states — that ``normalize()``s arc
weights into per-state transition distributions and ``compile()``s to
the dense log-matrices the scans consume (:class:`CompiledGraph`), plus
the standard constructors the recipes use (left-to-right unit HMMs,
ergodic HMMs, phone loops, bigram unit LMs, per-utterance transcription
graphs).  The builder is plain Python; only the compiled graph holds
tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from beer_tpu_torch.device import resolve_device

LOG_ZERO = -1e30


@dataclasses.dataclass
class CompiledGraph:
    """Dense representation of a graph.

    ``pdf_ids`` maps each state to its emission pdf index (< n_pdfs);
    several states may share one pdf (tied emissions).  Per-utterance
    graphs carry a leading batch axis: ``pdf_ids``/``log_init``/
    ``log_final`` (B, S) and, unless the transition structure is shared,
    ``log_trans`` (B, S, S).  ``l2r_banded`` marks a shared purely
    left-to-right matrix (diagonal + first superdiagonal), which decode
    takes through the banded Viterbi kernels.
    """

    log_init: torch.Tensor    # (S,) or (B, S)
    log_final: torch.Tensor   # (S,) or (B, S)
    log_trans: torch.Tensor   # (S, S) or (B, S, S), [..., i, j] = log p(j | i)
    pdf_ids: torch.Tensor     # (S,) or (B, S) int
    n_states: int = 0
    n_pdfs: int = 0
    l2r_banded: bool = False

    def expand_llh(self, per_pdf_llh: torch.Tensor) -> torch.Tensor:
        """(..., n_pdfs) per-pdf log-likelihoods → (..., S) per-state.

        With per-utterance ``pdf_ids`` (B, S) and ``per_pdf_llh`` (B, T,
        n_pdfs) this is an exact ``torch.gather`` (no selection product)."""
        ids = self.pdf_ids.long()
        if ids.ndim == 2:
            b, t_len, _ = per_pdf_llh.shape
            return torch.gather(per_pdf_llh, -1, ids[:, None, :].expand(b, t_len, ids.shape[-1]))
        return per_pdf_llh[..., ids]


class Graph:
    """Mutable HMM-graph builder."""

    def __init__(self):
        self._pdf_of_state: List[int] = []
        self._arcs: Dict[Tuple[int, int], float] = {}
        self._init: Dict[int, float] = {}
        self._final: Dict[int, float] = {}

    # -- construction ---------------------------------------------------
    def add_state(self, pdf_id: int) -> int:
        self._pdf_of_state.append(int(pdf_id))
        return len(self._pdf_of_state) - 1

    def add_arc(self, src: int, dst: int, weight: float = 1.0) -> None:
        self._arcs[(src, dst)] = self._arcs.get((src, dst), 0.0) + float(weight)

    def set_init(self, state: int, weight: float = 1.0) -> None:
        self._init[state] = float(weight)

    def set_final(self, state: int, weight: float = 1.0) -> None:
        self._final[state] = float(weight)

    @property
    def n_states(self) -> int:
        return len(self._pdf_of_state)

    # -- normalization + compilation -------------------------------------
    def normalize(self) -> None:
        """Scale outgoing arc weights (incl. final) to sum to 1 per state,
        and initial weights to sum to 1."""
        out_sums = [0.0] * self.n_states
        for (s, _), w in self._arcs.items():
            out_sums[s] += w
        for s, w in self._final.items():
            out_sums[s] += w
        for (s, d) in list(self._arcs):
            if out_sums[s] > 0:
                self._arcs[(s, d)] /= out_sums[s]
        for s in list(self._final):
            if out_sums[s] > 0:
                self._final[s] /= out_sums[s]
        z = sum(self._init.values())
        if z > 0:
            for s in list(self._init):
                self._init[s] /= z

    def compile(self, dtype=torch.float32, device=None) -> CompiledGraph:
        """The dense graph on the CUDA card unless ``device`` says otherwise."""
        device = resolve_device(device)
        n = self.n_states
        trans = np.full((n, n), LOG_ZERO, dtype=np.float64)
        init = np.full(n, LOG_ZERO, dtype=np.float64)
        final = np.full(n, LOG_ZERO, dtype=np.float64)
        for (s, d), w in self._arcs.items():
            if w > 0:
                trans[s, d] = math.log(w)
        for s, w in self._init.items():
            if w > 0:
                init[s] = math.log(w)
        for s, w in self._final.items():
            if w > 0:
                final[s] = math.log(w)
        pdf_ids = np.asarray(self._pdf_of_state, dtype=np.int64)
        n_pdfs = int(pdf_ids.max()) + 1 if n else 0
        f = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
        return CompiledGraph(f(init), f(final), f(trans),
                             torch.tensor(pdf_ids, device=device), n, n_pdfs)


# ----------------------------------------------------------------------
# Standard constructors
# ----------------------------------------------------------------------
def left_to_right(n_states: int, first_pdf: int = 0, self_loop: float = 0.5) -> Graph:
    """A left-to-right unit HMM: self-loop + advance per state."""
    g = Graph()
    states = [g.add_state(first_pdf + i) for i in range(n_states)]
    for i, s in enumerate(states):
        g.add_arc(s, s, self_loop)
        if i + 1 < n_states:
            g.add_arc(s, states[i + 1], 1.0 - self_loop)
    g.set_init(states[0])
    g.set_final(states[-1], 1.0 - self_loop)
    g.normalize()
    return g


def ergodic(n_states: int, self_loop: float = 0.5) -> Graph:
    """Fully-connected HMM: every state reaches every state (BASELINE
    config 2)."""
    g = Graph()
    states = [g.add_state(i) for i in range(n_states)]
    out = (1.0 - self_loop) / max(n_states - 1, 1)
    for s in states:
        for t in states:
            g.add_arc(s, t, self_loop if s == t else out)
        g.set_init(s)
        g.set_final(s, 0.1)
    g.normalize()
    return g


def phone_loop_graph(n_units: int, states_per_unit: int, self_loop: float = 0.5,
                     lm_trans=None, lm_init=None) -> Graph:
    """N left-to-right unit HMMs in a loop.

    Unit u owns pdfs [u·P, (u+1)·P) and states likewise; every unit's
    last state connects to every unit's first state, weighted by the
    bigram unit LM ``lm_trans`` (U, U) / ``lm_init`` (U,) (uniform by
    default)."""
    if lm_trans is None:
        lm_trans = np.full((n_units, n_units), 1.0 / n_units)
    if lm_init is None:
        lm_init = np.full(n_units, 1.0 / n_units)
    g = Graph()
    starts, ends = [], []
    for u in range(n_units):
        states = [g.add_state(u * states_per_unit + i) for i in range(states_per_unit)]
        for i, s in enumerate(states):
            g.add_arc(s, s, self_loop)
            if i + 1 < states_per_unit:
                g.add_arc(s, states[i + 1], 1.0 - self_loop)
        starts.append(states[0])
        ends.append(states[-1])
        g.set_init(states[0], float(lm_init[u]))
        g.set_final(states[-1], (1.0 - self_loop) * 0.5)
    exit_mass = (1.0 - self_loop) * 0.5
    for u, e in enumerate(ends):
        row = lm_trans[u] / max(float(np.sum(lm_trans[u])), 1e-30)
        for v, s in enumerate(starts):
            if row[v] > 0:
                g.add_arc(e, s, exit_mass * float(row[v]))
    g.normalize()
    return g


def bigram_lm(transcriptions, n_units: int, smoothing: float = 0.5):
    """ML bigram unit LM from transcriptions (add-``smoothing`` counts).

    Returns (lm_trans (U, U), lm_init (U,)) numpy arrays for
    :func:`phone_loop_graph`."""
    trans = np.full((n_units, n_units), smoothing)
    init = np.full(n_units, smoothing)
    for seq in transcriptions:
        if len(seq):
            init[seq[0]] += 1
        for a, b in zip(seq[:-1], seq[1:]):
            trans[a, b] += 1
    return trans / trans.sum(1, keepdims=True), init / init.sum()


def transcription_graphs(transcriptions, n_phones: int, states_per_phone: int,
                         self_loop: float = 0.5, dtype=torch.float32, shared: bool = True,
                         device=None) -> CompiledGraph:
    """Per-utterance forced-alignment graphs from phone transcriptions
    (the supervised recognizer, BASELINE config 3).

    Each utterance's graph is the left-to-right concatenation of its
    transcription's phone HMMs; phone p owns pdfs [p·P, (p+1)·P).
    ``shared=True``: one left-to-right (S, S) chain padded to the longest
    transcription serves the whole batch, with per-utterance
    ``log_final`` and ``pdf_ids`` (B, S).  This is exact: a shorter
    utterance's padding states never feed back into its real states and
    carry zero final weight.  ``shared=False`` materialises per-utterance
    (B, S, S) matrices and (B, S) init (the general path and the oracle).
    The graphs are built on the CUDA card unless ``device`` says otherwise.
    """
    device = resolve_device(device)
    p = states_per_phone
    b = len(transcriptions)
    s_max = max(len(t) for t in transcriptions) * p
    final = np.full((b, s_max), LOG_ZERO)
    pdf_ids = np.zeros((b, s_max), np.int64)
    log_sl = math.log(self_loop)
    log_adv = math.log(1.0 - self_loop)
    for i, phones in enumerate(transcriptions):
        n_states = len(phones) * p
        for j in range(n_states):
            pdf_ids[i, j] = phones[j // p] * p + (j % p)
        final[i, n_states - 1] = log_adv
    if shared:
        trans = np.full((s_max, s_max), LOG_ZERO)
        for j in range(s_max):
            trans[j, j] = log_sl
            if j + 1 < s_max:
                trans[j, j + 1] = log_adv
        init = np.full(s_max, LOG_ZERO)
        init[0] = 0.0
    else:
        trans = np.full((b, s_max, s_max), LOG_ZERO)
        init = np.full((b, s_max), LOG_ZERO)
        for i, phones in enumerate(transcriptions):
            n_states = len(phones) * p
            for j in range(n_states):
                trans[i, j, j] = log_sl
                if j + 1 < n_states:
                    trans[i, j, j + 1] = log_adv
            init[i, 0] = 0.0
    f = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return CompiledGraph(f(init), f(final), f(trans), torch.tensor(pdf_ids, device=device),
                         s_max, n_phones * p, l2r_banded=shared)
