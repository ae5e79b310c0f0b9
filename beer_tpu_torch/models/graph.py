"""HMM state graphs: the compiled form the scans consume (PyTorch).

Counterpart of ``LOG_ZERO`` and ``CompiledGraph`` in
``beer_tpu/models/graph.py``.  The ``Graph`` construction API comes with the
HMM port.
"""

from __future__ import annotations

import dataclasses

import torch

LOG_ZERO = -1e30


@dataclasses.dataclass
class CompiledGraph:
    """Dense representation of a shared graph.

    ``pdf_ids`` maps each state to its emission pdf index (< n_pdfs);
    several states may share one pdf (tied emissions).
    """

    log_init: torch.Tensor    # (S,)
    log_final: torch.Tensor   # (S,)
    log_trans: torch.Tensor   # (S, S), [i, j] = log p(j | i)
    pdf_ids: torch.Tensor     # (S,) int
    n_states: int = 0
    n_pdfs: int = 0
