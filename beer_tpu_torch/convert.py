"""Weights carried across: build the port's PhoneLoop from numpy arrays.

The dict layout (numpy arrays and Python statics):

* ``modelset_prior`` / ``modelset_posterior`` (S, 4D) — NormalGamma
  natural parameters of the diagonal NormalSet,
* ``sticks_prior`` / ``sticks_posterior`` (U−1, 2) — Beta natural
  parameters of the SBCategorical unit prior,
* ``base_log_trans`` (S, S), ``log_exit`` (U,) or None,
* ``n_units``, ``states_per_unit``, ``self_loop``, ``dim``, ``cov_type``.

The natural-parameter layouts are the JAX package's, so a model
exported from either package loads into the other.  The reverse is
:meth:`beer_tpu_torch.models.phoneloop.PhoneLoop.to_numpy`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from beer_tpu_torch import dists
from beer_tpu_torch.models.categorical import SBCategorical
from beer_tpu_torch.models.normal import NormalSet
from beer_tpu_torch.models.parameters import BayesianParameter
from beer_tpu_torch.models.phoneloop import PhoneLoop


def phone_loop_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> PhoneLoop:
    """A PhoneLoop on ``device`` (default CPU) in ``dtype`` (default: the
    arrays' own floating type)."""

    def t(x):  # always a copy: the port updates its buffers in place
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    prior = t(d["modelset_prior"])
    s, p = prior.shape
    dim = int(d["dim"])
    if p != 4 * dim:
        raise ValueError(f"modelset parameters have width {p}, expected 4·dim = {4 * dim}")
    nset = NormalSet(
        BayesianParameter(prior, t(d["modelset_posterior"]), dists.NormalGamma(dim=dim)),
        cov_type=d["cov_type"], ncomp=s, dim=dim,
    )
    n_units = int(d["n_units"])
    unit_prior = SBCategorical(
        BayesianParameter(t(d["sticks_prior"]), t(d["sticks_posterior"]), dists.Beta()),
        truncation=n_units,
    )
    log_exit = None if d.get("log_exit") is None else t(d["log_exit"])
    return PhoneLoop(nset, unit_prior, t(d["base_log_trans"]), log_exit, n_units,
                     int(d["states_per_unit"]), float(d["self_loop"]))
