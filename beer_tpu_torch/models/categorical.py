"""Categorical with Dirichlet prior and its stick-breaking variant (PyTorch).

Counterpart of ``Categorical`` and ``SBCategorical`` in
``beer_tpu/models/categorical.py``.  The SBCategorical is the prior over
acoustic units in phone-loop AUD: a truncated stick-breaking process
v_i ~ Beta(1, γ), π_i = v_i Π_{j<i}(1−v_j).

Both expose the small "weight model" protocol the phone loop consumes:
``expected_log_weights()``, ``accumulate_counts(counts)``,
``vb_update(acc)`` (in place), ``kl_div_posterior_prior()``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.nn import functional as F

from beer_tpu_torch import dists
from beer_tpu_torch.device import resolve_device
from beer_tpu_torch.models.basemodel import Model
from beer_tpu_torch.models.parameters import BayesianParameter


class Categorical(Model):
    """Categorical likelihood with a Dirichlet prior over the weights."""

    def __init__(self, weights: BayesianParameter, ncat: int):
        super().__init__()
        self.weights = weights
        self.ncat = ncat

    @classmethod
    def create(cls, ncat: int, prior_strength: float = 1.0,
               dtype=torch.float32, device=None) -> "Categorical":
        """On the CUDA card unless ``device`` says otherwise."""
        fam = dists.Dirichlet(dim=ncat)
        nat = fam.to_nat(torch.full((ncat,), prior_strength, dtype=dtype,
                                    device=resolve_device(device)))
        return cls(BayesianParameter(nat, nat.clone(), fam), ncat)

    def expected_log_weights(self) -> torch.Tensor:
        """E[log π], shape (K,)."""
        return self.weights.expected_sufficient_statistics()

    def accumulate_counts(self, counts: torch.Tensor) -> Dict[str, Any]:
        return {"weights": counts}

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        """Integer class ids (T,) → one-hot (T, K); float data passes through."""
        if not data.is_floating_point():
            return F.one_hot(data.long(), self.ncat).to(self.weights.posterior.dtype)
        return data

    def infer(self, stats: torch.Tensor):
        llh = stats @ self.expected_log_weights()
        return llh, {"counts": stats.sum(0)}

    def accumulate(self, stats: torch.Tensor, cache=None) -> Dict[str, Any]:
        counts = cache["counts"] if cache else stats.sum(0)
        return self.accumulate_counts(counts)

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.weights.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "Categorical":
        self.weights.natural_update(acc["weights"], lrate)
        return self

    def mean(self) -> torch.Tensor:
        """Posterior expected weights."""
        alpha = self.weights.family.to_std(self.weights.posterior)
        return alpha / alpha.sum(-1, keepdim=True)


class SBCategorical(Model):
    """Truncated stick-breaking (Dirichlet-process) categorical.

    ``sticks`` holds K−1 Beta posteriors as a batched 2-dim Dirichlet
    parameter of shape (K−1, 2).  Weight k uses sticks 0..k:
    E[log π_k] = E[log v_k] + Σ_{j<k} E[log(1−v_j)]   (v_{K−1} ≡ 1).
    """

    def __init__(self, sticks: BayesianParameter, truncation: int):
        super().__init__()
        self.sticks = sticks
        self.truncation = truncation

    @classmethod
    def create(cls, truncation: int, concentration: float = 1.0,
               dtype=torch.float32, device=None) -> "SBCategorical":
        """On the CUDA card unless ``device`` says otherwise."""
        device = resolve_device(device)
        fam = dists.Beta()
        alpha = torch.stack(
            [
                torch.ones(truncation - 1, dtype=dtype, device=device),
                torch.full((truncation - 1,), concentration, dtype=dtype, device=device),
            ],
            dim=-1,
        )
        nat = fam.to_nat(alpha)
        return cls(BayesianParameter(nat, nat.clone(), fam), truncation)

    def expected_log_weights(self) -> torch.Tensor:
        e = self.sticks.expected_sufficient_statistics()  # (K-1, 2)
        e_log_v, e_log_1mv = e[..., 0], e[..., 1]
        zero = torch.zeros_like(e_log_v[:1])
        tail = torch.cat([zero, torch.cumsum(e_log_1mv, 0)])
        head = torch.cat([e_log_v, zero])
        return head + tail

    def accumulate_counts(self, counts: torch.Tensor) -> Dict[str, Any]:
        """counts (K,) → per-stick Beta statistics (K−1, 2).

        Stick i sees [c_i, Σ_{j>i} c_j] — its own occupancy vs everything
        broken off after it.
        """
        rev_tail = torch.flip(torch.cumsum(torch.flip(counts, (0,)), 0), (0,))
        return {"sticks": torch.stack([counts[:-1], rev_tail[1:]], dim=-1)}

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return F.one_hot(data.long(), self.truncation).to(self.sticks.posterior.dtype)

    def infer(self, stats: torch.Tensor):
        llh = stats @ self.expected_log_weights()
        return llh, {"counts": stats.sum(0)}

    def accumulate(self, stats: torch.Tensor, cache=None) -> Dict[str, Any]:
        counts = cache["counts"] if cache else stats.sum(0)
        return self.accumulate_counts(counts)

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.sticks.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "SBCategorical":
        self.sticks.natural_update(acc["sticks"], lrate)
        return self

    def mean(self) -> torch.Tensor:
        alpha = self.sticks.family.to_std(self.sticks.posterior)  # (K-1, 2)
        e_v = alpha[..., 0] / alpha.sum(-1)
        one = torch.ones_like(e_v[:1])
        rest = torch.cat([one, torch.cumprod(1.0 - e_v, 0)])
        return torch.cat([e_v, one]) * rest
