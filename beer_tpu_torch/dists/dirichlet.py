"""Dirichlet prior (conjugate to Categorical), and Beta (PyTorch).

Counterpart of ``beer_tpu/dists/dirichlet.py``.  T(π) = log π, natural
parameters η = α − 1, A(η) = Σ lgamma(α) − lgamma(Σ α); E[log π] =
digamma(α) − digamma(Σα) falls out of ∇A.
"""

from __future__ import annotations

import dataclasses

import torch

from beer_tpu_torch.dists.basedist import ExpFamily


@dataclasses.dataclass(frozen=True)
class Dirichlet(ExpFamily):
    dim: int

    @property
    def nat_dim(self) -> int:
        return self.dim

    def to_nat(self, alpha: torch.Tensor) -> torch.Tensor:
        return alpha - 1.0

    def to_std(self, nat: torch.Tensor) -> torch.Tensor:
        """Concentration α."""
        return nat + 1.0

    def log_norm(self, nat: torch.Tensor) -> torch.Tensor:
        alpha = nat + 1.0
        return torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))


@dataclasses.dataclass(frozen=True)
class Beta(Dirichlet):
    """Beta(a, b) = Dirichlet on 2 categories; used by stick-breaking."""

    dim: int = 2
