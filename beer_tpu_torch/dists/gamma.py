"""Gamma prior (scalar precision / concentration hyper-prior) (PyTorch).

Counterpart of ``beer_tpu/dists/gamma.py``.

Basis: T(λ) = [λ, log λ], η = [−b, a − 1] (shape (..., 2)).
A(η) = lgamma(a) − a log b.  ∇A = [a/b, digamma(a) − log b] = [E[λ], E[log λ]].
"""

from __future__ import annotations

import dataclasses

import torch

from beer_tpu_torch.dists.basedist import ExpFamily


@dataclasses.dataclass(frozen=True)
class Gamma(ExpFamily):
    @property
    def nat_dim(self) -> int:
        return 2

    def to_nat(self, shape: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
        return torch.stack([-rate, shape - 1.0], dim=-1)

    def to_std(self, nat: torch.Tensor):
        """Returns (shape a, rate b)."""
        return nat[..., 1] + 1.0, -nat[..., 0]

    def log_norm(self, nat: torch.Tensor) -> torch.Tensor:
        a, b = nat[..., 1] + 1.0, -nat[..., 0]
        return torch.lgamma(a) - a * torch.log(b)
