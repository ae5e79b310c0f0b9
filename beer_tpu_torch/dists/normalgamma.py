"""NormalGamma and IsotropicNormalGamma priors (PyTorch).

Counterpart of ``beer_tpu/dists/normalgamma.py``; the flat layouts are
the same, so natural parameters carry across unchanged.

NormalGamma, per dimension d: N(μ_d | m_d, (κ_d λ_d)⁻¹) Gamma(λ_d | a_d, b_d).
Basis (P = 4D):
    T(θ) = [λ (D), λμ (D), λμ² (D), log λ (D)]
    η    = [−(b + ½κm²), κm, −κ/2, a − ½]
    A(η) = Σ_d lgamma(a_d) − a_d log b_d − ½ log κ_d + ½ log 2π

IsotropicNormalGamma, one precision λ shared across dims (P = D + 3):
    T(θ) = [λ, λμ (D), λ‖μ‖², log λ]
    η    = [−(b + ½κ‖m‖²), κm, −κ/2, a − 1 + D/2]
    A(η) = lgamma(a) − a log b − (D/2) log κ + (D/2) log 2π
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beer_tpu_torch.dists.basedist import ExpFamily

LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class NormalGamma(ExpFamily):
    dim: int

    @property
    def nat_dim(self) -> int:
        return 4 * self.dim

    def to_nat(self, mean, scale, shape, rate) -> torch.Tensor:
        """m (..., D), κ (..., D), a (..., D), b (..., D) → η (..., 4D)."""
        mean, scale, shape, rate = torch.broadcast_tensors(mean, scale, shape, rate)
        return torch.cat(
            [-(rate + 0.5 * scale * mean**2), scale * mean, -0.5 * scale, shape - 0.5],
            dim=-1,
        )

    def to_std(self, nat: torch.Tensor):
        """Returns (m, κ, a, b)."""
        eta1, eta2, eta3, eta4 = nat.split(self.dim, dim=-1)
        scale = -2.0 * eta3
        mean = eta2 / scale
        shape = eta4 + 0.5
        rate = -eta1 - 0.5 * scale * mean**2
        return mean, scale, shape, rate

    def log_norm(self, nat: torch.Tensor) -> torch.Tensor:
        _, scale, shape, rate = self.to_std(nat)
        return (
            torch.lgamma(shape)
            - shape * torch.log(rate)
            - 0.5 * torch.log(scale)
            + 0.5 * LOG_2PI
        ).sum(-1)


@dataclasses.dataclass(frozen=True)
class IsotropicNormalGamma(ExpFamily):
    dim: int

    @property
    def nat_dim(self) -> int:
        return self.dim + 3

    def to_nat(self, mean, scale, shape, rate) -> torch.Tensor:
        """m (..., D); κ, a, b scalars (broadcastable) → η (..., D+3)."""
        mean = torch.as_tensor(mean)
        batch = mean.shape[:-1]
        scale, shape, rate = (
            torch.as_tensor(v, dtype=mean.dtype, device=mean.device).expand(batch)
            for v in (scale, shape, rate)
        )
        return torch.cat(
            [
                (-(rate + 0.5 * scale * (mean**2).sum(-1)))[..., None],
                scale[..., None] * mean,
                (-0.5 * scale)[..., None],
                (shape - 1.0 + 0.5 * self.dim)[..., None],
            ],
            dim=-1,
        )

    def to_std(self, nat: torch.Tensor):
        d = self.dim
        eta1 = nat[..., 0]
        eta2 = nat[..., 1 : 1 + d]
        scale = -2.0 * nat[..., 1 + d]
        shape = nat[..., 2 + d] + 1.0 - 0.5 * d
        mean = eta2 / scale[..., None]
        rate = -eta1 - 0.5 * scale * (mean**2).sum(-1)
        return mean, scale, shape, rate

    def log_norm(self, nat: torch.Tensor) -> torch.Tensor:
        _, scale, shape, rate = self.to_std(nat)
        return (
            torch.lgamma(shape)
            - shape * torch.log(rate)
            - 0.5 * self.dim * torch.log(scale)
            + 0.5 * self.dim * LOG_2PI
        )
