"""NormalWishart prior, conjugate to a full-covariance Normal (PyTorch).

Counterpart of ``beer_tpu/dists/normalwishart.py``; the flat layout is
the same, so natural parameters carry across unchanged.

p(μ, Λ) = N(μ | m, (κΛ)⁻¹) Wishart(Λ | W, ν).

Basis (P = D² + D + 2):
    T(θ) = [vec(Λ), Λμ, μᵀΛμ, log|Λ|]
    η    = [vec(−½(W⁻¹ + κ m mᵀ)), κm, −κ/2, (ν − D)/2]
    A(η) = (ν/2) log|W| + (νD/2) log 2 + log Γ_D(ν/2)
           − (D/2) log κ + (D/2) log 2π

The matching data statistic (``dists/normallik.py``) is
s(x) = [vec(−½ x xᵀ), x, −½, ½].
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beer_tpu_torch.dists.basedist import ExpFamily, logdet_pd, sym, unvec, vec

LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class NormalWishart(ExpFamily):
    dim: int

    @property
    def nat_dim(self) -> int:
        d = self.dim
        return d * d + d + 2

    def to_nat(self, mean, scale, scale_matrix, dof) -> torch.Tensor:
        """m (..., D), κ, W (..., D, D), ν → η (..., D²+D+2)."""
        mean = torch.as_tensor(mean)
        like = dict(dtype=mean.dtype, device=mean.device)
        scale = torch.as_tensor(scale, **like).expand(mean.shape[:-1])
        dof = torch.as_tensor(dof, **like).expand(mean.shape[:-1])
        w_inv = torch.linalg.inv(torch.as_tensor(scale_matrix, **like))
        mmt = mean[..., :, None] * mean[..., None, :]
        eta1 = vec(-0.5 * (w_inv + scale[..., None, None] * mmt))
        return torch.cat(
            [eta1, scale[..., None] * mean, (-0.5 * scale)[..., None],
             (0.5 * (dof - self.dim))[..., None]],
            dim=-1,
        )

    def _winv_scale_dof(self, nat: torch.Tensor):
        """(W⁻¹, κ, ν) and the mean m of ``nat``."""
        d = self.dim
        eta1 = unvec(nat[..., : d * d], d)
        scale = -2.0 * nat[..., -2]
        dof = 2.0 * nat[..., -1] + d
        mean = nat[..., d * d : d * d + d] / scale[..., None]
        mmt = mean[..., :, None] * mean[..., None, :]
        return -2.0 * eta1 - scale[..., None, None] * mmt, scale, dof, mean

    def to_std(self, nat: torch.Tensor):
        """Returns (m, κ, W, ν)."""
        w_inv, scale, dof, mean = self._winv_scale_dof(nat)
        return mean, scale, torch.linalg.inv(sym(w_inv)), dof

    def log_norm(self, nat: torch.Tensor) -> torch.Tensor:
        d = self.dim
        w_inv, scale, dof, _ = self._winv_scale_dof(nat)
        return (
            -0.5 * dof * logdet_pd(w_inv)
            + 0.5 * dof * d * math.log(2.0)
            + torch.special.multigammaln(0.5 * dof, d)
            - 0.5 * d * torch.log(scale)
            + 0.5 * d * LOG_2PI
        )
