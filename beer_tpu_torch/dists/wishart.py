"""Wishart prior over a precision matrix (PyTorch).

Counterpart of ``beer_tpu/dists/wishart.py``; the flat layout is the
same, so natural parameters carry across unchanged.

Basis (P = D² + 1):
    T(Λ) = [vec(Λ), log|Λ|]
    η    = [vec(−½ W⁻¹), (ν − D − 1)/2]
    A(η) = (ν/2) log|W| + (νD/2) log 2 + log Γ_D(ν/2)

∇A gives E[Λ] = νW and E[log|Λ|] = Σ_i digamma((ν + 1 − i)/2) + D log 2
+ log|W|.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beer_tpu_torch.dists.basedist import ExpFamily, logdet_pd, sym, unvec, vec


@dataclasses.dataclass(frozen=True)
class Wishart(ExpFamily):
    dim: int

    @property
    def nat_dim(self) -> int:
        return self.dim * self.dim + 1

    def to_nat(self, scale, dof) -> torch.Tensor:
        """Scale matrix W (..., D, D) and dof ν → η (..., D² + 1)."""
        scale = torch.as_tensor(scale)
        eta1 = vec(-0.5 * torch.linalg.inv(scale))
        dof = torch.as_tensor(dof, dtype=eta1.dtype, device=eta1.device).expand(eta1.shape[:-1])
        return torch.cat([eta1, ((dof - self.dim - 1.0) / 2.0)[..., None]], dim=-1)

    def _winv_dof(self, nat: torch.Tensor):
        d = self.dim
        return unvec(-2.0 * nat[..., : d * d], d), 2.0 * nat[..., -1] + d + 1.0

    def to_std(self, nat: torch.Tensor):
        """Returns (W, ν)."""
        w_inv, dof = self._winv_dof(nat)
        return torch.linalg.inv(sym(w_inv)), dof

    def log_norm(self, nat: torch.Tensor) -> torch.Tensor:
        d = self.dim
        w_inv, dof = self._winv_dof(nat)
        return (
            -0.5 * dof * logdet_pd(w_inv)
            + 0.5 * dof * d * math.log(2.0)
            + torch.special.multigammaln(0.5 * dof, d)
        )
