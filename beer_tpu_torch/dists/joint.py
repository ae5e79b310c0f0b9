"""Joint priors: K Normal means sharing one precision (PyTorch).

Counterpart of ``beer_tpu/dists/joint.py``; the flat layouts are the
same, so natural parameters carry across unchanged.  They are the
priors of the tied-covariance NormalSets (``cov_type`` "shared_full",
"shared_diagonal", "shared_isotropic").

JointNormalWishart:  p(μ_{1..K}, Λ) = Π_k N(μ_k | m_k, (κ_k Λ)⁻¹) · W(Λ|W, ν)

    T(θ) = [vec(Λ), Λμ_1, …, Λμ_K, μ_1ᵀΛμ_1, …, μ_KᵀΛμ_K, log|Λ|]
    η    = [vec(−½(W⁻¹ + Σ_k κ_k m_k m_kᵀ)), κ_1 m_1, …, −κ_1/2, …,
            (ν − D − 1 + K)/2]
    A    = (ν/2)log|W| + (νD/2)log2 + logΓ_D(ν/2) − (D/2)Σ_k log κ_k
           + (KD/2) log 2π
    P    = D² + KD + K + 1

JointNormalGamma (shared diagonal precision vector λ ∈ R^D):
    T(θ) = [λ, λμ_1, …, λμ_K, λμ_1², …, λμ_K², log λ]   (all blocks length D)
    η    = [−(b + ½Σ_k κ_k m_k²), κ_1m_1, …, −κ_1/2, …, a − 1 + K/2]
    A    = Σ_d lgamma(a_d) − a_d log b_d − ½ Σ_{k,d} log κ_{kd} + (KD/2) log2π
    P    = 2D + 2KD

JointIsotropicNormalGamma (shared scalar precision λ):
    T(θ) = [λ, λμ_1, …, λμ_K, λ‖μ_1‖², …, λ‖μ_K‖², log λ]
    η    = [−(b + ½Σ_k κ_k‖m_k‖²), κ_1m_1, …, −κ_1/2, …, a − 1 + KD/2]
    A    = lgamma(a) − a log b − (D/2) Σ_k log κ_k + (KD/2) log 2π
    P    = KD + K + 2

The matching data statistics of component k are in
``dists/normallik.py`` (``suff_stats_shared_*``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beer_tpu_torch.dists.basedist import ExpFamily, logdet_pd, sym, unvec, vec

LOG_2PI = math.log(2.0 * math.pi)


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


@dataclasses.dataclass(frozen=True)
class JointNormalWishart(ExpFamily):
    dim: int
    ncomp: int

    @property
    def nat_dim(self) -> int:
        d, k = self.dim, self.ncomp
        return d * d + k * d + k + 1

    def to_nat(self, means, scales, scale_matrix, dof) -> torch.Tensor:
        """means (..., K, D), κ (..., K), W (..., D, D), ν → η (..., P)."""
        means = torch.as_tensor(means)
        d, k = self.dim, self.ncomp
        batch = means.shape[:-2]
        scales = _like(scales, means).expand(means.shape[:-1])
        dof = _like(dof, means).expand(batch)
        w_inv = torch.linalg.inv(_like(scale_matrix, means))
        mmt = torch.einsum("...ki,...kj->...ij", scales[..., None] * means, means)
        return torch.cat([
            vec(-0.5 * (w_inv + mmt)),
            (scales[..., None] * means).reshape(*batch, k * d),
            -0.5 * scales,
            (0.5 * (dof - d - 1.0 + k))[..., None],
        ], dim=-1)

    def _split(self, nat: torch.Tensor):
        """(W⁻¹, means, κ, ν) of ``nat``."""
        d, k = self.dim, self.ncomp
        eta1 = unvec(nat[..., : d * d], d)
        eta2 = nat[..., d * d: d * d + k * d].reshape(*nat.shape[:-1], k, d)
        scales = -2.0 * nat[..., d * d + k * d: d * d + k * d + k]
        dof = 2.0 * nat[..., -1] + d + 1.0 - k
        means = eta2 / scales[..., None]
        mmt = torch.einsum("...ki,...kj->...ij", scales[..., None] * means, means)
        return -2.0 * eta1 - mmt, means, scales, dof

    def to_std(self, nat: torch.Tensor):
        """Returns (means, κs, W, ν)."""
        w_inv, means, scales, dof = self._split(nat)
        return means, scales, torch.linalg.inv(sym(w_inv)), dof

    def log_norm(self, nat: torch.Tensor) -> torch.Tensor:
        d, k = self.dim, self.ncomp
        w_inv, _, scales, dof = self._split(nat)
        return (
            -0.5 * dof * logdet_pd(w_inv)
            + 0.5 * dof * d * math.log(2.0)
            + torch.special.multigammaln(0.5 * dof, d)
            - 0.5 * d * torch.log(scales).sum(-1)
            + 0.5 * k * d * LOG_2PI
        )


@dataclasses.dataclass(frozen=True)
class JointNormalGamma(ExpFamily):
    dim: int
    ncomp: int

    @property
    def nat_dim(self) -> int:
        d, k = self.dim, self.ncomp
        return 2 * d + 2 * k * d

    def to_nat(self, means, scales, shape, rate) -> torch.Tensor:
        """means (..., K, D), κ (..., K, D), a (..., D), b (..., D) → η (..., P)."""
        means = torch.as_tensor(means)
        d, k = self.dim, self.ncomp
        batch = means.shape[:-2]
        scales = _like(scales, means).expand(means.shape)
        rate = _like(rate, means).expand(*batch, d)
        shape = _like(shape, means).expand(*batch, d)
        return torch.cat([
            -(rate + 0.5 * (scales * means**2).sum(-2)),
            (scales * means).reshape(*batch, k * d),
            (-0.5 * scales).reshape(*batch, k * d),
            shape - 1.0 + 0.5 * k,
        ], dim=-1)

    def to_std(self, nat: torch.Tensor):
        """Returns (means (..., K, D), κ (..., K, D), a (..., D), b (..., D))."""
        d, k = self.dim, self.ncomp
        eta1 = nat[..., :d]
        eta2 = nat[..., d: d + k * d].reshape(*nat.shape[:-1], k, d)
        scales = -2.0 * nat[..., d + k * d: d + 2 * k * d].reshape(*nat.shape[:-1], k, d)
        means = eta2 / scales
        shape = nat[..., d + 2 * k * d:] + 1.0 - 0.5 * k
        rate = -eta1 - 0.5 * (scales * means**2).sum(-2)
        return means, scales, shape, rate

    def log_norm(self, nat: torch.Tensor) -> torch.Tensor:
        _, scales, shape, rate = self.to_std(nat)
        return (
            (torch.lgamma(shape) - shape * torch.log(rate)).sum(-1)
            - 0.5 * torch.log(scales).sum((-1, -2))
            + 0.5 * self.ncomp * self.dim * LOG_2PI
        )


@dataclasses.dataclass(frozen=True)
class JointIsotropicNormalGamma(ExpFamily):
    dim: int
    ncomp: int

    @property
    def nat_dim(self) -> int:
        d, k = self.dim, self.ncomp
        return k * d + k + 2

    def to_nat(self, means, scales, shape, rate) -> torch.Tensor:
        """means (..., K, D), κ (..., K), a and b (...) → η (..., P)."""
        means = torch.as_tensor(means)
        d, k = self.dim, self.ncomp
        batch = means.shape[:-2]
        scales = _like(scales, means).expand(means.shape[:-1])
        shape = _like(shape, means).expand(batch)
        rate = _like(rate, means).expand(batch)
        return torch.cat([
            (-(rate + 0.5 * (scales * (means**2).sum(-1)).sum(-1)))[..., None],
            (scales[..., None] * means).reshape(*batch, k * d),
            -0.5 * scales,
            (shape - 1.0 + 0.5 * k * d)[..., None],
        ], dim=-1)

    def to_std(self, nat: torch.Tensor):
        """Returns (means (..., K, D), κ (..., K), a, b)."""
        d, k = self.dim, self.ncomp
        eta2 = nat[..., 1: 1 + k * d].reshape(*nat.shape[:-1], k, d)
        scales = -2.0 * nat[..., 1 + k * d: 1 + k * d + k]
        means = eta2 / scales[..., None]
        shape = nat[..., -1] + 1.0 - 0.5 * k * d
        rate = -nat[..., 0] - 0.5 * (scales * (means**2).sum(-1)).sum(-1)
        return means, scales, shape, rate

    def log_norm(self, nat: torch.Tensor) -> torch.Tensor:
        _, scales, shape, rate = self.to_std(nat)
        return (
            torch.lgamma(shape)
            - shape * torch.log(rate)
            - 0.5 * self.dim * torch.log(scales).sum(-1)
            + 0.5 * self.ncomp * self.dim * LOG_2PI
        )
