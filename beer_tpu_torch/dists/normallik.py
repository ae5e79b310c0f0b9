"""Data-side sufficient statistics of Normal likelihoods (PyTorch).

Counterpart of ``beer_tpu/dists/normallik.py``, every layout: the
statistic vector lives in the conjugate prior's natural-parameter
space, so the expected log-likelihood is one product with E[T(θ)] and
the accumulation one product with the responsibilities.

Which layouts a NormalSet's path materialises (``models/normal.py``):
the diagonal one uses its reduced layout [−½x², x]; the isotropic one
:func:`suff_stats_isotropic` (D + 3 wide); the full-covariance one keeps
raw frames and builds xxᵀ inside the kernels (``ops/stats_kernels.py``),
so :func:`suff_stats_full` serves the plain versions and the tests.
The tied-covariance ("shared_*") sets also keep raw frames: their
per-component layouts below are (..., K, P) wide, P growing with K (at
K = 64, D = 39, 4,082 floats a component a frame), and the NormalSet
computes the same contractions from x directly.  The ``shared_*``
functions here are the definitions those contractions are tested
against.  :func:`suff_stats_diag` is the full diagonal layout, which the
subspace model's per-unit statistics are accumulated in.
"""

from __future__ import annotations

import torch


def suff_stats_diag(x: torch.Tensor) -> torch.Tensor:
    """Diagonal-covariance stats s(x) = [−½x², x, −½·1, ½·1]; (..., 4D)."""
    halves = torch.full_like(x, 0.5)
    return torch.cat([-0.5 * x**2, x, -halves, halves], dim=-1)


def suff_stats_full(x: torch.Tensor) -> torch.Tensor:
    """Full-covariance stats s(x) = [vec(−½xxᵀ), x, −½, ½]; (..., D²+D+2)."""
    batch = x.shape[:-1]
    outer = -0.5 * (x[..., :, None] * x[..., None, :])
    ones = x.new_ones(batch + (1,))
    return torch.cat([outer.reshape(*batch, -1), x, -0.5 * ones, 0.5 * ones], dim=-1)


def suff_stats_isotropic(x: torch.Tensor) -> torch.Tensor:
    """Isotropic stats s(x) = [−½‖x‖², x, −½, D/2]; (..., D+3)."""
    sq = -0.5 * (x**2).sum(-1, keepdim=True)
    ones = torch.ones_like(sq)
    return torch.cat([sq, x, -0.5 * ones, 0.5 * x.shape[-1] * ones], dim=-1)


def _blocks(x: torch.Tensor, ncomp: int) -> torch.Tensor:
    """x placed in block k of component k's row: (..., K, K·D)."""
    eye = torch.eye(ncomp, dtype=x.dtype, device=x.device)
    return (eye[:, :, None] * x[..., None, None, :]).reshape(*x.shape[:-1], ncomp,
                                                           ncomp * x.shape[-1])


def suff_stats_shared_full(x: torch.Tensor, ncomp: int) -> torch.Tensor:
    """Per-component stats for JointNormalWishart: (..., K, D²+KD+K+1).

    Component k's statistic places x in mean-block k; the vec(xxᵀ) block
    and the log|Λ| slot are shared, so responsibility-weighted sums over
    k accumulate the shared precision stats with total weight 1 a frame."""
    batch, dim = x.shape[:-1], x.shape[-1]
    outer = -0.5 * (x[..., :, None] * x[..., None, :]).reshape(*batch, 1, dim * dim)
    eye = torch.eye(ncomp, dtype=x.dtype, device=x.device)
    return torch.cat([
        outer.expand(*batch, ncomp, dim * dim),
        _blocks(x, ncomp),
        (-0.5 * eye).expand(*batch, ncomp, ncomp),
        x.new_full((*batch, ncomp, 1), 0.5),
    ], dim=-1)


def suff_stats_shared_diag(x: torch.Tensor, ncomp: int) -> torch.Tensor:
    """Per-component stats for JointNormalGamma: (..., K, 2D + 2KD)."""
    batch, dim = x.shape[:-1], x.shape[-1]
    return torch.cat([
        (-0.5 * x**2)[..., None, :].expand(*batch, ncomp, dim),
        _blocks(x, ncomp),
        _blocks(x.new_full((*batch, dim), -0.5), ncomp),
        x.new_full((*batch, ncomp, dim), 0.5),
    ], dim=-1)


def suff_stats_shared_isotropic(x: torch.Tensor, ncomp: int) -> torch.Tensor:
    """Per-component stats for JointIsotropicNormalGamma: (..., K, KD+K+2)."""
    batch, dim = x.shape[:-1], x.shape[-1]
    eye = torch.eye(ncomp, dtype=x.dtype, device=x.device)
    return torch.cat([
        (-0.5 * (x**2).sum(-1))[..., None, None].expand(*batch, ncomp, 1),
        _blocks(x, ncomp),
        (-0.5 * eye).expand(*batch, ncomp, ncomp),
        x.new_full((*batch, ncomp, 1), 0.5 * dim),
    ], dim=-1)
