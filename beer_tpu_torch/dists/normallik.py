"""Data-side sufficient statistics of Normal likelihoods (PyTorch).

Counterpart of ``beer_tpu/dists/normallik.py``, for the layouts the port
runs: the statistic vector lives in the conjugate prior's
natural-parameter space, so the expected log-likelihood is one product
with E[T(θ)] and the accumulation one product with the
responsibilities.  The diagonal NormalSet uses its reduced layout
(``models/normal.py``); the full-covariance one keeps raw frames on its
main path and builds xxᵀ inside the kernels (``ops/stats_kernels.py``),
so :func:`suff_stats_full` serves the plain versions and the tests.
:func:`suff_stats_diag` is the full diagonal layout, which the subspace
model's per-unit statistics are accumulated in.
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
