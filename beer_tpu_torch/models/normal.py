"""Vectorized Bayesian NormalSet, diagonal covariance (PyTorch).

Counterpart of ``NormalSet`` in ``beer_tpu/models/normal.py`` for
``cov_type="diagonal"``: one ``BayesianParameter`` whose posterior has
shape (K, 4D) over the NormalGamma basis.  Frames use the reduced
statistics layout [−½x², x] (2D); the constant blocks of the canonical
4D layout are recovered in closed form (a per-component bias in the
ELLH, a pure-count term in the accumulation).

The expected log-likelihood of all K components is one
``stats @ E[T]ᵀ`` product and accumulation is ``respsᵀ @ stats``; both
run in full f32 (the package turns TF32 off on import).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from beer_tpu_torch import dists
from beer_tpu_torch.models.modelset import ModelSet
from beer_tpu_torch.models.parameters import BayesianParameter

LOG_2PI = math.log(2.0 * math.pi)


def _check_cov_type(cov_type: str) -> None:
    if cov_type != "diagonal":
        raise NotImplementedError(
            f"cov_type={cov_type!r}: only the diagonal NormalSet is ported "
            "so far; the other covariance types are ROADMAP A.4"
        )


def _diag_nat(fam: dists.NormalGamma, mean, cov, prior_strength: float):
    var = torch.diagonal(cov, dim1=-2, dim2=-1) if cov.ndim >= 2 else cov
    k = torch.full_like(mean, float(prior_strength))
    return fam.to_nat(mean, k, k, float(prior_strength) * var)


class NormalSet(ModelSet):
    """K Bayesian diagonal-covariance Normals evaluated jointly."""

    def __init__(self, means_precisions: BayesianParameter, cov_type: str = "diagonal",
                 ncomp: int = 1, dim: int = 1):
        super().__init__()
        _check_cov_type(cov_type)
        self.means_precisions = means_precisions
        self.cov_type = cov_type
        self.ncomp = ncomp
        self.dim = dim

    @classmethod
    def create(
        cls,
        mean: torch.Tensor,
        cov: torch.Tensor,
        size: int,
        prior_strength: float = 1.0,
        noise_std: float = 0.1,
        cov_type: str = "diagonal",
        generator: torch.Generator | None = None,
        init_means: torch.Tensor | None = None,
    ) -> "NormalSet":
        """K components centred on ``mean`` with jittered posterior means.

        The prior is centred on the global (mean, cov); posterior means
        get N(0, noise_std²) jitter drawn from ``generator`` (seeded with
        1 on ``mean``'s device when omitted) so VB-EM breaks symmetry.
        ``init_means`` (K, D) overrides the jittered means.  The device
        and dtype are ``mean``'s.
        """
        _check_cov_type(cov_type)
        mean = torch.as_tensor(mean)
        cov = torch.as_tensor(cov, dtype=mean.dtype, device=mean.device)
        dim = mean.shape[-1]
        if init_means is not None:
            post_means = torch.as_tensor(init_means, dtype=mean.dtype, device=mean.device)
        else:
            if generator is None:
                generator = torch.Generator(device=mean.device).manual_seed(1)
            noise = torch.randn((size, dim), generator=generator, dtype=mean.dtype,
                                device=mean.device)
            post_means = mean + noise_std * noise
        fam = dists.NormalGamma(dim=dim)
        prior = _diag_nat(fam, mean, cov, prior_strength).expand(size, 4 * dim).clone()
        post = _diag_nat(fam, post_means, cov, prior_strength)
        return cls(BayesianParameter(prior, post, fam), cov_type, size, dim)

    def __len__(self) -> int:
        return self.ncomp

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        """Reduced layout [−½x², x] (..., 2D)."""
        return torch.cat([-0.5 * data**2, data], dim=-1)

    def infer(self, stats: torch.Tensor):
        return self.expected_log_likelihood(stats), {}

    def ellh_matrix(self):
        """(W (2D, K), bias (K,)) with ``expected_log_likelihood(stats)
        == stats @ W + bias`` — the affine form the fused scan kernels
        consume."""
        e_stats = self.means_precisions.expected_sufficient_statistics()
        d = self.dim
        bias = (
            -0.5 * e_stats[:, 2 * d:3 * d].sum(-1)
            + 0.5 * e_stats[:, 3 * d:].sum(-1)
            - 0.5 * d * LOG_2PI
        )
        return e_stats[:, :2 * d].T, bias

    def expected_log_likelihood(self, stats: torch.Tensor) -> torch.Tensor:
        """(..., K) expected log-likelihood of every component."""
        w_mat, bias = self.ellh_matrix()
        return torch.matmul(stats, w_mat) + bias

    def accumulate_from_moments(self, acc2: torch.Tensor, counts: torch.Tensor) -> Dict[str, Any]:
        """Natural-space statistics from ``acc2 (K, 2D) = Σ_t resps_t ⊗
        stats_t`` and ``counts (K,) = Σ_t resps_t``."""
        c = counts[..., None].expand(*counts.shape, self.dim)
        return {"means_precisions": torch.cat([acc2, -0.5 * c, 0.5 * c], dim=-1)}

    def accumulate(self, stats: torch.Tensor, resps: torch.Tensor) -> Dict[str, Any]:
        """resps (..., T, K) with stats (..., T, 2D) → natural-space statistics."""
        acc2 = torch.einsum("...tk,...tp->...kp", resps, stats)
        return self.accumulate_from_moments(acc2, resps.sum(-2))

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.means_precisions.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "NormalSet":
        self.means_precisions.natural_update(acc["means_precisions"], lrate)
        return self

    def means(self) -> torch.Tensor:
        """Posterior expected means, (K, D)."""
        return self.means_precisions.family.to_std(self.means_precisions.posterior)[0]
