"""Vectorized Bayesian NormalSet, diagonal and full covariance (PyTorch).

Counterpart of ``NormalSet`` in ``beer_tpu/models/normal.py`` for
``cov_type`` "diagonal" and "full": one ``BayesianParameter`` whose
posterior has shape (K, P).

* diagonal — NormalGamma basis, P = 4D.  Frames use the reduced
  statistics layout [−½x², x] (2D); the constant blocks of the canonical
  4D layout are recovered in closed form (a per-component bias in the
  ELLH, a pure-count term in the accumulation).  The expected
  log-likelihood of all K components is one ``stats @ E[T]ᵀ`` product
  and accumulation is ``respsᵀ @ stats``; both run in full f32 (the
  package turns TF32 off on import).
* full — NormalWishart basis, P = D² + D + 2.  The statistics are the
  raw frames on every device (the layout of the JAX package's fused
  route): the expected log-likelihood and the accumulation go through
  :func:`~beer_tpu_torch.ops.stats_kernels.ellh_full` (K9) and
  :func:`~beer_tpu_torch.ops.stats_kernels.accumulate_full` (K10), which
  build xxᵀ tile by tile, so the (T, D²+D+2) statistics never exist on
  the main path.  ``plain_scan`` asks for their plain versions on any
  device (the reference route on the card).  The ELLH goes through
  :class:`~beer_tpu_torch.ops.stats_kernels.EllhFull`, so it is
  differentiable with respect to the frames.

:class:`Normal` is the K = 1 set with squeezed outputs (the plain VAE
prior).  The isotropic and shared covariance types are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from beer_tpu_torch import dists
from beer_tpu_torch.models.modelset import ModelSet
from beer_tpu_torch.models.parameters import BayesianParameter
from beer_tpu_torch.ops import stats_kernels

LOG_2PI = math.log(2.0 * math.pi)
# the ported cov_types → the prior family of their components
FAMILIES = {"diagonal": dists.NormalGamma, "full": dists.NormalWishart}


def _check_cov_type(cov_type: str) -> None:
    if cov_type not in FAMILIES:
        raise NotImplementedError(
            f"cov_type={cov_type!r}: only the diagonal and full NormalSets are ported "
            "so far; the isotropic and shared covariance types are still to come"
        )


def _prior_nat(cov_type: str, mean, cov, prior_strength: float):
    """The family and the natural parameters of components centred on
    ``mean`` (..., D) with the global covariance ``cov``."""
    dim = mean.shape[-1]
    k = float(prior_strength)
    fam = FAMILIES[cov_type](dim=dim)
    if cov_type == "full":
        dof = dim + k
        return fam, fam.to_nat(mean, k, torch.linalg.inv(cov) / dof, dof)
    var = torch.diagonal(cov, dim1=-2, dim2=-1) if cov.ndim >= 2 else cov
    scale = torch.full_like(mean, k)
    return fam, fam.to_nat(mean, scale, scale, k * var)


class NormalSet(ModelSet):
    """K Bayesian Normals (diagonal or full covariance) evaluated jointly."""

    def __init__(self, means_precisions: BayesianParameter, cov_type: str = "diagonal",
                 ncomp: int = 1, dim: int = 1, plain_scan: bool = False):
        super().__init__()
        _check_cov_type(cov_type)
        self.means_precisions = means_precisions
        self.cov_type = cov_type
        self.ncomp = ncomp
        self.dim = dim
        self.plain_scan = plain_scan

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

        The prior is centred on the global (mean, cov) — ``cov`` (D, D),
        or its diagonal (D,) for ``cov_type="diagonal"``; posterior means
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
        fam, prior = _prior_nat(cov_type, mean, cov, prior_strength)
        _, post = _prior_nat(cov_type, post_means, cov, prior_strength)
        prior = prior.expand(size, fam.nat_dim).clone()
        return cls(BayesianParameter(prior, post, fam), cov_type, size, dim)

    def __len__(self) -> int:
        return self.ncomp

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        """Reduced layout [−½x², x] (..., 2D) for diagonal covariance, the
        raw frames (..., D) for full covariance."""
        if self.cov_type == "full":
            return data
        return torch.cat([-0.5 * data**2, data], dim=-1)

    def infer(self, stats: torch.Tensor):
        return self.expected_log_likelihood(stats), {}

    def _diagonal_only(self, what: str) -> None:
        if self.cov_type != "diagonal":
            raise ValueError(f"{what} is only defined for the diagonal reduced-stats layout")

    def ellh_matrix(self):
        """(W (2D, K), bias (K,)) with ``expected_log_likelihood(stats)
        == stats @ W + bias`` — the affine form the fused scan kernels
        consume (diagonal covariance only)."""
        self._diagonal_only("ellh_matrix")
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
        if self.cov_type == "full":
            e_stats = self.means_precisions.expected_sufficient_statistics()
            llh = stats_kernels.EllhFull.apply(stats.reshape(-1, self.dim).contiguous(), e_stats,
                                               self.plain_scan)
            return llh.reshape(*stats.shape[:-1], self.ncomp)
        w_mat, bias = self.ellh_matrix()
        return torch.matmul(stats, w_mat) + bias

    def accumulate_from_moments(self, acc2: torch.Tensor, counts: torch.Tensor) -> Dict[str, Any]:
        """Natural-space statistics from ``acc2 (K, 2D) = Σ_t resps_t ⊗
        stats_t`` and ``counts (K,) = Σ_t resps_t`` (diagonal covariance
        only)."""
        self._diagonal_only("accumulate_from_moments")
        c = counts[..., None].expand(*counts.shape, self.dim)
        return {"means_precisions": torch.cat([acc2, -0.5 * c, 0.5 * c], dim=-1)}

    def accumulate(self, stats: torch.Tensor, resps: torch.Tensor) -> Dict[str, Any]:
        """resps (..., T, K) with stats (..., T, 2D), or (N, K) with raw
        frames (N, D) for full covariance → natural-space statistics."""
        if self.cov_type == "full":
            fn = (stats_kernels.accumulate_full_plain if self.plain_scan
                  else stats_kernels.accumulate_full)
            return {"means_precisions": fn(stats.reshape(-1, self.dim).contiguous(),
                                           resps.reshape(-1, self.ncomp).contiguous())}
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

    def to_numpy(self) -> Dict[str, Any]:
        """Natural parameters and statics; the inverse of
        :func:`beer_tpu_torch.convert.normal_set_from_numpy`."""
        mp = self.means_precisions
        return {"type": "NormalSet", "prior": mp.prior.detach().cpu().numpy(),
                "posterior": mp.posterior.detach().cpu().numpy(), "dim": self.dim,
                "cov_type": self.cov_type}


class Normal(NormalSet):
    """A single Bayesian Normal: a K = 1 NormalSet with squeezed outputs.

    Counterpart of ``Normal`` in ``beer_tpu/models/normal.py``."""

    @classmethod
    def create(cls, mean: torch.Tensor, cov: torch.Tensor, prior_strength: float = 1.0,
               cov_type: str = "full") -> "Normal":
        """Prior and posterior centred on ``mean`` with covariance ``cov``
        (no jitter); device and dtype are ``mean``'s."""
        out = NormalSet.create(mean, cov, size=1, prior_strength=prior_strength, noise_std=0.0,
                               cov_type=cov_type)
        return cls(out.means_precisions, cov_type, 1, out.dim)

    def infer(self, stats: torch.Tensor):
        """Per-frame expected log-likelihood (...,) and an empty cache."""
        return self.expected_log_likelihood(stats)[..., 0], {}

    def accumulate(self, stats: torch.Tensor, cache=None) -> Dict[str, Any]:
        return super().accumulate(stats, stats.new_ones(*stats.shape[:-1], 1))

    def to_numpy(self) -> Dict[str, Any]:
        """The inverse of :func:`beer_tpu_torch.convert.normal_from_numpy`."""
        return dict(super().to_numpy(), type="Normal")
