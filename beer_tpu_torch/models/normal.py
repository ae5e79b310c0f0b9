"""Vectorized Bayesian NormalSet, every covariance type (PyTorch).

Counterpart of ``NormalSet`` in ``beer_tpu/models/normal.py``.  One
``BayesianParameter``: for the per-component types its posterior has
shape (K, P); for the tied ("shared_*") types all K components live in
one Joint* prior of shape (P,).

* diagonal — NormalGamma basis, P = 4D.  Frames use the reduced
  statistics layout [−½x², x] (2D), written in one pass by
  :func:`~beer_tpu_torch.ops.stats_kernels.diag_stats` (its plain version
  with ``plain_scan``, or for frames that need a gradient); the constant
  blocks of the canonical 4D layout are recovered in closed form (a
  per-component bias in the ELLH, a pure-count term in the
  accumulation).  The expected
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
* isotropic — IsotropicNormalGamma basis, P = D + 3, the JAX package's
  layout [−½‖x‖², x, −½, D/2]: one ``stats @ E[T]ᵀ`` product and one
  ``respsᵀ @ stats``.
* shared_full (alias "shared"), shared_diagonal, shared_isotropic —
  JointNormalWishart, JointNormalGamma, JointIsotropicNormalGamma.  The
  JAX package scores a (T, K, P) per-component layout
  (``dists/normallik.py``) whose width P grows with K; here the
  statistics are the raw frames (..., D) and the same contractions are
  taken from x: the ELLH of component k is the shared quadratic term
  (−½ xᵀE[Λ]x, −½ x²·E[λ] or −½‖x‖²E[λ]) plus x·E[Λμ_k] plus a
  per-component constant, and the accumulation is Σ_t w_t·(the shared
  block of x_t), respsᵀ @ x and the counts.  Plain torch on every
  device; no kernel (none of the JAX package's routes has one).

:class:`Normal` is the K = 1 set with squeezed outputs (the plain VAE
prior).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from beer_tpu_torch import dists
from beer_tpu_torch.dists import normallik
from beer_tpu_torch.models.modelset import ModelSet
from beer_tpu_torch.models.parameters import BayesianParameter
from beer_tpu_torch.ops import stats_kernels
from beer_tpu_torch.utils.profiling import named_scope, scoped

LOG_2PI = math.log(2.0 * math.pi)
# cov_type → the prior family of its components (the "shared_*" ones
# take (dim, ncomp))
FAMILIES = {
    "diagonal": dists.NormalGamma,
    "full": dists.NormalWishart,
    "isotropic": dists.IsotropicNormalGamma,
    "shared_full": dists.JointNormalWishart,
    "shared_diagonal": dists.JointNormalGamma,
    "shared_isotropic": dists.JointIsotropicNormalGamma,
}
SHARED = ("shared_full", "shared_diagonal", "shared_isotropic")
ALIASES = {"shared": "shared_full"}     # the reference's name for tied full covariance


def canonical_cov_type(cov_type: str) -> str:
    """``cov_type`` with the reference's alias resolved; raises on an
    unknown one."""
    cov_type = ALIASES.get(cov_type, cov_type)
    if cov_type not in FAMILIES:
        raise ValueError(f"unknown cov_type: {cov_type}")
    return cov_type


def family(cov_type: str, dim: int, ncomp: int):
    """The prior family of a set of ``ncomp`` components of ``cov_type``."""
    if cov_type in SHARED:
        return FAMILIES[cov_type](dim=dim, ncomp=ncomp)
    return FAMILIES[cov_type](dim=dim)


def _prior_nat(cov_type: str, mean, cov, prior_strength: float):
    """The family and the natural parameters of components centred on
    ``mean`` (..., D) with the global covariance ``cov`` (per-component
    types), or of the joint prior over the K means ``mean`` (K, D)
    (the "shared_*" types)."""
    dim = mean.shape[-1]
    k = float(prior_strength)
    fam = family(cov_type, dim, mean.shape[0] if cov_type in SHARED else 1)
    if cov_type in ("full", "shared_full"):
        dof = dim + k
        return fam, fam.to_nat(mean, k, torch.linalg.inv(cov) / dof, dof)
    var = torch.diagonal(cov, dim1=-2, dim2=-1) if cov.ndim >= 2 else cov
    if cov_type in ("isotropic", "shared_isotropic"):
        return fam, fam.to_nat(mean, k, k, k * var.mean())
    if cov_type == "shared_diagonal":
        return fam, fam.to_nat(mean, k, k, k * var)
    scale = torch.full_like(mean, k)
    return fam, fam.to_nat(mean, scale, scale, k * var)


class NormalSet(ModelSet):
    """K Bayesian Normals of one covariance type evaluated jointly."""

    def __init__(self, means_precisions: BayesianParameter, cov_type: str = "diagonal",
                 ncomp: int = 1, dim: int = 1, plain_scan: bool = False):
        super().__init__()
        self.means_precisions = means_precisions
        self.cov_type = canonical_cov_type(cov_type)
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
        or its diagonal (D,) for the diagonal and isotropic types (an
        isotropic prior takes the mean variance); posterior means get
        N(0, noise_std²) jitter drawn from ``generator`` (seeded with 1 on
        ``mean``'s device when omitted) so VB-EM breaks symmetry.
        ``init_means`` (K, D) overrides the jittered means.  ``cov_type``
        is one of "diagonal", "full", "isotropic", "shared_full" (or its
        alias "shared"), "shared_diagonal", "shared_isotropic".  The
        device and dtype are ``mean``'s.
        """
        cov_type = canonical_cov_type(cov_type)
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
        if cov_type in SHARED:
            fam, prior = _prior_nat(cov_type, mean.expand(size, dim), cov, prior_strength)
        else:
            fam, prior = _prior_nat(cov_type, mean, cov, prior_strength)
            prior = prior.expand(size, fam.nat_dim).clone()
        _, post = _prior_nat(cov_type, post_means, cov, prior_strength)
        return cls(BayesianParameter(prior, post, fam), cov_type, size, dim)

    def __len__(self) -> int:
        return self.ncomp

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        """Reduced layout [−½x², x] (..., 2D) for diagonal covariance,
        [−½‖x‖², x, −½, D/2] (..., D+3) for isotropic, the raw frames
        (..., D) for full covariance and the shared types."""
        if self.cov_type == "diagonal":
            # frames that need a gradient (the structured VAE's latent
            # frames) keep the plain expression: the kernel has no backward
            if self.plain_scan or (torch.is_grad_enabled() and data.requires_grad):
                return stats_kernels.diag_stats_plain(data)
            return stats_kernels.diag_stats(data.contiguous())
        if self.cov_type == "isotropic":
            return normallik.suff_stats_isotropic(data)
        return data

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

    def _shared_terms(self, e_stats: torch.Tensor):
        """The ELLH of a "shared_*" set as (quad(x) (...,), E[Λμ] (K, D),
        const (K,)), ELLH_k(x) = quad(x) + x·E[Λμ_k] + const_k: the
        contraction of the per-component layout of ``dists/normallik.py``
        with E[T] taken block by block."""
        d, k = self.dim, self.ncomp
        if self.cov_type == "shared_full":
            e_lam = e_stats[:d * d].reshape(d, d)
            quad = lambda x: -0.5 * ((x @ e_lam) * x).sum(-1)  # noqa: E731
            lam_mu = e_stats[d * d:d * d + k * d].reshape(k, d)
            const = -0.5 * e_stats[d * d + k * d:d * d + k * d + k] + 0.5 * e_stats[-1]
        elif self.cov_type == "shared_diagonal":
            e_lam = e_stats[:d]
            quad = lambda x: -0.5 * (x**2) @ e_lam  # noqa: E731
            lam_mu = e_stats[d:d + k * d].reshape(k, d)
            const = (-0.5 * e_stats[d + k * d:d + 2 * k * d].reshape(k, d).sum(-1)
                     + 0.5 * e_stats[d + 2 * k * d:].sum())
        else:
            quad = lambda x: -0.5 * (x**2).sum(-1) * e_stats[0]  # noqa: E731
            lam_mu = e_stats[1:1 + k * d].reshape(k, d)
            const = -0.5 * e_stats[1 + k * d:1 + k * d + k] + 0.5 * d * e_stats[-1]
        return quad, lam_mu, const

    @scoped("beer.ellh")
    def expected_log_likelihood(self, stats: torch.Tensor) -> torch.Tensor:
        """(..., K) expected log-likelihood of every component."""
        if self.cov_type == "diagonal":
            with named_scope("beer.operands"):
                w_mat, bias = self.ellh_matrix()
            return torch.matmul(stats, w_mat) + bias
        e_stats = self.means_precisions.expected_sufficient_statistics()
        if self.cov_type == "full":
            llh = stats_kernels.EllhFull.apply(stats.reshape(-1, self.dim).contiguous(), e_stats,
                                               self.plain_scan)
            return llh.reshape(*stats.shape[:-1], self.ncomp)
        if self.cov_type == "isotropic":
            return torch.matmul(stats, e_stats.T) - 0.5 * self.dim * LOG_2PI
        quad, lam_mu, const = self._shared_terms(e_stats)
        return (quad(stats)[..., None] + torch.matmul(stats, lam_mu.T) + const
                - 0.5 * self.dim * LOG_2PI)

    def accumulate_from_moments(self, acc2: torch.Tensor, counts: torch.Tensor) -> Dict[str, Any]:
        """Natural-space statistics from ``acc2 (K, 2D) = Σ_t resps_t ⊗
        stats_t`` and ``counts (K,) = Σ_t resps_t`` (diagonal covariance
        only)."""
        self._diagonal_only("accumulate_from_moments")
        c = counts[..., None].expand(*counts.shape, self.dim)
        return {"means_precisions": torch.cat([acc2, -0.5 * c, 0.5 * c], dim=-1)}

    def _accumulate_shared(self, x: torch.Tensor, resps: torch.Tensor) -> torch.Tensor:
        """Σ_t Σ_k resps_tk · s_k(x_t) of ``dists/normallik.py``'s
        per-component layout, (P,), from the raw frames: the shared block
        weighted by w_t = Σ_k resps_tk, the mean blocks respsᵀ @ x, the
        per-component counts."""
        d, k = self.dim, self.ncomp
        w = resps.sum(-1)
        means = (resps.T @ x).reshape(k * d)
        counts = resps.sum(0)
        if self.cov_type == "shared_full":
            outer = -0.5 * ((x * w[:, None]).T @ x).reshape(d * d)
            return torch.cat([outer, means, -0.5 * counts, 0.5 * w.sum()[None]])
        if self.cov_type == "shared_diagonal":
            return torch.cat([-0.5 * (w @ x**2), means,
                              (-0.5 * counts)[:, None].expand(k, d).reshape(k * d),
                              (0.5 * w.sum()).expand(d)])
        return torch.cat([(-0.5 * (w @ (x**2).sum(-1)))[None], means, -0.5 * counts,
                          (0.5 * d * w.sum())[None]])

    def accumulate(self, stats: torch.Tensor, resps: torch.Tensor) -> Dict[str, Any]:
        """resps (..., T, K) with stats (..., T, P) (the layout of
        :meth:`sufficient_statistics`) → natural-space statistics."""
        if self.cov_type == "full":
            fn = (stats_kernels.accumulate_full_plain if self.plain_scan
                  else stats_kernels.accumulate_full)
            return {"means_precisions": fn(stats.reshape(-1, self.dim).contiguous(),
                                           resps.reshape(-1, self.ncomp).contiguous())}
        if self.cov_type in SHARED:
            return {"means_precisions": self._accumulate_shared(
                stats.reshape(-1, self.dim), resps.reshape(-1, self.ncomp))}
        acc = torch.einsum("...tk,...tp->...kp", resps, stats)
        if self.cov_type == "isotropic":
            return {"means_precisions": acc}
        return self.accumulate_from_moments(acc, resps.sum(-2))

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
