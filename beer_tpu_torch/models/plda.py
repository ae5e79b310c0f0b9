"""Probabilistic Linear Discriminant Analysis, variational Bayes (PyTorch).

Counterpart of ``beer_tpu/models/plda.py`` (the reference's
``beer/models/plda.py``).  A two-level model of labelled embeddings
(class i, observation j):

    x_ij = μ + F h_i + ε_ij,   h_i ~ N(0, I_Q),   ε_ij ~ N(0, diag(λ)⁻¹)

with VB posteriors q(h_i) per class, q(F) (rows f_d ~ N(0, I_Q) a priori,
each row its own posterior covariance, since the noise is per dimension)
and a Gamma q(λ_d) per dimension.  Every update is a batched closed
form: the (C, Q, Q) and (D, Q, Q) stacks are inverted by
``torch.linalg.inv`` and their log-determinants taken by ``slogdet`` (the
JAX package's batched-LU form), and the quadratic term of the residual
is (C,) per-class terms looked up by label, never an (N, Q, Q) gather.
Plain torch on every device; TF32 is off (the package turns it off on
import).  As in PPCA, the expected residual is taken in its residual form
Σ_d E[λ_d](xc − F̄ m_h)²_d + tr(E[FᵀΛF] cov_h) + m_hᵀ(Σ_d E[λ_d] Σ_d) m_h,
the same function as the JAX package's expanded one without its
cancellation, the Gamma posteriors are evaluated in float64, and the
update's sums over frames are accumulated in float64.

Per-class sums (the counts and Σ_j projections of each class) are one
(C, N) one-hot product, not a scatter-add: ``index_add_`` on a CUDA
tensor sums with atomics in no fixed order, and two E-steps on the same
inputs must give the same bits.  The one-hot matrix takes C·N floats (67
MB at 512 classes × 32,768 embeddings).

Scoring (:meth:`PLDA.llr_score`) is the standard same- against
different-class marginal log-likelihood ratio under the point estimates
E[F], E[λ].
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from beer_tpu_torch import dists
from beer_tpu_torch.device import resolve_device
from beer_tpu_torch.models.basemodel import Model
from beer_tpu_torch.models.parameters import BayesianParameter
from beer_tpu_torch.models.ppca import _gamma_kl, _gamma_moments, _interp

LOG_2PI = math.log(2.0 * math.pi)
FIELDS = ("f_mean", "f_cov", "mean", "prec")


class PLDA(Model):
    """Buffers ``f_mean`` (D, Q) E[F], ``f_cov`` (D, Q, Q) each row's
    posterior covariance, ``mean`` (D,) the point estimate of μ; ``prec``
    the per-dimension Gamma posterior over λ, (D, 2)."""

    def __init__(self, f_mean: torch.Tensor, f_cov: torch.Tensor, mean: torch.Tensor,
                 prec: BayesianParameter):
        super().__init__()
        self.register_buffer("f_mean", f_mean)
        self.register_buffer("f_cov", f_cov)
        self.register_buffer("mean", mean)
        self.prec = prec
        self.obs_dim, self.latent_dim = f_mean.shape

    @classmethod
    def create(cls, obs_dim: int, latent_dim: int, mean=None, prior_shape: float = 1.0,
               prior_rate: float = 1.0, noise_std: float = 0.5, device=None,
               dtype=torch.float32, generator: Optional[torch.Generator] = None) -> "PLDA":
        """F's posterior mean N(0, noise_std²) from ``generator`` (a CPU
        generator seeded 0 when omitted; drawn on the generator's device),
        every row covariance I, μ = ``mean`` or 0, each λ_d's prior and
        posterior Gamma(prior_shape, prior_rate).  Built on the CUDA card
        unless ``device`` says otherwise."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        like = dict(dtype=dtype, device=device)
        f = noise_std * torch.randn((obs_dim, latent_dim), generator=generator, dtype=dtype,
                                    device=generator.device).to(device)
        fam = dists.Gamma()
        nat = fam.to_nat(torch.full((obs_dim,), prior_shape, **like),
                         torch.full((obs_dim,), prior_rate, **like))
        f_cov = torch.eye(latent_dim, **like).expand(obs_dim, latent_dim, latent_dim).clone()
        mean = torch.zeros(obs_dim, **like) if mean is None else torch.as_tensor(mean).to(**like)
        return cls(f, f_cov, mean.clone(), BayesianParameter(nat, nat.clone(), fam))

    # -- expectations (float64) -----------------------------------------
    def _e_lam(self):
        """(E[λ] (D,), E[log λ] (D,)) in float64."""
        return _gamma_moments(self.prec)

    def _row_cov(self) -> torch.Tensor:
        """Σ_d E[λ_d] Σ_d, (Q, Q), in float64."""
        return torch.einsum("d,dij->ij", self._e_lam()[0], self.f_cov.double())

    def _e_ftlf(self) -> torch.Tensor:
        """E[Fᵀ diag(E[λ]) F] with the row-covariance correction, (Q, Q),
        in float64."""
        f = self.f_mean.double()
        return f.T @ (self._e_lam()[0][:, None] * f) + self._row_cov()

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return data

    def infer(self, stats: torch.Tensor, labels: Optional[torch.Tensor] = None,
              n_classes: Optional[int] = None):
        """q(h_i) per class and the per-frame ELBO contributions (N,).

        ``labels`` (N,) integer class ids in [0, n_classes); all frames
        are one class when omitted."""
        x = stats
        n, d = x.shape
        q = self.latent_dim
        if labels is None:
            labels = torch.zeros(n, dtype=torch.long, device=x.device)
            n_classes = 1
        labels = labels.long()
        e_lam, e_loglam = self._e_lam()
        lam = e_lam.to(x.dtype)
        xc = x - self.mean
        onehot = (labels[None, :] == torch.arange(n_classes, device=x.device)[:, None]).to(x.dtype)
        counts = onehot.sum(1)                                   # (C,)
        e_ftlf = self._e_ftlf()
        eye = torch.eye(q, dtype=e_ftlf.dtype, device=x.device)
        cov_h = torch.linalg.inv(eye + counts.double()[:, None, None] * e_ftlf)   # (C, Q, Q)
        sum_proj = onehot @ (xc @ (lam[:, None] * self.f_mean))  # (C, Q)
        m_h = torch.einsum("cij,cj->ci", cov_h, sum_proj.double())
        e_hh = cov_h + m_h[:, :, None] * m_h[:, None, :]         # (C, Q, Q)
        # E[(xc − F h)ᵀ Λ (xc − F h)] = Σ_d E[λ_d](xc − F̄ m_h)²_d plus the
        # per-class tr(E[FᵀΛF] cov_h) + m_hᵀ(Σ_d E[λ_d] Σ_d) m_h
        quad = (e_ftlf * cov_h).sum((-1, -2)) + ((m_h @ self._row_cov()) * m_h).sum(-1)
        per_class = (-0.5 * (torch.einsum("cii->c", e_hh) + q * LOG_2PI)
                     + 0.5 * (q * (1.0 + LOG_2PI) + torch.linalg.slogdet(cov_h)[1]))
        # each frame's terms that depend on its class only: −½·quad and its
        # share of the class's prior and entropy terms
        by_class = -0.5 * quad + per_class / counts.double().clamp_min(1.0)
        const = 0.5 * (e_loglam.sum() - d * LOG_2PI)
        m_h, e_hh = m_h.to(x.dtype), e_hh.to(x.dtype)
        resid = (xc - m_h[labels] @ self.f_mean.T)**2 @ lam
        llh = const.to(x.dtype) - 0.5 * resid + by_class.to(x.dtype)[labels]
        return llh, {"m_h": m_h, "xc": xc, "labels": labels, "counts": counts, "e_hh": e_hh}

    def accumulate(self, stats: torch.Tensor, cache: Dict[str, Any]) -> Dict[str, Any]:
        """The update's sums over frames, accumulated in float64 (see
        :mod:`beer_tpu_torch.models.ppca`)."""
        xc = cache["xc"].double()
        m_per = cache["m_h"].double()[cache["labels"]]
        return {
            "n": torch.tensor(float(xc.shape[0]), dtype=torch.float64, device=xc.device),
            "sum_x": stats.sum(0, dtype=torch.float64),
            "sum_m": m_per.sum(0),
            "sum_sq": (xc**2).sum(0),                              # (D,)
            "c": xc.T @ m_per,                                     # (D, Q)
            "s_h": torch.einsum("c,cij->ij", cache["counts"].double(),
                                cache["e_hh"].double()),           # (Q, Q)
        }

    def kl_div_posterior_prior(self) -> torch.Tensor:
        f_cov = self.f_cov.double()
        kl_f = 0.5 * (torch.einsum("dii->d", f_cov).sum() + (self.f_mean.double()**2).sum()
                      - self.obs_dim * self.latent_dim - torch.linalg.slogdet(f_cov)[1].sum())
        return (kl_f + _gamma_kl(self.prec)).to(self.f_mean.dtype)

    def mean_field_factorization(self):
        """Two coordinate-ascent groups: the subspace F (with μ), then the
        noise precisions λ."""
        return [["f_mean", "f_cov", "mean"], ["prec"]]

    @torch.no_grad()
    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0, group=None) -> "PLDA":
        """Coordinate ascent F (given the old λ) → λ (given the new F) → μ,
        in place; ``group`` restricts it to those fields (see
        :meth:`beer_tpu_torch.models.ppca.PPCA.vb_update`)."""
        sel = set(FIELDS if group is None else group)
        q = self.latent_dim
        acc = {k: v.double() for k, v in acc.items()}
        e_lam, _ = self._e_lam()
        f_mean, f_cov = self.f_mean.double(), self.f_cov.double()
        if "f_mean" in sel:
            eye = torch.eye(q, dtype=f_cov.dtype, device=f_cov.device)
            new_cov = torch.linalg.inv(eye + e_lam[:, None, None] * acc["s_h"])
            new_mean = torch.einsum("d,dq,dqr->dr", e_lam, acc["c"], new_cov)
            f_mean = _interp(f_mean, new_mean, lrate)
            f_cov = _interp(f_cov, new_cov, lrate)
        if "prec" in sel:
            e_ff = f_mean[:, :, None] * f_mean[:, None, :] + f_cov
            resid = (acc["sum_sq"] - 2.0 * (f_mean * acc["c"]).sum(-1)
                     + torch.einsum("dij,ij->d", e_ff, acc["s_h"]))
            lam_stats = torch.stack([-0.5 * resid, 0.5 * acc["n"] * torch.ones_like(resid)], -1)
            self.prec.natural_update(lam_stats, lrate)
        if "mean" in sel:
            mean = (acc["sum_x"] - f_mean @ acc["sum_m"]) / acc["n"]
            self.mean.copy_(_interp(self.mean.double(), mean, lrate))
        if "f_mean" in sel:
            self.f_mean.copy_(f_mean)
            self.f_cov.copy_(f_cov)
        return self

    # -- scoring ---------------------------------------------------------
    def llr_score(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        """log p(e1, e2 | same class) − log p(e1, e2 | different classes)
        of paired trials e1, e2 (N, D) under the point estimates E[F],
        E[λ]; returns (N,)."""
        e_lam = self._e_lam()[0].to(self.f_mean.dtype)
        sigma_b = self.f_mean @ self.f_mean.T
        tot = sigma_b + torch.diag(1.0 / e_lam)

        def logpdf(x, cov):
            logdet = torch.linalg.slogdet(cov)[1]
            sol = torch.linalg.solve(cov, x.T).T
            return -0.5 * ((x * sol).sum(-1) + logdet + x.shape[-1] * LOG_2PI)

        x1, x2 = e1 - self.mean, e2 - self.mean
        joint = torch.cat([torch.cat([tot, sigma_b], 1), torch.cat([sigma_b, tot], 1)], 0)
        same = logpdf(torch.cat([x1, x2], dim=-1), joint)
        return same - (logpdf(x1, tot) + logpdf(x2, tot))

    def to_numpy(self) -> Dict[str, Any]:
        """Buffers and statics as numpy arrays; the inverse of
        :func:`beer_tpu_torch.convert.plda_from_numpy`."""
        np_ = lambda x: x.detach().cpu().numpy()  # noqa: E731
        return {"type": "PLDA", "f_mean": np_(self.f_mean), "f_cov": np_(self.f_cov),
                "mean": np_(self.mean), "prec_prior": np_(self.prec.prior),
                "prec_posterior": np_(self.prec.posterior)}
