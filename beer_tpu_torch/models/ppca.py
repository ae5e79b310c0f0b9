"""Probabilistic PCA with a variational-Bayes subspace (PyTorch).

Counterpart of ``beer_tpu/models/ppca.py`` (the reference's
``beer/models/ppca.py``; Bishop, "Variational PCA", 1999):

    x = μ + W z + ε,   z ~ N(0, I_Q),   ε ~ N(0, λ⁻¹ I_D)
    q(z_n) q(W) q(λ);  rows of W have prior N(0, I_Q), λ ~ Gamma(a₀, b₀)

Every per-frame quantity is a batched closed form: one (N, D) @ (D, Q)
product for the latent means, shared (Q, Q) inverses, and the
accumulation's two products (D, N) @ (N, Q) and (Q, N) @ (N, Q).  Plain
torch on every device (the JAX package runs it in jnp, no kernel); the
package turns TF32 off on import, the counterpart of the JAX package's
``default_matmul_precision("highest")`` here.

Precision.  A float32 model does its per-frame work (the E-step's
(N, ·) products and per-frame terms) in float32, and in float64 its sums
over frames (``accumulate``'s statistics) and its parameter-sized closed
forms (the (Q, Q) inverses and log-determinants, the Gamma posterior's
moments and KL, the per-frame ELBO's frame-independent terms, the whole
M-step), cast back.  The λ update subtracts statistics ~100 times the
residual it leaves (‖xc‖² − 2 tr(W̄ᵀc) + Σ E[WᵀW]∘s_z).  With c and
s_z summed by SGEMM along config 7's 262,144 frames, the float32 run
fell up to 1.5e-3 ELBO a frame from a float64 run from the same start;
summed in float64 (one (D, N)·(N, Q) DGEMM) it stays within 2.1e-5
(phase 22 of ``chip_smoke.py``, one H100).  The Gamma's shape is ≈ N·D/2, 3.4e7 at config 7, where
float32's lgamma and digamma alone round away more than 1e-4 of ELBO a
frame.  The expected residual E‖x − μ − W z‖² is taken as
‖xc − W̄m‖² + D·mᵀΣ_w m + tr(E[WᵀW] cov_z), the same function as the JAX
package's ‖xc‖² − 2 xcᵀW̄m + Σ_ij E[WᵀW]_ij E[z zᵀ]_ij: that form
subtracts terms of ~2·D to leave ~D/E[λ], and its cancellation alone
moved the float32 per-frame ELBO of config 7 by up to 6e-3 from a float64
run on the same parameters (CPU, N = 32,768).  It also never builds the
(N, Q, Q) E[z zᵀ] that XLA fuses away and PyTorch would allocate (4.3 GB
at N = 262,144, Q = 64).

``vb_update`` is coordinate ascent W (given the old λ) → λ (given the
new W) → μ, in place; ``group=`` restricts it to some fields, holding
the others at their current values inside the update, so each mean-field
group step (:func:`beer_tpu_torch.vbi.vb_update_partial`) is an exact
coordinate update.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from beer_tpu_torch import dists
from beer_tpu_torch.device import resolve_device
from beer_tpu_torch.models.basemodel import Model
from beer_tpu_torch.models.parameters import BayesianParameter

LOG_2PI = math.log(2.0 * math.pi)
FIELDS = ("w_mean", "w_cov", "mean", "prec")


def _interp(old: torch.Tensor, new: torch.Tensor, lrate: float) -> torch.Tensor:
    return new if lrate == 1.0 else old + lrate * (new - old)


def _gamma_moments(prec: BayesianParameter):
    """(E[λ], E[log λ]) of a Gamma posterior, in float64."""
    e = prec.family.expected_sufficient_statistics(prec.posterior.double())
    return e[..., 0], e[..., 1]


def _gamma_kl(prec: BayesianParameter) -> torch.Tensor:
    """Σ KL(q‖p) of a Gamma parameter, in float64."""
    return prec.family.kl_div(prec.posterior.double(), prec.prior.double()).sum()


class PPCA(Model):
    """Buffers ``w_mean`` (D, Q) E[W], ``w_cov`` (Q, Q) the shared
    posterior row covariance, ``mean`` (D,) the point estimate of μ; ``prec``
    the Gamma posterior over λ."""

    def __init__(self, w_mean: torch.Tensor, w_cov: torch.Tensor, mean: torch.Tensor,
                 prec: BayesianParameter):
        super().__init__()
        self.register_buffer("w_mean", w_mean)
        self.register_buffer("w_cov", w_cov)
        self.register_buffer("mean", mean)
        self.prec = prec
        self.obs_dim, self.latent_dim = w_mean.shape

    @classmethod
    def create(cls, obs_dim: int, latent_dim: int, mean=None, prior_shape: float = 1.0,
               prior_rate: float = 1.0, noise_std: float = 0.5, device=None,
               dtype=torch.float32, generator: Optional[torch.Generator] = None) -> "PPCA":
        """W's posterior mean N(0, noise_std²) from ``generator`` (a CPU
        generator seeded 0 when omitted; the draw is made on the
        generator's device, so one seed gives one W on every device),
        W's row covariance I, μ = ``mean`` or 0, λ's prior and posterior
        Gamma(prior_shape, prior_rate).  Built on the CUDA card unless
        ``device`` says otherwise."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        like = dict(dtype=dtype, device=device)
        w = noise_std * torch.randn((obs_dim, latent_dim), generator=generator, dtype=dtype,
                                    device=generator.device).to(device)
        fam = dists.Gamma()
        nat = fam.to_nat(torch.tensor(prior_shape, **like), torch.tensor(prior_rate, **like))
        mean = torch.zeros(obs_dim, **like) if mean is None else torch.as_tensor(mean).to(**like)
        return cls(w, torch.eye(latent_dim, **like), mean.clone(),
                   BayesianParameter(nat, nat.clone(), fam))

    # -- expectations (float64) -----------------------------------------
    def _e_lam(self):
        """(E[λ], E[log λ]) in float64."""
        return _gamma_moments(self.prec)

    def _e_wtw(self, w_mean: torch.Tensor, w_cov: torch.Tensor) -> torch.Tensor:
        w_mean, w_cov = w_mean.double(), w_cov.double()
        return w_mean.T @ w_mean + self.obs_dim * w_cov

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return data

    def infer(self, stats: torch.Tensor):
        """q(z_n) and the per-frame ELBO contributions (N,); the cache holds
        the latent means ``m`` (N, Q), ``cov_z`` (Q, Q) and ``xc`` = x − μ."""
        x = stats
        d, q = self.obs_dim, self.latent_dim
        e_lam, e_loglam = self._e_lam()
        e_wtw = self._e_wtw(self.w_mean, self.w_cov)
        cov_z = torch.linalg.inv(torch.eye(q, dtype=e_wtw.dtype, device=x.device)
                                 + e_lam * e_wtw)
        const = (0.5 * d * (e_loglam - LOG_2PI) - 0.5 * e_lam * (e_wtw * cov_z).sum()
                 - 0.5 * q * LOG_2PI - 0.5 * torch.trace(cov_z)
                 + 0.5 * (q * (1.0 + LOG_2PI) + torch.linalg.slogdet(cov_z)[1]))
        cov_z, lam = cov_z.to(x.dtype), e_lam.to(x.dtype)
        xc = x - self.mean
        m = lam * (xc @ self.w_mean) @ cov_z                      # (N, Q)
        resid = (((xc - m @ self.w_mean.T)**2).sum(-1)
                 + d * ((m @ self.w_cov) * m).sum(-1))
        llh = const.to(x.dtype) - 0.5 * lam * resid - 0.5 * (m**2).sum(-1)
        return llh, {"m": m, "cov_z": cov_z, "xc": xc}

    def accumulate(self, stats: torch.Tensor, cache: Dict[str, Any]) -> Dict[str, Any]:
        """The update's sums over frames, accumulated in float64."""
        x, cov_z = stats, cache["cov_z"]
        m, xc = cache["m"].double(), cache["xc"].double()
        n = x.shape[0]
        return {
            "n": torch.tensor(float(n), dtype=torch.float64, device=x.device),
            "sum_x": x.sum(0, dtype=torch.float64),
            "sum_m": m.sum(0),
            "sum_sq": (xc**2).sum(),
            "c": xc.T @ m,                               # (D, Q)
            "s_z": n * cov_z.double() + m.T @ m,         # (Q, Q)
        }

    def kl_div_posterior_prior(self) -> torch.Tensor:
        """KL(q(W)‖p(W)) over the D rows N(w_d, Σ_w) against N(0, I), plus λ's."""
        d, q = self.obs_dim, self.latent_dim
        w_cov = self.w_cov.double()
        kl_w = 0.5 * (d * torch.trace(w_cov) + (self.w_mean.double()**2).sum() - d * q
                      - d * torch.linalg.slogdet(w_cov)[1])
        return (kl_w + _gamma_kl(self.prec)).to(self.w_mean.dtype)

    def mean_field_factorization(self):
        """Two coordinate-ascent groups: the subspace W (with μ), then the
        noise precision λ."""
        return [["w_mean", "w_cov", "mean"], ["prec"]]

    @torch.no_grad()
    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0, group=None) -> "PPCA":
        """Coordinate ascent W (given the old λ) → λ (given the new W) → μ,
        in place; ``group`` restricts it to those fields."""
        sel = set(FIELDS if group is None else group)
        d, q = self.obs_dim, self.latent_dim
        acc = {k: v.double() for k, v in acc.items()}
        e_lam, _ = self._e_lam()
        w_mean, w_cov = self.w_mean.double(), self.w_cov.double()
        if "w_mean" in sel:
            eye = torch.eye(q, dtype=w_cov.dtype, device=w_cov.device)
            new_cov = torch.linalg.inv(eye + e_lam * acc["s_z"])
            w_mean = _interp(w_mean, e_lam * acc["c"] @ new_cov, lrate)
            w_cov = _interp(w_cov, new_cov, lrate)
        if "prec" in sel:
            e_wtw = self._e_wtw(w_mean, w_cov)
            resid = (acc["sum_sq"] - 2.0 * torch.trace(w_mean.T @ acc["c"])
                     + (e_wtw * acc["s_z"]).sum())
            self.prec.natural_update(torch.stack([-0.5 * resid, 0.5 * d * acc["n"]]), lrate)
        if "mean" in sel:
            mean = (acc["sum_x"] - w_mean @ acc["sum_m"]) / acc["n"]
            self.mean.copy_(_interp(self.mean.double(), mean, lrate))
        if "w_mean" in sel:
            self.w_mean.copy_(w_mean)
            self.w_cov.copy_(w_cov)
        return self

    # -- convenience ---------------------------------------------------
    def transform(self, data: torch.Tensor) -> torch.Tensor:
        """Posterior latent means E[z|x], (N, Q)."""
        return self.infer(self.sufficient_statistics(data))[1]["m"]

    def to_numpy(self) -> Dict[str, Any]:
        """Buffers and statics as numpy arrays and Python values; the
        inverse of :func:`beer_tpu_torch.convert.ppca_from_numpy`."""
        np_ = lambda x: x.detach().cpu().numpy()  # noqa: E731
        return {"type": "PPCA", "w_mean": np_(self.w_mean), "w_cov": np_(self.w_cov),
                "mean": np_(self.mean), "prec_prior": np_(self.prec.prior),
                "prec_posterior": np_(self.prec.posterior)}
