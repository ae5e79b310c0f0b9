"""Categorical with Dirichlet prior and its stick-breaking variants (PyTorch).

Counterpart of ``Categorical``, ``SBCategorical`` and
``SBCategoricalHyperPrior`` in ``beer_tpu/models/categorical.py``.  The
SBCategorical is the prior over acoustic units in phone-loop AUD: a
truncated stick-breaking process v_i ~ Beta(1, γ), π_i = v_i
Π_{j<i}(1−v_j); the hyper-prior variant puts a Gamma on γ.

All three expose the small "weight model" protocol the phone loop consumes:
``expected_log_weights()``, ``accumulate_counts(counts)``,
``vb_update(acc)`` (in place), ``kl_div_posterior_prior()``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.nn import functional as F

from beer_tpu_torch import dists
from beer_tpu_torch.device import resolve_device
from beer_tpu_torch.models.basemodel import Model
from beer_tpu_torch.models.parameters import BayesianParameter


class Categorical(Model):
    """Categorical likelihood with a Dirichlet prior over the weights."""

    def __init__(self, weights: BayesianParameter, ncat: int):
        super().__init__()
        self.weights = weights
        self.ncat = ncat

    @classmethod
    def create(cls, ncat: int, prior_strength: float = 1.0,
               dtype=torch.float32, device=None) -> "Categorical":
        """On the CUDA card unless ``device`` says otherwise."""
        fam = dists.Dirichlet(dim=ncat)
        nat = fam.to_nat(torch.full((ncat,), prior_strength, dtype=dtype,
                                    device=resolve_device(device)))
        return cls(BayesianParameter(nat, nat.clone(), fam), ncat)

    def expected_log_weights(self) -> torch.Tensor:
        """E[log π], shape (K,)."""
        return self.weights.expected_sufficient_statistics()

    def accumulate_counts(self, counts: torch.Tensor) -> Dict[str, Any]:
        return {"weights": counts}

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        """Integer class ids (T,) → one-hot (T, K); float data passes through."""
        if not data.is_floating_point():
            return F.one_hot(data.long(), self.ncat).to(self.weights.posterior.dtype)
        return data

    def infer(self, stats: torch.Tensor):
        llh = stats @ self.expected_log_weights()
        return llh, {"counts": stats.sum(0)}

    def accumulate(self, stats: torch.Tensor, cache=None) -> Dict[str, Any]:
        counts = cache["counts"] if cache else stats.sum(0)
        return self.accumulate_counts(counts)

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.weights.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "Categorical":
        self.weights.natural_update(acc["weights"], lrate)
        return self

    def mean(self) -> torch.Tensor:
        """Posterior expected weights."""
        alpha = self.weights.family.to_std(self.weights.posterior)
        return alpha / alpha.sum(-1, keepdim=True)


class SBCategorical(Model):
    """Truncated stick-breaking (Dirichlet-process) categorical.

    ``sticks`` holds K−1 Beta posteriors as a batched 2-dim Dirichlet
    parameter of shape (K−1, 2).  Weight k uses sticks 0..k:
    E[log π_k] = E[log v_k] + Σ_{j<k} E[log(1−v_j)]   (v_{K−1} ≡ 1).
    """

    def __init__(self, sticks: BayesianParameter, truncation: int):
        super().__init__()
        self.sticks = sticks
        self.truncation = truncation

    @classmethod
    def create(cls, truncation: int, concentration: float = 1.0,
               dtype=torch.float32, device=None) -> "SBCategorical":
        """On the CUDA card unless ``device`` says otherwise."""
        device = resolve_device(device)
        fam = dists.Beta()
        alpha = torch.stack(
            [
                torch.ones(truncation - 1, dtype=dtype, device=device),
                torch.full((truncation - 1,), concentration, dtype=dtype, device=device),
            ],
            dim=-1,
        )
        nat = fam.to_nat(alpha)
        return cls(BayesianParameter(nat, nat.clone(), fam), truncation)

    def expected_log_weights(self) -> torch.Tensor:
        e = self.sticks.expected_sufficient_statistics()  # (K-1, 2)
        e_log_v, e_log_1mv = e[..., 0], e[..., 1]
        zero = torch.zeros_like(e_log_v[:1])
        tail = torch.cat([zero, torch.cumsum(e_log_1mv, 0)])
        head = torch.cat([e_log_v, zero])
        return head + tail

    def accumulate_counts(self, counts: torch.Tensor) -> Dict[str, Any]:
        """counts (K,) → per-stick Beta statistics (K−1, 2).

        Stick i sees [c_i, Σ_{j>i} c_j] — its own occupancy vs everything
        broken off after it.
        """
        rev_tail = torch.flip(torch.cumsum(torch.flip(counts, (0,)), 0), (0,))
        return {"sticks": torch.stack([counts[:-1], rev_tail[1:]], dim=-1)}

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return F.one_hot(data.long(), self.truncation).to(self.sticks.posterior.dtype)

    def infer(self, stats: torch.Tensor):
        llh = stats @ self.expected_log_weights()
        return llh, {"counts": stats.sum(0)}

    def accumulate(self, stats: torch.Tensor, cache=None) -> Dict[str, Any]:
        counts = cache["counts"] if cache else stats.sum(0)
        return self.accumulate_counts(counts)

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.sticks.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "SBCategorical":
        self.sticks.natural_update(acc["sticks"], lrate)
        return self

    def mean(self) -> torch.Tensor:
        alpha = self.sticks.family.to_std(self.sticks.posterior)  # (K-1, 2)
        e_v = alpha[..., 0] / alpha.sum(-1)
        one = torch.ones_like(e_v[:1])
        rest = torch.cat([one, torch.cumprod(1.0 - e_v, 0)])
        return torch.cat([e_v, one]) * rest


class SBCategoricalHyperPrior(Model):
    """Stick-breaking categorical with a Gamma hyper-prior on γ.

    v_i ~ Beta(1, γ), γ ~ Gamma(a₀, b₀).  Mean-field q(v) q(γ):

    * sticks update against the *expected* prior η̄_p = [0, E[γ] − 1]
      (exact: E_γ[A_Beta(1, γ)] = −E[log γ], so the ELBO stays closed
      form),
    * γ's conjugate statistics per stick are [E[log(1−v_i)], 1].
    """

    def __init__(self, sticks: BayesianParameter, concentration: BayesianParameter,
                 truncation: int):
        super().__init__()
        self.sticks = sticks
        self.concentration = concentration
        self.truncation = truncation

    @classmethod
    def create(cls, truncation: int, prior_shape: float = 1.0, prior_rate: float = 1.0,
               dtype=torch.float32, device=None) -> "SBCategoricalHyperPrior":
        """On the CUDA card unless ``device`` says otherwise."""
        device = resolve_device(device)
        gamma_fam = dists.Gamma()
        g_nat = gamma_fam.to_nat(torch.tensor(prior_shape, dtype=dtype, device=device),
                                 torch.tensor(prior_rate, dtype=dtype, device=device))
        conc = BayesianParameter(g_nat, g_nat.clone(), gamma_fam)
        e_gamma = prior_shape / prior_rate
        alpha = torch.stack(
            [
                torch.ones(truncation - 1, dtype=dtype, device=device),
                torch.full((truncation - 1,), e_gamma, dtype=dtype, device=device),
            ],
            dim=-1,
        )
        beta_fam = dists.Beta()
        nat = beta_fam.to_nat(alpha)
        return cls(BayesianParameter(nat, nat.clone(), beta_fam), conc, truncation)

    def _e_gamma(self):
        e = self.concentration.expected_sufficient_statistics()
        return e[..., 0], e[..., 1]  # E[γ], E[log γ]

    def _expected_prior_nat(self) -> torch.Tensor:
        e_gamma, _ = self._e_gamma()
        zeros = torch.zeros(self.truncation - 1, dtype=e_gamma.dtype, device=e_gamma.device)
        return torch.stack([zeros, zeros + (e_gamma - 1.0)], dim=-1)

    # -- weight-model protocol -----------------------------------------
    def expected_log_weights(self) -> torch.Tensor:
        e = self.sticks.expected_sufficient_statistics()
        e_log_v, e_log_1mv = e[..., 0], e[..., 1]
        zero = torch.zeros_like(e_log_v[:1])
        return torch.cat([e_log_v, zero]) + torch.cat([zero, torch.cumsum(e_log_1mv, 0)])

    def accumulate_counts(self, counts: torch.Tensor) -> Dict[str, Any]:
        rev_tail = torch.flip(torch.cumsum(torch.flip(counts, (0,)), 0), (0,))
        return {"sticks": torch.stack([counts[:-1], rev_tail[1:]], dim=-1)}

    # -- Model API -------------------------------------------------------
    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return F.one_hot(data.long(), self.truncation).to(self.sticks.posterior.dtype)

    def infer(self, stats: torch.Tensor):
        llh = stats @ self.expected_log_weights()
        return llh, {"counts": stats.sum(0)}

    def accumulate(self, stats: torch.Tensor, cache=None) -> Dict[str, Any]:
        counts = cache["counts"] if cache else stats.sum(0)
        return self.accumulate_counts(counts)

    def kl_div_posterior_prior(self) -> torch.Tensor:
        fam = self.sticks.family
        nat_q = self.sticks.posterior
        nat_p = self._expected_prior_nat()
        grad_q = fam.expected_sufficient_statistics(nat_q)
        _, e_log_gamma = self._e_gamma()
        kl_sticks = (
            ((nat_q - nat_p) * grad_q).sum(-1)
            - fam.log_norm(nat_q)
            - e_log_gamma  # = E_γ[−A_Beta(1, γ)], exact
        ).sum()
        return kl_sticks + self.concentration.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "SBCategoricalHyperPrior":
        """Sticks against the expected prior of the current q(γ), then γ
        from the new stick posteriors; in place."""
        target = self._expected_prior_nat() + acc["sticks"]
        post = self.sticks.posterior
        post.copy_(post + lrate * (target - post))
        # γ's statistics: [Σ E log(1−v_i), K−1]
        e = self.sticks.expected_sufficient_statistics()
        g_stats = torch.stack([e[..., 1].sum(), torch.full_like(e[0, 1], self.truncation - 1.0)])
        self.concentration.natural_update(g_stats, lrate)
        return self

    def mean(self) -> torch.Tensor:
        alpha = self.sticks.family.to_std(self.sticks.posterior)
        e_v = alpha[..., 0] / alpha.sum(-1)
        one = torch.ones_like(e_v[:1])
        return torch.cat([e_v, one]) * torch.cat([one, torch.cumprod(1.0 - e_v, 0)])
