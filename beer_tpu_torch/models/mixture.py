"""A set of Bayesian mixtures over a diagonal NormalSet (PyTorch).

Counterpart of ``MixtureSet`` in ``beer_tpu/models/mixture.py``: S
mixtures of K components each (one GMM per HMM state, the HMM-GMM
emissions of the recognizer recipe).  The S·K components live in one
NormalSet; the weights are a batched Dirichlet of shape (S, K).  Each
state's expected log-likelihood is logsumexp over its K components of
the component ELLH + E[log w].  ``Mixture`` and the full-covariance
NormalSet come with the GMM slice (ROADMAP A.4, B5/B6).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from beer_tpu_torch import dists
from beer_tpu_torch.models.modelset import ModelSet
from beer_tpu_torch.models.normal import NormalSet
from beer_tpu_torch.models.parameters import BayesianParameter


class MixtureSet(ModelSet):
    """S mixtures sharing one NormalSet of S·K components."""

    def __init__(self, weights: BayesianParameter, modelset: NormalSet, nmix: int = 1,
                 ncomp_per_mix: int = 1):
        super().__init__()
        self.weights = weights
        self.modelset = modelset
        self.nmix = nmix
        self.ncomp_per_mix = ncomp_per_mix

    @classmethod
    def create(cls, modelset: NormalSet, nmix: int, prior_strength: float = 1.0) -> "MixtureSet":
        """Split a NormalSet of size S·K into S mixtures of K components;
        the weights' device and dtype are the NormalSet's."""
        ncomp = len(modelset) // nmix
        post = modelset.means_precisions.posterior
        fam = dists.Dirichlet(dim=ncomp)
        nat = fam.to_nat(torch.full((nmix, ncomp), prior_strength, dtype=post.dtype,
                                    device=post.device))
        return cls(BayesianParameter(nat, nat.clone(), fam), modelset, nmix, ncomp)

    def __len__(self) -> int:
        return self.nmix

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return self.modelset.sufficient_statistics(data)

    def _joint(self, stats: torch.Tensor) -> torch.Tensor:
        """(..., S, K) component ELLH + E[log w]."""
        per_comp = self.modelset.expected_log_likelihood(stats)
        per_comp = per_comp.reshape(*per_comp.shape[:-1], self.nmix, self.ncomp_per_mix)
        return per_comp + self.weights.expected_sufficient_statistics()

    def expected_log_likelihood(self, stats: torch.Tensor) -> torch.Tensor:
        """(..., S): each state's mixture ELLH."""
        return torch.logsumexp(self._joint(stats), dim=-1)

    def infer(self, stats: torch.Tensor):
        return self.expected_log_likelihood(stats), {}

    def accumulate(self, stats: torch.Tensor, resps: torch.Tensor) -> Dict[str, Any]:
        """resps (N, S) state responsibilities with stats (N, P) →
        per-component statistics."""
        comp_resps = torch.softmax(self._joint(stats), dim=-1) * resps[..., None]
        return {
            "weights": comp_resps.reshape(-1, self.nmix, self.ncomp_per_mix).sum(0),
            "modelset": self.modelset.accumulate(stats, comp_resps.flatten(-2)),
        }

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.weights.kl_div_posterior_prior() + self.modelset.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "MixtureSet":
        """Conjugate step on the weights and the components, in place."""
        self.weights.natural_update(acc["weights"], lrate)
        self.modelset.vb_update(acc["modelset"], lrate)
        return self

    def to_numpy(self) -> Dict[str, Any]:
        """Weights and statics as numpy arrays and Python values; the
        inverse of :func:`beer_tpu_torch.convert.mixture_set_from_numpy`."""
        return {
            "type": "MixtureSet",
            "weights_prior": self.weights.prior.detach().cpu().numpy(),
            "weights_posterior": self.weights.posterior.detach().cpu().numpy(),
            "nmix": self.nmix,
            "ncomp_per_mix": self.ncomp_per_mix,
            "modelset": self.modelset.to_numpy(),
        }
