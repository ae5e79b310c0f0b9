"""Bayesian mixtures (PyTorch): the GMM and the set of GMMs of an HMM.

Counterpart of ``beer_tpu/models/mixture.py``.

* :class:`Mixture` — one mixture of any ModelSet under a weight model
  exposing ``expected_log_weights`` (a Dirichlet :class:`Categorical` by
  default): the Bayesian GMM of BASELINE config 1.  Over a
  full-covariance :class:`NormalSet` its E-step is one kernel
  (:func:`~beer_tpu_torch.ops.stats_kernels.gmm_estep_full`, K8): the
  per-frame log-marginal, the responsibilities and the accumulated
  statistics, with the responsibilities never stored.  Other components
  take the logsumexp route with the responsibilities in the cache, and
  so do statistics that require grad (the structured VAE's prior): K8
  has no gradient, the component ELLH (K9 through
  :class:`~beer_tpu_torch.ops.stats_kernels.EllhFull`) does.
* :class:`MixtureSet` — S mixtures of K components each (one GMM per HMM
  state, the HMM-GMM emissions of the recognizer recipe).  The S·K
  components live in one NormalSet; the weights are a batched Dirichlet
  of shape (S, K).  Each state's expected log-likelihood is logsumexp
  over its K components of the component ELLH + E[log w].
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from beer_tpu_torch import dists
from beer_tpu_torch.models.basemodel import DiscreteLatentModel
from beer_tpu_torch.models.categorical import Categorical
from beer_tpu_torch.models.modelset import ModelSet
from beer_tpu_torch.models.normal import NormalSet
from beer_tpu_torch.models.parameters import BayesianParameter
from beer_tpu_torch.ops import stats_kernels


class Mixture(DiscreteLatentModel):
    """Mixture of any ModelSet with a Bayesian prior over the weights.

    ``plain_scan`` runs the plain PyTorch version of the fused E-step
    kernel even on CUDA tensors (the reference route on the card).
    """

    def __init__(self, categorical, modelset, plain_scan: bool = False):
        super().__init__()
        self.categorical = categorical
        self.modelset = modelset
        self.plain_scan = plain_scan

    @classmethod
    def create(cls, modelset, prior_strength: float = 1.0, weight_model=None) -> "Mixture":
        """The default weight model is a Dirichlet :class:`Categorical`
        on the modelset's device, in its dtype."""
        if weight_model is None:
            like = next(modelset.buffers())
            weight_model = Categorical.create(len(modelset), prior_strength, like.dtype,
                                              like.device)
        return cls(weight_model, modelset)

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return self.modelset.sufficient_statistics(data)

    def _fused(self) -> bool:
        """The one-kernel E-step route: full-covariance NormalSet components."""
        return isinstance(self.modelset, NormalSet) and self.modelset.cov_type == "full"

    def _joint(self, stats: torch.Tensor) -> torch.Tensor:
        """(..., K) component ELLH + E[log w]."""
        return self.modelset.expected_log_likelihood(stats) + self.categorical.expected_log_weights()

    def infer(self, stats: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """Per-frame log-marginal (masked frames 0) and the cache
        ``accumulate`` needs: ``{"gmm_acc", "gmm_counts"}`` on the fused
        route, ``{"resps"}`` otherwise (and for ``stats`` that require
        grad while grad mode is on)."""
        if self._fused() and not (torch.is_grad_enabled() and stats.requires_grad):
            ms = self.modelset
            fn = (stats_kernels.gmm_estep_full_plain if self.plain_scan
                  else stats_kernels.gmm_estep_full)
            llh, acc, counts = fn(
                stats.reshape(-1, ms.dim).contiguous(),
                ms.means_precisions.expected_sufficient_statistics(),
                self.categorical.expected_log_weights(),
                None if mask is None else mask.reshape(-1).to(stats.dtype).contiguous())
            return llh.reshape(stats.shape[:-1]), {"gmm_acc": acc, "gmm_counts": counts}
        joint = self._joint(stats)
        llh = torch.logsumexp(joint, dim=-1)
        resps = torch.exp(joint - llh[..., None])
        if mask is not None:
            llh = llh * mask
            resps = resps * mask[..., None]
        return llh, {"resps": resps}

    def accumulate(self, stats: torch.Tensor, cache: Dict[str, Any]) -> Dict[str, Any]:
        if "gmm_acc" in cache:
            return {"categorical": self.categorical.accumulate_counts(cache["gmm_counts"]),
                    "modelset": {"means_precisions": cache["gmm_acc"]}}
        resps = cache["resps"]
        counts = resps.reshape(-1, resps.shape[-1]).sum(0)
        return {"categorical": self.categorical.accumulate_counts(counts),
                "modelset": self.modelset.accumulate(stats, resps)}

    def posteriors(self, data: torch.Tensor) -> torch.Tensor:
        """(..., K) responsibilities, computed directly (the fused E-step
        never stores them): the component ELLH (K9 for full covariance)
        and a softmax."""
        return torch.softmax(self._joint(self.sufficient_statistics(data)), dim=-1)

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.categorical.kl_div_posterior_prior() + self.modelset.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "Mixture":
        """Conjugate step on the weights and the components, in place."""
        self.categorical.vb_update(acc["categorical"], lrate)
        self.modelset.vb_update(acc["modelset"], lrate)
        return self

    def mean_field_factorization(self):
        """Two coordinate-ascent groups: weights, then components."""
        return [["categorical"], ["modelset"]]

    def weights(self) -> torch.Tensor:
        """Posterior expected mixture weights, (K,)."""
        return self.categorical.mean()

    def to_numpy(self) -> Dict[str, Any]:
        """The Dirichlet weight model and the components as numpy arrays
        and Python values; the inverse of
        :func:`beer_tpu_torch.convert.mixture_from_numpy`."""
        w = self.categorical.weights
        return {"type": "Mixture", "prior": w.prior.detach().cpu().numpy(),
                "posterior": w.posterior.detach().cpu().numpy(),
                "modelset": self.modelset.to_numpy()}


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
        """resps (N, S) state responsibilities with stats (N, P), raw
        frames (N, D) for full covariance → per-component statistics."""
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
