"""Model protocol (PyTorch).

Counterpart of ``beer_tpu/models/basemodel.py``.  The reference's
three-method contract is kept —

* ``sufficient_statistics(data)``    data → stats tensor,
* ``expected_log_likelihood(stats)`` stats → per-frame log-likelihood,
* ``accumulate(stats, cache)``       stats (+ cache) → stats dict,

— with models as ``nn.Module``s whose Bayesian parameters are buffers.
``infer`` returns an explicit cache that ``accumulate`` consumes, and
``vb_update`` applies the conjugate step to the buffers IN PLACE and
returns the model itself (the JAX package returns a new pytree).

Statistics are plain dicts mirroring each model's parameter fields.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn


class Model(nn.Module):
    """Base class; concrete models hold BayesianParameter / sub-model children."""

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def expected_log_likelihood(self, stats: torch.Tensor) -> torch.Tensor:
        return self.infer(stats)[0]

    def accumulate(self, stats: torch.Tensor, cache: Any) -> Dict[str, Any]:
        """Responsibility-weighted statistics for every Bayesian parameter."""
        raise NotImplementedError

    def infer(self, stats: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Per-frame expected log-likelihood + cache for ``accumulate``."""
        raise NotImplementedError

    def kl_div_posterior_prior(self) -> torch.Tensor:
        """Total KL(q‖p) over all Bayesian parameters (scalar)."""
        raise NotImplementedError

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "Model":
        """Apply the conjugate natural-parameter step in place; returns ``self``."""
        raise NotImplementedError


class DiscreteLatentModel(Model):
    """Models with a discrete latent (mixtures, HMMs): adds ``posteriors``."""

    def posteriors(self, data: torch.Tensor) -> torch.Tensor:
        """Posterior responsibilities of the discrete latent per frame."""
        stats = self.sufficient_statistics(data)
        return self.infer(stats)[1]["resps"]
