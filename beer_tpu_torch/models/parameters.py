"""Bayesian parameters: (prior, posterior) conjugate pairs (PyTorch).

Counterpart of ``beer_tpu/models/parameters.py``.  A parameter is an
``nn.Module`` whose prior and posterior natural parameters are
registered buffers (not ``nn.Parameter``: VB-EM updates them in closed
form, never by gradient).  Leading axes of the buffers batch a set of
parameters.  The coordinate-ascent step is plain arithmetic:

    posterior ← posterior + lr · (prior + stats − posterior)

which at lr = 1 is the textbook closed-form VB-EM M-step.
"""

from __future__ import annotations

import torch
from torch import nn

from beer_tpu_torch.dists.basedist import ExpFamily


class BayesianParameter(nn.Module):
    """A conjugate (prior, posterior) pair over one exponential family."""

    def __init__(self, prior: torch.Tensor, posterior: torch.Tensor, family: ExpFamily):
        super().__init__()
        self.family = family
        self.register_buffer("prior", prior)
        self.register_buffer("posterior", posterior)

    def expected_sufficient_statistics(self) -> torch.Tensor:
        """E_q[T(θ)] = ∇A(η_post), shape (..., P)."""
        return self.family.expected_sufficient_statistics(self.posterior)

    def kl_div_posterior_prior(self) -> torch.Tensor:
        """Σ KL(q(θ)‖p(θ)) over the whole parameter set (scalar)."""
        return self.family.kl_div(self.posterior, self.prior).sum()

    def natural_update(self, stats: torch.Tensor, lrate: float = 1.0) -> "BayesianParameter":
        """Natural-gradient coordinate-ascent step (stats already scaled).

        Updates the posterior buffer IN PLACE and returns ``self``.
        """
        self.posterior.copy_(self.posterior + lrate * (self.prior + stats - self.posterior))
        return self
