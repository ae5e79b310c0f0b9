"""ModelSet protocol and its compositions (PyTorch).

Counterpart of ``beer_tpu/models/modelset.py``.  A set is one model whose
Bayesian parameters carry a leading component axis, so every component
is evaluated by one (T, P) @ (P, K) product.

Contract (consumed by mixtures and HMM-like models):

* ``sufficient_statistics(x)``       → (..., P) stats,
* ``expected_log_likelihood(stats)`` → (..., K) per-frame per-component,
* ``accumulate(stats, resps)``       → stats dict, resps (..., K),
* ``__len__``                        → K.

:class:`JointModelSet` concatenates sets that score the same statistics;
:class:`RepeatedModelSet` repeats one set's components R times over
shared parameters.  Both update their members in place.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from beer_tpu_torch.models.basemodel import Model


class ModelSet(Model):
    """Marker base class for vectorized model sets."""

    def __len__(self) -> int:
        raise NotImplementedError


class JointModelSet(ModelSet):
    """Concatenation of model sets evaluated jointly on the same data.

    K₁ + K₂ + … components drawn from sets with their own priors (e.g. two
    NormalSets).  Every member scores member 0's statistics, so the
    members must share one statistics layout: :meth:`create` refuses
    members whose (cov_type, dim) differ.  The ELLH is the column-wise
    concatenation; accumulation splits the responsibilities back.
    """

    def __init__(self, modelsets):
        super().__init__()
        self.modelsets = nn.ModuleList(modelsets)

    @classmethod
    def create(cls, modelsets) -> "JointModelSet":
        sets = list(modelsets)
        sigs = [(getattr(s, "cov_type", None), getattr(s, "dim", None)) for s in sets]
        known = {sig for sig in sigs if any(v is not None for v in sig)}
        if len(known) > 1:
            raise ValueError(
                "JointModelSet members must share one sufficient-statistics "
                f"layout; got (cov_type, dim) signatures {sorted(known)}")
        return cls(sets)

    def __len__(self) -> int:
        return sum(len(s) for s in self.modelsets)

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return self.modelsets[0].sufficient_statistics(data)

    def expected_log_likelihood(self, stats: torch.Tensor) -> torch.Tensor:
        return torch.cat([s.expected_log_likelihood(stats) for s in self.modelsets], dim=-1)

    def infer(self, stats: torch.Tensor):
        return self.expected_log_likelihood(stats), {}

    def accumulate(self, stats: torch.Tensor, resps: torch.Tensor) -> Dict[str, Any]:
        out, off = [], 0
        for s in self.modelsets:
            k = len(s)
            out.append(s.accumulate(stats, resps[..., off:off + k]))
            off += k
        return {"modelsets": tuple(out)}

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return sum(s.kl_div_posterior_prior() for s in self.modelsets)

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "JointModelSet":
        for s, a in zip(self.modelsets, acc["modelsets"]):
            s.vb_update(a, lrate)
        return self

    def to_numpy(self) -> Dict[str, Any]:
        """The inverse of :func:`beer_tpu_torch.convert.modelset_from_numpy`."""
        return {"type": "JointModelSet", "modelsets": [s.to_numpy() for s in self.modelsets]}


class RepeatedModelSet(ModelSet):
    """A base set of K components repeated R times (parameter sharing).

    R·K virtual components backed by K real parameters (e.g. HMM states
    sharing one emission inventory).  The ELLH tiles the base columns;
    accumulation sums the responsibilities across repeats, so every
    repeat's evidence updates the shared parameters.
    """

    def __init__(self, modelset, repeats: int = 1):
        super().__init__()
        self.modelset = modelset
        self.repeats = repeats

    @classmethod
    def create(cls, modelset, repeats: int) -> "RepeatedModelSet":
        return cls(modelset, repeats)

    def __len__(self) -> int:
        return self.repeats * len(self.modelset)

    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return self.modelset.sufficient_statistics(data)

    def expected_log_likelihood(self, stats: torch.Tensor) -> torch.Tensor:
        base = self.modelset.expected_log_likelihood(stats)   # (..., K)
        return base.repeat(*(1,) * (base.ndim - 1), self.repeats)

    def infer(self, stats: torch.Tensor):
        return self.expected_log_likelihood(stats), {}

    def accumulate(self, stats: torch.Tensor, resps: torch.Tensor) -> Dict[str, Any]:
        folded = resps.reshape(*resps.shape[:-1], self.repeats, len(self.modelset)).sum(-2)
        return self.modelset.accumulate(stats, folded)

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.modelset.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "RepeatedModelSet":
        self.modelset.vb_update(acc, lrate)
        return self

    def to_numpy(self) -> Dict[str, Any]:
        """The inverse of :func:`beer_tpu_torch.convert.modelset_from_numpy`."""
        return {"type": "RepeatedModelSet", "repeats": self.repeats,
                "modelset": self.modelset.to_numpy()}
