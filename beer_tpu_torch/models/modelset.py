"""ModelSet protocol: vectorized sets of density models (PyTorch).

Counterpart of the ``ModelSet`` base in ``beer_tpu/models/modelset.py``.
A set is one model whose Bayesian parameters carry a leading component
axis, so every component is evaluated by one (T, P) @ (P, K) product.

Contract (consumed by mixtures and HMM-like models):

* ``sufficient_statistics(x)``       → (..., P) stats,
* ``expected_log_likelihood(stats)`` → (..., K) per-frame per-component,
* ``accumulate(stats, resps)``       → stats dict, resps (..., K),
* ``__len__``                        → K.
"""

from __future__ import annotations

from beer_tpu_torch.models.basemodel import Model


class ModelSet(Model):
    """Marker base class for vectorized model sets."""

    def __len__(self) -> int:
        raise NotImplementedError
