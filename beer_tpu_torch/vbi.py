"""Variational-Bayes objective and conjugate optimizer (PyTorch).

Counterpart of ``beer_tpu/vbi.py``:

* :func:`elbo_and_stats` — one E-step: ELBO value + scaled accumulated
  statistics dict,
* :func:`vb_step` — E-step + conjugate M-step, returns ``(elbo, model)``.
  The model's buffers are updated IN PLACE and the same model object is
  returned (the JAX package returns a new pytree),
* :func:`tree_add` — the sum of two statistics dicts (minibatches,
  map-reduce shards),

and the reference-API veneer: :func:`evidence_lower_bound` returns an
:class:`ELBO` whose ``.backward()`` is a no-op (statistics are already
computed), and :class:`VBConjugateOptimizer` applies the steps.
:class:`VBOptimizer` is the hybrid of the VAE: a ``torch.optim``
optimizer for the nnet parameters plus the conjugate step.

The ELBO is summed in float64 whatever the model's dtype: it is a
scalar over ~10⁵ frames, where float32 rounding alone would exceed the
per-frame tolerances used to check VB-EM monotonicity.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch


def _scale(acc: Any, scale: float) -> Any:
    if isinstance(acc, dict):
        return {k: _scale(v, scale) for k, v in acc.items()}
    return scale * acc


def tree_add(a: Any, b: Any) -> Any:
    """The sum of two statistics dicts of the same layout (as
    :func:`elbo_and_stats` returns them), leaf by leaf: how minibatch
    and shard statistics are reduced before one conjugate update."""
    if isinstance(a, dict):
        return {k: tree_add(a[k], b[k]) for k in a}
    return a + b


def elbo_and_stats(
    model,
    data: torch.Tensor,
    datasize: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Any]:
    """One VB E-step: ``(elbo, acc)``, with ``acc`` scaled by ``datasize /
    batch_size`` for minibatch training (the reference convention)."""
    stats = model.sufficient_statistics(data)
    if mask is None:
        llh, cache = model.infer(stats)
    else:
        llh, cache = model.infer(stats, mask=mask)
    scale = 1.0 if datasize is None else datasize / llh.numel()
    elbo = scale * llh.sum(dtype=torch.float64) - model.kl_div_posterior_prior().double()
    acc = model.accumulate(stats, cache)
    if datasize is not None:
        acc = _scale(acc, scale)
    return elbo, acc


@torch.no_grad()
def vb_step(
    model,
    data: torch.Tensor,
    datasize: Optional[int] = None,
    lrate: float = 1.0,
    mask: Optional[torch.Tensor] = None,
):
    """E-step + conjugate M-step (in place); returns ``(elbo, model)``."""
    elbo, acc = elbo_and_stats(model, data, datasize, mask)
    return elbo, model.vb_update(acc, lrate)


class ELBO:
    """Value + statistics of one evidence-lower-bound evaluation."""

    def __init__(self, value: torch.Tensor, acc: Any):
        self.value = value
        self.acc = acc

    def backward(self) -> "ELBO":
        """No-op kept for reference-notebook compatibility: the statistics
        were computed explicitly and already live in ``self.acc``."""
        return self

    def __float__(self) -> float:
        return float(self.value)

    def __repr__(self) -> str:
        return f"ELBO({float(self.value):.6f})"


def evidence_lower_bound(model, data, datasize: Optional[int] = None,
                         mask: Optional[torch.Tensor] = None) -> ELBO:
    """Reference-compatible entry point (``beer.evidence_lower_bound``)."""
    with torch.no_grad():
        value, acc = elbo_and_stats(model, data, datasize, mask)
    return ELBO(value, acc)


class VBConjugateOptimizer:
    """Natural-parameter coordinate-ascent "optimizer" (reference API)::

        optim = VBConjugateOptimizer(model, lrate=1.)
        for epoch in range(E):
            optim.init_step()
            elbo = evidence_lower_bound(optim.model, X, datasize=N)
            elbo.backward()
            optim.step(elbo)
    """

    def __init__(self, model, lrate: float = 1.0):
        self.model = model
        self.lrate = lrate

    def init_step(self) -> None:
        """Kept for API parity; statistics are per-ELBO, nothing to zero."""

    @torch.no_grad()
    def step(self, elbo: ELBO):
        self.model = self.model.vb_update(elbo.acc, self.lrate)
        return self.model


class VBOptimizer:
    """Hybrid optimizer: a ``torch.optim`` step on the nnet parameters
    plus the conjugate natural step on the model (the reference's
    ``VBOptimizer``)::

        optim = VBOptimizer(vae, torch.optim.Adam(vae.parameters(), lr=1e-3))
        optim.zero_grad()
        elbo, acc = vae.elbo_and_stats(x, generator)
        (-elbo).backward()
        optim.step(acc)

    ``step`` must follow ``backward()``: the conjugate update writes the
    model's buffers in place.
    """

    def __init__(self, model, optimizer: torch.optim.Optimizer, lrate: float = 1.0):
        self.model = model
        self.optimizer = optimizer
        self.lrate = lrate

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, acc):
        self.optimizer.step()
        with torch.no_grad():
            self.model = self.model.vb_update(acc, self.lrate)
        return self.model
