"""Variational-Bayes objective and conjugate optimizer (PyTorch).

Counterpart of ``beer_tpu/vbi.py``:

* :func:`elbo_and_stats` — one E-step: ELBO value + scaled accumulated
  statistics dict,
* :func:`vb_step` — E-step + conjugate M-step, returns ``(elbo, model)``.
  The model's buffers are updated IN PLACE and the same model object is
  returned (the JAX package returns a new pytree),
* :func:`vb_update_partial` / :func:`vb_step_coordinate` — mean-field
  coordinate ascent over ``model.mean_field_factorization()``'s groups:
  one E-step and one update per group, each update confined to its
  group,
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

Spans (:mod:`beer_tpu_torch.utils.profiling`): ``beer.vb_step`` around
:func:`vb_step`, ``beer.estep`` around :func:`elbo_and_stats` and,
inside it, ``beer.stats``, ``beer.infer``, ``beer.kl`` and
``beer.accumulate`` around the model's four calls; ``beer.svae.optim``
around :class:`VBOptimizer`'s ``torch.optim`` step.
"""

from __future__ import annotations

import inspect
from typing import Any, Optional, Sequence, Tuple

import torch

from beer_tpu_torch.utils.profiling import named_scope


def _scale(acc: Any, scale: float) -> Any:
    if isinstance(acc, dict):
        return {k: _scale(v, scale) for k, v in acc.items()}
    if isinstance(acc, (tuple, list)):
        return type(acc)(_scale(v, scale) for v in acc)
    return scale * acc


def tree_add(a: Any, b: Any) -> Any:
    """The sum of two statistics dicts of the same layout (as
    :func:`elbo_and_stats` returns them), leaf by leaf: how minibatch
    and shard statistics are reduced before one conjugate update."""
    if isinstance(a, dict):
        return {k: tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(tree_add(x, y) for x, y in zip(a, b))
    return a + b


def elbo_and_stats(
    model,
    data: torch.Tensor,
    datasize: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    **infer_kw,
) -> Tuple[torch.Tensor, Any]:
    """One VB E-step: ``(elbo, acc)``, with ``acc`` scaled by ``datasize /
    batch_size`` for minibatch training (the reference convention).
    ``infer_kw`` go to ``model.infer`` (PLDA's ``labels`` and
    ``n_classes``)."""
    with named_scope("beer.estep"):
        with named_scope("beer.stats"):
            stats = model.sufficient_statistics(data)
        if mask is not None:
            infer_kw["mask"] = mask
        with named_scope("beer.infer"):
            llh, cache = model.infer(stats, **infer_kw)
        scale = 1.0 if datasize is None else datasize / llh.numel()
        with named_scope("beer.kl"):
            kl = model.kl_div_posterior_prior()
        elbo = scale * llh.sum(dtype=torch.float64) - kl.double()
        with named_scope("beer.accumulate"):
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
    **infer_kw,
):
    """E-step + conjugate M-step (in place); returns ``(elbo, model)``."""
    with named_scope("beer.vb_step"):
        elbo, acc = elbo_and_stats(model, data, datasize, mask, **infer_kw)
        return elbo, model.vb_update(acc, lrate)


def _field_tensors(module: torch.nn.Module, name: str):
    """(owner, key) of every buffer and parameter that field ``name``
    of ``module`` holds: the field itself when it is a buffer or a
    parameter, every one under it when it is a sub-module."""
    if name in module._buffers or name in module._parameters:
        return [(module, name)]
    return [(owner, key) for owner in getattr(module, name).modules()
            for key in (*owner._buffers, *owner._parameters)]


def _snapshot(module: torch.nn.Module, paths: Sequence[str]):
    """Copies of the state of every field of ``module`` outside ``paths``
    (dotted paths address fields of sub-modules)."""
    take, nested = set(), {}
    for p in paths:
        head, _, rest = p.partition(".")
        if rest:
            nested.setdefault(head, []).append(rest)
        else:
            take.add(p)
    fields = [n for n, _ in module.named_children()] + [
        n for n in (*module._buffers, *module._parameters)]
    saved = []
    for name in fields:
        if name in take:
            continue
        if name in nested:
            saved += _snapshot(getattr(module, name), nested[name])
            continue
        for owner, key in _field_tensors(module, name):
            value = getattr(owner, key)
            if value is not None:
                saved.append((owner, key, value.detach().clone()))
    return saved


def vb_update_partial(model, acc, group: Sequence[str], lrate: float = 1.0):
    """The conjugate update of the fields in ``group`` only, in place;
    returns the model.

    The building block of mean-field coordinate ascent over
    ``model.mean_field_factorization()``'s groups.  A model whose
    ``vb_update`` takes ``group=`` (PPCA, PLDA: sequential coordinate
    updates) gets it and updates those fields only, holding the others
    at their values inside the update.  For every other model the state
    of each field outside the group is copied, the whole update runs, and
    the copies are written back; that is exact, since each parameter's
    conjugate update depends on the statistics only."""
    if "group" in inspect.signature(model.vb_update).parameters:
        return model.vb_update(acc, lrate, group=group)
    saved = _snapshot(model, group)
    model.vb_update(acc, lrate)
    with torch.no_grad():
        for owner, key, value in saved:
            getattr(owner, key).copy_(value)
    return model


@torch.no_grad()
def vb_step_coordinate(
    model,
    data: torch.Tensor,
    datasize: Optional[int] = None,
    lrate: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    **infer_kw,
):
    """Mean-field coordinate ascent: one E-step and one update per group of
    ``model.mean_field_factorization()``, in place.  Returns ``(elbo,
    model)`` with the ELBO of the last group's E-step.  It can climb
    further than :func:`vb_step` a data pass, at the cost of one E-step a
    group."""
    elbo = None
    for group in model.mean_field_factorization():
        elbo, acc = elbo_and_stats(model, data, datasize, mask, **infer_kw)
        vb_update_partial(model, acc, group, lrate)
    return elbo, model


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
                         mask: Optional[torch.Tensor] = None, **infer_kw) -> ELBO:
    """Reference-compatible entry point (``beer.evidence_lower_bound``)."""
    with torch.no_grad():
        value, acc = elbo_and_stats(model, data, datasize, mask, **infer_kw)
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
        with named_scope("beer.svae.optim"):
            self.optimizer.step()
        with torch.no_grad():
            self.model = self.model.vb_update(acc, self.lrate)
        return self.model
