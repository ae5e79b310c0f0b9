"""Numerical guards: finite-value checks on what a step returns.

Counterpart of ``beer_tpu/utils/debug.py``.  There is no checkify: a
guard runs the step, then checks every floating tensor it returned —
tensors, dicts, lists, tuples and the buffers of ``nn.Module``s —
and raises :class:`FloatingPointError` naming the step and the path of
each non-finite field.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch
from torch import nn


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor in ``tree``; a module's are its
    buffers and parameters by their dotted names."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, nn.Module):
        for name, t in list(tree.named_buffers()) + list(tree.named_parameters()):
            yield f"{path}.{name}", t
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")


def _non_finite(tree):
    """Paths of the floating tensors of ``tree`` that hold a NaN or an Inf
    (one flag a tensor, read back in one transfer)."""
    leaves = [(p, t) for p, t in _leaves(tree) if t.is_floating_point()]
    if not leaves:
        return []
    flags = torch.stack([torch.isfinite(t).all().to(leaves[0][1].device) for _, t in leaves])
    return [p for (p, _), ok in zip(leaves, flags.tolist()) if not ok]


def guard_finite_outputs(name: str = "step"):
    """``check(tree)``, which raises :class:`FloatingPointError` naming
    ``name`` and the paths of the non-finite fields of ``tree``."""

    def check(tree):
        bad = _non_finite(tree)
        if bad:
            raise FloatingPointError(f"{name}: non-finite values in outputs at {bad}")

    return check


def nan_guard(fn, name: str = "fn"):
    """``fn`` with its outputs checked: a non-finite value in any floating
    tensor it returns raises :class:`FloatingPointError` naming ``name``
    and the field.  Usage::

        step = nan_guard(vb_step, "vb_step")
        elbo, model = step(model, x, mask=m)
    """
    check = guard_finite_outputs(name)

    def checked(*args, **kw):
        out = fn(*args, **kw)
        check(out)
        return out

    return checked


def assert_finite(tree, name: str = "tree") -> None:
    """Finite check for tests and debugging."""
    bad = _non_finite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values at {name}{bad[0]}")
