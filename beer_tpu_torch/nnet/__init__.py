"""Neural building blocks of the VAE (PyTorch).

Counterpart of ``beer_tpu/nnet/__init__.py``: MLP and residual trunks,
probabilistic output heads (diagonal and isotropic Normal, Bernoulli)
returning parameter dicts, and pure functions over those dicts
(reparameterised sampling, log-likelihood, entropy).  The string
constructors take the JAX package's specs (``"mlp:128,128[:tanh]"``,
``"resmlp:256x3[:relu]"``) plus the input width, which a torch layer
needs up front.

Layers are initialised as flax initialises its ``Dense`` (a lecun-normal
kernel, a zero bias) from an explicit ``torch.Generator``.  The two
packages draw different numbers from one seed, so weights are carried
across as the flax parameter tree: every module here names its children
as flax does (``Dense_0``, ``MLP_0``, …) and :func:`flax_tree` /
:func:`load_flax_tree` map an ``nn.Linear``'s ``weight`` to the flax
``kernel``ᵀ.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

LOG_2PI = math.log(2.0 * math.pi)
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at ±2


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's gelu is the tanh approximation


ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu, "gelu": _gelu, "sigmoid": torch.sigmoid}


def dense(n_in: int, n_out: int, generator: torch.Generator | None = None,
          dtype=None) -> nn.Linear:
    """A CPU ``nn.Linear`` initialised as flax's ``Dense``: kernel from a
    normal truncated at ±2σ with σ = (1/fan_in)^½ / 0.8796 (lecun-normal),
    bias 0."""
    layer = nn.utils.skip_init(nn.Linear, n_in, n_out, dtype=dtype)
    std = math.sqrt(1.0 / n_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """Plain MLP trunk: ``hidden`` sizes with ``activation`` after each."""

    flax_name = "MLP"

    def __init__(self, n_in: int, hidden: Sequence[int], activation: Callable = torch.tanh,
                 generator=None, dtype=None):
        super().__init__()
        sizes = [n_in, *hidden]
        self.layers = nn.ModuleList(dense(a, b, generator, dtype)
                                    for a, b in zip(sizes[:-1], sizes[1:]))
        self.activation = activation
        self.out_features = sizes[-1]

    def forward(self, x):
        for layer in self.layers:
            x = self.activation(layer(x))
        return x

    def flax_children(self):
        return {f"Dense_{i}": layer for i, layer in enumerate(self.layers)}


class ResMLP(nn.Module):
    """Residual MLP trunk: a projection to ``hidden[0]``, then one
    pre-activation residual block per entry of ``hidden`` (all equal)."""

    flax_name = "ResMLP"

    def __init__(self, n_in: int, hidden: Sequence[int], activation: Callable = torch.tanh,
                 generator=None, dtype=None):
        super().__init__()
        width = hidden[0]
        if any(size != width for size in hidden):
            raise ValueError("ResMLP needs constant hidden widths")
        self.proj = dense(n_in, width, generator, dtype)
        self.blocks = nn.ModuleList(dense(width, width, generator, dtype) for _ in hidden)
        self.activation = activation
        self.out_features = width

    def forward(self, x):
        h = self.proj(x)
        for block in self.blocks:
            h = h + block(self.activation(h))
        return self.activation(h)

    def flax_children(self):
        return {"Dense_0": self.proj,
                **{f"Dense_{i + 1}": block for i, block in enumerate(self.blocks)}}


class NormalDiagLayer(nn.Module):
    """Probabilistic head: diagonal Normal (mean, log-variance in ±10)."""

    flax_name = "NormalDiagLayer"

    def __init__(self, n_in: int, dim: int, generator=None, dtype=None):
        super().__init__()
        self.mean = dense(n_in, dim, generator, dtype)
        self.logvar = dense(n_in, dim, generator, dtype)

    def forward(self, h):
        return {"mean": self.mean(h), "logvar": torch.clamp(self.logvar(h), -10.0, 10.0)}

    def flax_children(self):
        return {"Dense_0": self.mean, "Dense_1": self.logvar}


class NormalIsoLayer(NormalDiagLayer):
    """Probabilistic head: isotropic Normal (one log-variance per row,
    broadcast to the diagonal layout)."""

    flax_name = "NormalIsoLayer"

    def __init__(self, n_in: int, dim: int, generator=None, dtype=None):
        nn.Module.__init__(self)
        self.mean = dense(n_in, dim, generator, dtype)
        self.logvar = dense(n_in, 1, generator, dtype)

    def forward(self, h):
        mean = self.mean(h)
        return {"mean": mean, "logvar": torch.clamp(self.logvar(h), -10.0, 10.0).expand_as(mean)}


class BernoulliLayer(nn.Module):
    """Probabilistic head: independent Bernoullis (logits)."""

    flax_name = "BernoulliLayer"

    def __init__(self, n_in: int, dim: int, generator=None, dtype=None):
        super().__init__()
        self.logits = dense(n_in, dim, generator, dtype)

    def forward(self, h):
        return {"logits": self.logits(h)}

    def flax_children(self):
        return {"Dense_0": self.logits}


# ----------------------------------------------------------------------
# Distribution functions over head outputs (pure)
# ----------------------------------------------------------------------
def normal_rsample(params, generator: torch.Generator | None = None, nsamples: int = 1,
                   eps: torch.Tensor | None = None):
    """Reparameterised samples, (nsamples, ..., dim).  ``eps`` (same shape)
    injects the standard-normal noise instead of drawing it from
    ``generator`` (on the parameters' device)."""
    mean, logvar = params["mean"], params["logvar"]
    if eps is None:
        eps = torch.randn((nsamples, *mean.shape), generator=generator, dtype=mean.dtype,
                          device=mean.device)
    return mean[None] + torch.exp(0.5 * logvar)[None] * eps


def normal_log_likelihood(params, x):
    """log N(x | mean, diag(exp(logvar))) summed over the last axis."""
    mean, logvar = params["mean"], params["logvar"]
    return -0.5 * ((x - mean) ** 2 * torch.exp(-logvar) + logvar + LOG_2PI).sum(-1)


def normal_entropy(params):
    """Entropy of the diagonal Normal, summed over the last axis."""
    return 0.5 * (params["logvar"] + 1.0 + LOG_2PI).sum(-1)


def bernoulli_log_likelihood(params, x):
    logits = params["logits"]
    return -(torch.relu(logits) - logits * x + torch.log1p(torch.exp(-logits.abs()))).sum(-1)


# ----------------------------------------------------------------------
# Config-string constructors
# ----------------------------------------------------------------------
_TRUNKS = {"mlp": MLP, "resmlp": ResMLP}
_HEADS = {"normal": NormalDiagLayer, "normal_iso": NormalIsoLayer, "bernoulli": BernoulliLayer}


def build_trunk(spec: str, n_in: int, generator=None, dtype=None) -> nn.Module:
    """An MLP/ResMLP trunk over ``n_in`` inputs from a config string:
    ``"mlp:128,128[:tanh]"`` or ``"resmlp:256x3[:relu]"`` (``WxN`` = N
    blocks of width W)."""
    parts = spec.split(":")
    kind = parts[0].lower()
    if kind not in _TRUNKS:
        raise ValueError(f"unknown trunk kind: {kind!r} (mlp | resmlp)")
    act = ACTIVATIONS[parts[2].lower()] if len(parts) > 2 else torch.tanh
    if "x" in parts[1]:
        width, n = parts[1].split("x")
        sizes = (int(width),) * int(n)
    else:
        sizes = tuple(int(size) for size in parts[1].split(","))
    return _TRUNKS[kind](n_in, sizes, act, generator, dtype)


def build_head(spec: str, n_in: int, dim: int, generator=None, dtype=None) -> nn.Module:
    """A probabilistic head over ``n_in`` inputs: ``"normal" |
    "normal_iso" | "bernoulli"``."""
    try:
        cls = _HEADS[spec.lower()]
    except KeyError:
        raise ValueError(f"unknown head: {spec!r} ({' | '.join(_HEADS)})") from None
    return cls(n_in, dim, generator, dtype)


# ----------------------------------------------------------------------
# The flax parameter tree
# ----------------------------------------------------------------------
def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def flax_tree(module: nn.Module, grads: bool = False) -> dict:
    """The module's parameters as the JAX package's flax tree of numpy
    arrays (``Dense``: ``{"kernel": weightᵀ, "bias"}``); with ``grads``
    their ``.grad`` in the same layout (zeros where there is none)."""

    def value(p):
        if not grads:
            return p
        return torch.zeros_like(p) if p.grad is None else p.grad

    out = {}
    for name, child in module.flax_children().items():
        if isinstance(child, nn.Linear):
            out[name] = {"kernel": _np(value(child.weight).T), "bias": _np(value(child.bias))}
        elif isinstance(child, nn.Parameter):
            out[name] = _np(value(child))
        else:
            out[name] = flax_tree(child, grads)
    return out


@torch.no_grad()
def load_flax_tree(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a flax tree (numpy or JAX arrays) into the module's parameters."""

    def put(p, x):
        p.copy_(torch.as_tensor(np.array(x)).reshape(p.shape))

    for name, child in module.flax_children().items():
        node = tree[name]
        if isinstance(child, nn.Linear):
            put(child.weight, np.asarray(node["kernel"]).T)
            put(child.bias, node["bias"])
        elif isinstance(child, nn.Parameter):
            put(child, node)
        else:
            load_flax_tree(child, node)
    return module
