"""Normalizing-flow blocks for richer VAE posteriors (PyTorch).

Counterpart of ``beer_tpu/nnet/flows.py``:

* :class:`PlanarFlow` — z' = z + û·tanh(wᵀz + b), with the û
  reparameterisation (wᵀû ≥ −1) that keeps the flow invertible;
* :class:`AffineAutoregressiveFlow` — one masked (MADE) affine IAF step,
  z'_d = z_d · exp(s_d(z_{<d})) + m_d(z_{<d}), its masks as buffers;
* :class:`FlowStack` and :func:`flow_rsample`, which pushes a diagonal
  Normal sample through the stack and returns (z_K, log q(z_K)).

Parameters are initialised as the JAX package initialises them (normal
with σ 0.1 or 0.01, zero biases) from an explicit ``torch.Generator``,
and named as flax names them, so :func:`beer_tpu_torch.nnet.flax_tree`
carries them across.
"""

from __future__ import annotations

import torch
from torch import nn

from beer_tpu_torch import nnet


def _normal(shape, std, generator, dtype) -> nn.Parameter:
    return nn.Parameter(std * torch.randn(shape, generator=generator, dtype=dtype))


class PlanarFlow(nn.Module):
    flax_name = "PlanarFlow"

    def __init__(self, dim: int, generator=None, dtype=None):
        super().__init__()
        self.u = _normal((dim,), 0.1, generator, dtype)
        self.w = _normal((dim,), 0.1, generator, dtype)
        self.b = nn.Parameter(torch.zeros((), dtype=dtype))

    def forward(self, z):
        """(z', log|det ∂z'/∂z|), batched over the leading dims."""
        u, w = self.u, self.w
        wu = (w * u).sum()
        m = -1.0 + torch.logaddexp(wu, torch.zeros_like(wu))   # −1 + softplus(wᵀu)
        u_hat = u + (m - wu) * w / (w**2).sum()
        lin = z @ w + self.b
        z_new = z + u_hat * torch.tanh(lin)[..., None]
        psi = (1.0 - torch.tanh(lin) ** 2)[..., None] * w
        return z_new, torch.log(torch.abs(1.0 + psi @ u_hat) + 1e-12)

    def flax_children(self):
        return {"u": self.u, "w": self.w, "b": self.b}


class AffineAutoregressiveFlow(nn.Module):
    """One masked-affine IAF step with a small MADE conditioner."""

    flax_name = "AffineAutoregressiveFlow"

    def __init__(self, dim: int, hidden: int = 32, generator=None, dtype=None):
        super().__init__()
        dtype = dtype or torch.get_default_dtype()
        in_deg = torch.arange(1, dim + 1)
        hid_deg = torch.arange(hidden) % max(dim - 1, 1) + 1
        # every output depends on z_{<d} only
        self.register_buffer("m1", (hid_deg[None, :] >= in_deg[:, None]).to(dtype))
        self.register_buffer("m2", (in_deg[None, :] > hid_deg[:, None]).to(dtype))
        self.w1 = _normal((dim, hidden), 0.1, generator, dtype)
        self.b1 = nn.Parameter(torch.zeros(hidden, dtype=dtype))
        self.w_m = _normal((hidden, dim), 0.01, generator, dtype)
        self.w_s = _normal((hidden, dim), 0.01, generator, dtype)
        self.b_m = nn.Parameter(torch.zeros(dim, dtype=dtype))
        self.b_s = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, z):
        h = torch.tanh(z @ (self.w1 * self.m1) + self.b1)
        shift = h @ (self.w_m * self.m2) + self.b_m
        log_scale = torch.clamp(h @ (self.w_s * self.m2) + self.b_s, -5.0, 5.0)
        return z * torch.exp(log_scale) + shift, log_scale.sum(-1)

    def flax_children(self):
        return {name: getattr(self, name) for name in ("w1", "b1", "w_m", "w_s", "b_m", "b_s")}


class FlowStack(nn.Module):
    """``n_planar`` planar flows, then ``n_iaf`` IAF steps; returns (z_K,
    Σ log-dets)."""

    def __init__(self, dim: int, n_planar: int = 2, n_iaf: int = 0, generator=None, dtype=None):
        super().__init__()
        self.planar = nn.ModuleList(PlanarFlow(dim, generator, dtype) for _ in range(n_planar))
        self.iaf = nn.ModuleList(AffineAutoregressiveFlow(dim, 32, generator, dtype)
                                 for _ in range(n_iaf))

    def forward(self, z):
        total = z.new_zeros(z.shape[:-1])
        for flow in (*self.planar, *self.iaf):
            z, logdet = flow(z)
            total = total + logdet
        return z, total

    def flax_children(self):
        return {**{f"PlanarFlow_{i}": f for i, f in enumerate(self.planar)},
                **{f"AffineAutoregressiveFlow_{i}": f for i, f in enumerate(self.iaf)}}


def flow_rsample(flow: FlowStack, q_params, generator=None, nsamples: int = 1, eps=None):
    """Sample z₀ ~ N(mean, var) (or from the injected ``eps``) and push it
    through ``flow``.  Returns (z_K, log q(z_K)) with log q(z_K) = log
    N(z₀) − Σ log|det|, the corrected density of the ELBO's entropy term."""
    z0 = nnet.normal_rsample(q_params, generator, nsamples, eps)
    log_q0 = nnet.normal_log_likelihood({k: v[None] for k, v in q_params.items()}, z0)
    z_k, logdet = flow(z0)
    return z_k, log_q0 - logdet
