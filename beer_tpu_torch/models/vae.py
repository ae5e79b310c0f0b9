"""(Structured) variational autoencoder (PyTorch).

Counterpart of ``beer_tpu/models/vae.py``: an encoder MLP with a
diagonal-Normal head gives q(z|x), reparameterised samples of z go
through the decoder (data likelihood) and through a conjugate latent
model — a :class:`Normal` (plain VAE), a :class:`Mixture` (structured
VAE over frames) or, in :class:`SequenceVAE`, a :class:`PhoneLoop` or
an :class:`HMM` over latent sequences (BASELINE config 5).  Optional
normalizing flows (:mod:`beer_tpu_torch.nnet.flows`) enrich q(z|x).

The ELBO mixes Monte-Carlo terms (reconstruction, q-entropy) with the
latent model's expected log-likelihood (log Z for a sequence model) and
its conjugate KL.  One hybrid step (:func:`make_vae_train_step`)
back-propagates the ELBO into the nnet parameters, takes a
``torch.optim`` step, then applies the latent model's conjugate update
in place from the statistics of the same E-step.  The gradient through
the latent model runs its ``torch.autograd.Function`` classes, whose
backward is the Fisher identity (∂log Z/∂llh = γ), through the CUDA
kernels on the card (the phone loop: K1 + K11; the HMM: K5 + K7; the
full-covariance ELLH: K9).  The accumulated statistics are computed
under ``torch.no_grad()``: they feed the conjugate update, not autograd.

The nnet parameters are ``vae.parameters()`` (the latent model holds
buffers only); the noise ε is drawn from a ``torch.Generator`` or
injected (``eps``).  The ELBO is summed in float64.

Spans (:mod:`beer_tpu_torch.utils.profiling`): ``beer.svae.encode`` (the
encoder, the sample and the entropy), ``beer.svae.prior`` (the latent
statistics and the latent model's ``infer``), ``beer.svae.decode`` (the
decoder and the reconstruction), ``beer.kl`` and ``beer.accumulate``
around the ELBO's terms; ``beer.svae.backward`` around the hybrid step's
``backward()``.  :data:`NNET_FRAMES` counts, on the host, the frames the
nnets ran over.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from beer_tpu_torch import nnet
from beer_tpu_torch.nnet import flows as nnet_flows
from beer_tpu_torch.utils.profiling import named_scope
from beer_tpu_torch.vbi import VBOptimizer


@dataclasses.dataclass
class FrameCount:
    """Frames the nnets ran over, padding included: the encoder's N (B·T
    for sequences) and the decoder's nsamples·N at each evaluation of the
    ELBO's terms, counted from the shapes on the host."""

    frames: int = 0


NNET_FRAMES = FrameCount()


def _scale(acc: Any, scale: float) -> Any:
    if isinstance(acc, dict):
        return {k: _scale(v, scale) for k, v in acc.items()}
    return scale * acc


class Encoder(nn.Module):
    """MLP (or residual) trunk + a probabilistic head: the encoder
    (diagonal Normal) and the decoder (Normal, isotropic Normal or
    Bernoulli)."""

    def __init__(self, trunk: nn.Module, head: nn.Module):
        super().__init__()
        self.trunk = trunk
        self.head = head

    def forward(self, x):
        return self.head(self.trunk(x))

    def flax_children(self):
        return {f"{self.trunk.flax_name}_0": self.trunk, f"{self.head.flax_name}_0": self.head}


class VAE(nn.Module):
    """VAE whose prior over z is a conjugate latent model (frames i.i.d.)."""

    def __init__(self, encoder: Encoder, decoder: Encoder, latent_model: nn.Module,
                 flow: Optional[nnet_flows.FlowStack] = None, latent_dim: int = 2,
                 nsamples: int = 1):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.flow = flow
        self.latent_model = latent_model
        self.latent_dim = latent_dim
        self.nsamples = nsamples

    @classmethod
    def create(cls, obs_dim: int, latent_dim: int, latent_model, hidden=(128, 128),
               nsamples: int = 1, output: str = "normal", residual: bool = False,
               n_flow_planar: int = 0, n_flow_iaf: int = 0,
               generator: Optional[torch.Generator] = None) -> "VAE":
        """Encoder/decoder trunks (tanh MLPs, or residual) with a Normal /
        Normal-iso / Bernoulli output head and an optional flow posterior.
        The weights are drawn on the CPU from ``generator`` (a CPU
        generator; seeded with 0 when omitted) and moved to the latent
        model's device and dtype."""
        like = next(latent_model.buffers())
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        trunk = nnet.ResMLP if residual else nnet.MLP
        hidden = tuple(hidden)

        def build(n_in, head, dim):
            body = trunk(n_in, hidden, torch.tanh, generator, like.dtype)
            return Encoder(body, nnet.build_head(head, body.out_features, dim, generator,
                                                 like.dtype))

        encoder = build(obs_dim, "normal", latent_dim)
        decoder = build(latent_dim, output, obs_dim)
        flow = None
        if n_flow_planar or n_flow_iaf:
            flow = nnet_flows.FlowStack(latent_dim, n_flow_planar, n_flow_iaf, generator,
                                        like.dtype)
        vae = cls(encoder, decoder, latent_model, flow, latent_dim, nsamples)
        return vae.to(like.device)

    # ------------------------------------------------------------------
    def _sample_posterior(self, q, generator, eps):
        """(z (S, ..., dz), the ELBO's entropy term): the analytic H(q), or
        −E[log q(z_K)] with the flow's log-det corrections."""
        if self.flow is None:
            return nnet.normal_rsample(q, generator, self.nsamples, eps), nnet.normal_entropy(q)
        z, log_q = nnet_flows.flow_rsample(self.flow, q, generator, self.nsamples, eps)
        return z, -log_q.mean(0)

    def _reconstruction(self, flat_z, x_rep):
        out = self.decoder(flat_z)
        if "logits" in out:
            return nnet.bernoulli_log_likelihood(out, x_rep)
        return nnet.normal_log_likelihood(out, x_rep)

    def _elbo(self, terms: torch.Tensor, scale: float) -> torch.Tensor:
        with named_scope("beer.kl"):
            kl = self.latent_model.kl_div_posterior_prior()
        return scale * terms.sum(dtype=torch.float64) - kl.double()

    def _accumulate(self, stats, cache, scale: float):
        with torch.no_grad(), named_scope("beer.accumulate"):
            return _scale(self.latent_model.accumulate(stats, cache), scale / self.nsamples)

    def _terms(self, x, mask, generator, eps):
        """Per-frame rec + E_q[prior ELLH] + H(q), the latent statistics,
        the latent model's cache and q (``mask`` is unused: frames are
        i.i.d.)."""
        n = x.shape[0]
        with named_scope("beer.svae.encode"):
            q = self.encoder(x)
            z, entropy = self._sample_posterior(q, generator, eps)  # (S, N, dz)
            NNET_FRAMES.frames += n
        with named_scope("beer.svae.prior"):
            flat_z = z.reshape(-1, self.latent_dim)
            stats = self.latent_model.sufficient_statistics(flat_z)
            prior_llh, cache = self.latent_model.infer(stats)
            prior_llh = prior_llh.reshape(self.nsamples, n).mean(0)
        with named_scope("beer.svae.decode"):
            x_rep = x[None].expand(self.nsamples, *x.shape).reshape(-1, x.shape[-1])
            rec = self._reconstruction(flat_z, x_rep).reshape(self.nsamples, n).mean(0)
            NNET_FRAMES.frames += flat_z.shape[0]
        return rec + prior_llh + entropy, stats, cache, q

    def elbo_and_stats(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                       datasize=None, mask=None, eps: Optional[torch.Tensor] = None):
        """Monte-Carlo ELBO (float64, differentiable in the nnet
        parameters) and the latent model's statistics (detached):

        ELBO = E_q[log p(x|z)] + E_q[E_θ log p(z|θ)] + H(q(z|x)) − KL(q(θ)‖p(θ)).

        ``x`` (N, D) frames, or (B, T, D) utterances with a (B, T)
        ``mask`` for :class:`SequenceVAE`; ``eps`` (nsamples, *x.shape[:-1],
        dz) injects the noise."""
        scale = 1.0 if datasize is None else datasize / x.shape[0]
        terms, stats, cache, _ = self._terms(x, mask, generator, eps)
        return self._elbo(terms, scale), self._accumulate(stats, cache, scale)

    # -- Model API ------------------------------------------------------
    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return data

    def _fixed_noise(self, x):
        return torch.Generator(device=x.device).manual_seed(0)

    def infer(self, stats: torch.Tensor, mask: Optional[torch.Tensor] = None,
              eps: Optional[torch.Tensor] = None):
        """Monte-Carlo ELBO terms rec + E_q[prior ELLH] + H(q), per frame
        (per sequence for :class:`SequenceVAE`, over the true frames of
        ``mask``), with a fixed noise (a generator seeded with 0, or
        ``eps``), and ``{"posterior": q}``."""
        terms, _, _, q = self._terms(stats, mask, self._fixed_noise(stats), eps)
        return terms, {"posterior": q}

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.latent_model.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "VAE":
        """The latent model's conjugate step, in place; returns ``self``."""
        self.latent_model.vb_update(acc, lrate)
        return self

    def mean_field_factorization(self):
        """The latent model's conjugate groups, as dotted paths."""
        return [[f"latent_model.{name}" for name in group]
                for group in self.latent_model.mean_field_factorization()]

    def posteriors(self, x: torch.Tensor):
        """q(z|x) head outputs (mean, logvar)."""
        return self.encoder(x)

    # ------------------------------------------------------------------
    def to_numpy(self) -> Dict[str, Any]:
        """The nnets as the JAX package's flax trees and the latent model's
        ``to_numpy()``; the inverse of
        :func:`beer_tpu_torch.convert.vae_from_numpy`."""
        out = {"type": type(self).__name__, "latent_type": type(self.latent_model).__name__,
               "latent_model": self.latent_model.to_numpy(), "nsamples": self.nsamples,
               "encoder": {"params": nnet.flax_tree(self.encoder)},
               "decoder": {"params": nnet.flax_tree(self.decoder)}}
        if self.flow is not None:
            out["flow"] = {"params": nnet.flax_tree(self.flow)}
        return out


class SequenceVAE(VAE):
    """Structured VAE whose latent prior is a sequence model (a phone loop
    or an HMM): data (B, T, D) with a (B, T) prefix mask; each sampled
    latent sequence runs through the latent model's E-step."""

    def _terms(self, x, mask, generator, eps):
        """Per-sequence terms: entropy and reconstruction summed over the
        true frames of ``mask`` (default all ones), log Z of each sampled
        latent sequence."""
        b, t, _ = x.shape
        if mask is None:
            mask = x.new_ones(b, t)
        s = self.nsamples
        with named_scope("beer.svae.encode"):
            q = self.encoder(x)
            z, entropy = self._sample_posterior(q, generator, eps)    # (S, B, T, dz)
            entropy = (entropy * mask).sum(-1)                        # (B,)
            NNET_FRAMES.frames += b * t
        with named_scope("beer.svae.prior"):
            flat_z = z.reshape(s * b, t, self.latent_dim)
            mask_rep = mask.repeat(s, 1)
            stats = self.latent_model.sufficient_statistics(flat_z)
            log_z, cache = self.latent_model.infer(stats, mask=mask_rep)
            prior_llh = log_z.reshape(s, b).mean(0)                   # (B,)
        with named_scope("beer.svae.decode"):
            x_rep = x[None].expand(s, *x.shape).reshape(s * b, t, x.shape[-1])
            rec = (self._reconstruction(flat_z, x_rep) * mask_rep).sum(-1).reshape(s, b).mean(0)
            NNET_FRAMES.frames += s * b * t
        return rec + prior_llh + entropy, stats, cache, q

    @torch.no_grad()
    def latent_decode(self, x: torch.Tensor, mask=None):
        """Viterbi on the latent posterior means: (labels (B, T), scores
        (B,)); unit labels for a phone loop (K3 + K4 on the card), state
        paths otherwise."""
        z = self.posteriors(x)["mean"]
        if hasattr(self.latent_model, "decode_units"):
            return self.latent_model.decode_units(z, mask)
        return self.latent_model.decode(z, mask)


def make_vae_train_step(optimizer: torch.optim.Optimizer, datasize=None, lrate: float = 1.0):
    """The hybrid step: a ``torch.optim`` step on the nnet parameters and
    the conjugate step on the latent model, from one E-step.

    Returns ``step(vae, x, generator, mask=None, eps=None) -> elbo``
    (float64, detached); ``mask`` applies to :class:`SequenceVAE`.  The
    backward runs before the in-place conjugate update, which would
    otherwise change tensors that autograd saved."""

    def step(vae: VAE, x, generator=None, mask=None, eps=None):
        hybrid = VBOptimizer(vae, optimizer, lrate)
        hybrid.zero_grad()
        elbo, acc = vae.elbo_and_stats(x, generator, datasize, mask, eps)
        with named_scope("beer.svae.backward"):
            (-elbo).backward()
        hybrid.step(acc)
        return elbo.detach()

    return step
