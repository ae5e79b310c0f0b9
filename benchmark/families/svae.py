"""The structured VAE through the program: ``beer_tpu_torch.SequenceVAE``
over a ``PhoneLoop`` of diagonal Normal-Gamma states in the latent space,
built from the configuration, the seed-made initial means and the seed;
its nnet weights in the reference's layout; and the work one hybrid step
needs, counted from the shapes.
"""

from __future__ import annotations

import torch

from benchmark.families import phone_loop


def build(cfg: dict, init_means: torch.Tensor, seed: int):
    """The latent phone loop from the first ``latent_dim`` columns of the
    seed-made means (i.i.d. N(prior_mean, noise_std²) draws), the nnets
    drawn on the CPU from a generator seeded with ``seed``."""
    import beer_tpu_torch as bt

    dz = cfg["latent_dim"]
    latent = phone_loop.build(dict(cfg, dim=dz), init_means[:, :dz].contiguous())
    return bt.SequenceVAE.create(cfg["dim"], dz, latent, hidden=tuple(cfg["hidden"]),
                                 nsamples=cfg["nsamples"], output=cfg["output"],
                                 generator=torch.Generator().manual_seed(seed))


def posteriors(model) -> dict:
    return phone_loop.posteriors(model.latent_model)


def priors(model) -> dict:
    return phone_loop.priors(model.latent_model)


def _linears(model) -> dict:
    out = {}
    for side, net in (("enc", model.encoder), ("dec", model.decoder)):
        for i, layer in enumerate(net.trunk.layers):
            out[f"{side}.{i}"] = layer
        out[f"{side}.mean"], out[f"{side}.logvar"] = net.head.mean, net.head.logvar
    return out


def nnet_state(model, grads: bool = False) -> dict:
    """The nnet weights (or, with ``grads``, their gradients) as detached
    copies in the reference's layout: ``<side>.<layer>.w`` (out, in) and
    ``.b``, side ``enc`` or ``dec``, layer a trunk index, ``mean`` or
    ``logvar``."""
    out = {}
    for name, layer in _linears(model).items():
        for key, p in (("w", layer.weight), ("b", layer.bias)):
            out[f"{name}.{key}"] = (p.grad if grads else p).detach().clone()
    return out


def work(cfg: dict, lens: torch.Tensor, t_len: int) -> dict:
    """Float32 operations and bytes of one hybrid step over the valid
    frames N of ``lens`` (padding is not useful work; B rows padded to
    ``t_len``), each input byte read once and each output byte written
    once.  Widths: D observations, dz latent, hidden H₁ … H_L, S states,
    P = 2·dz statistics, U units, n samples.

    * nnet forward a frame, G = 2·(D·H₁ + Σ H_i·H_{i+1} + H_L·2dz) for the
      encoder and n times 2·(dz·H₁ + Σ H_i·H_{i+1} + H_L·2D) for the
      decoder;
    * the latent phone loop a frame and sample (``prior_flops``): K1's
      ELLH 2·S·P and banded forward 8·S, K11's ELLH 2·S·P and γ-emitting
      backward 12·S, the loop-back ξ 2·U²; it reads the statistics and
      writes γ (``prior_bytes``);
    * ``forward_flops``: G·N, the prior, and the emission moments γᵀ·stats
      2·S·P a frame and sample; it reads the frames, ε and the weights;
    * ``backward_flops``: twice the forward's GEMMs, 2·G·N, and the Fisher
      backward γ·w 2·S·P a frame and sample; it reads the frames, ε and
      the weights and writes the gradients;
    * ``step_flops`` = forward + backward (Adam and the conjugate update
      are parameter-sized and left out);
    * ``nnet_valid_frames``: the frames the nnets need, (1 + n)·N.
    """
    n = float(lens.sum())
    d, dz, ns = cfg["dim"], cfg["latent_dim"], cfg["nsamples"]
    hidden = list(cfg["hidden"])
    s, p, u = cfg["components"], 2 * cfg["latent_dim"], cfg["units"]

    def mlp(n_in, n_out):
        sizes = [n_in, *hidden]
        pairs = list(zip(sizes[:-1], sizes[1:])) + [(hidden[-1], n_out)] * 2
        return 2 * sum(a * b for a, b in pairs), sum(a * b + b for a, b in pairs)

    (enc, enc_params), (dec, dec_params) = mlp(d, dz), mlp(dz, d)
    gemm = enc + ns * dec
    n_params = enc_params + dec_params
    prior = ns * n * (4 * s * p + 20 * s + 2 * u * u)
    inputs = 4 * (n * (d + ns * dz) + n_params)
    return {"forward_flops": gemm * n + prior + ns * n * 2 * s * p,
            "backward_flops": 2 * gemm * n + ns * n * 2 * s * p,
            "step_flops": 3 * gemm * n + prior + ns * n * 4 * s * p,
            "forward_bytes": inputs,
            "backward_bytes": inputs + 4 * n_params,
            "prior_flops": prior,
            "prior_bytes": 4 * ns * n * (p + s),
            "nnet_valid_frames": (1 + ns) * n}
