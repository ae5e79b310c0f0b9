"""Plain reference of the structured VAE over a phone loop: the HMM-VAE of
Ebbers et al. ("Hidden Markov Model Variational Autoencoder for Acoustic
Unit Discovery", Interspeech 2017) as beer implements it
(``beer/models/vae.py``), trained by its hybrid step.

A frame x (D) goes through the encoder, tanh layers and a diagonal-Normal
head (mean, log-variance clamped to ±10), to q(z|x); z = μ + exp(½ logvar)·ε
with ε given; the decoder, the same shape from z, gives a diagonal Normal
over x.  The latent sequences' prior is the phone loop of
:mod:`benchmark.reference.phone_loop` over z's statistics [−½z², z].  With
the data terms scaled by ``scale`` (the corpus over the minibatch), an
utterance's share of the ELBO is

    scale·(Σ_t log N(x_t | dec(z_t)) + mean over samples of log Z(z) + Σ_t H(q(z_t|x_t))),

summed over the rows, less the phone loop's KL, over the valid frames of
each row.  One hybrid step takes the gradient of −ELBO in the nnet
weights, one Adam step on them (torch's defaults: β 0.9, 0.999, ε 1e-8),
and the phone loop's conjugate step at learning rate ρ from the same
E-step's statistics: posterior ← posterior + ρ·(prior + statistics −
posterior).

Departure: the gradient of log Z is taken by the Fisher identity,
∂log Z/∂llh_t = γ_t, from this file's own forward-backward, and carried
to z by autograd through d[−½z², z]·W/dz; exact for this model, whose
state log-likelihoods are affine in the statistics.  Everything else,
the nnets' gradients included, is plain autograd over plain operations,
in row blocks.  Nothing of the program is imported; the nnet weights are
given as tensors in this file's layout: ``<side>.<i>.w`` (out, in) and
``.b`` for the trunk's layers i, ``<side>.mean.*`` and ``<side>.logvar.*``
for the heads, side ``enc`` or ``dec``.
"""

from __future__ import annotations

import torch

from benchmark.reference import common, phone_loop

LEAVES = phone_loop.LEAVES
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


class _Tf32Linear(torch.autograd.Function):
    """x·wᵀ + b with every product's inputs rounded to TF32, the backward's
    too, as the card's tensor cores take them with TF32 on."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return common.to_tf32(x) @ common.to_tf32(w).T + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
        gx = common.to_tf32(g) @ common.to_tf32(w)
        gw = common.to_tf32(g2).T @ common.to_tf32(x2)
        return gx, gw, g2.sum(0)


def _linear(x, w, b, prec: common.Precision):
    if prec.name == "tf32":
        return _Tf32Linear.apply(x, w, b)
    return x @ w.T + b


def _net(weights: dict, side: str, x, prec: common.Precision):
    """(mean, logvar) of the ``side`` net's diagonal-Normal head."""
    i = 0
    while f"{side}.{i}.w" in weights:
        x = torch.tanh(_linear(x, weights[f"{side}.{i}.w"], weights[f"{side}.{i}.b"], prec))
        i += 1
    mean = _linear(x, weights[f"{side}.mean.w"], weights[f"{side}.mean.b"], prec)
    logvar = _linear(x, weights[f"{side}.logvar.w"], weights[f"{side}.logvar.b"], prec)
    return mean, torch.clamp(logvar, -10.0, 10.0)


def initial(cfg: dict, init_means: torch.Tensor, weights: dict, dtype=torch.float64) -> dict:
    """The phone loop's priors and initial posteriors over the first
    ``latent_dim`` columns of the initial means, the given nnet weights
    and Adam's zero moments."""
    dz = cfg["latent_dim"]
    params = phone_loop.initial(dict(cfg, dim=dz), init_means[:, :dz], dtype)
    nnet = {k: v.to(dtype).clone() for k, v in weights.items()}
    zeros = {k: torch.zeros_like(v) for k, v in nnet.items()}
    return dict(params, nnet=nnet, m=zeros, v={k: v.clone() for k, v in zeros.items()}, t=0)


def posteriors(stats, lens, w, bias, trans, init, final, prec: common.Precision):
    """Scaled forward-backward over the statistics ``stats`` (B, T, P) of
    rows of lengths ``lens`` (each ≥ 1), state log-likelihoods stats·W +
    bias, transitions ``trans`` (S, S), ``init`` and ``final`` (S,)
    (probabilities): (log Z (B,), γ (B, T, S), 0 past each row's end,
    Σ_b γ at the first frame (S,), the expected transition counts (S, S))."""
    dt = prec.dtype
    b, t_len, p = stats.shape
    s = trans.shape[0]
    w, bias, trans, init, final = (v.to(dt) for v in (w, bias, trans, init, final))
    lens = lens.to(stats.device).long()
    n_t = int(lens.max())
    llh = prec.mm(stats.reshape(-1, p), w).reshape(b, t_len, s) + bias
    shift = llh.max(-1, keepdim=True).values
    e = torch.exp(llh - shift)
    alpha = torch.empty(b, n_t, s, dtype=dt, device=stats.device)
    norms = torch.ones(b, n_t, dtype=dt, device=stats.device)
    log_z = torch.zeros(b, dtype=dt, device=stats.device)
    prev = init.expand(b, s)
    for t in range(n_t):
        valid = t < lens
        a = (prev if t == 0 else prec.mm(prev, trans)) * e[:, t]
        n = a.sum(-1)
        a = a / n[:, None]
        prev = torch.where(valid[:, None], a, prev)
        alpha[:, t] = prev
        norms[:, t] = torch.where(valid, n, 1.0)
        log_z = log_z + torch.where(valid, torch.log(n) + shift[:, t, 0], 0.0)
    zeta = (alpha[torch.arange(b, device=stats.device), lens - 1] * final).sum(-1)
    log_z = log_z + torch.log(zeta)
    gamma = torch.zeros(b, t_len, s, dtype=dt, device=stats.device)
    xi = torch.zeros(s, s, dtype=dt, device=stats.device)
    beta, carry = final.expand(b, s), None
    for t in range(n_t - 1, -1, -1):
        valid, last = t < lens, t == lens - 1
        if carry is not None:
            beta = torch.where(last[:, None], final.expand(b, s), prec.mm(carry, trans.T))
        gamma[:, t] = torch.where(valid[:, None], alpha[:, t] * beta / zeta[:, None], 0.0)
        carry = torch.where(valid[:, None], e[:, t] * beta / norms[:, t, None], 0.0)
        if t > 0:
            xi = xi + prec.mm(alpha[:, t - 1].T, carry / zeta[:, None]) * trans
    return log_z, gamma, gamma[:, 0].sum(0), xi


def step(cfg: dict, params: dict, x, lens, eps, prec: common.Precision, scale: float = 1.0,
         block: int = 2048):
    """One E-step of the hybrid step over ``x`` (B, T, D) with lengths
    ``lens`` and noise ``eps`` (nsamples, B, T, dz), the data terms times
    ``scale``: (ELBO (float64), the gradients of −ELBO by weight, the
    phone loop's statistics by leaf, times ``scale``).  Rows in blocks of
    ``block``."""
    common.tf32_off()
    dt, dz, ns = prec.dtype, cfg["latent_dim"], eps.shape[0]
    lcfg = dict(cfg, dim=dz)
    post = {k: v.to(dt) for k, v in params["post"].items()}
    nnet = {k: v.detach().to(dt).requires_grad_() for k, v in params["nnet"].items()}
    w, bias = common.ellh_affine(post["modelset"])
    trans, init, final = phone_loop.graph(lcfg, post)
    dev, s = x.device, trans.shape[0]
    total = torch.zeros((), dtype=torch.float64, device=dev)
    acc2 = torch.zeros(s, 2 * dz, dtype=dt, device=dev)
    counts, gamma0 = (torch.zeros(s, dtype=dt, device=dev) for _ in range(2))
    xi = torch.zeros(s, s, dtype=dt, device=dev)
    for i in range(0, x.shape[0], block):
        xb, lb = x[i:i + block].to(dt), lens[i:i + block].to(dev).long()
        mask = (torch.arange(x.shape[1], device=dev)[None, :] < lb[:, None]).to(dt)
        mean, logvar = _net(nnet, "enc", xb, prec)
        entropy = (0.5 * (logvar + 1.0 + common.LOG_2PI)).sum(-1) * mask
        z = mean[None] + torch.exp(0.5 * logvar)[None] * eps[:, i:i + block].to(dt)
        z = z.reshape(-1, *z.shape[2:])                                  # (ns·b, T, dz)
        stats = common.reduced_stats(z, dt)
        lens_rep = lb.repeat(ns)
        log_z, gamma, g0, xib = posteriors(stats.detach(), lens_rep, w, bias, trans, init, final,
                                           prec)
        dmean, dlogvar = _net(nnet, "dec", z, prec)
        x_rep = xb.repeat(ns, 1, 1)
        rec = -0.5 * ((x_rep - dmean) ** 2 * torch.exp(-dlogvar) + dlogvar + common.LOG_2PI).sum(-1)
        data = (rec * mask.repeat(ns, 1)).sum() / ns + entropy.sum()
        # ∂log Z/∂stats_t = γ_t·Wᵀ (the Fisher identity), carried to z by autograd
        surrogate = (stats * prec.mm(gamma.reshape(-1, s), w.T).reshape(stats.shape)).sum() / ns
        (-scale * (data + surrogate)).backward()
        total = total + scale * (data.detach().double() + log_z.double().sum() / ns)
        flat = stats.detach().reshape(-1, stats.shape[-1])
        acc2 = acc2 + prec.mm(gamma.reshape(-1, s).T, flat)
        counts, gamma0, xi = counts + gamma.sum((0, 1)), gamma0 + g0, xi + xib
    starts, ends = phone_loop._structure(lcfg, dev)
    unit_counts = xi[ends][:, starts].sum(0) + gamma0[starts]
    tail = torch.flip(torch.cumsum(torch.flip(unit_counts, (0,)), 0), (0,))
    stats = {"modelset": common.ng_stats(acc2, counts),
             "unit_prior": torch.stack([unit_counts[:-1], tail[1:]], -1)}
    stats = {k: scale / ns * v.double() for k, v in stats.items()}
    elbo = total - phone_loop.kl(params).double()
    return elbo, {k: v.grad for k, v in nnet.items()}, stats


def adam(params: dict, grads: dict, lr: float) -> dict:
    """One Adam step on the nnet weights, in the weights' dtype."""
    (b1, b2), t = BETAS, params["t"] + 1
    out = dict(params, nnet={}, m={}, v={}, t=t)
    for k, p in params["nnet"].items():
        g = grads[k].to(p.dtype)
        m = b1 * params["m"][k] + (1.0 - b1) * g
        v = b2 * params["v"][k] + (1.0 - b2) * g * g
        out["m"][k], out["v"][k] = m, v
        out["nnet"][k] = p - lr * (m / (1.0 - b1**t)) / (torch.sqrt(v / (1.0 - b2**t)) + ADAM_EPS)
    return out


def update(params: dict, stats: dict, lrate: float) -> dict:
    """The conjugate step at learning rate ``lrate``."""
    prior, post = params["prior"], params["post"]
    new = {k: (post[k].double() + lrate * (prior[k].double() + stats[k] - post[k].double()))
           .to(post[k].dtype) for k in LEAVES}
    return dict(params, post=new)

