"""Plain reference of the Bayesian ergodic HMM.

S states, every state reaching every state: a self-loop ``self_loop``,
1 − ``self_loop`` shared evenly by the S − 1 others, and an end weight
``final_weight``, normalised together per state; start uniform over the
states.  Diagonal Normal-Gamma emissions, one per state, and a Dirichlet
over each state's outgoing arcs (prior ``trans_prior_strength`` × the
normalised arc weights; the end weight stays fixed), trained by
full-batch VB-EM: the E-step runs under exp E[log A].  Decoding is the
dense (max, +) Viterbi under E[log A], log init and log final.

Nothing of the program is imported.  The leaves are the emissions'
natural parameters ("modelset", (S, 4D)) and the transition
concentrations ("transitions", (S, S)).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import common

LEAVES = ("modelset", "transitions")


def arcs(cfg: dict, dtype, dev):
    """(trans (S, S), init (S,), final (S,)) of the normalised graph."""
    s, sl = cfg["states"], float(cfg["self_loop"])
    out = (1.0 - sl) / max(s - 1, 1)
    trans = torch.full((s, s), out, dtype=dtype, device=dev)
    trans.fill_diagonal_(sl)
    final = torch.full((s,), float(cfg["final_weight"]), dtype=dtype, device=dev)
    z = trans.sum(-1) + final
    return trans / z[:, None], torch.full((s,), 1.0 / s, dtype=dtype, device=dev), final / z


def initial(cfg: dict, init_means: torch.Tensor, dtype=torch.float64) -> dict:
    d, s = cfg["dim"], cfg["states"]
    k, var = float(cfg["prior_strength"]), float(cfg["prior_var"])
    dev = init_means.device
    full = lambda v: torch.full((d,), v, dtype=dtype, device=dev)  # noqa: E731
    prior_ng = common.ng_natural(full(float(cfg["prior_mean"])), full(k), full(k),
                                 full(k * var)).expand(s, 4 * d).clone()
    post_ng = common.ng_natural(init_means.to(dtype), full(k), full(k), full(k * var))
    alpha = float(cfg["trans_prior_strength"]) * arcs(cfg, dtype, dev)[0]
    return {"prior": {"modelset": prior_ng, "transitions": alpha},
            "post": {"modelset": post_ng, "transitions": alpha.clone()}}


def kl(params: dict) -> torch.Tensor:
    prior, post = params["prior"], params["post"]
    return (common.ng_kl(post["modelset"], prior["modelset"])
            + common.dirichlet_kl(post["transitions"], prior["transitions"]))


def estep(cfg: dict, params: dict, x, lens, prec: common.Precision, scale: float = 1.0):
    post = {k: v.to(prec.dtype) for k, v in params["post"].items()}
    w, bias = common.ellh_affine(post["modelset"])
    _, init, final = arcs(cfg, prec.dtype, x.device)
    trans = torch.exp(common.dirichlet_expected_log(post["transitions"]))
    e = common.forward_backward(x, lens, w, bias, trans, init, final, prec)
    stats = {"modelset": common.ng_stats(e.acc2, e.counts), "transitions": e.xi}
    stats = {k: scale * v.double() for k, v in stats.items()}
    elbo = scale * e.log_z.double().sum() - kl(params).double()
    return elbo, stats


def update(params: dict, stats: dict) -> dict:
    return {"prior": params["prior"],
            "post": {k: (params["prior"][k].double() + stats[k]).to(params["post"][k].dtype)
                     for k in LEAVES}}


def decode(cfg: dict, params: dict, x, lens, prec: common.Precision, labels=None):
    """Viterbi over ``x`` / ``lens`` under the posterior: (state labels
    (B, T), scores (B,)).  With ``labels`` (B, T) the scores are those of
    the best path whose frames lie in those states (−inf where none does),
    and no labels are returned."""
    common.tf32_off()
    post = {k: v.to(prec.dtype) for k, v in params["post"].items()}
    w, bias = common.ellh_affine(post["modelset"])
    _, init, final = arcs(cfg, prec.dtype, x.device)
    log_trans = common.dirichlet_expected_log(post["transitions"])
    stats = common.reduced_stats(x, prec.dtype)
    llh = prec.mm(stats.reshape(-1, stats.shape[-1]), w).reshape(*x.shape[:2], -1) + bias
    if labels is not None:
        states = torch.arange(llh.shape[-1], device=x.device)
        llh = torch.where(states == labels[..., None].to(x.device).long(), llh, -math.inf)
    return common.viterbi(llh, lens, log_trans, torch.log(init), torch.log(final),
                          backtrace=labels is None)
