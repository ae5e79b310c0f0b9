"""Plain reference of the phone loop for acoustic-unit discovery.

A loop over U left-to-right units of ``states_per_unit`` states with
diagonal Normal-Gamma emissions and a truncated stick-breaking prior over
units (Beta(1, γ) sticks), trained by full-batch VB-EM and decoded by
Viterbi.  Transitions: a self-loop ``self_loop`` and an advance
1 − ``self_loop`` inside a unit; a unit's last state leaves with
(1 − ``self_loop``)/2 to the next unit's first state, weighted by
exp E[log π], and ends an utterance with the same (1 − ``self_loop``)/2;
an utterance starts in a unit's first state with exp E[log π].

Everything is worked out from the configuration, the initial means and
the frames, by :mod:`common`'s dense recursions; nothing of the program
is imported.  The leaves are the natural parameters of the emissions'
posterior ("modelset", (S, 4D)) and of the sticks' ("unit_prior",
(U − 1, 2): α − 1).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import common

LEAVES = ("modelset", "unit_prior")


def initial(cfg: dict, init_means: torch.Tensor, dtype=torch.float64) -> dict:
    """The priors and the initial posteriors, as natural parameters."""
    d = cfg["dim"]
    s = cfg["units"] * cfg["states_per_unit"]
    k, var = float(cfg["prior_strength"]), float(cfg["prior_var"])
    dev = init_means.device
    full = lambda v: torch.full((d,), v, dtype=dtype, device=dev)  # noqa: E731
    prior_ng = common.ng_natural(full(float(cfg["prior_mean"])), full(k), full(k),
                                 full(k * var)).expand(s, 4 * d).clone()
    post_ng = common.ng_natural(init_means.to(dtype), full(k), full(k), full(k * var))
    sticks = torch.stack([torch.ones(cfg["units"] - 1, dtype=dtype, device=dev),
                          torch.full((cfg["units"] - 1,), float(cfg["concentration"]),
                                     dtype=dtype, device=dev)], -1) - 1.0
    return {"prior": {"modelset": prior_ng, "unit_prior": sticks},
            "post": {"modelset": post_ng, "unit_prior": sticks.clone()}}


def _structure(cfg: dict, dev):
    spu = cfg["states_per_unit"]
    starts = torch.arange(cfg["units"], device=dev) * spu
    return starts, starts + spu - 1


def _expected_log_weights(sticks_nat: torch.Tensor) -> torch.Tensor:
    e = common.dirichlet_expected_log(sticks_nat + 1.0)          # (U − 1, 2)
    zero = e.new_zeros(1)
    return torch.cat([e[:, 0], zero]) + torch.cat([zero, torch.cumsum(e[:, 1], 0)])


def graph(cfg: dict, post: dict, factored: bool = False):
    """(trans (S, S), init (S,), final (S,)) probabilities, 0 for no arc.
    ``factored``: the logs instead, with a loop arc's exit in ``trans`` and
    its unit weight apart, (log trans, log weight (S, S), log init, log
    final)."""
    dev, dt = post["modelset"].device, post["modelset"].dtype
    spu, sl = cfg["states_per_unit"], float(cfg["self_loop"])
    s = cfg["units"] * spu
    starts, ends = _structure(cfg, dev)
    log_w = _expected_log_weights(post["unit_prior"])
    weights = torch.exp(log_w)
    exit_p = (1.0 - sl) * 0.5
    ids = torch.arange(s, device=dev)
    trans = torch.zeros(s, s, dtype=dt, device=dev)
    trans[ids, ids] = sl
    adv = ids[(ids % spu) != spu - 1]
    trans[adv, adv + 1] = 1.0 - sl
    if factored:
        loop = torch.zeros(s, s, dtype=dt, device=dev)
        trans[ends[:, None], starts[None, :]] = exit_p
        loop[ends[:, None], starts[None, :]] = log_w[None, :]
        init = torch.full((s,), -math.inf, dtype=dt, device=dev)
        init[starts] = log_w
        final = torch.full((s,), -math.inf, dtype=dt, device=dev)
        final[ends] = math.log(exit_p)
        return torch.log(trans), loop, init, final
    trans[ends[:, None], starts[None, :]] = exit_p * weights[None, :]
    init = torch.zeros(s, dtype=dt, device=dev)
    init[starts] = weights
    final = torch.zeros(s, dtype=dt, device=dev)
    final[ends] = exit_p
    return trans, init, final


def kl(params: dict) -> torch.Tensor:
    prior, post = params["prior"], params["post"]
    return (common.ng_kl(post["modelset"], prior["modelset"])
            + common.dirichlet_kl(post["unit_prior"] + 1.0, prior["unit_prior"] + 1.0))


def estep(cfg: dict, params: dict, x, lens, prec: common.Precision, scale: float = 1.0):
    """(ELBO, statistics by leaf) of one E-step over ``x`` / ``lens``,
    the data terms multiplied by ``scale``."""
    post = {k: v.to(prec.dtype) for k, v in params["post"].items()}
    w, bias = common.ellh_affine(post["modelset"])
    trans, init, final = graph(cfg, post)
    e = common.forward_backward(x, lens, w, bias, trans, init, final, prec)
    starts, ends = _structure(cfg, x.device)
    unit_counts = e.xi[ends][:, starts].sum(0) + e.gamma0[starts]
    tail = torch.flip(torch.cumsum(torch.flip(unit_counts, (0,)), 0), (0,))
    stats = {"modelset": common.ng_stats(e.acc2, e.counts),
             "unit_prior": torch.stack([unit_counts[:-1], tail[1:]], -1)}
    stats = {k: scale * v.double() for k, v in stats.items()}
    elbo = scale * e.log_z.double().sum() - kl(params).double()
    return elbo, stats


def update(params: dict, stats: dict) -> dict:
    """The conjugate step at learning rate 1: posterior = prior + stats."""
    return {"prior": params["prior"],
            "post": {k: (params["prior"][k].double() + stats[k]).to(params["post"][k].dtype)
                     for k in LEAVES}}


def decode(cfg: dict, params: dict, x, lens, prec: common.Precision, labels=None):
    """Viterbi over ``x`` / ``lens`` under the posterior: (unit labels
    (B, T), scores (B,)).  With ``labels`` (B, T) the scores are those of
    the best path whose frames lie in those units (−inf where none does),
    and no labels are returned."""
    common.tf32_off()
    post = {k: v.to(prec.dtype) for k, v in params["post"].items()}
    w, bias = common.ellh_affine(post["modelset"])
    log_trans, log_w, log_init, log_final = graph(cfg, post, factored=True)
    stats = common.reduced_stats(x, prec.dtype)
    llh = prec.mm(stats.reshape(-1, stats.shape[-1]), w).reshape(*x.shape[:2], -1) + bias
    spu = cfg["states_per_unit"]
    if labels is not None:
        unit_of_state = torch.arange(llh.shape[-1], device=x.device) // spu
        llh = torch.where(unit_of_state == labels[..., None].to(x.device), llh, -math.inf)
    paths, scores = common.viterbi(llh, lens, log_trans, log_init, log_final,
                                   backtrace=labels is None, log_trans_factor=log_w)
    return (None if paths is None else paths // spu), scores
