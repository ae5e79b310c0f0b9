"""The Bayesian ergodic HMM through the program: ``beer_tpu_torch.HMM``
over ``ergodic(S)`` with learned transitions and a diagonal
``NormalSet``, built from the configuration and the seed-made initial
means; and the work one E-step needs, counted from the shapes.
"""

from __future__ import annotations

import torch

def build(cfg: dict, init_means: torch.Tensor):
    import beer_tpu_torch as bt

    d, dev = cfg["dim"], init_means.device
    nset = bt.NormalSet.create(
        torch.full((d,), float(cfg["prior_mean"]), device=dev),
        torch.full((d,), float(cfg["prior_var"]), device=dev),
        size=cfg["components"], prior_strength=float(cfg["prior_strength"]),
        init_means=init_means)
    graph = bt.ergodic(cfg["states"], self_loop=float(cfg["self_loop"]))
    if float(cfg["final_weight"]) != 0.1:
        raise ValueError("the program's ergodic graph ends with weight 0.1")
    return bt.HMM.create(graph, nset, learn_transitions=True,
                         trans_prior_strength=float(cfg["trans_prior_strength"]))


def posteriors(model) -> dict:
    return {"modelset": model.modelset.means_precisions.posterior,
            "transitions": model.trans_alpha_post}


def priors(model) -> dict:
    return {"modelset": model.modelset.means_precisions.prior,
            "transitions": model.trans_alpha_prior}


def work(cfg: dict, lens: torch.Tensor, t_len: int) -> dict:
    """Float32 operations and bytes over the valid frames N, each input
    byte read once and each output byte written once.  E-step a frame: the
    ELLH 2·S·P and the moment accumulation 2·S·P (P = 2D), the dense
    scaled forward 2·S² + 4·S, the backward 2·S² + 10·S and ξ 2·S²; it
    reads the frames and writes the statistics."""
    n, b = float(lens.sum()), lens.shape[0]
    d, s, p = cfg["dim"], cfg["components"], 2 * cfg["dim"]
    params = 4 * (s * 4 * d + s * s)
    return {"estep_flops": n * (4 * s * p + 6 * s * s + 14 * s),
            "estep_bytes": 4 * (n * d + b) + 2 * params}
