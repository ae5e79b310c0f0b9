"""The phone loop through the program: ``beer_tpu_torch.PhoneLoop`` over a
diagonal ``NormalSet`` with the stick-breaking unit prior, built from the
configuration and the seed-made initial means; and the work one E-step
and one decode need, counted from the shapes.
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
    return bt.PhoneLoop.create(cfg["units"], cfg["states_per_unit"], nset,
                               concentration=float(cfg["concentration"]),
                               self_loop=float(cfg["self_loop"]))


def posteriors(model) -> dict:
    return {"modelset": model.modelset.means_precisions.posterior,
            "unit_prior": model.unit_prior.sticks.posterior}


def priors(model) -> dict:
    return {"modelset": model.modelset.means_precisions.prior,
            "unit_prior": model.unit_prior.sticks.prior}


def decode(model, x, mask):
    """The timed decode: unit labels (B, T) and best-path scores (B,)."""
    return model.decode_units(x, mask)


def work(cfg: dict, lens: torch.Tensor, t_len: int) -> dict:
    """Float32 operations and bytes over the valid frames N (B rows padded
    to ``t_len``), each input byte read once and each output byte written
    once.  E-step a frame: the ELLH 2·S·P and the moment accumulation
    2·S·P (P = 2D, the reduced statistics [−½x², x]), the banded scaled
    forward 8·S and backward 12·S, the loop-back ξ 2·U²; it reads the
    frames and writes the statistics.  Decode a frame: the ELLH 2·S·P, the
    banded (max, +) step 6·S and the backtrace 2; it reads the frames and
    writes a label a padded frame and a score a row."""
    n, b = float(lens.sum()), lens.shape[0]
    d, u = cfg["dim"], cfg["units"]
    s, p = cfg["components"], 2 * cfg["dim"]
    params = 4 * (s * 4 * d + (u - 1) * 2)
    return {"estep_flops": n * (4 * s * p + 20 * s + 2 * u * u),
            "estep_bytes": 4 * (n * d + b) + 2 * params,
            "decode_flops": n * (2 * s * p + 6 * s + 2),
            "decode_bytes": 4 * (n * d + b) + params + 4 * (b * t_len + b)}
