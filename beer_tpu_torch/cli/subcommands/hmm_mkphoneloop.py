"""Build an initial phone-loop AUD model (reference: ``beer hmm mkphoneloop``)."""

from __future__ import annotations

import numpy as np


def setup(parser):
    parser.add_argument("conf", help="hmm YAML config")
    parser.add_argument("feats", help="feature archive (.npz or .bar)")
    parser.add_argument("out", help="output model (.mdl)")


def main(args):
    import torch

    import beer_tpu_torch as bt
    from beer_tpu_torch.device import resolve_device
    from beer_tpu_torch.models.categorical import SBCategoricalHyperPrior
    from beer_tpu_torch.utils import load_yaml, save_model

    device = resolve_device(args.device)
    conf = load_yaml(args.conf)
    n_units = int(conf.get("n_units", 50))
    states_per_unit = int(conf.get("states_per_unit", 3))
    cov_type = conf.get("cov_type", "diagonal")
    concentration = float(conf.get("concentration", 1.0))
    prior_strength = float(conf.get("prior_strength", 1.0))
    noise_std = float(conf.get("noise_std", 1.0))
    seed = int(conf.get("seed", 1))
    self_loop = float(conf.get("self_loop", 0.5))

    if args.feats.endswith(".bar"):
        from beer_tpu_torch import io as bio

        bar = bio.Archive(args.feats)
        flat = np.concatenate([bar[i] for i in range(len(bar))])
    else:
        archive = np.load(args.feats)
        flat = np.concatenate([archive[k] for k in archive.files])
    mean = torch.as_tensor(flat.mean(0), device=device)
    if cov_type == "full":
        cov = np.cov(flat.T)
    else:
        cov = np.diag(flat.var(0))

    # The initial means, in numpy from the config's seed exactly as the
    # JAX package's verb draws them, so both packages start from the same
    # model.  "kmeans" (default) places each unit on one Lloyd centroid of
    # a 20,000-frame subsample (its states on that centroid + jitter);
    # "frames" samples random data frames.  Either keeps every unit inside
    # the data manifold, so no single unit wins all responsibilities in
    # the first lrate-1 VB step and collapses the loop.
    rng = np.random.default_rng(seed)
    n_states = n_units * states_per_unit
    init_method = conf.get("init", "kmeans")
    if init_method == "kmeans":
        sub = flat[rng.choice(len(flat), size=min(len(flat), 20000),
                              replace=False)]
        centers = sub[rng.choice(len(sub), size=n_units,
                                 replace=len(sub) < n_units)]
        for _ in range(25):
            d2 = ((sub[:, None, :] - centers[None]) ** 2).sum(-1)
            assign = d2.argmin(1)
            centers = np.stack([
                sub[assign == j].mean(0) if (assign == j).any() else centers[j]
                for j in range(n_units)
            ])
        # unit u's states all start at centroid u (+ jitter)
        frames = np.repeat(centers, states_per_unit, axis=0)
    else:
        frames = flat[
            rng.choice(len(flat), size=n_states, replace=len(flat) < n_states)
        ]
    frames = frames + 0.1 * noise_std * flat.std(0) * rng.standard_normal(frames.shape)
    nset = bt.NormalSet.create(
        mean, torch.as_tensor(cov, device=device), size=n_states,
        prior_strength=prior_strength, noise_std=noise_std, cov_type=cov_type,
        init_means=torch.as_tensor(frames, device=device),
    )
    unit_prior = None
    if conf.get("hyperprior", False):
        # Gamma hyper-prior on the DP concentration
        unit_prior = SBCategoricalHyperPrior.create(
            n_units,
            prior_shape=float(conf.get("hyperprior_shape", 1.0)),
            prior_rate=float(conf.get("hyperprior_rate", 1.0)),
            dtype=mean.dtype, device=device,
        )
    loop = bt.PhoneLoop.create(
        n_units, states_per_unit, nset,
        unit_prior=unit_prior, concentration=concentration,
        self_loop=self_loop,
    )
    save_model(loop, args.out)
    print(
        f"wrote phone loop ({n_units} units x {states_per_unit} states, "
        f"{cov_type} cov, dim {flat.shape[-1]}) to {args.out}"
    )
