"""Build per-phone HMM-GMM emissions (reference: ``beer hmm mkphones``).

Creates the MixtureSet emissions for a supervised phone recognizer
(BASELINE config 3): one GMM per phone-state, phone inventory taken from
the training transcriptions.  Writes ``out.mdl`` (emissions) and
``out.mdl.phones.json`` (phone inventory + topology metadata consumed by
``hmm train --transcriptions``, ``hmm align`` and ``hmm decode
--phone-lm``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def setup(parser):
    parser.add_argument("conf", help="hmm YAML config")
    parser.add_argument("feats", help="feature archive (.npz or .bar)")
    parser.add_argument("transcriptions", help="'uttid ph1 ph2 ...' per line")
    parser.add_argument("out", help="output model (.mdl)")


def read_transcriptions(path):
    """``{uttid: [phone, ...]}`` from a file of ``uttid ph1 ph2 ...`` lines."""
    out = {}
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if parts:
            out[parts[0]] = parts[1:]
    return out


def main(args):
    import torch

    import beer_tpu_torch as bt
    from beer_tpu_torch.device import resolve_device
    from beer_tpu_torch.utils import load_yaml, save_model

    device = resolve_device(args.device)
    conf = load_yaml(args.conf)
    states_per_phone = int(conf.get("states_per_phone", 3))
    ncomp = int(conf.get("ncomp_per_state", 2))
    cov_type = conf.get("cov_type", "diagonal")
    prior_strength = float(conf.get("prior_strength", 1.0))
    noise_std = float(conf.get("noise_std", 1.0))
    seed = int(conf.get("seed", 1))

    trans = read_transcriptions(args.transcriptions)
    phones = sorted({p for seq in trans.values() for p in seq})

    if args.feats.endswith(".bar"):
        from beer_tpu_torch import io as bio

        bar = bio.Archive(args.feats)
        flat = np.concatenate([bar[i] for i in range(len(bar))])
    else:
        archive = np.load(args.feats)
        flat = np.concatenate([archive[k] for k in archive.files])
    mean = flat.mean(0)
    cov = np.cov(flat.T) if cov_type == "full" else np.diag(flat.var(0))

    # The initial means: random data frames plus jitter, drawn in numpy
    # from the config's seed exactly as the JAX package's verb draws
    # them, so both packages start from the same model.
    n_pdfs = len(phones) * states_per_phone
    rng = np.random.default_rng(seed)
    n_comps = n_pdfs * ncomp
    frames = flat[rng.choice(len(flat), size=n_comps, replace=len(flat) < n_comps)]
    frames = frames + 0.1 * noise_std * flat.std(0) * rng.standard_normal(frames.shape)
    # The priors are made in float64 from the float64 covariance (a
    # fbank's channels are strongly correlated, and its inverse in float32
    # would be noise), from the means rounded to float32 as the JAX verb
    # rounds them; then the model is cast to the features' float32.
    f64 = dict(dtype=torch.float64, device=device)
    nset = bt.NormalSet.create(
        torch.as_tensor(mean, **f64), torch.as_tensor(cov, **f64), size=n_comps,
        prior_strength=prior_strength, noise_std=noise_std, cov_type=cov_type,
        init_means=torch.as_tensor(frames.astype(mean.dtype), **f64),
    )
    emissions = bt.MixtureSet.create(nset, nmix=n_pdfs).to(torch.float32)
    save_model(emissions, args.out)
    meta = {
        "phones": phones,
        "states_per_phone": states_per_phone,
        "ncomp_per_state": ncomp,
    }
    Path(args.out + ".phones.json").write_text(json.dumps(meta, indent=1))
    print(
        f"wrote emissions for {len(phones)} phones x {states_per_phone} "
        f"states x {ncomp} components to {args.out}"
    )
