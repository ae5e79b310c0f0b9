"""Extract fbank/MFCC features for a manifest (reference: ``beer features extract``)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def setup(parser):
    parser.add_argument("conf", help="features YAML config")
    parser.add_argument("manifest", help="dataset manifest (.json)")
    parser.add_argument("out", help="output archive (.npz or .bar)")
    parser.add_argument(
        "--cmvn", choices=["none", "global", "utterance"], default="none",
        help="cepstral mean+variance normalization applied after "
        "extraction (on top of the config's per-utterance mean_norm)",
    )


def _load_audio(path: str, expected_srate: int):
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path)
    if path.suffix == ".wav":
        from scipy.io import wavfile

        srate, sig = wavfile.read(path)
        if srate != expected_srate:
            raise ValueError(f"{path}: srate {srate} != conf srate {expected_srate}")
        if sig.dtype.kind == "i":
            sig = sig.astype(np.float32) / np.iinfo(sig.dtype).max
        return sig
    raise ValueError(f"unsupported audio format: {path}")


def main(args):
    import dataclasses

    import torch

    from beer_tpu_torch import features
    from beer_tpu_torch.device import resolve_device
    from beer_tpu_torch.utils import load_yaml

    device = resolve_device(args.device)
    conf = features.FeatureConfig.from_dict(load_yaml(args.conf))
    with open(args.manifest) as fh:
        utts = json.load(fh)["utterances"]

    # The spectrum of each utterance's true signal on the device; deltas
    # and mean-norm on the host over its true frames (add_deltas_np), as
    # the JAX package's verb computes them.
    raw_conf = dataclasses.replace(conf, mean_norm=False, deltas=False)
    archive = {}
    for uttid, path in utts.items():
        sig = _load_audio(path, conf.srate)
        n = len(sig)
        n_frames = 1 + (n - conf.frame_length) // conf.frame_shift
        if n < conf.frame_length or n_frames <= 0:
            raise ValueError(
                f"{uttid}: signal too short ({n} samples < frame_length "
                f"{conf.frame_length})"
            )
        x = torch.from_numpy(np.ascontiguousarray(sig)).to(device)
        feats = features.extract(x, raw_conf).cpu().numpy()
        if conf.deltas:
            feats = features.add_deltas_np(feats)
        if conf.mean_norm:
            feats = feats - feats.mean(0, keepdims=True)
        archive[uttid] = feats
    if args.cmvn == "utterance":
        archive = {
            k: (v - v.mean(0)) / np.maximum(v.std(0), 1e-8)
            for k, v in archive.items()
        }
    elif args.cmvn == "global":
        flat = np.concatenate(list(archive.values()))
        mu, sd = flat.mean(0), np.maximum(flat.std(0), 1e-8)
        archive = {k: (v - mu) / sd for k, v in archive.items()}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    if args.out.endswith(".bar"):
        from beer_tpu_torch import io as bio

        bio.write_archive(args.out, archive)
    else:
        np.savez_compressed(args.out, **archive)
    dims = {v.shape[-1] for v in archive.values()}
    print(f"extracted {len(archive)} utterances (feature dim {dims}) to {args.out}")
