"""Viterbi-decode unit transcriptions (reference: ``beer hmm decode``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def setup(parser):
    parser.add_argument("model", help="trained model (.mdl)")
    parser.add_argument("feats", help="feature archive (.npz or .bar)")
    parser.add_argument("out", help="output transcription file")
    parser.add_argument(
        "--per-frame", action="store_true",
        help="emit per-frame unit labels instead of collapsed transcriptions",
    )
    parser.add_argument(
        "--phone-lm", action="store_true",
        help="the model is mkphones emissions: decode with a phone-loop "
        "graph and emit phone symbols (supervised recognizer)",
    )
    parser.add_argument(
        "--lm-transcriptions", default=None,
        help="with --phone-lm: estimate a bigram phone LM from this "
        "transcription file instead of a uniform loop",
    )


def collapse(units):
    """Per-frame unit labels → unit transcription (collapse repeats)."""
    out = []
    for u in units:
        if not out or out[-1] != u:
            out.append(int(u))
    return out


def _phone_recognizer(args, emissions):
    """The phone-loop HMM over ``hmm mkphones`` emissions, under a bigram
    phone LM from ``--lm-transcriptions`` (phones outside the inventory
    dropped) or a uniform loop; with its phone symbols and states per
    phone.  Its graph is not left-to-right, so ``decode`` takes the dense
    (max, +) recursion."""
    import json

    from beer_tpu_torch.models.graph import bigram_lm, phone_loop_graph
    from beer_tpu_torch.models.hmm import HMM

    meta = json.loads(Path(args.model + ".phones.json").read_text())
    phones = meta["phones"]
    lm_trans = lm_init = None
    if args.lm_transcriptions:
        from beer_tpu_torch.cli.subcommands.hmm_mkphones import read_transcriptions

        idx = {p: i for i, p in enumerate(phones)}
        seqs = [[idx[p] for p in seq if p in idx]
                for seq in read_transcriptions(args.lm_transcriptions).values()]
        lm_trans, lm_init = bigram_lm(seqs, len(phones))
    spp = meta["states_per_phone"]
    graph = phone_loop_graph(len(phones), spp, lm_trans=lm_trans, lm_init=lm_init)
    return HMM.create(graph, emissions), np.asarray(phones), spp


def main(args):
    import torch

    from beer_tpu_torch import io as bio
    from beer_tpu_torch.device import resolve_device
    from beer_tpu_torch.utils import load_model

    device = resolve_device(args.device)
    model = load_model(args.model, device)
    keys, data, mask = bio.load_padded(args.feats)
    dtype = next(model.buffers()).dtype       # the features follow the model's dtype
    x, m = torch.from_numpy(data).to(device, dtype), torch.from_numpy(mask).to(device, dtype)
    with torch.no_grad():
        if args.phone_lm:
            recognizer, symbols, spp = _phone_recognizer(args, model)
            units = recognizer.decode(x, m)[0] // spp
        else:
            symbols = np.char.add("au", np.arange(model.n_units).astype(str))
            units = model.decode_units(x, m)[0]
    units = units.cpu().numpy()

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        for i, k in enumerate(keys):
            ln = int(mask[i].sum())
            labels = units[i, :ln]
            if not args.per_frame:
                labels = collapse(labels)
            fh.write(f"{k} {' '.join(symbols[labels])}\n")
    print(f"decoded {len(keys)} utterances to {args.out}")
