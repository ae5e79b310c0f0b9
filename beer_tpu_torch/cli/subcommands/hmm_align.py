"""Forced alignment (reference recipes' alignment step).

Viterbi on per-utterance transcription graphs with trained emissions:
emits per-frame phone labels (the input to SHMM training or scoring).
The graphs share one left-to-right chain, so the decode takes the
banded Viterbi kernels at every number of states.
"""

from __future__ import annotations

import json
from pathlib import Path


def setup(parser):
    parser.add_argument("model", help="trained emissions (.mdl from mkphones/train)")
    parser.add_argument("feats", help="feature archive (.npz/.bar)")
    parser.add_argument("transcriptions", help="'uttid ph1 ph2 ...' per line")
    parser.add_argument("out", help="output per-frame alignment file")


def main(args):
    import torch

    from beer_tpu_torch import io as bio
    from beer_tpu_torch.cli.subcommands.hmm_mkphones import read_transcriptions
    from beer_tpu_torch.device import resolve_device
    from beer_tpu_torch.models.graph import transcription_graphs
    from beer_tpu_torch.models.hmm import HMM
    from beer_tpu_torch.utils import load_model

    device = resolve_device(args.device)
    meta = json.loads(Path(args.model + ".phones.json").read_text())
    phones = meta["phones"]
    spp = meta["states_per_phone"]
    phone_idx = {p: i for i, p in enumerate(phones)}

    emissions = load_model(args.model, device)
    keys, data, mask = bio.load_padded(args.feats)
    trans = read_transcriptions(args.transcriptions)
    seqs = [[phone_idx[p] for p in trans[k]] for k in keys]
    dtype = next(emissions.buffers()).dtype   # the features follow the emissions' dtype
    graphs = transcription_graphs(seqs, len(phones), spp, dtype=dtype, device=device)
    hmm = HMM.create(graphs, emissions)

    with torch.no_grad():
        paths, _ = hmm.decode(torch.from_numpy(data).to(device, dtype),
                              torch.from_numpy(mask).to(device, dtype))
    frame_phones = (torch.gather(graphs.pdf_ids, 1, paths.long()) // spp).cpu().numpy()

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        for i, key in enumerate(keys):
            ln = int(mask[i].sum())
            fh.write(f"{key} {' '.join(phones[p] for p in frame_phones[i, :ln])}\n")
    print(f"aligned {len(keys)} utterances to {args.out}")
