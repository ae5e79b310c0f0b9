"""Viterbi-decode unit transcriptions (reference: ``beer hmm decode``)."""

from __future__ import annotations

from pathlib import Path


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
        help="(not ported yet) decode mkphones emissions with a phone-loop graph",
    )
    parser.add_argument(
        "--lm-transcriptions", default=None,
        help="(not ported yet) with --phone-lm: a bigram phone LM from this file",
    )


def collapse(units):
    """Per-frame unit labels → unit transcription (collapse repeats)."""
    out = []
    for u in units:
        if not out or out[-1] != u:
            out.append(int(u))
    return out


def main(args):
    if args.phone_lm or args.lm_transcriptions:
        raise SystemExit("beer-torch: `hmm decode --phone-lm` / `--lm-transcriptions` "
                         "is not ported yet")
    import torch

    from beer_tpu_torch import io as bio
    from beer_tpu_torch.device import resolve_device
    from beer_tpu_torch.utils import load_model

    device = resolve_device(args.device)
    model = load_model(args.model, device)
    keys, data, mask = bio.load_padded(args.feats)
    with torch.no_grad():
        units, _ = model.decode_units(torch.from_numpy(data).to(device),
                                      torch.from_numpy(mask).to(device))
    units = units.cpu().numpy()

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        for i, k in enumerate(keys):
            ln = int(mask[i].sum())
            labels = units[i, :ln]
            if not args.per_frame:
                labels = collapse(labels)
            fh.write(f"{k} {' '.join(f'au{u}' for u in labels)}\n")
    print(f"decoded {len(keys)} utterances to {args.out}")
