"""Create a dataset manifest from an scp-style list (reference: ``beer dataset``)."""

from __future__ import annotations

import json
from pathlib import Path


def setup(parser):
    parser.add_argument(
        "scp",
        help="'<uttid> <path>' list file, or a directory of audio files "
        "(.wav/.npy; utterance ids from file stems)",
    )
    parser.add_argument("out", help="output manifest (.json)")


def main(args):
    utts = {}
    src = Path(args.scp)
    if src.is_dir():
        for path in sorted(
            list(src.glob("*.wav")) + list(src.glob("*.npy"))
        ):
            utts[path.stem] = str(path.resolve())
    else:
        for line in src.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            uttid, path = line.split(maxsplit=1)
            utts[uttid] = path
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"utterances": utts}, fh, indent=1)
    print(f"wrote manifest with {len(utts)} utterances to {args.out}")
