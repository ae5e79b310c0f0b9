"""CLI dispatcher: ``beer-torch <group> <subcommand>``.

Every verb of the JAX package's CLI, with its arguments and files:
``dataset create``, ``features extract``, ``hmm mkphones``, ``hmm
mkphoneloop``, ``hmm align``, ``hmm train`` (also ``--transcriptions``),
``hmm decode`` (also ``--phone-lm``), ``hmm accumulate``, ``hmm
update`` and ``shmm train``.  Every verb takes ``--device {cuda,cpu}``;
without it a verb that computes builds on the CUDA card and raises when
there is none — there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import sys

GROUPS = {
    "dataset": ["create"],
    "features": ["extract"],
    "hmm": ["mkphones", "mkphoneloop", "align", "train", "decode",
            "accumulate", "update"],
    "shmm": ["train"],
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="beer-torch",
        description="Bayesian speech modeling on PyTorch and CUDA (beer_tpu_torch)",
    )
    groups = parser.add_subparsers(dest="group", required=True)
    for group, cmds in GROUPS.items():
        gparser = groups.add_parser(group)
        subs = gparser.add_subparsers(dest="command", required=True)
        for cmd in cmds:
            mod = importlib.import_module(f"beer_tpu_torch.cli.subcommands.{group}_{cmd}")
            sparser = subs.add_parser(cmd, help=mod.__doc__)
            sparser.add_argument(
                "--device", choices=["cuda", "cpu"], default=None,
                help="compute device (default: the CUDA card; raises without one)",
            )
            mod.setup(sparser)
            sparser.set_defaults(_main=mod.main)
    args = parser.parse_args(argv)
    return args._main(args) or 0


if __name__ == "__main__":
    sys.exit(main())
