"""CLI dispatcher: ``beer-torch <group> <subcommand>``.

The verbs of ``recipes/aud/run.sh``, in its order: ``dataset create``,
``features extract``, ``hmm mkphoneloop``, ``hmm train``, ``hmm
decode``.  Every verb takes ``--device {cuda,cpu}``; without it a verb
that computes builds on the CUDA card and raises when there is none —
there is no fallback to the CPU.  The JAX package's other verbs are
listed in ``NOT_PORTED`` and exit with a message saying so.
"""

from __future__ import annotations

import argparse
import importlib
import sys

GROUPS = {
    "dataset": ["create"],
    "features": ["extract"],
    "hmm": ["mkphoneloop", "train", "decode"],
}

NOT_PORTED = {
    "hmm": ["mkphones", "align", "accumulate", "update"],
    "shmm": ["train"],
}


def not_ported(what: str):
    """A verb's ``main`` for ``what``, which is not ported yet."""

    def main(args):
        raise SystemExit(f"beer-torch: {what} is not ported yet")

    return main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="beer-torch",
        description="Bayesian speech modeling on PyTorch and CUDA (beer_tpu_torch)",
    )
    groups = parser.add_subparsers(dest="group", required=True)
    for group in dict.fromkeys([*GROUPS, *NOT_PORTED]):
        gparser = groups.add_parser(group)
        subs = gparser.add_subparsers(dest="command", required=True)
        for cmd in GROUPS.get(group, []):
            mod = importlib.import_module(f"beer_tpu_torch.cli.subcommands.{group}_{cmd}")
            sparser = subs.add_parser(cmd, help=mod.__doc__)
            sparser.add_argument(
                "--device", choices=["cuda", "cpu"], default=None,
                help="compute device (default: the CUDA card; raises without one)",
            )
            mod.setup(sparser)
            sparser.set_defaults(_main=mod.main)
        for cmd in NOT_PORTED.get(group, []):
            sparser = subs.add_parser(cmd, help="not ported yet")
            sparser.add_argument("rest", nargs=argparse.REMAINDER)
            sparser.set_defaults(_main=not_ported(f"`{group} {cmd}`"))
    args = parser.parse_args(argv)
    return args._main(args) or 0


if __name__ == "__main__":
    sys.exit(main())
