"""Command-line interface of the port.

Counterpart of ``beer_tpu/cli``: ``beer-torch <group> <subcommand>``
(or ``python -m beer_tpu_torch.cli <group> <subcommand>``), each
subcommand a module with ``setup(parser)`` / ``main(args)``, with the
flags and file formats of the JAX package's verbs.
"""

from beer_tpu_torch.cli.main import main

__all__ = ["main"]
