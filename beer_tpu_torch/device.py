"""The device the port's entry points build on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` if given; otherwise the current CUDA card.  With no card
    and no device given this raises: an entry point never builds on the
    CPU unless the caller asks for it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' to build on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
