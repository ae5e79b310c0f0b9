"""Model checkpointing: the port's ``.mdl`` format.

Counterpart of ``beer_tpu/utils/checkpoint.py`` (same entry points,
``save_model``, ``load_model``, ``latest_checkpoint``; a format of the
port's own — a JAX ``.mdl`` unpickles ``beer_tpu`` classes and does not
load here).

A checkpoint holds two parts:

* ``tensors``: every tensor of the model, moved to the CPU, as a state
  dict ``{"0": t0, "1": t1, …}`` written by ``torch.save`` and read back
  with ``torch.load(weights_only=True)``;
* ``skeleton``: the model pickled with each tensor replaced by a
  persistent reference to its entry in ``tensors``.  Anything that is
  not a tensor — statics, families, and fields that are truly ``None``
  such as ``PhoneLoop.log_exit`` — is pickled as it is, so ``None``
  stays ``None``; a tensor shared by two fields is stored once and
  stays shared.

The file itself is a pickle of ``{"format", "skeleton", "tensors"}``
(two byte strings), so, as with any pickle (and the reference's
``torch.save`` checkpoints), load only checkpoints you trust.
"""

from __future__ import annotations

import io
import pickle
from pathlib import Path

import torch
from torch import nn

from beer_tpu_torch.device import resolve_device

FORMAT = "beer_tpu_torch.mdl/1"


class _Pickler(pickle.Pickler):
    """Pickles a model with each tensor swapped for a reference."""

    def __init__(self, fh):
        super().__init__(fh, protocol=pickle.HIGHEST_PROTOCOL)
        self.tensors = {}
        self._ids = {}

    def persistent_id(self, obj):
        if not isinstance(obj, torch.Tensor):
            return None
        key = self._ids.get(id(obj))
        if key is None:
            key = str(len(self._ids))
            self._ids[id(obj)] = key
            self.tensors[key] = obj.detach().to("cpu", copy=True)
        return ("tensor", key, isinstance(obj, nn.Parameter),
                bool(obj.requires_grad))


class _Unpickler(pickle.Unpickler):
    def __init__(self, fh, tensors, device):
        super().__init__(fh)
        self.tensors = tensors
        self.device = device
        self._made = {}

    def persistent_load(self, pid):
        kind, key, is_param, requires_grad = pid
        if kind != "tensor":
            raise pickle.UnpicklingError(f"unknown reference {kind!r}")
        if key not in self._made:
            t = self.tensors[key].to(self.device)
            self._made[key] = (nn.Parameter(t, requires_grad=requires_grad)
                               if is_param else t)
        return self._made[key]


def save_model(model, path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    skeleton = io.BytesIO()
    pickler = _Pickler(skeleton)
    pickler.dump(model)
    tensors = io.BytesIO()
    torch.save(pickler.tensors, tensors)
    with open(path, "wb") as fh:
        pickle.dump({"format": FORMAT, "skeleton": skeleton.getvalue(),
                     "tensors": tensors.getvalue()}, fh)


def load_model(path, device=None):
    """The model saved at ``path``, on ``device`` (default: the CUDA card;
    ``device="cpu"`` for the CPU; with no card and no device it raises)."""
    device = resolve_device(device)
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path}: not a beer_tpu_torch checkpoint ({FORMAT})")
    tensors = torch.load(io.BytesIO(payload["tensors"]), map_location="cpu",
                         weights_only=True)
    return _Unpickler(io.BytesIO(payload["skeleton"]), tensors, device).load()


def latest_checkpoint(directory, pattern: str = "epoch*.mdl"):
    """Highest-numbered checkpoint in a directory, or None."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    ckpts = sorted(directory.glob(pattern))
    return ckpts[-1] if ckpts else None
