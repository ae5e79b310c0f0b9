"""The one traffic generator: a corpus of utterances made on the device
from the seed, as a traffic file describes it.

A traffic file (``benchmark/traffic/<name>.json``) gives

* ``task`` — the loop that drives the corpus (a module of
  ``benchmark/tasks``),
* ``utterances`` (B) and ``min_frames`` / ``max_frames``: the lengths are
  the same multiset for every seed, spread evenly over the integers
  [min_frames, max_frames], in an order the seed draws, so a seed changes
  which utterance is long and never how much work there is,
* ``frames``: ``"normal"``, every frame (padding included) N(0, 1) in the
  configuration's dimension, float32, drawn on the device.

The initial means of the model's components come from the same seed,
before the frames: ``prior_mean`` + ``noise_std`` × N(0, 1), one row a
component.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Corpus:
    x: torch.Tensor          # (B, T, D) float32
    lens: torch.Tensor       # (B,) int64
    mask: torch.Tensor       # (B, T) float32, 1 on valid frames
    init_means: torch.Tensor  # (K, D) float32

    @property
    def n_frames(self) -> int:
        return int(self.lens.sum())


def lengths(traffic: dict) -> torch.Tensor:
    """The seed-independent multiset of lengths, longest last."""
    b, lo, hi = traffic["utterances"], traffic["min_frames"], traffic["max_frames"]
    return lo + (torch.arange(b, dtype=torch.int64) * (hi - lo + 1)) // b


def make(traffic: dict, cfg: dict, seed: int, device) -> Corpus:
    if traffic["frames"] != "normal":
        raise ValueError(f"unknown frame distribution {traffic['frames']!r}")
    gen = torch.Generator(device=device).manual_seed(seed)
    k, d = cfg["components"], cfg["dim"]
    init_means = float(cfg["prior_mean"]) + float(cfg["noise_std"]) * torch.randn(
        (k, d), generator=gen, device=device)
    order = torch.randperm(traffic["utterances"], generator=gen, device=device)
    lens = lengths(traffic).to(device)[order]
    t_len = traffic["max_frames"]
    x = torch.randn((traffic["utterances"], t_len, d), generator=gen, device=device)
    mask = (torch.arange(t_len, device=device)[None, :] < lens[:, None]).float()
    return Corpus(x, lens, mask, init_means)


def sample_rows(corpus: Corpus, n: int, seed: int) -> torch.Tensor:
    """``n`` distinct rows drawn from the seed, a longest one among them."""
    b = corpus.lens.shape[0]
    gen = torch.Generator().manual_seed(seed)
    longest = int(torch.argmax(corpus.lens.cpu()))
    rest = [int(i) for i in torch.randperm(b, generator=gen) if int(i) != longest]
    return torch.tensor(sorted([longest] + rest[:max(0, min(n, b) - 1)]))
