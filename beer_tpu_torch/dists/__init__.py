"""Conjugate exponential-family distributions (PyTorch port of ``beer_tpu.dists``)."""

from beer_tpu_torch.dists.basedist import ExpFamily
from beer_tpu_torch.dists.dirichlet import Beta, Dirichlet
from beer_tpu_torch.dists.gamma import Gamma
from beer_tpu_torch.dists.normalgamma import IsotropicNormalGamma, NormalGamma
from beer_tpu_torch.dists.normalwishart import NormalWishart

__all__ = ["ExpFamily", "Beta", "Dirichlet", "Gamma", "NormalGamma", "IsotropicNormalGamma",
           "NormalWishart"]
