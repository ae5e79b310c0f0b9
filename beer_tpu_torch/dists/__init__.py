"""Conjugate exponential-family distributions (PyTorch port of ``beer_tpu.dists``)."""

from beer_tpu_torch.dists.basedist import ExpFamily, logdet_pd, sym, unvec, vec
from beer_tpu_torch.dists.dirichlet import Beta, Dirichlet
from beer_tpu_torch.dists.gamma import Gamma
from beer_tpu_torch.dists.joint import (
    JointIsotropicNormalGamma,
    JointNormalGamma,
    JointNormalWishart,
)
from beer_tpu_torch.dists.normalgamma import IsotropicNormalGamma, NormalGamma
from beer_tpu_torch.dists.normalwishart import NormalWishart
from beer_tpu_torch.dists.wishart import Wishart
from beer_tpu_torch.dists import normallik

__all__ = [
    "ExpFamily",
    "Beta",
    "Dirichlet",
    "Gamma",
    "Wishart",
    "NormalGamma",
    "IsotropicNormalGamma",
    "NormalWishart",
    "JointNormalGamma",
    "JointIsotropicNormalGamma",
    "JointNormalWishart",
    "normallik",
    "logdet_pd",
    "sym",
    "vec",
    "unvec",
]
