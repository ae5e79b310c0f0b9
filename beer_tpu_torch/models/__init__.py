"""Models (PyTorch port of ``beer_tpu.models``)."""

from beer_tpu_torch.models.basemodel import DiscreteLatentModel, Model
from beer_tpu_torch.models.categorical import Categorical, SBCategorical
from beer_tpu_torch.models.graph import LOG_ZERO, CompiledGraph
from beer_tpu_torch.models.modelset import ModelSet
from beer_tpu_torch.models.normal import NormalSet
from beer_tpu_torch.models.parameters import BayesianParameter
from beer_tpu_torch.models.phoneloop import PhoneLoop

__all__ = [
    "Model",
    "DiscreteLatentModel",
    "ModelSet",
    "BayesianParameter",
    "NormalSet",
    "Categorical",
    "SBCategorical",
    "CompiledGraph",
    "LOG_ZERO",
    "PhoneLoop",
]
