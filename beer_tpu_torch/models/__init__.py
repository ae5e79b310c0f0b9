"""Models (PyTorch port of ``beer_tpu.models``)."""

from beer_tpu_torch.models.basemodel import DiscreteLatentModel, Model
from beer_tpu_torch.models.categorical import Categorical, SBCategorical, SBCategoricalHyperPrior
from beer_tpu_torch.models.graph import (
    LOG_ZERO,
    CompiledGraph,
    Graph,
    bigram_lm,
    ergodic,
    left_to_right,
    phone_loop_graph,
    transcription_graphs,
)
from beer_tpu_torch.models.gsm import (
    GSM,
    HierarchicalGSM,
    accumulate_unit_stats,
    apply_to_phoneloop,
    induced_posterior_moments,
    make_gsm_train_scan,
    make_gsm_train_step,
    slice_gsm,
    train_gsm,
    train_key,
)
from beer_tpu_torch.models.hmm import HMM
from beer_tpu_torch.models.mixture import Mixture, MixtureSet
from beer_tpu_torch.models.modelset import JointModelSet, ModelSet, RepeatedModelSet
from beer_tpu_torch.models.normal import Normal, NormalSet
from beer_tpu_torch.models.parameters import BayesianParameter
from beer_tpu_torch.models.phoneloop import PhoneLoop
from beer_tpu_torch.models.plda import PLDA
from beer_tpu_torch.models.ppca import PPCA
from beer_tpu_torch.models.vae import VAE, SequenceVAE, make_vae_train_step

__all__ = [
    "Model",
    "DiscreteLatentModel",
    "ModelSet",
    "JointModelSet",
    "RepeatedModelSet",
    "BayesianParameter",
    "Normal",
    "NormalSet",
    "Categorical",
    "SBCategorical",
    "SBCategoricalHyperPrior",
    "CompiledGraph",
    "Graph",
    "LOG_ZERO",
    "bigram_lm",
    "ergodic",
    "left_to_right",
    "phone_loop_graph",
    "transcription_graphs",
    "HMM",
    "Mixture",
    "MixtureSet",
    "PhoneLoop",
    "PPCA",
    "PLDA",
    "VAE",
    "SequenceVAE",
    "make_vae_train_step",
    "GSM",
    "HierarchicalGSM",
    "accumulate_unit_stats",
    "apply_to_phoneloop",
    "induced_posterior_moments",
    "make_gsm_train_scan",
    "make_gsm_train_step",
    "slice_gsm",
    "train_gsm",
    "train_key",
]
