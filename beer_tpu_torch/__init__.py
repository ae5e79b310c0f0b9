"""beer_tpu_torch — the PyTorch/CUDA port of beer_tpu.

Bayesian speech models (variational-Bayes conjugate exponential-family
models) in PyTorch, with the scan recursions and the full-covariance
statistics of the ported paths as hand-written CUDA kernels for Hopper
(``beer_tpu_torch/csrc``).  The
JAX package ``beer_tpu`` is the reference this package is tested against;
the natural-parameter layouts are the same, so weights carry across
(:mod:`beer_tpu_torch.convert`).

Ported so far: the phone-loop acoustic-unit-discovery model with a
diagonal NormalSet (BASELINE config 4), and the Bayesian HMM over state
graphs with diagonal NormalSet or MixtureSet emissions and optionally
learned transitions (ergodic HMMs, config 2; the supervised recognizer
on transcription graphs, config 3): VB-EM steps (:func:`vb_step`),
posteriors and Viterbi decoding; the full-covariance Bayesian GMM
(:class:`Mixture` over a full-covariance NormalSet, config 1) and
full-covariance NormalSet and MixtureSet emissions of the HMM; the
structured VAE (:class:`VAE`, :class:`SequenceVAE` over a phone-loop or
HMM prior, config 5) with its nnets (:mod:`beer_tpu_torch.nnet`) and
the hybrid step (:func:`make_vae_train_step`, :class:`VBOptimizer`); the
subspace-HMM (:class:`GSM`, :class:`HierarchicalGSM`): the phone-loop
E-step with materialised posteriors through the general-path kernels
(``PhoneLoop.smooth``), :func:`accumulate_unit_stats`, the ELBO gradient
step (:func:`make_gsm_train_step`) and the moment-matched write-back
(:func:`apply_to_phoneloop`); and the acoustic-unit-discovery recipe's
command line (``python -m beer_tpu_torch.cli`` or ``beer-torch``:
``dataset create``, ``features extract``, ``hmm mkphoneloop``, ``hmm
train``, ``hmm decode``) with what it stands on: the feature frontend
(:mod:`beer_tpu_torch.features`), feature archives and batch loading
(:mod:`beer_tpu_torch.io`), checkpoints, configs, guards, metrics and
profiling hooks (:mod:`beer_tpu_torch.utils`), and the Gamma
hyper-prior on the unit prior's concentration
(:class:`SBCategoricalHyperPrior`); and since then the rest of the
model zoo in plain torch: PPCA and PLDA (bench configs 7 and 8), the
isotropic and tied ("shared_*") covariance types of :class:`NormalSet`
with the Wishart and joint priors behind them, :class:`JointModelSet`
and :class:`RepeatedModelSet`, mean-field coordinate VB
(:func:`vb_step_coordinate`, :func:`vb_update_partial`), and the
log-domain and associative-scan forward recursions of
:mod:`beer_tpu_torch.ops.semiring_scan`; and last data-parallel VB-EM
over a ``torch.distributed`` mesh (:mod:`beer_tpu_torch.parallel`, with
``hmm train`` across ranks), sequence-parallel inference
(:mod:`beer_tpu_torch.ops.seq_parallel`) and learned transitions on
per-utterance graphs.

Entry points that build a model or a graph (the ``*_from_numpy``
converters, ``Graph.compile``, ``transcription_graphs``,
``Categorical.create``, ``SBCategorical.create``,
``SBCategoricalHyperPrior.create``, ``GSM.create``,
``HierarchicalGSM.create``, ``PPCA.create``, ``PLDA.create``,
``utils.load_model`` and the CLI's verbs
without ``--device``) build on the CUDA card
unless they are given ``device="cpu"``; with no card and no device they
raise.  Models made from a NormalSet follow its device.

Importing the package turns TF32 off for float32 matmuls and
convolutions: the expected log-likelihood and the moment accumulation
must stay full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from beer_tpu_torch import dists, nnet  # noqa: E402
from beer_tpu_torch.convert import (  # noqa: E402
    gsm_from_numpy,
    hmm_from_numpy,
    mixture_from_numpy,
    mixture_set_from_numpy,
    normal_from_numpy,
    normal_set_from_numpy,
    phone_loop_from_numpy,
    plda_from_numpy,
    ppca_from_numpy,
    vae_from_numpy,
)
from beer_tpu_torch.models import *  # noqa: E402,F401,F403
from beer_tpu_torch.vbi import (  # noqa: E402
    ELBO,
    VBConjugateOptimizer,
    VBOptimizer,
    elbo_and_stats,
    evidence_lower_bound,
    vb_step,
    vb_step_coordinate,
    vb_update_partial,
)

__version__ = "0.1.0"

__all__ = [
    "dists",
    "nnet",
    "phone_loop_from_numpy",
    "hmm_from_numpy",
    "mixture_from_numpy",
    "mixture_set_from_numpy",
    "normal_set_from_numpy",
    "normal_from_numpy",
    "vae_from_numpy",
    "ppca_from_numpy",
    "plda_from_numpy",
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
    "make_gsm_train_step",
    "slice_gsm",
    "train_gsm",
    "gsm_from_numpy",
    "ELBO",
    "VBConjugateOptimizer",
    "VBOptimizer",
    "elbo_and_stats",
    "evidence_lower_bound",
    "vb_step",
    "vb_step_coordinate",
    "vb_update_partial",
]
