"""beer_tpu_torch — the PyTorch/CUDA port of beer_tpu.

Bayesian speech models (variational-Bayes conjugate exponential-family
models) in PyTorch, with the scan recursions of the phone-loop main path
as hand-written CUDA kernels for Hopper (``beer_tpu_torch/csrc``).  The
JAX package ``beer_tpu`` is the reference this package is tested against;
the natural-parameter layouts are the same, so weights carry across
(:mod:`beer_tpu_torch.convert`).

This slice covers the phone-loop acoustic-unit-discovery model with a
diagonal NormalSet: VB-EM steps (:func:`vb_step`) and Viterbi decoding
(``PhoneLoop.decode_units``).

Importing the package turns TF32 off for float32 matmuls and
convolutions: the expected log-likelihood and the moment accumulation
must stay full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from beer_tpu_torch import dists  # noqa: E402
from beer_tpu_torch.convert import phone_loop_from_numpy  # noqa: E402
from beer_tpu_torch.models import *  # noqa: E402,F401,F403
from beer_tpu_torch.vbi import (  # noqa: E402
    ELBO,
    VBConjugateOptimizer,
    elbo_and_stats,
    evidence_lower_bound,
    vb_step,
)

__version__ = "0.1.0"

__all__ = [
    "dists",
    "phone_loop_from_numpy",
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
    "ELBO",
    "VBConjugateOptimizer",
    "elbo_and_stats",
    "evidence_lower_bound",
    "vb_step",
]
