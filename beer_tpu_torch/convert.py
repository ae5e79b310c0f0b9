"""Weights carried across: build the port's models from numpy arrays.

The natural-parameter layouts are the JAX package's, so a model exported
from either package loads into the other.  Each ``*_from_numpy`` is the
inverse of the model's ``to_numpy()``.

* PhoneLoop (:func:`phone_loop_from_numpy`): ``modelset_prior`` /
  ``modelset_posterior`` (S, 4D) NormalGamma natural parameters of the
  diagonal NormalSet, ``sticks_prior`` / ``sticks_posterior`` (U−1, 2)
  Beta natural parameters of the SBCategorical unit prior (with
  ``concentration_prior`` / ``concentration_posterior`` (2,), the Gamma
  natural parameters of γ, for an SBCategoricalHyperPrior),
  ``base_log_trans`` (S, S), ``log_exit`` (U,) or None, ``n_units``,
  ``states_per_unit``, ``self_loop``, ``dim``, ``cov_type``.
* NormalSet (:func:`normal_set_from_numpy`): ``type`` "NormalSet",
  ``prior`` / ``posterior`` (K, 4D) NormalGamma natural parameters for
  ``cov_type`` "diagonal", (K, D²+D+2) NormalWishart ones for "full",
  (K, D+3) IsotropicNormalGamma ones for "isotropic", and for the tied
  types one joint prior (P,): JointNormalWishart for "shared_full" (or
  "shared"), JointNormalGamma for "shared_diagonal",
  JointIsotropicNormalGamma for "shared_isotropic" (K is read off P);
  ``dim``, ``cov_type``.
* MixtureSet (:func:`mixture_set_from_numpy`): ``type`` "MixtureSet",
  ``weights_prior`` / ``weights_posterior`` (S, K) Dirichlet natural
  parameters, ``nmix``, ``ncomp_per_mix`` and ``modelset``, a NormalSet
  dict.
* Mixture (:func:`mixture_from_numpy`): ``type`` "Mixture", ``prior`` /
  ``posterior`` (K,) Dirichlet natural parameters of the weight model
  and ``modelset``, a NormalSet dict.
* HMM (:func:`hmm_from_numpy`): the compiled graph (``log_init``,
  ``log_final``, ``log_trans``, ``pdf_ids``, ``n_states``, ``n_pdfs``,
  ``l2r_banded``), ``modelset`` (a NormalSet or MixtureSet dict) and the
  transition Dirichlet ``trans_alpha_prior`` / ``trans_alpha_post``
  (S, S), or None for fixed transitions.
* Normal (:func:`normal_from_numpy`): a NormalSet dict of one component
  with ``type`` "Normal".
* JointModelSet / RepeatedModelSet (:func:`modelset_from_numpy`):
  ``type``, and ``modelsets`` (a list of modelset dicts) or ``modelset``
  (one) with ``repeats``.
* PPCA (:func:`ppca_from_numpy`): ``w_mean`` (D, Q), ``w_cov`` (Q, Q),
  ``mean`` (D,), ``prec_prior`` / ``prec_posterior`` (2,) Gamma natural
  parameters of the noise precision.
* PLDA (:func:`plda_from_numpy`): ``f_mean`` (D, Q), ``f_cov`` (D, Q, Q),
  ``mean`` (D,), ``prec_prior`` / ``prec_posterior`` (D, 2) Gamma natural
  parameters of the per-dimension noise precisions.
* VAE / SequenceVAE (:func:`vae_from_numpy`): ``type`` ("VAE" or
  "SequenceVAE"), ``encoder`` / ``decoder`` / optional ``flow``, each the
  JAX package's flax parameter tree ``{"params": {"MLP_0" or "ResMLP_0":
  {"Dense_i": {"kernel" (in, out), "bias"}}, "NormalDiagLayer_0" (or
  the decoder's head): {"Dense_0", "Dense_1"}}}`` (an ``nn.Linear``'s
  weight is the kernelᵀ), ``latent_type`` (the latent model's class
  name: PhoneLoop, HMM, Mixture or Normal) with
  ``latent_model`` its dict, and ``nsamples``.  The widths, the trunk
  kind, the output head and the flows are read off the trees.

* GSM / HierarchicalGSM (:func:`gsm_from_numpy`): ``type``, the
  variational parameters ``e_mean`` / ``e_logvar`` (U, E), ``w_mean`` /
  ``w_logvar`` (H+1, out) (and ``lang_mean`` / ``lang_logvar`` (L,
  lang_dim) with ``unit_lang``), the statics ``n_units``, ``embed_dim``,
  ``obs_dim``, ``states_per_unit``, ``n_comp``, ``learn_transitions``,
  and for a trunk its config string ``trunk_spec`` with ``trunk_params``,
  the flax tree ``{"params": {"Dense_i": {"kernel", "bias"}}}``.

Every builder puts the model on the CUDA card unless ``device`` says
otherwise (``device="cpu"``), and raises when there is no card and no
device was given.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from beer_tpu_torch import dists
from beer_tpu_torch.device import resolve_device
from beer_tpu_torch.models.categorical import Categorical, SBCategorical, SBCategoricalHyperPrior
from beer_tpu_torch.models.graph import CompiledGraph
from beer_tpu_torch.models.gsm import GSM, HierarchicalGSM
from beer_tpu_torch.models.hmm import HMM
from beer_tpu_torch import nnet
from beer_tpu_torch.models.mixture import Mixture, MixtureSet
from beer_tpu_torch.models.modelset import JointModelSet, RepeatedModelSet
from beer_tpu_torch.models.normal import SHARED, Normal, NormalSet, canonical_cov_type, family
from beer_tpu_torch.models.parameters import BayesianParameter
from beer_tpu_torch.models.phoneloop import PhoneLoop
from beer_tpu_torch.models.plda import PLDA
from beer_tpu_torch.models.ppca import PPCA
from beer_tpu_torch.models.vae import Encoder, SequenceVAE, VAE
from beer_tpu_torch.nnet import flows as nnet_flows


def _tensor(x, dtype=None, device=None) -> torch.Tensor:
    """Always a copy: the port updates its buffers in place."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _shared_ncomp(cov_type: str, p: int, dim: int) -> int:
    """K of a "shared_*" set from its joint prior's width P."""
    if cov_type == "shared_full":
        k, rest = divmod(p - dim * dim - 1, dim + 1)
    elif cov_type == "shared_diagonal":
        k, rest = divmod(p - 2 * dim, 2 * dim)
    else:
        k, rest = divmod(p - 2, dim + 1)
    if rest or k < 1:
        raise ValueError(f"modelset parameters have width {p}, which no {cov_type!r} set "
                         f"at dim={dim} has")
    return k


def _normal_set(prior, posterior, dim, cov_type, dtype, device, cls=NormalSet) -> NormalSet:
    cov_type = canonical_cov_type(cov_type)
    prior = _tensor(prior, dtype, device)
    p = prior.shape[-1]
    k = _shared_ncomp(cov_type, p, dim) if cov_type in SHARED else prior.shape[0]
    fam = family(cov_type, dim, k)
    if p != fam.nat_dim or prior.ndim != (1 if cov_type in SHARED else 2):
        raise ValueError(f"modelset parameters have shape {tuple(prior.shape)}, expected "
                         f"width {fam.nat_dim} for cov_type={cov_type!r} at dim={dim}")
    return cls(BayesianParameter(prior, _tensor(posterior, dtype, device), fam),
               cov_type=cov_type, ncomp=k, dim=dim)


def phone_loop_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> PhoneLoop:
    """A PhoneLoop on ``device`` (default: the CUDA card) in ``dtype``
    (default: the arrays' own floating type).  Per-state GMM emissions
    come as ``modelset``, a MixtureSet dict, in place of the
    ``modelset_prior`` / ``modelset_posterior`` pair."""
    device = resolve_device(device)

    def t(x):
        return _tensor(x, dtype, device)

    if "modelset" in d:
        nset = modelset_from_numpy(d["modelset"], device, dtype)
    else:
        nset = _normal_set(d["modelset_prior"], d["modelset_posterior"], int(d["dim"]),
                           d["cov_type"], dtype, device)
    n_units = int(d["n_units"])
    sticks = BayesianParameter(t(d["sticks_prior"]), t(d["sticks_posterior"]), dists.Beta())
    if d.get("concentration_prior") is not None:
        conc = BayesianParameter(t(d["concentration_prior"]), t(d["concentration_posterior"]),
                                 dists.Gamma())
        unit_prior = SBCategoricalHyperPrior(sticks, conc, truncation=n_units)
    else:
        unit_prior = SBCategorical(sticks, truncation=n_units)
    log_exit = None if d.get("log_exit") is None else t(d["log_exit"])
    return PhoneLoop(nset, unit_prior, t(d["base_log_trans"]), log_exit, n_units,
                     int(d["states_per_unit"]), float(d["self_loop"]))


def normal_set_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> NormalSet:
    """A NormalSet of any covariance type on ``device`` (default: the CUDA
    card)."""
    device = resolve_device(device)
    return _normal_set(d["prior"], d["posterior"], int(d["dim"]), d["cov_type"], dtype, device)


def normal_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> Normal:
    """A single Bayesian Normal (one component) on ``device`` (default:
    the CUDA card)."""
    device = resolve_device(device)
    out = _normal_set(d["prior"], d["posterior"], int(d["dim"]), d["cov_type"], dtype, device,
                      Normal)
    if out.ncomp != 1:
        raise ValueError(f"a Normal has one component, got {out.ncomp}")
    return out


def mixture_set_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> MixtureSet:
    """A MixtureSet on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    nmix, ncomp = int(d["nmix"]), int(d["ncomp_per_mix"])
    weights = BayesianParameter(_tensor(d["weights_prior"], dtype, device),
                                _tensor(d["weights_posterior"], dtype, device),
                                dists.Dirichlet(dim=ncomp))
    return MixtureSet(weights, normal_set_from_numpy(d["modelset"], device, dtype), nmix, ncomp)


def mixture_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> Mixture:
    """A Mixture with a Dirichlet weight model on ``device`` (default: the
    CUDA card) in ``dtype`` (default: the arrays' own floating type)."""
    device = resolve_device(device)
    prior = _tensor(d["prior"], dtype, device)
    weights = BayesianParameter(prior, _tensor(d["posterior"], dtype, device),
                                dists.Dirichlet(dim=prior.shape[-1]))
    return Mixture(Categorical(weights, prior.shape[-1]),
                   modelset_from_numpy(d["modelset"], device, dtype))


def modelset_from_numpy(d: Dict[str, Any], device=None, dtype=None):
    """A NormalSet, MixtureSet, Mixture, JointModelSet or RepeatedModelSet,
    by the dict's ``type``."""
    builders = {"NormalSet": normal_set_from_numpy, "MixtureSet": mixture_set_from_numpy,
                "Mixture": mixture_from_numpy,
                "JointModelSet": lambda d, device, dtype: JointModelSet.create(
                    [modelset_from_numpy(m, device, dtype) for m in d["modelsets"]]),
                "RepeatedModelSet": lambda d, device, dtype: RepeatedModelSet.create(
                    modelset_from_numpy(d["modelset"], device, dtype), int(d["repeats"]))}
    if d["type"] not in builders:
        raise ValueError(f"unknown modelset type {d['type']!r}")
    return builders[d["type"]](d, device, dtype)


def hmm_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> HMM:
    """An HMM on ``device`` (default: the CUDA card) in ``dtype`` (default:
    the arrays' own floating type)."""
    device = resolve_device(device)

    def t(x):
        return None if x is None else _tensor(x, dtype, device)

    graph = CompiledGraph(t(d["log_init"]), t(d["log_final"]), t(d["log_trans"]),
                          _tensor(d["pdf_ids"], torch.int64, device), int(d["n_states"]),
                          int(d["n_pdfs"]), bool(d.get("l2r_banded", False)))
    return HMM(graph, modelset_from_numpy(d["modelset"], device, dtype),
               t(d.get("trans_alpha_prior")), t(d.get("trans_alpha_post")))


def _subspace_model(cls, d: Dict[str, Any], keys, device, dtype):
    device = resolve_device(device)
    t = lambda k: _tensor(d[k], dtype, device)  # noqa: E731
    prec = BayesianParameter(t("prec_prior"), t("prec_posterior"), dists.Gamma())
    return cls(*(t(k) for k in keys), prec)


def ppca_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> PPCA:
    """A PPCA on ``device`` (default: the CUDA card) in ``dtype`` (default:
    the arrays' own floating type)."""
    return _subspace_model(PPCA, d, ("w_mean", "w_cov", "mean"), device, dtype)


def plda_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> PLDA:
    """A PLDA on ``device`` (default: the CUDA card) in ``dtype`` (default:
    the arrays' own floating type)."""
    return _subspace_model(PLDA, d, ("f_mean", "f_cov", "mean"), device, dtype)


def gsm_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> GSM:
    """A GSM or HierarchicalGSM on ``device`` (default: the CUDA card) in
    ``dtype`` (default: the arrays' own floating type)."""
    device = resolve_device(device)

    def t(key):
        return _tensor(d[key], dtype)

    e_mean = t("e_mean")
    statics = {k: int(d[k]) for k in ("n_units", "embed_dim", "obs_dim", "states_per_unit",
                                      "n_comp")}
    statics["learn_transitions"] = bool(d["learn_transitions"])
    hierarchical = d.get("type", "GSM") == "HierarchicalGSM"
    trunk = None
    if d.get("trunk_spec") is not None:
        n_in = statics["embed_dim"] + (np.asarray(d["lang_mean"]).shape[1] if hierarchical else 0)
        trunk = nnet.build_trunk(d["trunk_spec"], n_in, dtype=e_mean.dtype)
        nnet.load_flax_tree(trunk, d["trunk_params"]["params"])
    args = (e_mean, t("e_logvar"), t("w_mean"), t("w_logvar"))
    if hierarchical:
        model = HierarchicalGSM(*args, t("lang_mean"), t("lang_logvar"), d["unit_lang"], trunk,
                                **statics)
    else:
        model = GSM(*args, trunk, **statics)
    model.trunk_spec = d.get("trunk_spec")
    return model.to(device)


# ----------------------------------------------------------------------
# The VAE
# ----------------------------------------------------------------------
def _dense_sizes(tree: Dict[str, Any]):
    """(n_in, [n_out of Dense_0, Dense_1, …]) of a flax trunk or head."""
    kernels = [np.asarray(tree[f"Dense_{i}"]["kernel"]) for i in range(len(tree))]
    return kernels[0].shape[0], [k.shape[1] for k in kernels]


def _coder_from_tree(params: Dict[str, Any], dtype) -> Encoder:
    """An encoder or decoder (trunk + head) shaped after its flax tree."""
    (trunk_key,) = [k for k in params if k.startswith(("MLP_", "ResMLP_"))]
    (head_key,) = [k for k in params if k != trunk_key]
    n_in, sizes = _dense_sizes(params[trunk_key])
    if trunk_key.startswith("ResMLP_"):
        trunk = nnet.ResMLP(n_in, sizes[1:], torch.tanh, dtype=dtype)
    else:
        trunk = nnet.MLP(n_in, sizes, torch.tanh, dtype=dtype)
    heads = {cls.flax_name: cls for cls in (nnet.NormalDiagLayer, nnet.NormalIsoLayer,
                                            nnet.BernoulliLayer)}
    dim = _dense_sizes(params[head_key])[1][0]
    head = heads[head_key.rsplit("_", 1)[0]](trunk.out_features, dim, dtype=dtype)
    return nnet.load_flax_tree(Encoder(trunk, head), params)


def _flow_from_tree(params: Dict[str, Any], dim: int, dtype) -> nnet_flows.FlowStack:
    n_planar = sum(k.startswith("PlanarFlow_") for k in params)
    n_iaf = sum(k.startswith("AffineAutoregressiveFlow_") for k in params)
    return nnet.load_flax_tree(nnet_flows.FlowStack(dim, n_planar, n_iaf, dtype=dtype), params)


LATENT_TYPES = {"PhoneLoop": phone_loop_from_numpy, "HMM": hmm_from_numpy,
                   "Mixture": mixture_from_numpy, "Normal": normal_from_numpy}


def vae_from_numpy(d: Dict[str, Any], device=None, dtype=None) -> VAE:
    """A VAE or SequenceVAE on ``device`` (default: the CUDA card) in
    ``dtype`` (default: the latent model's arrays' own floating type)."""
    device = resolve_device(device)
    latent = LATENT_TYPES[d["latent_type"]](d["latent_model"], device, dtype)
    dtype = next(latent.buffers()).dtype
    encoder = _coder_from_tree(d["encoder"]["params"], dtype)
    decoder = _coder_from_tree(d["decoder"]["params"], dtype)
    latent_dim = encoder.head.mean.out_features
    flow = _flow_from_tree(d["flow"]["params"], latent_dim, dtype) if "flow" in d else None
    cls = {"VAE": VAE, "SequenceVAE": SequenceVAE}[d.get("type", "VAE")]
    return cls(encoder, decoder, latent, flow, latent_dim, int(d.get("nsamples", 1))).to(device)
