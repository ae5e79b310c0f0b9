"""Phone-loop model for acoustic unit discovery (PyTorch).

Counterpart of ``beer_tpu/models/phoneloop.py``: a loop over N
left-to-right unit HMMs with a Bayesian stick-breaking prior over units,
trained by VB-EM and decoded to unit transcriptions.

The within-unit topology is fixed; the unit-level language model enters
the transitions each E-step as exp(E[log π]):

* ``log_init[start_v]         = E[log π_v]``
* ``log_trans[end_u, start_v] = log_exit_u + E[log π_v]``
* ``log_final[end_u]          = log_exit_u``

Unit u owns states and pdfs [u·P, (u+1)·P).

Routes.  :meth:`PhoneLoop.infer` / :meth:`PhoneLoop.accumulate` take
the fused E-step for a diagonal :class:`NormalSet` (any state count, any
device):
a scaled banded forward with the ELLH computed from the reduced stats,
then an accumulating backward pass that reduces γ to the emission
moments, the first-frame posteriors and the loop-back ξ — through the
CUDA kernels on a CUDA tensor, their plain versions on a CPU tensor, or
the plain versions on any device when ``plain_scan`` is set.  Any other
emissions (per-state GMMs, the other covariance types) have no affine
ELLH for the fused kernels and take :meth:`PhoneLoop.smooth`, as the JAX
package routes them.
:meth:`PhoneLoop.smooth` is the general path with materialized
posteriors (the subspace-HMM statistics bridge
:func:`beer_tpu_torch.models.gsm.accumulate_unit_stats`, tests): the
scaled passes and the smoothing backward over one shared matrix, as
kernels on CUDA tensors.

Gradient route.  When grad mode is on and the statistics require grad
(the structured VAE's latent prior), :meth:`PhoneLoop.infer` takes
:class:`~beer_tpu_torch.ops.semiring_scan.PhoneLoopLogZ` instead: the
same forward, then the γ-emitting backward (K11), whose γ is both the
gradient of log Z (the Fisher identity) and, reduced by one matmul
against the statistics in :meth:`PhoneLoop.accumulate`, the emission
moments.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from beer_tpu_torch.models.basemodel import DiscreteLatentModel
from beer_tpu_torch.models.categorical import SBCategorical
from beer_tpu_torch.models.graph import LOG_ZERO, CompiledGraph
from beer_tpu_torch.models.mixture import MixtureSet
from beer_tpu_torch.models.normal import NormalSet
from beer_tpu_torch.ops import semiring_scan
from beer_tpu_torch.utils.profiling import named_scope


def _promote(x: torch.Tensor) -> torch.Tensor:
    return x[None] if x.ndim == 2 else x


class PhoneLoop(DiscreteLatentModel):
    """Loop of left-to-right unit HMMs with a Bayesian unit prior.

    ``base_log_trans`` (S, S) holds the within-unit transitions only;
    ``log_exit`` (U,) the per-unit log exit probability of each end state
    (None: derived from ``self_loop``).  ``plain_scan`` runs the plain
    PyTorch versions of the scan kernels even on CUDA tensors (the
    reference route on the card).
    """

    def __init__(self, modelset, unit_prior, base_log_trans: torch.Tensor,
                 log_exit: Optional[torch.Tensor] = None, n_units: int = 1,
                 states_per_unit: int = 1, self_loop: float = 0.5, plain_scan: bool = False):
        super().__init__()
        self.modelset = modelset
        self.unit_prior = unit_prior
        self.register_buffer("base_log_trans", base_log_trans)
        self.register_buffer("log_exit", log_exit)
        self.n_units = n_units
        self.states_per_unit = states_per_unit
        self.self_loop = self_loop
        self.plain_scan = plain_scan

    @classmethod
    def create(cls, n_units: int, states_per_unit: int, modelset, unit_prior=None,
               concentration: float = 1.0, self_loop: float = 0.5) -> "PhoneLoop":
        """Device and dtype follow ``modelset``'s parameters."""
        post = next(modelset.buffers())
        dtype, device = post.dtype, post.device
        if unit_prior is None:
            unit_prior = SBCategorical.create(n_units, concentration, dtype, device)
        s = n_units * states_per_unit
        base = torch.full((s, s), LOG_ZERO, dtype=dtype, device=device)
        ids = torch.arange(s, device=device)
        base[ids, ids] = math.log(self_loop)
        adv = ids[(ids % states_per_unit) != states_per_unit - 1]
        base[adv, adv + 1] = math.log(1.0 - self_loop)
        return cls(modelset, unit_prior, base, None, n_units, states_per_unit, self_loop)

    # -- structural indices -------------------------------------------
    @property
    def n_states(self) -> int:
        return self.n_units * self.states_per_unit

    def _starts(self) -> torch.Tensor:
        return torch.arange(self.n_units, device=self.base_log_trans.device) * self.states_per_unit

    def _ends(self) -> torch.Tensor:
        return self._starts() + self.states_per_unit - 1

    def _exit_log_probs(self, dtype) -> torch.Tensor:
        """(U,) log exit probability: ``log_exit`` or log((1 − sl) / 2)."""
        if self.log_exit is not None:
            return self.log_exit.to(dtype)
        value = math.log((1.0 - self.self_loop) * 0.5)
        return torch.full((self.n_units,), value, dtype=dtype, device=self.base_log_trans.device)

    def _effective_graph(self) -> CompiledGraph:
        dtype = self.base_log_trans.dtype
        s = self.n_states
        starts, ends = self._starts(), self._ends()
        elogw = self.unit_prior.expected_log_weights().to(dtype)
        log_exit = self._exit_log_probs(dtype)
        trans = self.base_log_trans.clone()
        trans[ends[:, None], starts[None, :]] = log_exit[:, None] + elogw[None, :]
        init = torch.full((s,), LOG_ZERO, dtype=dtype, device=trans.device)
        init[starts] = elogw
        final = torch.full((s,), LOG_ZERO, dtype=dtype, device=trans.device)
        final[ends] = log_exit
        return CompiledGraph(init, final, trans, torch.arange(s, device=trans.device), s, s)

    def _structured_trans(self, dtype) -> torch.Tensor:
        """Band + rank-1 factorization of the effective transitions, (4, S)
        rows [a_self, a_adv, exit, w], with ``bands_to_dense == exp(log_trans)``.

        Bands come from ``base_log_trans`` (per-state values), not the
        scalar ``self_loop``."""
        s = self.n_states
        base = self.base_log_trans
        starts, ends = self._starts(), self._ends()
        if self.states_per_unit == 1:
            # every entry is a loop arc: the bands are empty
            a_self = base.new_zeros(s)
            a_adv = base.new_zeros(s)
        else:
            a_self = torch.exp(torch.diagonal(base))
            a_adv = torch.cat([torch.exp(torch.diagonal(base, 1)), base.new_zeros(1)])
            # (end, start) entries belong to the loop block.  The Python
            # scalar written through an index tensor is first copied to the
            # card from pageable host memory: there the host waits for all
            # the work queued before it
            with named_scope("beer.sync.structured_trans"):
                a_adv[ends] = 0.0
        exit_v = base.new_zeros(s)
        exit_v[ends] = torch.exp(self._exit_log_probs(base.dtype))
        w_v = base.new_zeros(s)
        w_v[starts] = torch.exp(self.unit_prior.expected_log_weights().to(base.dtype))
        return torch.stack([a_self, a_adv, exit_v, w_v]).to(dtype)

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return self.modelset.sufficient_statistics(_promote(data))

    def scan_operands(self, stats: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """The fused E-step kernels' operands for ``stats`` (B, T, P), in
        ``stats``' dtype: ``lens`` (B,) int32 and ``ends``/``starts`` (U,)
        int32, ``w`` (S, P) and ``bias`` (S,) of the ELLH, ``bands`` (4, S),
        ``init``/``final`` (S,) probabilities, and the effective ``graph``."""
        b, t_len, _ = stats.shape
        dt = stats.dtype
        with named_scope("beer.operands"):
            if mask is None:
                lens = torch.full((b,), t_len, dtype=torch.int32, device=stats.device)
            else:
                lens = mask.sum(-1).to(torch.int32)
            graph = self._effective_graph()
            w_mat, bias = self.modelset.ellh_matrix()
            return {
                "lens": lens,
                "w": w_mat.T.to(dt).contiguous(),
                "bias": bias.to(dt).contiguous(),
                "bands": self._structured_trans(dt).contiguous(),
                "init": torch.exp(torch.clamp(graph.log_init, min=LOG_ZERO)).to(dt),
                "final": torch.exp(torch.clamp(graph.log_final, min=LOG_ZERO)).to(dt),
                "ends": self._ends().to(torch.int32),
                "starts": self._starts().to(torch.int32),
                "graph": graph,
            }

    def infer(self, stats: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """Fused E-step forward: log Z (B,) and the cache ``accumulate`` needs.

        Differentiable with respect to ``stats`` when they require grad
        (the cache then holds the detached γ, γ0 and ``xi_raw``).
        Emissions other than a diagonal NormalSet (per-state GMMs, the
        other covariance types) have no ELLH matrix for the fused kernels
        and take :meth:`smooth`."""
        if not (type(self.modelset) is NormalSet and self.modelset.cov_type == "diagonal"):
            return self.smooth(stats, mask)
        stats = stats.contiguous()
        ops = self.scan_operands(stats, mask)
        if torch.is_grad_enabled() and stats.requires_grad:
            log_z, gamma, gamma0, xi_raw = semiring_scan.PhoneLoopLogZ.apply(
                stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["init"],
                ops["final"], ops["ends"], ops["starts"], self.plain_scan)
            return log_z, dict(ops, gamma=gamma, gamma0=gamma0, xi_raw=xi_raw)
        alpha, norms, last, logz_base = semiring_scan.phone_loop_forward(
            stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["init"],
            plain=self.plain_scan)
        log_z = semiring_scan.log_z_from_forward(logz_base, last, ops["final"], ops["lens"])
        return log_z, dict(ops, alpha=alpha, norms=norms)

    def smooth(self, stats: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """General E-step with materialized posteriors in the cache: the
        scaled forward and the smoothing backward of the general path (K12
        + K13 on CUDA tensors, always through their band + rank-1
        instances: on an NVIDIA H100 (700 W) the banded pair is level with
        the dense one at S = 30, 2.7x faster at S = 150 and the only one
        that fits at S = 450 (``chip_smoke.py``, phases 15 and 17; the
        plain loops over time with ``plain_scan``)."""
        graph = self._effective_graph()
        llh = self.modelset.expected_log_likelihood(stats)
        bands = self._structured_trans(llh.dtype)
        fb = semiring_scan.forward_backward_probs(
            llh, graph.log_trans, graph.log_init, graph.log_final, mask,
            structured_trans=bands, plain=self.plain_scan)
        log_z = fb.log_z
        if mask is not None:
            log_z = log_z * (mask.sum(-1) > 0)  # fully padded rows contribute 0
        return log_z, {"posteriors": fb.posteriors, "fb": fb, "llh_states": llh,
                       "mask": mask, "graph": graph}

    def accumulate(self, stats: torch.Tensor, cache: Dict[str, Any]) -> Dict[str, Any]:
        graph = cache["graph"]
        starts, ends = self._starts(), self._ends()
        if "posteriors" in cache:
            post = cache["posteriors"]
            xi = semiring_scan.expected_transition_counts_probs(
                cache["fb"], graph.log_trans, cache["mask"], rows=ends, cols=starts)
            unit_counts = xi.sum(0) + post[:, 0][:, starts].sum(0)
            acc = self.modelset.accumulate(stats.reshape(-1, stats.shape[-1]),
                                           post.reshape(-1, self.n_states))
        else:
            if "gamma" in cache:
                # the gradient route: reduce K11's γ (the JAX package's
                # BEER_FUSE_ACC=0 route)
                gamma = cache["gamma"].flatten(0, 1)
                acc2 = gamma.T @ stats.flatten(0, 1)
                counts, gamma0, xi_raw = gamma.sum(0), cache["gamma0"], cache["xi_raw"]
            else:
                acc2, counts, gamma0, xi_raw = semiring_scan.phone_loop_estep_acc(
                    stats.contiguous(), cache["lens"], cache["w"], cache["bias"],
                    cache["bands"], cache["final"], cache["alpha"], cache["norms"],
                    cache["ends"], cache["starts"], plain=self.plain_scan)
            trans_blk = torch.exp(graph.log_trans)[ends][:, starts]
            unit_counts = (xi_raw * trans_blk).sum(0) + gamma0[:, starts].sum(0)
            acc = self.modelset.accumulate_from_moments(acc2, counts)
        return {"modelset": acc, "unit_prior": self.unit_prior.accumulate_counts(unit_counts)}

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.modelset.kl_div_posterior_prior() + self.unit_prior.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "PhoneLoop":
        """Conjugate step on the emissions and the unit prior, in place."""
        with named_scope("beer.vb_update"):
            self.modelset.vb_update(acc["modelset"], lrate)
            self.unit_prior.vb_update(acc["unit_prior"], lrate)
        return self

    def mean_field_factorization(self):
        """Coordinate-ascent groups: emissions, then the unit prior — the
        q(θ_emis)·q(π) mean-field split of the AUD papers."""
        return [["modelset"], ["unit_prior"]]

    # ------------------------------------------------------------------
    def decode(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """Viterbi: (state paths (B, T) int32, scores (B,)), through the
        band + rank-1 factorization (O(B·S) per step)."""
        with named_scope("beer.decode"):
            with named_scope("beer.operands"):
                graph = self._effective_graph()
            with named_scope("beer.stats"):
                stats = self.sufficient_statistics(data)
            llh = self.modelset.expected_log_likelihood(stats)
            with named_scope("beer.operands"):
                bands = self._structured_trans(llh.dtype)
            return semiring_scan.viterbi_banded(
                llh, bands, graph.log_init, graph.log_final, mask, plain=self.plain_scan)

    def decode_units(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """Per-frame unit labels (B, T) = state path // states_per_unit."""
        paths, scores = self.decode(data, mask)
        return paths // self.states_per_unit, scores

    # ------------------------------------------------------------------
    def to_numpy(self) -> Dict[str, Any]:
        """Weights and statics as numpy arrays and Python values; the
        inverse of :func:`beer_tpu_torch.convert.phone_loop_from_numpy`."""
        sticks = self.unit_prior.sticks

        def np_(x):
            return x.detach().cpu().numpy()

        if isinstance(self.modelset, MixtureSet):
            emissions = {"modelset": self.modelset.to_numpy()}
            nset = self.modelset.modelset
        else:
            nset = self.modelset
            mp = nset.means_precisions
            emissions = {"modelset_prior": np_(mp.prior), "modelset_posterior": np_(mp.posterior)}
        conc = getattr(self.unit_prior, "concentration", None)
        return {
            **emissions,
            "sticks_prior": np_(sticks.prior),
            "sticks_posterior": np_(sticks.posterior),
            "concentration_prior": None if conc is None else np_(conc.prior),
            "concentration_posterior": None if conc is None else np_(conc.posterior),
            "base_log_trans": np_(self.base_log_trans),
            "log_exit": None if self.log_exit is None else np_(self.log_exit),
            "n_units": self.n_units,
            "states_per_unit": self.states_per_unit,
            "self_loop": self.self_loop,
            "dim": nset.dim,
            "cov_type": nset.cov_type,
        }
