"""Bayesian HMM (PyTorch).

Counterpart of ``beer_tpu/models/hmm.py``: an HMM over a compiled state
graph with any ModelSet as tied-state emissions, trained by VB-EM and
decoded by Viterbi.  Transition probabilities are either fixed by the
graph or, with ``learn_transitions=True``, given a per-row Dirichlet over
each state's allowed arcs: the E-step then uses E[log A] (digammas) and
``accumulate`` adds the expected ξ transition counts.

Routes of :meth:`HMM.infer` / :meth:`HMM.accumulate`, chosen as the JAX
package chooses them (``hmm.py:135-154``):

* **stats** — one shared (S, S) matrix, a diagonal :class:`NormalSet`
  (the reduced statistics' affine ELLH) and a 1-D pdf map, init and
  final (BASELINE config 2): the dense
  forward computes llh = W·stats + bias in the kernel (the pdf map folds
  into W's rows) and the accumulating backward reduces γ to the emission
  moments and the full ξ (K5 + K6);
* **llh** — one shared (S, S) matrix otherwise, e.g. per-utterance pdf
  maps and final vectors of shared transcription graphs (config 3), a
  :class:`MixtureSet` or full-covariance emissions (whose component ELLH
  and statistics run K9 and K10): the forward reads the per-state llh
  stream and the backward emits γ and the full ξ (K5 + K7);
* **general** — per-utterance (B, S, S) matrices: the plain-torch
  probability-space smoothing of :mod:`beer_tpu_torch.ops.semiring_scan`.
  Learned transitions there have a (B, S, S) Dirichlet, one per
  utterance's graph, whose statistics are the JAX package's: the batch's
  summed ξ outer products times each utterance's own matrix, and whose KL
  is the JAX package's expression (both faults of the reference, kept so
  the port equals it: ROADMAP §C).

The fused routes run the CUDA kernels on CUDA tensors and their plain
versions on CPU tensors, or with ``plain_scan`` set.  ``infer`` returns
per-utterance log Z (0 for empty rows).

When grad mode is on and the statistics require grad (the structured
VAE's latent prior), the stats and llh routes both take
:class:`~beer_tpu_torch.ops.semiring_scan.HMMLogZ` over the state llh
(K5 + K7 in the forward, γ·ct in the backward) and ``accumulate``
reduces the cached γ as the llh route does; the general route stays
plain-torch autograd.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from beer_tpu_torch.models.basemodel import DiscreteLatentModel
from beer_tpu_torch.models.graph import LOG_ZERO, CompiledGraph, Graph
from beer_tpu_torch.models.normal import NormalSet
from beer_tpu_torch.ops import semiring_scan


def _promote(x: torch.Tensor) -> torch.Tensor:
    return x[None] if x.ndim == 2 else x


def _lengths(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    return mask.sum(-1).to(torch.int32)


def _probs(log_v: torch.Tensor, b: int, s: int, dtype) -> torch.Tensor:
    """exp of a (S,) or (B, S) log vector, as a contiguous (B, S) array."""
    return torch.exp(torch.clamp(log_v, min=LOG_ZERO)).expand(b, s).to(dtype).contiguous()


class HMM(DiscreteLatentModel):
    """HMM with any ModelSet as tied-state emissions.

    The compiled graph's tensors are buffers (``graph_*``), so ``.to()``
    moves them with the emissions; :attr:`graph` rebuilds the
    :class:`CompiledGraph` view.  ``trans_alpha_prior``/``trans_alpha_post``
    (S, S), or (B, S, S) on per-utterance graphs, are the transition
    Dirichlet's concentrations (0 on forbidden arcs), or None for fixed
    transitions.
    """

    def __init__(self, graph: CompiledGraph, modelset,
                 trans_alpha_prior: Optional[torch.Tensor] = None,
                 trans_alpha_post: Optional[torch.Tensor] = None, plain_scan: bool = False):
        super().__init__()
        self.modelset = modelset
        self.register_buffer("graph_log_init", graph.log_init)
        self.register_buffer("graph_log_final", graph.log_final)
        self.register_buffer("graph_log_trans", graph.log_trans)
        self.register_buffer("graph_pdf_ids", graph.pdf_ids.long())
        self.n_states = graph.n_states
        self.n_pdfs = graph.n_pdfs
        self.l2r_banded = graph.l2r_banded
        self.register_buffer("trans_alpha_prior", trans_alpha_prior)
        self.register_buffer("trans_alpha_post", trans_alpha_post)
        self.plain_scan = plain_scan

    @classmethod
    def create(cls, graph, modelset, learn_transitions: bool = False,
               trans_prior_strength: float = 1.0) -> "HMM":
        """A :class:`Graph` is compiled in the emissions' dtype, on their
        device.  With ``learn_transitions`` the prior concentration is
        ``trans_prior_strength`` × the graph's arc probabilities, 0 on
        forbidden arcs, of the graph's shape: (S, S) or per-utterance
        (B, S, S)."""
        like = next(modelset.buffers())
        if isinstance(graph, Graph):
            graph = graph.compile(like.dtype, like.device)
        prior = None
        if learn_transitions:
            prior = torch.where(graph.log_trans > LOG_ZERO / 2,
                                trans_prior_strength * torch.exp(graph.log_trans), 0.0)
        return cls(graph, modelset, prior, None if prior is None else prior.clone())

    @property
    def graph(self) -> CompiledGraph:
        return CompiledGraph(self.graph_log_init, self.graph_log_final, self.graph_log_trans,
                             self.graph_pdf_ids, self.n_states, self.n_pdfs, self.l2r_banded)

    # -- Bayesian transitions -------------------------------------------
    def _effective_log_trans(self) -> torch.Tensor:
        """E[log A] under the transition Dirichlet (the graph's log A when
        transitions are fixed); closed form with ``torch.digamma``."""
        if self.trans_alpha_post is None:
            return self.graph_log_trans
        a = self.trans_alpha_post
        allowed = self.trans_alpha_prior > 0
        row_sum = torch.where(allowed, a, 0.0).sum(-1, keepdim=True)
        e_log = torch.digamma(torch.where(allowed, a, 1.0)) - torch.digamma(
            row_sum.clamp_min(1e-30))
        return torch.where(allowed, e_log, LOG_ZERO)

    def _trans_kl(self) -> torch.Tensor:
        """Σ_rows KL(Dir(α_post)‖Dir(α_prior)) over each row's allowed arcs."""
        if self.trans_alpha_post is None:
            return self.graph_log_trans.new_zeros(())
        a_q, a_p = self.trans_alpha_post, self.trans_alpha_prior
        allowed = a_p > 0
        aq = torch.where(allowed, a_q, 1.0)
        ap = torch.where(allowed, a_p, 1.0)
        q_sum = torch.where(allowed, a_q, 0.0).sum(-1)
        p_sum = torch.where(allowed, a_p, 0.0).sum(-1)
        # [:, None] is the JAX package's expression (beer_tpu/models/hmm.py:102):
        # right for (S, S), but for per-utterance (B, S, S) rows it takes entry
        # (b, i, j) against row j's sum, not row i's (ROADMAP §C, in both
        # packages); kept so the port's ELBO equals the reference's
        dig = torch.digamma(aq) - torch.digamma(q_sum.clamp_min(1e-30))[:, None]
        per_row = (
            torch.lgamma(q_sum.clamp_min(1e-30))
            - torch.where(allowed, torch.lgamma(aq), 0.0).sum(-1)
            - torch.lgamma(p_sum.clamp_min(1e-30))
            + torch.where(allowed, torch.lgamma(ap), 0.0).sum(-1)
            + torch.where(allowed, (a_q - a_p) * dig, 0.0).sum(-1)
        )
        return torch.where(q_sum > 0, per_row, 0.0).sum()

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: torch.Tensor) -> torch.Tensor:
        return self.modelset.sufficient_statistics(_promote(data))

    def _state_llh(self, stats: torch.Tensor) -> torch.Tensor:
        return self.graph.expand_llh(self.modelset.expected_log_likelihood(stats))

    def route(self) -> str:
        """"stats", "llh" or "general" (see the module docstring)."""
        if self.graph_log_trans.ndim == 3:
            return "general"
        if (type(self.modelset) is NormalSet and self.modelset.cov_type == "diagonal"
                and self.graph_pdf_ids.ndim == 1 and self.graph_log_init.ndim == 1
                and self.graph_log_final.ndim == 1):
            return "stats"
        return "llh"

    def infer(self, stats: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """E-step forward: log Z (B,) and the cache ``accumulate`` needs."""
        return self._infer(stats, mask, self.route())

    def _infer(self, stats: torch.Tensor, mask: Optional[torch.Tensor], route: str):
        log_trans = self._effective_log_trans()
        if route == "general":
            fb = semiring_scan.forward_backward_probs(
                self._state_llh(stats), log_trans, self.graph_log_init, self.graph_log_final, mask)
            log_z = fb.log_z if mask is None else fb.log_z * (mask.sum(-1) > 0)
            return log_z, {"route": route, "posteriors": fb.posteriors, "fb": fb, "mask": mask,
                           "log_trans": log_trans}
        b, _, _ = stats.shape
        s, dt = self.n_states, stats.dtype
        lens = _lengths(stats, mask)
        trans = torch.exp(log_trans).to(dt).contiguous()
        init = _probs(self.graph_log_init, b, s, dt)
        final = _probs(self.graph_log_final, b, s, dt)
        cache = {"route": route, "lens": lens, "trans": trans, "final": final,
                 "log_trans": log_trans}
        if torch.is_grad_enabled() and stats.requires_grad:
            llh = self._state_llh(stats).to(dt).contiguous()
            log_z, gamma, xi_raw = semiring_scan.HMMLogZ.apply(llh, lens, trans, init, final,
                                                               self.plain_scan)
            return log_z, dict(cache, route="llh", gamma=gamma, xi_raw=xi_raw)
        if route == "stats":
            x = cache["stats"] = stats.contiguous()
            w_mat, bias = self.modelset.ellh_matrix()      # (P, n_pdfs), (n_pdfs,)
            cache["w"] = w_mat.T[self.graph_pdf_ids].to(dt).contiguous()
            cache["bias"] = bias[self.graph_pdf_ids].to(dt).contiguous()
            alpha, norms, last, logz_base = semiring_scan.hmm_forward(
                x, lens, trans, init, cache["w"], cache["bias"], plain=self.plain_scan)
        else:
            x = cache["llh"] = self._state_llh(stats).to(dt).contiguous()
            alpha, norms, last, logz_base = semiring_scan.hmm_forward(
                x, lens, trans, init, plain=self.plain_scan)
        log_z = semiring_scan.log_z_from_forward(logz_base, last, final, lens)
        return log_z, dict(cache, alpha=alpha, norms=norms)

    def _backward(self, cache: Dict[str, Any]):
        """The fused routes' backward pass: (acc2, counts, xi_raw) on the
        stats route, (γ (B, T, S), xi_raw) on the llh route (from the
        cache on the gradient route, which ran it in the forward)."""
        if "gamma" in cache:
            return cache["gamma"], cache["xi_raw"]
        if cache["route"] == "stats":
            acc2, counts, _, xi_raw = semiring_scan.hmm_estep_acc(
                cache["stats"], cache["lens"], cache["w"], cache["bias"], cache["trans"],
                cache["final"], cache["alpha"], cache["norms"], plain=self.plain_scan)
            return acc2, counts, xi_raw
        return semiring_scan.hmm_estep_gamma(
            cache["llh"], cache["lens"], cache["trans"], cache["final"], cache["alpha"],
            cache["norms"], plain=self.plain_scan)

    def _pdf_map(self, dtype: torch.dtype) -> torch.Tensor:
        """The pdf map as one-hot (S, n_pdfs) or (B, S, n_pdfs) rows.  A
        product with it sums the states sharing a pdf: each term is exact
        (TF32 is off) and, unlike ``index_add_`` / ``scatter_add_``, whose
        CUDA atomics add in no fixed order, two runs on the same inputs give
        the same bits."""
        return torch.nn.functional.one_hot(self.graph_pdf_ids, self.n_pdfs).to(dtype)

    def _pdf_posteriors(self, post: torch.Tensor) -> torch.Tensor:
        """(B, T, S) state posteriors → (B, T, n_pdfs): states sharing a
        pdf sum together."""
        ids = self.graph_pdf_ids
        if ids.ndim == 1 and self.n_pdfs == self.n_states and torch.equal(
                ids, torch.arange(self.n_states, device=ids.device)):
            return post
        return post @ self._pdf_map(post.dtype)

    def accumulate(self, stats: torch.Tensor, cache: Dict[str, Any]) -> Dict[str, Any]:
        route = cache["route"]
        if route == "stats":
            acc2, counts, xi_raw = self._backward(cache)
            acc_pdf = self._pdf_map(acc2.dtype).T @ acc2
            counts_pdf = counts @ self._pdf_map(counts.dtype)
            acc = {"modelset": self.modelset.accumulate_from_moments(acc_pdf, counts_pdf)}
        else:
            if route == "llh":
                post, xi_raw = self._backward(cache)
            else:
                post = cache["posteriors"]
            pdf_post = self._pdf_posteriors(post)
            acc = {"modelset": self.modelset.accumulate(stats.reshape(-1, stats.shape[-1]),
                                                        pdf_post.reshape(-1, self.n_pdfs))}
        if self.trans_alpha_post is not None:
            if route == "general":
                # on (B, S, S) matrices the JAX package's pooled counts (ROADMAP §C)
                acc["trans"] = semiring_scan.expected_transition_counts_probs(
                    cache["fb"], cache["log_trans"], cache["mask"], pooled=True)
            else:
                acc["trans"] = xi_raw * cache["trans"]
        return acc

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return self.modelset.kl_div_posterior_prior() + self._trans_kl()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "HMM":
        """Conjugate step on the emissions and the transition Dirichlet,
        in place."""
        self.modelset.vb_update(acc["modelset"], lrate)
        if self.trans_alpha_post is not None and "trans" in acc:
            counts = torch.where(self.trans_alpha_prior > 0, acc["trans"], 0.0)
            post = self.trans_alpha_post
            post.copy_(post + lrate * (self.trans_alpha_prior + counts - post))
        return self

    def mean_field_factorization(self):
        """Coordinate-ascent groups: emissions, then the transitions when
        they are learned — the reference's q(θ_emis)·q(A) factorization."""
        if self.trans_alpha_post is None:
            return [["modelset"]]
        return [["modelset"], ["trans_alpha_post"]]

    # ------------------------------------------------------------------
    def posteriors(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-frame state occupancies γ (B, T, S), 0 on padded frames:
        the llh route's forward and γ-emitting backward (K5 + K7) for one
        shared (S, S) matrix, the general path for per-utterance ones."""
        stats = self.sufficient_statistics(data)
        if self.route() == "general":
            return self.infer(stats, mask)[1]["posteriors"]
        return self._backward(self._infer(stats, mask, "llh")[1])[0]

    def expected_transition_counts(self, cache: Dict[str, Any]) -> torch.Tensor:
        """E[#transitions i→j] summed over the batch, (S, S), under the
        matrix that produced ``cache`` (from :meth:`infer`)."""
        if cache["route"] == "general":
            return semiring_scan.expected_transition_counts_probs(
                cache["fb"], cache["log_trans"], cache["mask"])
        return self._backward(cache)[-1] * cache["trans"]

    def decode(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """Viterbi best state path: (paths (B, T) int32, scores (B,)).

        A shared left-to-right graph (``l2r_banded``) takes the banded
        Viterbi kernels with an empty loop-back family (exact: learned
        transitions only reweight the existing arcs) at every S; anything
        else takes the dense (max,+) recursion."""
        stats = self.sufficient_statistics(data)
        llh = self._state_llh(stats)
        log_trans = self._effective_log_trans()
        s = self.n_states
        if self.l2r_banded and log_trans.ndim == 2:
            ids = torch.arange(s - 1, device=llh.device)
            a_self = torch.exp(torch.diagonal(log_trans))
            a_adv = torch.cat([torch.exp(log_trans[ids, ids + 1]), log_trans.new_zeros(1)])
            zeros = log_trans.new_zeros(s)
            bands = torch.stack([a_self, a_adv, zeros, zeros]).to(llh.dtype)
            return semiring_scan.viterbi_banded(llh, bands, self.graph_log_init,
                                                self.graph_log_final, mask,
                                                plain=self.plain_scan)
        return semiring_scan.viterbi(llh, log_trans, self.graph_log_init, self.graph_log_final,
                                     mask)

    # ------------------------------------------------------------------
    def to_numpy(self) -> Dict[str, Any]:
        """Graph, emissions and transition Dirichlet as numpy arrays and
        Python values; the inverse of
        :func:`beer_tpu_torch.convert.hmm_from_numpy`."""

        def np_(x):
            return None if x is None else x.detach().cpu().numpy()

        return {
            "log_init": np_(self.graph_log_init),
            "log_final": np_(self.graph_log_final),
            "log_trans": np_(self.graph_log_trans),
            "pdf_ids": np_(self.graph_pdf_ids.to(torch.int32)),
            "n_states": self.n_states,
            "n_pdfs": self.n_pdfs,
            "l2r_banded": self.l2r_banded,
            "modelset": self.modelset.to_numpy(),
            "trans_alpha_prior": np_(self.trans_alpha_prior),
            "trans_alpha_post": np_(self.trans_alpha_post),
        }
