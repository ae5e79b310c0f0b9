"""Generalized Subspace Model (GSM): subspace-HMM / H-SHMM (PyTorch).

Counterpart of ``beer_tpu/models/gsm.py``.  Each acoustic unit u gets a
low-dimensional embedding e_u whose image η(e_u) through a variational
affine map (optionally after a deterministic MLP trunk) parameterizes
the unit's HMM; embeddings and subspace are trained by
reparameterization-trick gradient ascent on

    Σ_u E_q[⟨s_u, T(η(e_u))⟩ − counts_u · A_x(η(e_u))]
        − KL(q(e)‖p(e)) − KL(q(W,b)‖p(W,b))

where s_u are the per-unit statistics of a phone-loop E-step.  The
subspace generates the diagonal-Normal emissions (μ, λ) of every unit
state (with ``n_comp > 1`` a GMM per state including its mixture
weights) and optionally one self-loop logit per state
(``learn_transitions``).

One outer iteration of subspace-HMM training is

1. VB steps of the phone loop (``beer_tpu_torch.vb_step``),
2. :func:`accumulate_unit_stats`: a phone-loop E-step with materialised
   posteriors (``PhoneLoop.smooth``: the general-path kernels K12 + K13
   on the card) reduced to per-unit statistics,
3. gradient steps on :meth:`GSM.elbo` (:func:`make_gsm_train_step`;
   :func:`train_gsm` loops over them, :func:`make_gsm_train_scan` runs
   them as one CUDA graph on the card),
4. :func:`apply_to_phoneloop`: the Monte-Carlo moments of q(η(e_u)) are
   moment-matched to NormalGamma / Dirichlet posteriors and written back.

The models are ``nn.Module``s whose variational parameters are
``nn.Parameter``s.  Noise comes from an explicit ``torch.Generator`` on
the parameters' device, or is passed in as ``eps`` (a dict of the blocks
of :meth:`GSM._eps_spec`), which is how the tests feed both packages the
same numbers.  ``GSM.create`` / ``HierarchicalGSM.create`` build on the
CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from beer_tpu_torch import nnet
from beer_tpu_torch.device import resolve_device
from beer_tpu_torch.dists import normallik
from beer_tpu_torch.models.mixture import MixtureSet
from beer_tpu_torch.ops import semiring_scan

LOG_2PI = math.log(2.0 * math.pi)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -_softplus(-x)


def _kl_diag(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mean, diag(exp(logvar))) ‖ N(0, I))."""
    return 0.5 * (torch.exp(logvar) + mean**2 - 1.0 - logvar).sum()


class GSM(nn.Module):
    """Subspace over the per-unit HMM parameters.

    Variational parameters (all trained by gradient): ``e_mean``,
    ``e_logvar`` (U, E) of q(e_u); ``w_mean``, ``w_logvar`` (H+1, out) of
    the affine map (with its bias row) that reads the trunk's output (or
    the raw embedding); ``trunk``, a deterministic MLP (MAP-trained), or
    None for the plain affine subspace.

    Output layout per unit: ``[P·K·2D emission raw | P·K weight logits
    (K>1) | P self-loop logits (learn_transitions)]``.
    """

    def __init__(self, e_mean, e_logvar, w_mean, w_logvar, trunk: Optional[nn.Module] = None,
                 n_units: int = 1, embed_dim: int = 2, obs_dim: int = 1,
                 states_per_unit: int = 1, n_comp: int = 1, learn_transitions: bool = False):
        super().__init__()
        self.e_mean = nn.Parameter(e_mean)
        self.e_logvar = nn.Parameter(e_logvar)
        self.w_mean = nn.Parameter(w_mean)
        self.w_logvar = nn.Parameter(w_logvar)
        self.trunk = trunk
        self.trunk_spec: Optional[str] = None   # the trunk's config string, for to_numpy()
        self.n_units = n_units
        self.embed_dim = embed_dim
        self.obs_dim = obs_dim
        self.states_per_unit = states_per_unit
        self.n_comp = n_comp
        self.learn_transitions = learn_transitions

    # -- layout helpers --------------------------------------------------
    @property
    def _emis_size(self) -> int:
        return self.states_per_unit * self.n_comp * 2 * self.obs_dim

    @property
    def _weight_size(self) -> int:
        return self.states_per_unit * self.n_comp if self.n_comp > 1 else 0

    @property
    def _trans_size(self) -> int:
        return self.states_per_unit if self.learn_transitions else 0

    @property
    def out_dim(self) -> int:
        return self._emis_size + self._weight_size + self._trans_size

    @classmethod
    def create(cls, n_units: int, embed_dim: int, obs_dim: int, states_per_unit: int = 1,
               n_comp: int = 1, learn_transitions: bool = False, trunk: Optional[str] = None,
               generator: Optional[torch.Generator] = None, dtype=torch.float32,
               device=None) -> "GSM":
        """``trunk``: an optional nnet config string (see
        :func:`beer_tpu_torch.nnet.build_trunk`, e.g. ``"mlp:32,32:tanh"``).
        ``generator`` is a CPU generator: the weights are drawn on the CPU
        and moved to ``device`` (default: the CUDA card)."""
        device = resolve_device(device)
        trunk_module, in_dim = None, embed_dim
        if trunk is not None:
            trunk_module = nnet.build_trunk(trunk, embed_dim, generator, dtype)
            in_dim = trunk_module.out_features
        e_mean = 0.1 * torch.randn(n_units, embed_dim, generator=generator, dtype=dtype)
        placeholder = torch.zeros(1, 1, dtype=dtype)   # the map's width follows from the layout
        model = cls(e_mean, torch.full((n_units, embed_dim), -2.0, dtype=dtype), placeholder,
                    placeholder.clone(), trunk_module, n_units, embed_dim, obs_dim,
                    states_per_unit, n_comp, learn_transitions)
        shape = (in_dim + 1, model.out_dim)
        model.w_mean = nn.Parameter(0.1 * torch.randn(shape, generator=generator, dtype=dtype))
        model.w_logvar = nn.Parameter(torch.full(shape, -4.0, dtype=dtype))
        model.trunk_spec = trunk
        return model.to(device)

    # ------------------------------------------------------------------
    def _eps_spec(self, nsamples: int) -> Dict[str, tuple]:
        """Name → shape of the reparameterization noise blocks."""
        return {"e": (nsamples, *self.e_mean.shape), "w": (nsamples, *self.w_mean.shape)}

    def sample_eps(self, generator: Optional[torch.Generator] = None,
                   nsamples: int = 4) -> Dict[str, torch.Tensor]:
        """Parameter-independent N(0, 1) noise for one step: one draw per
        block of :meth:`_eps_spec`, on the parameters' device (where
        ``generator`` must live)."""
        ref = self.e_mean
        return {name: torch.randn(shape, generator=generator, dtype=ref.dtype, device=ref.device)
                for name, shape in self._eps_spec(nsamples).items()}

    def _params_from_eps(self, eps):
        e = self.e_mean[None] + torch.exp(0.5 * self.e_logvar)[None] * eps["e"]
        w = self.w_mean[None] + torch.exp(0.5 * self.w_logvar)[None] * eps["w"]
        return e, w

    def _mean_inputs(self) -> torch.Tensor:
        """The posterior-mean input of the map, (U, E)."""
        return self.e_mean

    def unit_params(self, e: torch.Tensor, w: torch.Tensor) -> Dict[str, Any]:
        """Trunk + affine map + links: embeddings → per-unit parameters.

        Returns a dict with ``mu, lam`` of shape (..., U, P, K, D),
        ``log_w`` (..., U, P, K) (K > 1 only) and ``trans_logit``
        (..., U, P) (``learn_transitions`` only); None where absent."""
        h = e if self.trunk is None else self.trunk(e)
        raw = torch.matmul(torch.cat([h, h.new_ones(*h.shape[:-1], 1)], dim=-1), w)
        p, k, d = self.states_per_unit, self.n_comp, self.obs_dim
        em = raw[..., : self._emis_size].reshape(*raw.shape[:-1], p, k, 2 * d)
        out = {"mu": em[..., :d], "lam": _softplus(em[..., d:]) + 1e-4, "log_w": None,
               "trans_logit": None}
        off = self._emis_size
        if k > 1:
            logits = raw[..., off: off + self._weight_size].reshape(*raw.shape[:-1], p, k)
            out["log_w"] = torch.log_softmax(logits, dim=-1)
            off += self._weight_size
        if self.learn_transitions:
            out["trans_logit"] = raw[..., off: off + p]
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _normalize_stats(unit_stats) -> Dict[str, Any]:
        """Accept the array form (U, [P,] 4D) or the full stats dict."""
        if isinstance(unit_stats, dict):
            return unit_stats
        s = unit_stats if unit_stats.ndim == 3 else unit_stats[:, None]
        return {"emission": s[..., None, :], "comp_counts": None, "self": None, "adv": None}

    def expected_llh_of_stats(self, unit_stats, unit_counts=None,
                              generator: Optional[torch.Generator] = None, nsamples: int = 4,
                              eps=None) -> torch.Tensor:
        """Monte-Carlo E_q[Σ_u ⟨s_u, T(η(e_u))⟩ − c_u A_x(η(e_u))].

        ``unit_stats`` is either the emission stats array (U, P, 4D) in
        the diagonal-Normal layout [−½Σx², Σx, −½c, ½c] with
        ``unit_counts`` (U, P), or the dict of
        :func:`accumulate_unit_stats` (emission / comp_counts / self /
        adv entries, covering mixture weights and transitions)."""
        st = self._normalize_stats(unit_stats)
        emission = st["emission"]                          # (U, P, K, 4D)
        if st.get("comp_counts") is None:
            if unit_counts is None:
                raise ValueError(
                    "expected_llh_of_stats: the array form of unit_stats carries no frame "
                    "counts: pass unit_counts (U,) or (U, P), or the accumulate_unit_stats dict")
            counts = unit_counts if unit_counts.ndim == 2 else unit_counts[:, None]
            comp_counts = counts[..., None]                # (U, P, 1)
        else:
            comp_counts = st["comp_counts"]
        if eps is None:
            eps = self.sample_eps(generator, nsamples)
        params = self.unit_params(*self._params_from_eps(eps))
        mu, lam = params["mu"], params["lam"]              # (S, U, P, K, D)
        d = self.obs_dim
        s_sq, s_x = emission[..., :d], emission[..., d: 2 * d]
        # Σ_t log N(x_t|μ,λ⁻¹) = −½λΣx² + λμΣx − c(½λμ² − ½logλ + ½log2π)
        ll = ((s_sq * lam).sum(-1) + (s_x * (lam * mu)).sum(-1)
              - comp_counts[None] * (0.5 * (lam * mu**2) - 0.5 * torch.log(lam)
                                     + 0.5 * LOG_2PI).sum(-1))   # (S, U, P, K)
        if params["log_w"] is not None:
            ll = ll + comp_counts[None] * params["log_w"]
        total = ll.flatten(1).sum(1)
        if self.learn_transitions and st.get("self") is not None:
            logit = params["trans_logit"]                  # (S, U, P)
            trans_ll = (st["self"][None] * _log_sigmoid(logit)
                        + st["adv"][None] * _log_sigmoid(-logit))
            total = total + trans_ll.flatten(1).sum(1)
        return total.mean()                                # MC average

    def kl_div_posterior_prior(self) -> torch.Tensor:
        """KL of q(e) and q(W) against standard-Normal priors (diagonal);
        the trunk is a point estimate and has none."""
        return _kl_diag(self.e_mean, self.e_logvar) + _kl_diag(self.w_mean, self.w_logvar)

    def elbo(self, unit_stats, unit_counts=None, generator=None, nsamples: int = 4, eps=None):
        return (self.expected_llh_of_stats(unit_stats, unit_counts, generator, nsamples, eps)
                - self.kl_div_posterior_prior())

    def to_numpy(self) -> Dict[str, Any]:
        """Weights and statics as numpy arrays and Python values; the
        inverse of :func:`beer_tpu_torch.convert.gsm_from_numpy`."""
        out = {name: p.detach().cpu().numpy() for name, p in self.named_parameters(recurse=False)}
        out.update(type=type(self).__name__, n_units=self.n_units, embed_dim=self.embed_dim,
                   obs_dim=self.obs_dim, states_per_unit=self.states_per_unit,
                   n_comp=self.n_comp, learn_transitions=self.learn_transitions,
                   trunk_spec=self.trunk_spec)
        if self.trunk is not None:
            out["trunk_params"] = {"params": nnet.flax_tree(self.trunk)}
        return out

    # ------------------------------------------------------------------
    def emission_expectations(self):
        """Posterior-mean unit emissions (μ, λ): (U, P, D) when
        ``n_comp == 1``, (U, P, K, D) otherwise.  For decoding, prefer the
        moment-matched :func:`apply_to_phoneloop` write-back."""
        p = self.unit_params(self._mean_inputs(), self.w_mean)
        mu, lam = p["mu"], p["lam"]
        if self.n_comp == 1:
            mu, lam = mu[..., 0, :], lam[..., 0, :]
        return mu, lam


class HierarchicalGSM(GSM):
    """H-SHMM: per-language embeddings entering the shared affine map,
    η(e_u, l_{g(u)}) = W·[e_u; l_{g(u)}; 1]; ``unit_lang`` maps each unit u
    to its language g(u)."""

    def __init__(self, e_mean, e_logvar, w_mean, w_logvar, lang_mean, lang_logvar,
                 unit_lang: Sequence[int], trunk: Optional[nn.Module] = None, **statics):
        super().__init__(e_mean, e_logvar, w_mean, w_logvar, trunk, **statics)
        self.lang_mean = nn.Parameter(lang_mean)
        self.lang_logvar = nn.Parameter(lang_logvar)
        self.unit_lang = tuple(int(u) for u in unit_lang)
        self.register_buffer("unit_lang_index", torch.tensor(self.unit_lang, dtype=torch.long),
                             persistent=False)

    @property
    def n_langs(self) -> int:
        return self.lang_mean.shape[0]

    @property
    def lang_dim(self) -> int:
        return self.lang_mean.shape[1]

    @classmethod
    def create(cls, n_units: int, embed_dim: int, obs_dim: int, lang_dim: int = 2,
               n_langs: int = 1, unit_lang=None, states_per_unit: int = 1, n_comp: int = 1,
               learn_transitions: bool = False, trunk: Optional[str] = None,
               generator: Optional[torch.Generator] = None, dtype=torch.float32,
               device=None) -> "HierarchicalGSM":
        """``unit_lang`` maps each unit to its language (default: all 0)."""
        device = resolve_device(device)
        base = GSM.create(n_units, embed_dim + lang_dim, obs_dim, states_per_unit, n_comp,
                          learn_transitions, trunk, generator, dtype, device="cpu")
        # base was built with the augmented input width; the per-unit
        # embedding keeps its own
        lang_mean = 0.1 * torch.randn(n_langs, lang_dim, generator=generator, dtype=dtype)
        model = cls(base.e_mean.detach()[:, :embed_dim].clone(),
                    base.e_logvar.detach()[:, :embed_dim].clone(), base.w_mean.detach(),
                    base.w_logvar.detach(), lang_mean,
                    torch.full((n_langs, lang_dim), -2.0, dtype=dtype),
                    (0,) * n_units if unit_lang is None else unit_lang, base.trunk,
                    n_units=n_units, embed_dim=embed_dim, obs_dim=obs_dim,
                    states_per_unit=states_per_unit, n_comp=n_comp,
                    learn_transitions=learn_transitions)
        model.trunk_spec = trunk
        return model.to(device)

    def to_numpy(self) -> Dict[str, Any]:
        return dict(super().to_numpy(), unit_lang=self.unit_lang)

    def _eps_spec(self, nsamples: int):
        spec = super()._eps_spec(nsamples)
        spec["l"] = (nsamples, *self.lang_mean.shape)
        return spec

    def _params_from_eps(self, eps):
        e, w = super()._params_from_eps(eps)
        lang = self.lang_mean[None] + torch.exp(0.5 * self.lang_logvar)[None] * eps["l"]
        # each unit gets its own language's embedding
        return torch.cat([e, lang[:, self.unit_lang_index]], dim=-1), w

    def _mean_inputs(self) -> torch.Tensor:
        return torch.cat([self.e_mean, self.lang_mean[self.unit_lang_index]], dim=-1)

    def kl_div_posterior_prior(self) -> torch.Tensor:
        return super().kl_div_posterior_prior() + _kl_diag(self.lang_mean, self.lang_logvar)


def slice_gsm(gsm: HierarchicalGSM, lang_idx: int, n_units: int) -> GSM:
    """A per-language view of a :class:`HierarchicalGSM` for the write-back:
    a plain GSM over the ``n_units`` units of language ``lang_idx`` (units
    are laid out language by language) whose sampling uses [e_u; l_lang]
    through the shared map, i.e. the induced q(η) of those units.  The
    view holds detached copies."""
    sl = slice(lang_idx * n_units, (lang_idx + 1) * n_units)

    def with_lang(unit, lang):
        return torch.cat([unit.detach()[sl], lang.detach()[lang_idx].expand(n_units, -1)], dim=-1)

    return GSM(with_lang(gsm.e_mean, gsm.lang_mean), with_lang(gsm.e_logvar, gsm.lang_logvar),
               gsm.w_mean.detach().clone(), gsm.w_logvar.detach().clone(), gsm.trunk, n_units,
               gsm.embed_dim + gsm.lang_dim, gsm.obs_dim, gsm.states_per_unit, gsm.n_comp,
               gsm.learn_transitions)


def make_gsm_train_step(optimizer: torch.optim.Optimizer, nsamples: int = 4):
    """A gradient step on the GSM ELBO given accumulated unit statistics.

    Returns ``step(gsm, unit_stats, unit_counts=None, generator=None,
    eps=None) -> elbo`` (detached); ``optimizer`` holds ``gsm``'s
    parameters."""

    def step(gsm: GSM, unit_stats, unit_counts=None, generator=None, eps=None):
        optimizer.zero_grad(set_to_none=True)
        elbo = gsm.elbo(unit_stats, unit_counts, generator, nsamples, eps)
        (-elbo).backward()
        optimizer.step()
        return elbo.detach()

    return step


def train_gsm(gsm: GSM, optimizer: torch.optim.Optimizer, unit_stats, unit_counts=None,
              generator=None, nsteps: int = 1, nsamples: int = 4) -> torch.Tensor:
    """``nsteps`` gradient steps (a plain loop, one launch sequence per
    step); returns the ELBO of every step, (nsteps,), without a host
    synchronisation in between."""
    step = make_gsm_train_step(optimizer, nsamples)
    return torch.stack([step(gsm, unit_stats, unit_counts, generator) for _ in range(nsteps)])


def train_key(seed: int, device=None) -> torch.Generator:
    """The generator of the subspace training loop's noise, seeded
    ``seed`` on ``device`` (default: the CUDA card).  The JAX package's
    choice among PRNG implementations has no counterpart here."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def require_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Raise ``ValueError`` unless every parameter group of ``optimizer``
    was built with ``capturable=True``.  Without it Adam keeps its step
    count on the host, so a captured step would synchronise (and replay
    the bias correction of the step it was captured at)."""
    if not all(group.get("capturable", False) for group in optimizer.param_groups):
        raise ValueError(
            f"make_gsm_train_scan on a CUDA device needs an optimizer built with "
            f"capturable=True, got {type(optimizer).__name__} without it")


def _stats_tensors(unit_stats, unit_counts):
    """The tensors of a ``run`` call's statistics, in a fixed order, and
    the signature (structure, shapes, dtypes) that a captured graph keys on."""
    if isinstance(unit_stats, dict):
        names = sorted(unit_stats)
        tensors = [unit_stats[k] for k in names]
    else:
        names, tensors = None, [unit_stats]
    tensors.append(unit_counts)
    sig = (names, tuple(None if v is None else (tuple(v.shape), v.dtype) for v in tensors))
    return tensors, sig


def _default_generator(device: torch.device) -> torch.Generator:
    return torch.cuda.default_generators[
        device.index if device.index is not None else torch.cuda.current_device()]


class _CapturedStep:
    """One Adam step on the GSM ELBO captured as a CUDA graph.

    The statistics, the step's noise (when the caller passes ``eps``) and
    the step's ELBO live in static buffers that a replay reads and
    writes.  With a ``generator`` the noise is drawn inside the graph from
    it (registered with the graph, so every replay draws new numbers and
    advances it as an eager step would)."""

    WARMUP_STEPS = 2

    def __init__(self, gsm: GSM, optimizer, nsamples: int, unit_stats, unit_counts, generator,
                 with_eps: bool):
        tensors, _ = _stats_tensors(unit_stats, unit_counts)
        self.statics = [None if v is None else v.detach().clone() for v in tensors]
        stats = (dict(zip(sorted(unit_stats), self.statics[:-1]))
                 if isinstance(unit_stats, dict) else self.statics[0])
        counts = self.statics[-1]
        ref = gsm.e_mean
        device = ref.device
        self.eps = ({name: torch.zeros(shape, dtype=ref.dtype, device=device)
                     for name, shape in gsm._eps_spec(nsamples).items()} if with_eps else None)
        params = [p for group in optimizer.param_groups for p in group["params"]]

        # Nothing in the step synchronises or copies from the host: the
        # ELBO, the links, the trunk's layers and the H-SHMM's language
        # gather are device ops on device tensors (the array form without
        # counts raises its ValueError in the warm-up, before the capture),
        # and the matmuls are captured with TF32 off, as the package sets it.
        def step():
            # the gradients are left to the graph's pool: with set_to_none,
            # backward assigns them afresh (no accumulation across replays)
            optimizer.zero_grad(set_to_none=True)
            elbo = gsm.elbo(stats, counts, generator, nsamples, self.eps)
            (-elbo).backward()
            optimizer.step()
            return elbo.detach()

        # The optimizer's state must exist before the capture: Adam makes
        # exp_avg / exp_avg_sq / step at its first step(), and a first step
        # inside the capture would zero them again on every replay.  The
        # warm-up (which also makes cuBLAS's and autograd's lazy state)
        # takes real steps, so the parameters, the optimizer state and the
        # generator are put back as they were before the capture.
        saved_params = [p.detach().clone() for p in params]
        saved_state = {p: {n: v.clone() if torch.is_tensor(v) else v
                           for n, v in optimizer.state[p].items()}
                       for p in params if optimizer.state.get(p)}
        rng = generator if generator is not None else _default_generator(device)
        saved_rng = rng.get_state()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP_STEPS):
                step()
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for p, v in zip(params, saved_params):
                p.copy_(v)
            for p in params:
                state, before = optimizer.state[p], saved_state.get(p)
                for n, v in state.items():
                    if before is not None:
                        if torch.is_tensor(v):
                            v.copy_(before[n])
                        else:
                            state[n] = before[n]
                    elif torch.is_tensor(v):
                        # a state the warm-up created: the Adam family's
                        # lazy initial value is zeros and step 0
                        v.zero_()
        rng.set_state(saved_rng)
        optimizer.zero_grad(set_to_none=True)

        self.graph = torch.cuda.CUDAGraph()
        # the default generator registers itself at the capture; another
        # must be registered, or every replay would draw the same numbers
        if generator is not None and generator is not _default_generator(device):
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph):
            self.elbo = step()

    def load(self, unit_stats, unit_counts) -> None:
        """Copy a call's statistics into the static buffers."""
        tensors, _ = _stats_tensors(unit_stats, unit_counts)
        for static, v in zip(self.statics, tensors):
            if static is not None:
                static.copy_(v)

    def replay(self, eps: Optional[Dict[str, torch.Tensor]]) -> None:
        """One step; with ``eps``, on that step's noise."""
        if eps is not None:
            for name, buf in self.eps.items():
                buf.copy_(eps[name])
        self.graph.replay()


def make_gsm_train_scan(optimizer: torch.optim.Optimizer, nsamples: int = 4):
    """``nsteps`` Adam steps on the GSM ELBO as one device program (the
    counterpart of the JAX package's ``lax.scan`` over the steps).

    Returns ``run(gsm, unit_stats, unit_counts=None, generator=None,
    nsteps=1, eps=None) -> last_elbo``, a detached 0-dim tensor, read
    without a host synchronisation.  ``gsm`` and ``optimizer`` are updated
    in place, as :func:`train_gsm` updates them.  ``eps`` is optional
    per-step noise, a dict of ``(nsteps, *shape)`` tensors, one for each
    block of ``gsm._eps_spec(nsamples)``; without it each step draws its
    noise from ``generator``.

    On a CUDA device one step is captured as a CUDA graph and replayed
    ``nsteps`` times (a captured block of 10 steps ran no faster on an
    H100).  The graph is kept for the next call with the same model,
    parameters, statistics' shapes, generator and noise mode; a new outer
    iteration's statistics are copied into it.  The optimizer must be
    built with ``capturable=True`` there (:func:`require_capturable`).
    A capture that fails raises; nothing falls back to the eager loop on
    the card.  On the CPU the same steps run eagerly
    (:func:`make_gsm_train_step`), the plain version."""
    step = make_gsm_train_step(optimizer, nsamples)
    captured: Dict[str, Any] = {}       # "sig", "generator", "step" of the last capture

    def run(gsm: GSM, unit_stats, unit_counts=None, generator=None, nsteps: int = 1, eps=None):
        if nsteps < 1:
            raise ValueError(f"nsteps must be >= 1, got {nsteps}")
        if eps is not None:
            want = {name: (nsteps, *shape) for name, shape in gsm._eps_spec(nsamples).items()}
            got = {name: tuple(v.shape) for name, v in eps.items()}
            if got != want:
                raise ValueError(f"eps: expected blocks {want}, got {got}")
        if gsm.e_mean.device.type != "cuda":
            for i in range(nsteps):
                elbo = step(gsm, unit_stats, unit_counts, generator,
                            None if eps is None else {k: v[i] for k, v in eps.items()})
            return elbo
        require_capturable(optimizer)
        sig = (id(gsm), tuple(p.data_ptr() for p in gsm.parameters()),
               _stats_tensors(unit_stats, unit_counts)[1], eps is not None)
        if captured.get("sig") != sig or captured.get("generator") is not generator:
            captured.clear()
            captured.update(sig=sig, generator=generator, step=_CapturedStep(
                gsm, optimizer, nsamples, unit_stats, unit_counts, generator, eps is not None))
        graph = captured["step"]
        graph.load(unit_stats, unit_counts)
        for i in range(nsteps):
            graph.replay(None if eps is None else {k: v[i] for k, v in eps.items()})
        return graph.elbo.clone()

    return run


# ----------------------------------------------------------------------
# Phone-loop bridge (the subspace-HMM training loop)
# ----------------------------------------------------------------------
@torch.no_grad()
def accumulate_unit_stats(loop, data: torch.Tensor, mask: Optional[torch.Tensor] = None,
                          transitions: bool = False):
    """Per-unit-state statistics from a phone-loop E-step.

    Default: (stats (U, P, 4D), counts (U, P)), the emission-only layout
    :meth:`GSM.expected_llh_of_stats` consumes directly.  With
    ``transitions=True`` returns the full stats dict adding per-state
    expected self-loop and advance/exit counts (``self`` / ``adv``,
    (U, P) each) for the transition subspace.  When the loop's emissions
    are a per-state GMM (``MixtureSet``) the statistics are per
    component: ``emission`` (U, P, K, 4D) + ``comp_counts`` (U, P, K).

    The E-step is ``loop.smooth``: this bridge needs materialised
    posteriors, which the fused E-step never builds."""
    x = data if data.ndim == 3 else data[None]
    b, t_len, d = x.shape
    if mask is None:
        mask = x.new_ones(b, t_len)
    _, cache = loop.smooth(loop.sufficient_statistics(x), mask=mask)
    post = cache["posteriors"]                                  # (B, T, S)
    u, p = loop.n_units, loop.states_per_unit
    s_states = u * p
    diag_stats = normallik.suff_stats_diag(x).reshape(-1, 4 * d)

    is_mixture = isinstance(loop.modelset, MixtureSet)
    if is_mixture:
        inner = loop.modelset
        k = inner.ncomp_per_mix
        within = torch.softmax(inner._joint(inner.sufficient_statistics(x)), dim=-1)
        flat_cr = (within * post[..., None]).reshape(-1, s_states * k)   # (B·T, S·K)
        emission = (flat_cr.T @ diag_stats).reshape(u, p, k, 4 * d)
        counts = flat_cr.sum(0).reshape(u, p, k)
    else:
        flat_post = post.reshape(-1, s_states)
        emission = (flat_post.T @ diag_stats).reshape(u, p, 1, 4 * d)
        counts = flat_post.sum(0).reshape(u, p, 1)

    if not transitions:
        if is_mixture:
            return ({"emission": emission, "comp_counts": counts, "self": None, "adv": None},
                    counts.sum(-1))
        return emission[..., 0, :], counts[..., 0]

    xi = semiring_scan.expected_transition_counts_probs(cache["fb"], cache["graph"].log_trans,
                                                        mask)       # (S, S)
    # advance: within-unit forward arcs for non-final states; for final
    # states, exits = loop-backs to any unit start + end-of-sequence mass
    adv = torch.cat([torch.diagonal(xi, 1), xi.new_zeros(1)])
    starts, ends = loop._starts(), loop._ends()
    lens = mask.sum(-1)
    last_idx = (lens.long() - 1).clamp_min(0)
    gamma_last = post[torch.arange(b, device=post.device), last_idx]     # (B, S)
    final_mass = (gamma_last * (lens > 0)[:, None]).sum(0)
    adv[ends] = xi[ends][:, starts].sum(-1) + final_mass[ends]
    return ({"emission": emission, "comp_counts": counts,
             "self": torch.diagonal(xi).reshape(u, p), "adv": adv.reshape(u, p)},
            counts.sum(-1))


# ----------------------------------------------------------------------
# Moment-matched posterior write-back
# ----------------------------------------------------------------------
def _inv_digamma(y: torch.Tensor, iters: int = 15) -> torch.Tensor:
    """ψ⁻¹(y) by Newton (Minka's initialisation)."""
    psi1 = torch.digamma(torch.ones((), dtype=y.dtype, device=y.device))
    x = torch.where(y >= -2.22, torch.exp(y) + 0.5, -1.0 / (y - psi1))
    for _ in range(iters):
        x = (x - (torch.digamma(x) - y) / torch.polygamma(1, x)).clamp_min(1e-6)
    return x


def _gamma_from_moments(e_lam, e_loglam, iters: int = 20, max_shape: float = 1e5):
    """(a, b) of a Gamma matching E[λ] and E[log λ] (Newton on
    ψ(a) − log a = E[log λ] − log E[λ]).

    ``max_shape`` bounds the matched pseudo-count: a nearly deterministic
    subspace posterior drives a → ∞, and natural parameters of that
    magnitude turn the float32 KL into cancellation noise without
    changing the induced E[T] measurably."""
    c = torch.clamp(e_loglam - torch.log(e_lam), max=-0.5 / max_shape)
    a = -0.5 / c                                    # ψ(a) − ln a ≈ −1/(2a)
    for _ in range(iters):
        f = torch.digamma(a) - torch.log(a) - c
        fp = torch.polygamma(1, a) - 1.0 / a
        a = torch.minimum(torch.maximum(a - f / fp, a * 0.1), a * 10.0)
        a = a.clamp(1e-3, max_shape)
    return a, a / e_lam


def _dirichlet_from_elogw(elogw: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Dirichlet α matching E[log w] per row (last axis): Newton on g_k =
    ψ(α_k) − ψ(α₀) − y_k, the Jacobian diag(ψ'(α_k)) − ψ'(α₀)·11ᵀ inverted
    by Sherman–Morrison."""
    alpha = _inv_digamma(elogw)  # warm start: ignore the shared ψ(α₀)
    for _ in range(iters):
        a0 = alpha.sum(-1, keepdim=True)
        g = torch.digamma(alpha) - torch.digamma(a0) - elogw
        q = torch.polygamma(1, alpha)
        c = torch.polygamma(1, a0)
        gq = (g / q).sum(-1, keepdim=True)
        iq = (1.0 / q).sum(-1, keepdim=True)
        delta = g / q + (c * gq / (1.0 - c * iq)) / q
        alpha = torch.maximum(alpha - delta, alpha * 0.1)
    return alpha


@torch.no_grad()
def induced_posterior_moments(gsm: GSM, generator: Optional[torch.Generator] = None,
                              nsamples: int = 64, eps=None) -> Dict[str, torch.Tensor]:
    """MC moments of q(η(e_u)): E[λ], E[λμ], E[λμ²], E[log λ] (each
    (U, P, K, D)) + E[log w] (U, P, K) and E[log σ], E[log(1−σ)] (U, P)
    when those heads exist."""
    if eps is None:
        eps = gsm.sample_eps(generator, nsamples)
    p = gsm.unit_params(*gsm._params_from_eps(eps))
    mu, lam = p["mu"], p["lam"]
    out = {"e_lam": lam.mean(0), "e_lam_mu": (lam * mu).mean(0),
           "e_lam_mu2": (lam * mu**2).mean(0), "e_log_lam": torch.log(lam).mean(0)}
    if p["log_w"] is not None:
        out["e_log_w"] = p["log_w"].mean(0)
    if p["trans_logit"] is not None:
        out["e_log_self"] = _log_sigmoid(p["trans_logit"]).mean(0)
        out["e_log_adv"] = _log_sigmoid(-p["trans_logit"]).mean(0)
    return out


@torch.no_grad()
def apply_to_phoneloop(gsm: GSM, loop, generator: Optional[torch.Generator] = None,
                       nsamples: int = 64, confidence: Optional[float] = None, eps=None):
    """Write the subspace posterior back into a phone loop, in place
    (returns ``loop``).

    Moment matching: the Monte-Carlo moments of q(η(e_u)) determine a
    NormalGamma posterior with identical expected sufficient statistics;
    the phone-loop E-step depends on the emissions only through E[T(θ)],
    so the written-back loop runs the subspace-marginalized E-step (to MC
    accuracy).  Mixture weights are Dirichlet-matched from E[log w];
    learned transitions land in ``base_log_trans`` / ``log_exit`` as
    expected log-probabilities.

    ``confidence`` (legacy): if given, skip moment matching and write
    sharp posteriors at the posterior-mean point estimate."""
    d = gsm.obs_dim
    if confidence is not None:
        mu, lam = gsm.emission_expectations()
        m, lam = mu.reshape(-1, d), lam.reshape(-1, d)
        a = torch.full_like(lam, confidence)
        b, kappa = a / lam, a.clone()
    else:
        mom = induced_posterior_moments(gsm, generator, nsamples, eps)
        m1, m2, m3, m4 = (mom[k].reshape(-1, d)
                          for k in ("e_lam", "e_lam_mu", "e_lam_mu2", "e_log_lam"))
        a, b = _gamma_from_moments(m1, m4)
        m = m2 / m1
        # 1/κ; the 1e-5 floor caps κ at 1e5 (see _gamma_from_moments)
        kappa = 1.0 / (m3 - m2**2 / m1).clamp_min(1e-5)

    modelset = loop.modelset
    is_mixture = isinstance(modelset, MixtureSet)
    nset = modelset.modelset if is_mixture else modelset
    mp = nset.means_precisions
    mp.posterior.copy_(mp.family.to_nat(m, kappa, a, b))
    if is_mixture and gsm.n_comp > 1 and confidence is None:
        alpha = _dirichlet_from_elogw(mom["e_log_w"].reshape(modelset.nmix, gsm.n_comp))
        modelset.weights.posterior.copy_(modelset.weights.family.to_nat(alpha))

    if gsm.learn_transitions and confidence is None:
        u, p = gsm.n_units, gsm.states_per_unit
        e_self, e_adv = mom["e_log_self"].reshape(u * p), mom["e_log_adv"].reshape(u * p)
        base = loop.base_log_trans
        st = torch.arange(u * p, device=base.device)
        base[st, st] = e_self.to(base.dtype)
        nonfinal = st[(st % p) != p - 1]
        base[nonfinal, nonfinal + 1] = e_adv[nonfinal].to(base.dtype)
        loop.log_exit = (e_adv[loop._ends()] - math.log(2.0)).to(base.dtype)   # split loop/final
    return loop
