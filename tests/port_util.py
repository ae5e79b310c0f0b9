"""Helpers for the tests that hold beer_tpu_torch against beer_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU (x64 enabled by conftest), the port on the CPU
through the plain PyTorch versions of its kernels.  The JAX-side weight
extractor lives here, not in the port, because it needs jax.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)  # the suite runs several xdist workers

# small port shapes: U units × SPU states, D dims, B utterances, T frames
U, SPU, D, B, T = 4, 3, 3, 4, 20


def lengths_and_mask(t_len: int = T):
    """One full row, two ragged rows, one zero-length row."""
    lengths = np.array([t_len, t_len - 7, 5, 0])
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)
    return lengths, mask


def scan_problem(seed: int, n_units: int, spu: int, p_dim: int, b: int, t_len: int,
                 lengths=None) -> dict:
    """Seeded numpy inputs of one phone-loop E-step and decode: reduced
    stats, ELLH matrix and bias, bands (4, S), init/final vectors, unit
    ends/starts, lengths and the prefix mask (default lengths: one full,
    two ragged, one zero-length row, then random)."""
    rng = np.random.default_rng(seed)
    s = n_units * spu
    ids = np.arange(s)
    ends, starts = ids[ids % spu == spu - 1], ids[ids % spu == 0]
    a_self = np.full(s, 0.6)
    a_adv = np.where(ids % spu != spu - 1, 0.4, 0.0)
    exit_v = np.where(ids % spu == spu - 1, 0.2, 0.0)
    w_v = np.zeros(s)
    w_v[starts] = rng.dirichlet(np.ones(n_units))
    if lengths is None:
        fixed = [t_len, t_len - 7, 5, 0][:b]
        lengths = np.concatenate([fixed, rng.integers(1, t_len + 1, size=b - len(fixed))])
    lengths = np.asarray(lengths)
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)
    return dict(stats=rng.normal(size=(b, t_len, p_dim)), w=rng.normal(size=(s, p_dim)) * 0.7,
                bias=rng.normal(size=s) - 3.0, bands=np.stack([a_self, a_adv, exit_v, w_v]),
                init=w_v.copy(), final=exit_v.copy(), lengths=lengths, mask=mask,
                ends=ends, starts=starts)


def underflow_problem() -> dict:
    """The general path's banded operands of an untrained phone loop over
    long utterances (ROADMAP §C.1): :func:`scan_problem` with emissions 18
    times as peaked (W scaled), T = 200, lengths 200, 150, 0, 90.  The
    scaled forward's α̂ and the backward's u1 then put their mass on
    different states, and α̂·u1 underflows on some frames in float32, where
    γ sums to 0.  Returns the numpy problem with ``e_llh`` = exp(llh −
    rowmax) (1 on frames t >= len) and per-row ``init`` / ``final``."""
    pb = scan_problem(1, U, SPU, 6, 4, 200, lengths=[200, 150, 0, 90])
    s = U * SPU
    llh = pb["stats"] @ (18.0 * pb["w"]).T + pb["bias"]
    m = pb["mask"][..., None]
    pb["e_llh"] = np.exp(llh - llh.max(-1, keepdims=True)) * m + (1 - m)
    pb["init"] = np.broadcast_to(pb["init"], (4, s)).copy()
    pb["final"] = np.broadcast_to(pb["final"], (4, s)).copy()
    return pb


def dense_problem(seed: int, s: int, p_dim: int, b: int, t_len: int, lengths=None) -> dict:
    """Seeded numpy inputs of one dense-transition HMM E-step: reduced
    stats, ELLH matrix and bias, a sub-stochastic (S, S) matrix with
    forbidden arcs, per-row init and per-row final vectors whose last
    states are padding (final 0, as in shared transcription graphs),
    lengths and the prefix mask (default lengths as in
    :func:`scan_problem`)."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.ones(s), size=s) * 0.9
    trans[rng.random((s, s)) < 0.3] = 0.0
    init = rng.dirichlet(np.ones(s), size=b)
    final = rng.uniform(0.05, 0.5, size=(b, s))
    pad = rng.integers(0, max(s // 3, 1) + 1, size=b)
    final[np.arange(s)[None, :] >= s - pad[:, None]] = 0.0
    if lengths is None:
        fixed = [t_len, t_len - 7, 5, 0][:b]
        lengths = np.concatenate([fixed, rng.integers(1, t_len + 1, size=b - len(fixed))])
    lengths = np.asarray(lengths)
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)
    return dict(stats=rng.normal(size=(b, t_len, p_dim)), w=rng.normal(size=(s, p_dim)) * 0.7,
                bias=rng.normal(size=s) - 3.0, trans=trans, init=init, final=final,
                lengths=lengths, mask=mask)


def full_problem(seed: int, d: int, k: int, t_len: int) -> dict:
    """Seeded numpy inputs of the full-covariance kernels: frames at
    production magnitude (N(0, 9)), responsibilities, E[T] (K, D²+D+2)
    of K random NormalWisharts (the port's family in float64), E[log w]
    and a mask with a stretch and a scatter of frames off."""
    from beer_tpu_torch.dists import NormalWishart

    rng = np.random.default_rng(seed)
    q = rng.normal(size=(k, d, d))
    w = (q @ q.transpose(0, 2, 1) + d * np.eye(d)) / (20.0 * d)
    fam = NormalWishart(dim=d)
    nat = fam.to_nat(t(rng.normal(size=(k, d))), 2.0, t(w), d + 2.0)
    mask = (rng.uniform(size=t_len) > 0.1).astype(np.float64)
    mask[t_len // 4: t_len // 2] = 0.0
    return dict(x=3.0 * rng.normal(size=(t_len, d)), r=rng.dirichlet(np.ones(k), size=t_len),
                e=fam.expected_sufficient_statistics(nat).numpy(),
                log_w=np.log(rng.dirichlet(np.ones(k))), mask=mask)


def dense_args(pb: dict, dtype, device=None) -> dict:
    """:func:`dense_problem`'s arrays as the port's kernel operands, with
    ``llh`` = stats @ wᵀ + bias."""
    f = lambda k: t(pb[k], dtype).to(device)  # noqa: E731
    out = dict(stats=f("stats"), lens=t(pb["lengths"], torch.int32).to(device), w=f("w"),
               bias=f("bias"), trans=f("trans"), init=f("init"), final=f("final"))
    out["llh"] = (out["stats"] @ out["w"].T + out["bias"]).contiguous()
    return out


def port_args(pb: dict, dtype, device=None) -> dict:
    """:func:`scan_problem`'s arrays as the port's kernel operands."""
    f = lambda k: t(pb[k], dtype).to(device)  # noqa: E731
    i32 = lambda k: t(pb[k], torch.int32).to(device)  # noqa: E731
    return dict(stats=f("stats"), lens=i32("lengths"), w=f("w"), bias=f("bias"),
                bands=f("bands"), init=f("init"), final=f("final"), ends=i32("ends"),
                starts=i32("starts"))


def phone_loop_to_numpy(loop) -> dict:
    """A ``beer_tpu`` PhoneLoop's weights and statics in the dict layout of
    :func:`beer_tpu_torch.convert.phone_loop_from_numpy`."""
    ms = loop.modelset
    if hasattr(ms, "nmix"):   # per-state GMM emissions
        emissions = {"modelset": modelset_to_numpy(ms)}
        ms = ms.modelset
    else:
        emissions = {"modelset_prior": np.asarray(ms.means_precisions.prior),
                     "modelset_posterior": np.asarray(ms.means_precisions.posterior)}
    conc = getattr(loop.unit_prior, "concentration", None)   # SBCategoricalHyperPrior
    return {
        **emissions,
        "sticks_prior": np.asarray(loop.unit_prior.sticks.prior),
        "sticks_posterior": np.asarray(loop.unit_prior.sticks.posterior),
        "concentration_prior": None if conc is None else np.asarray(conc.prior),
        "concentration_posterior": None if conc is None else np.asarray(conc.posterior),
        "base_log_trans": np.asarray(loop.base_log_trans),
        "log_exit": None if loop.log_exit is None else np.asarray(loop.log_exit),
        "n_units": loop.n_units,
        "states_per_unit": loop.states_per_unit,
        "self_loop": loop.self_loop,
        "dim": ms.dim,
        "cov_type": ms.cov_type,
    }


def normal_set_to_numpy(ns) -> dict:
    """A ``beer_tpu`` NormalSet in the dict layout of
    :func:`beer_tpu_torch.convert.normal_set_from_numpy`."""
    return {"type": "NormalSet", "prior": np.asarray(ns.means_precisions.prior),
            "posterior": np.asarray(ns.means_precisions.posterior), "dim": ns.dim,
            "cov_type": ns.cov_type}


def mixture_to_numpy(mix) -> dict:
    """A ``beer_tpu`` Mixture (Dirichlet weights over a NormalSet) in the
    dict layout of :func:`beer_tpu_torch.convert.mixture_from_numpy`.  Its
    ``fused`` flag (a NormalSet static field) changes no weight."""
    w = mix.categorical.weights
    return {"type": "Mixture", "prior": np.asarray(w.prior), "posterior": np.asarray(w.posterior),
            "modelset": normal_set_to_numpy(mix.modelset)}


def mixture_to_port(jax_mixture, dtype):
    from beer_tpu_torch.convert import mixture_from_numpy

    return mixture_from_numpy(mixture_to_numpy(jax_mixture), device="cpu", dtype=dtype)


def modelset_to_numpy(ms) -> dict:
    """A ``beer_tpu`` NormalSet or MixtureSet as a numpy dict."""
    if hasattr(ms, "nmix"):
        return {"type": "MixtureSet", "weights_prior": np.asarray(ms.weights.prior),
                "weights_posterior": np.asarray(ms.weights.posterior), "nmix": ms.nmix,
                "ncomp_per_mix": ms.ncomp_per_mix, "modelset": normal_set_to_numpy(ms.modelset)}
    return normal_set_to_numpy(ms)


def hmm_to_numpy(hmm) -> dict:
    """A ``beer_tpu`` HMM's graph, emissions and transition Dirichlet in
    the dict layout of :func:`beer_tpu_torch.convert.hmm_from_numpy`."""
    g = hmm.graph
    opt = lambda x: None if x is None else np.asarray(x)  # noqa: E731
    return {"log_init": np.asarray(g.log_init), "log_final": np.asarray(g.log_final),
            "log_trans": np.asarray(g.log_trans), "pdf_ids": np.asarray(g.pdf_ids),
            "n_states": g.n_states, "n_pdfs": g.n_pdfs,
            "l2r_banded": bool(getattr(g, "l2r_banded", False)),
            "modelset": modelset_to_numpy(hmm.modelset),
            "trans_alpha_prior": opt(hmm.trans_alpha_prior),
            "trans_alpha_post": opt(hmm.trans_alpha_post)}


def hmm_to_port(jax_hmm, dtype):
    from beer_tpu_torch.convert import hmm_from_numpy

    return hmm_from_numpy(hmm_to_numpy(jax_hmm), device="cpu", dtype=dtype)


def gsm_to_numpy(gsm) -> dict:
    """A ``beer_tpu`` GSM or HierarchicalGSM in the dict layout of
    :func:`beer_tpu_torch.convert.gsm_from_numpy`; the trunk's config
    string is rebuilt from its flax module."""
    out = {k: np.asarray(getattr(gsm, k)) for k in ("e_mean", "e_logvar", "w_mean", "w_logvar")}
    out.update(type=type(gsm).__name__, n_units=gsm.n_units, embed_dim=gsm.embed_dim,
               obs_dim=gsm.obs_dim, states_per_unit=gsm.states_per_unit, n_comp=gsm.n_comp,
               learn_transitions=gsm.learn_transitions, trunk_spec=None)
    if gsm.trunk_def is not None:
        trunk = gsm.trunk_def
        out["trunk_spec"] = "%s:%s:%s" % (type(trunk).__name__.lower(),
                                          ",".join(str(h) for h in trunk.hidden),
                                          trunk.activation.__name__)
        out["trunk_params"] = gsm.trunk_params
    if hasattr(gsm, "lang_mean"):
        out.update(lang_mean=np.asarray(gsm.lang_mean), lang_logvar=np.asarray(gsm.lang_logvar),
                   unit_lang=gsm.unit_lang)
    return out


def gsm_to_port(jax_gsm, dtype=None):
    from beer_tpu_torch.convert import gsm_from_numpy

    return gsm_from_numpy(gsm_to_numpy(jax_gsm), device="cpu", dtype=dtype)


def jax_phone_loop(dtype, n_units=U, spu=SPU, dim=D, self_loop=0.5, seed=1):
    """A config-4-style JAX PhoneLoop (diagonal NormalSet, stick-breaking prior)."""
    import jax
    import jax.numpy as jnp

    import beer_tpu
    from beer_tpu.models.phoneloop import PhoneLoop

    nset = beer_tpu.NormalSet.create(
        jnp.zeros(dim, dtype), jnp.ones(dim, dtype), size=n_units * spu,
        cov_type="diagonal", noise_std=0.5, key=jax.random.PRNGKey(seed),
    )
    return PhoneLoop.create(n_units, spu, nset, self_loop=self_loop, dtype=dtype)


def to_port(jax_loop, dtype):
    from beer_tpu_torch.convert import phone_loop_from_numpy

    return phone_loop_from_numpy(phone_loop_to_numpy(jax_loop), device="cpu", dtype=dtype)


def t(x, dtype=None) -> torch.Tensor:
    out = torch.as_tensor(np.array(x))
    return out if dtype is None else out.to(dtype)


def close(actual, expected, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), rtol=rtol, atol=atol)


def ppca_to_numpy(model) -> dict:
    """A ``beer_tpu`` PPCA in the dict layout of
    :func:`beer_tpu_torch.convert.ppca_from_numpy`."""
    return {"type": "PPCA", "w_mean": np.asarray(model.w_mean), "w_cov": np.asarray(model.w_cov),
            "mean": np.asarray(model.mean), "prec_prior": np.asarray(model.prec.prior),
            "prec_posterior": np.asarray(model.prec.posterior)}


def plda_to_numpy(model) -> dict:
    """A ``beer_tpu`` PLDA in the dict layout of
    :func:`beer_tpu_torch.convert.plda_from_numpy`."""
    return {"type": "PLDA", "f_mean": np.asarray(model.f_mean), "f_cov": np.asarray(model.f_cov),
            "mean": np.asarray(model.mean), "prec_prior": np.asarray(model.prec.prior),
            "prec_posterior": np.asarray(model.prec.posterior)}


def subspace_to_port(jax_model, dtype=None):
    """A ``beer_tpu`` PPCA or PLDA carried across to the port, on the CPU."""
    from beer_tpu_torch.convert import plda_from_numpy, ppca_from_numpy

    if hasattr(jax_model, "w_mean"):
        return ppca_from_numpy(ppca_to_numpy(jax_model), device="cpu", dtype=dtype)
    return plda_from_numpy(plda_to_numpy(jax_model), device="cpu", dtype=dtype)
