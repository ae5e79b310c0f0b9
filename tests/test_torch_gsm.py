"""The port's subspace-HMM (GSM / HierarchicalGSM) against beer_tpu.

Weights are carried across with ``gsm_from_numpy`` (``port_util.gsm_to_port``)
and both sides get the **same noise**: ε is drawn on the JAX side with
``gsm._sample_eps(key, n)`` — exactly what ``elbo(..., key=key)`` and
``apply_to_phoneloop(..., key=key)`` draw — and handed to the port as
``eps``.  Float64, rtol 1e-9, unless stated: the two packages run the same
arithmetic in another order.  The miniature outer iteration runs in
float32 and holds the phone loop's ELBO within 1e-4 per frame.

Shapes: 4 units × 3 states, D = 4, embedding 3, two languages (language
dim 2), 4 Monte-Carlo samples; the variants add K = 2 components with
mixture weights, learned transitions, and an MLP trunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import beer_tpu
import beer_tpu_torch as bt
from beer_tpu.cli.subcommands.shmm_train import _slice_gsm
from beer_tpu.models import gsm as jgsm
from beer_tpu.models.mixture import MixtureSet as JaxMixtureSet
from beer_tpu.models.phoneloop import PhoneLoop as JaxPhoneLoop
from beer_tpu.vbi import vb_step as jax_vb_step
from beer_tpu_torch.models import gsm as tgsm
from port_util import close, gsm_to_port, t, to_port

U, P, D, E, L, LANG_D, NS = 4, 3, 4, 3, 2, 2, 4
RTOL = 1e-9
VARIANTS = ["plain", "k2_transitions", "trunk", "hierarchical", "hierarchical_transitions"]


def _jax_gsm(variant: str, dtype=jnp.float64):
    key = jax.random.PRNGKey(3)
    kw = dict(states_per_unit=P, key=key, dtype=dtype)
    if variant == "k2_transitions":
        kw.update(n_comp=2, learn_transitions=True)
    if variant == "trunk":
        kw.update(trunk="mlp:5,6:tanh", learn_transitions=True)
    if variant.startswith("hierarchical"):
        kw["learn_transitions"] = variant.endswith("transitions")
        g = jgsm.HierarchicalGSM.create(U, E, D, lang_dim=LANG_D, n_langs=L,
                                        unit_lang=[0, 0, 1, 1], **kw)
    else:
        g = jgsm.GSM.create(U, E, D, **kw)
    if g.trunk_params is not None:   # flax initialises in float32
        g = g.replace(trunk_params=jax.tree_util.tree_map(lambda x: x.astype(dtype),
                                                          g.trunk_params))
    return g


def _unit_stats(k: int, transitions: bool, seed: int = 5):
    """Synthetic per-unit statistics in the dict layout of
    ``accumulate_unit_stats`` (numpy, float64)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(20.0, 80.0, size=(U, P, k))
    mu = rng.normal(size=(U, P, k, D))
    var = rng.uniform(0.5, 2.0, size=(U, P, k, D))
    cc = c[..., None]
    emission = np.concatenate([-0.5 * cc * (var + mu**2), cc * mu,
                               np.broadcast_to(-0.5 * cc, mu.shape),
                               np.broadcast_to(0.5 * cc, mu.shape)], axis=-1)
    tot = c.sum(-1)
    return {"emission": emission, "comp_counts": c,
            "self": 0.8 * tot if transitions else None, "adv": 0.2 * tot if transitions else None}


def _both(stats: dict):
    to = lambda f: {k: None if v is None else f(v) for k, v in stats.items()}  # noqa: E731
    return to(jnp.asarray), to(t)


def _eps(jg, key, n=NS):
    eps = jg._sample_eps(key, n)
    return eps, {k: t(np.asarray(v)) for k, v in eps.items()}


def _stats_for(variant):
    return _unit_stats(2 if variant == "k2_transitions" else 1, variant != "plain")


# ----------------------------------------------------------------------
# The model: parameters, ELBO, gradients, Adam
# ----------------------------------------------------------------------
@pytest.mark.parametrize("variant", VARIANTS)
def test_unit_params_and_emission_expectations_vs_jax(variant):
    jg = _jax_gsm(variant)
    pg = gsm_to_port(jg)
    eps_j, eps_p = _eps(jg, jax.random.PRNGKey(1))
    assert {k: tuple(v) for k, v in pg._eps_spec(NS).items()} == \
        {k: tuple(v) for k, v in jg._eps_spec(NS).items()}
    want = jg.unit_params(*jg._params_from_eps(eps_j))
    got = pg.unit_params(*pg._params_from_eps(eps_p))
    for name in ("mu", "lam", "log_w", "trans_logit"):
        assert (want[name] is None) == (got[name] is None), name
        if want[name] is not None:
            close(got[name].detach(), want[name], RTOL, 1e-300)
    for a, b in zip(pg.emission_expectations(), jg.emission_expectations()):
        close(a.detach(), b, RTOL, 1e-300)
    assert pg.out_dim == jg.out_dim


@pytest.mark.parametrize("variant", VARIANTS)
def test_expected_llh_kl_and_elbo_vs_jax(variant):
    jg = _jax_gsm(variant)
    pg = gsm_to_port(jg)
    eps_j, eps_p = _eps(jg, jax.random.PRNGKey(2))
    sj, sp = _both(_stats_for(variant))
    close(pg.kl_div_posterior_prior().detach(), jg.kl_div_posterior_prior(), RTOL)
    close(pg.expected_llh_of_stats(sp, eps=eps_p).detach(),
          jg.expected_llh_of_stats(sj, eps=eps_j), RTOL)
    close(pg.elbo(sp, eps=eps_p).detach(), jg.elbo(sj, eps=eps_j), RTOL)
    if variant == "plain":   # the array form: (U, P, 4D) stats with (U, P) or (U,) counts
        arr_j, cnt_j = sj["emission"][..., 0, :], sj["comp_counts"][..., 0]
        arr_p, cnt_p = sp["emission"][..., 0, :], sp["comp_counts"][..., 0]
        close(pg.elbo(arr_p, cnt_p, eps=eps_p).detach(), jg.elbo(arr_j, cnt_j, eps=eps_j), RTOL)
        close(pg.elbo(arr_p, cnt_p, eps=eps_p).detach(), pg.elbo(sp, eps=eps_p).detach(), 1e-12)
        with pytest.raises(ValueError, match="unit_counts"):
            pg.elbo(arr_p, eps=eps_p)


@pytest.mark.parametrize("variant", VARIANTS)
def test_elbo_gradients_vs_jax_grad(variant):
    jg = _jax_gsm(variant)
    pg = gsm_to_port(jg)
    eps_j, eps_p = _eps(jg, jax.random.PRNGKey(4))
    sj, sp = _both(_stats_for(variant))
    grads = jax.grad(lambda g: g.elbo(sj, eps=eps_j))(jg)
    pg.elbo(sp, eps=eps_p).backward()
    names = ["e_mean", "e_logvar", "w_mean", "w_logvar"]
    if variant.startswith("hierarchical"):
        names += ["lang_mean", "lang_logvar"]
    for name in names:
        close(getattr(pg, name).grad, getattr(grads, name), 1e-8, 1e-12)
    if variant == "trunk":
        tree = bt.nnet.flax_tree(pg.trunk, grads=True)
        for layer, leaves in grads.trunk_params["params"].items():
            for leaf, want in leaves.items():
                close(tree[layer][leaf], want, 1e-8, 1e-12)


@pytest.mark.parametrize("variant", ["k2_transitions", "hierarchical_transitions"])
def test_five_adam_steps_vs_optax(variant):
    jg = _jax_gsm(variant)
    pg = gsm_to_port(jg)
    sj, sp = _both(_stats_for(variant))
    tx = optax.adam(5e-2)
    opt_state = tx.init(jg)
    jstep = jgsm.make_gsm_train_step(tx, nsamples=NS)
    pstep = tgsm.make_gsm_train_step(torch.optim.Adam(pg.parameters(), lr=5e-2), nsamples=NS)
    for key in jax.random.split(jax.random.PRNGKey(6), 5):
        _, eps_p = _eps(jg, key)
        want, jg, opt_state = jstep(jg, opt_state, sj, None, key)
        got = pstep(pg, sp, eps=eps_p)
        close(got, want, 1e-8)
    for name in ("e_mean", "e_logvar", "w_mean", "w_logvar"):
        close(getattr(pg, name).detach(), getattr(jg, name), 1e-7, 1e-10)


def test_train_gsm_raises_the_elbo_and_samples_from_a_generator():
    pg = tgsm.GSM.create(U, E, D, states_per_unit=P, learn_transitions=True,
                         generator=torch.Generator().manual_seed(0), dtype=torch.float64,
                         device="cpu")
    _, sp = _both(_unit_stats(1, True))
    gen = torch.Generator().manual_seed(1)
    elbos = tgsm.train_gsm(pg, torch.optim.Adam(pg.parameters(), lr=5e-2), sp, generator=gen,
                           nsteps=60, nsamples=NS)
    assert elbos.shape == (60,) and bool(torch.isfinite(elbos).all())
    assert float(elbos[-10:].mean()) > float(elbos[:10].mean())
    eps = pg.sample_eps(torch.Generator().manual_seed(2), 3)
    assert {k: tuple(v.shape) for k, v in eps.items()} == pg._eps_spec(3)


def _eps_stack(jg, key, nsteps):
    """The noise of each step of the JAX scan (``jax.random.split(key,
    nsteps)``, one ``_sample_eps`` a step), stacked for the port's ``eps``."""
    per_step = [jg._sample_eps(k, NS) for k in jax.random.split(key, nsteps)]
    return {name: t(np.stack([np.asarray(e[name]) for e in per_step])) for name in per_step[0]}


@pytest.mark.parametrize("variant", ["plain", "trunk", "hierarchical"])
def test_train_scan_vs_jax_scan(variant):
    """``make_gsm_train_scan``'s run on the noise the JAX scan draws equals
    the JAX package's scan: the last ELBO and every parameter."""
    jg = _jax_gsm(variant)
    pg = gsm_to_port(jg)
    sj, sp = _both(_stats_for(variant))
    nsteps, key = 6, jax.random.PRNGKey(12)
    eps = _eps_stack(jg, key, nsteps)
    tx = optax.adam(5e-2)
    want, jg, _ = jgsm.make_gsm_train_scan(tx, nsamples=NS)(jg, tx.init(jg), sj, None, key,
                                                           nsteps)
    run = tgsm.make_gsm_train_scan(torch.optim.Adam(pg.parameters(), lr=5e-2), nsamples=NS)
    got = run(pg, sp, nsteps=nsteps, eps=eps)
    assert got.shape == () and not got.requires_grad
    close(got, want, 1e-8)
    names = ["e_mean", "e_logvar", "w_mean", "w_logvar"]
    if variant == "hierarchical":
        names += ["lang_mean", "lang_logvar"]
    for name in names:
        close(getattr(pg, name).detach(), getattr(jg, name), 1e-7, 1e-10)
    if variant == "trunk":
        tree = bt.nnet.flax_tree(pg.trunk)
        for layer, leaves in jg.trunk_params["params"].items():
            for leaf, value in leaves.items():
                close(tree[layer][leaf], value, 1e-7, 1e-10)


@pytest.mark.parametrize("nsteps", [1, 5])
def test_train_scan_equals_train_steps(nsteps):
    """On the CPU the scan is the eager loop: ``nsteps`` calls of
    ``make_gsm_train_step`` on the same noise give the same numbers."""
    jg = _jax_gsm("k2_transitions")
    a, b = gsm_to_port(jg), gsm_to_port(jg)
    _, sp = _both(_stats_for("k2_transitions"))
    eps = _eps_stack(jg, jax.random.PRNGKey(13), nsteps)
    opt_a, opt_b = (torch.optim.Adam(m.parameters(), lr=5e-2) for m in (a, b))
    got = tgsm.make_gsm_train_scan(opt_a, nsamples=NS)(a, sp, nsteps=nsteps, eps=eps)
    step = tgsm.make_gsm_train_step(opt_b, nsamples=NS)
    for i in range(nsteps):
        want = step(b, sp, eps={k: v[i] for k, v in eps.items()})
    assert torch.equal(got, want)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(opt_a.state[p]["exp_avg_sq"], opt_b.state[q]["exp_avg_sq"])


def test_train_scan_raises_the_elbo_and_samples_from_a_generator():
    """Without ``eps`` each step draws its noise from the generator, as
    ``train_gsm`` does: the same generator state gives the same run, and
    the ELBO rises."""
    def fresh():
        g = tgsm.GSM.create(U, E, D, states_per_unit=P, learn_transitions=True,
                            generator=torch.Generator().manual_seed(0), dtype=torch.float64,
                            device="cpu")
        return g, torch.optim.Adam(g.parameters(), lr=5e-2)

    _, sp = _both(_unit_stats(1, True))
    pg, opt = fresh()
    run = tgsm.make_gsm_train_scan(opt, nsamples=NS)
    gen = tgsm.train_key(1, "cpu")
    elbos = [run(pg, sp, generator=gen, nsteps=10) for _ in range(6)]
    twin, twin_opt = fresh()
    want = tgsm.train_gsm(twin, twin_opt, sp, generator=torch.Generator().manual_seed(1),
                          nsteps=60, nsamples=NS)
    assert torch.equal(torch.stack(elbos), want[9::10])
    assert all(torch.equal(p, q) for p, q in zip(pg.parameters(), twin.parameters()))
    assert bool(torch.isfinite(want).all()) and float(elbos[-1]) > float(elbos[0])


def test_train_scan_on_a_card_refuses_an_optimizer_that_cannot_be_captured():
    """``require_capturable``, which the card path runs before a capture:
    an Adam without ``capturable=True`` keeps its step count on the host."""
    g = tgsm.GSM.create(U, E, D, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="capturable=True"):
        tgsm.require_capturable(torch.optim.Adam(g.parameters(), lr=5e-2))
    tgsm.require_capturable(torch.optim.Adam(g.parameters(), lr=5e-2, capturable=True))
    mixed = torch.optim.Adam([{"params": [g.e_mean], "capturable": True},
                              {"params": [g.w_mean]}], lr=5e-2)
    with pytest.raises(ValueError, match="capturable=True"):
        tgsm.require_capturable(mixed)
    run = tgsm.make_gsm_train_scan(torch.optim.Adam(g.parameters(), lr=5e-2), nsamples=NS)
    _, sp = _both(_unit_stats(1, False))
    with pytest.raises(ValueError, match="eps"):     # one step of noise for two steps
        run(g, sp, nsteps=2, eps={k: v[None] for k, v in g.sample_eps(None, NS).items()})
    with pytest.raises(ValueError, match="nsteps"):
        run(g, sp, nsteps=0)


def test_train_key_is_a_seeded_generator_on_the_device():
    """The JAX package's ``train_key(seed)`` makes the scan's PRNG key; the
    port's makes a seeded ``torch.Generator`` on the compute device (the
    two packages' streams cannot match)."""
    assert jgsm.train_key(1).shape == ()
    gen = tgsm.train_key(1, "cpu")
    assert isinstance(gen, torch.Generator) and gen.device.type == "cpu"
    assert torch.equal(torch.randn(5, generator=gen),
                       torch.randn(5, generator=torch.Generator().manual_seed(1)))
    assert not torch.equal(torch.randn(5, generator=tgsm.train_key(2, "cpu")),
                           torch.randn(5, generator=tgsm.train_key(1, "cpu")))
    if not torch.cuda.is_available():   # an entry point never builds on the CPU unasked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgsm.train_key(1)


def test_slice_gsm_vs_jax_slice():
    jg = _jax_gsm("hierarchical_transitions")
    pg = gsm_to_port(jg)
    for lang in range(L):
        js, ps = _slice_gsm(jg, lang, U // L, E), tgsm.slice_gsm(pg, lang, U // L)
        assert type(ps) is tgsm.GSM and ps.embed_dim == js.embed_dim and ps.n_units == js.n_units
        eps_j, eps_p = _eps(js, jax.random.PRNGKey(8), 6)
        want = jgsm.induced_posterior_moments(js, jax.random.PRNGKey(8), 6)
        got = tgsm.induced_posterior_moments(ps, eps=eps_p)
        assert sorted(got) == sorted(want)
        for name in want:
            close(got[name], want[name], RTOL, 1e-300)


def test_gsm_round_trip_and_entry_point_device_default():
    jg = _jax_gsm("trunk")
    pg = gsm_to_port(jg)
    again = bt.gsm_from_numpy(pg.to_numpy(), device="cpu")
    for (name, a), (_, b) in zip(pg.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), name
    hg = gsm_to_port(_jax_gsm("hierarchical"))
    assert bt.gsm_from_numpy(hg.to_numpy(), device="cpu").unit_lang == (0, 0, 1, 1)
    if not torch.cuda.is_available():   # an entry point never builds on the CPU unasked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgsm.GSM.create(U, E, D)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgsm.HierarchicalGSM.create(U, E, D, n_langs=L)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bt.gsm_from_numpy(pg.to_numpy())
    h = tgsm.HierarchicalGSM.create(U, E, D, lang_dim=LANG_D, n_langs=L, unit_lang=[0, 1, 1, 0],
                                    states_per_unit=P, trunk="mlp:5:tanh", device="cpu")
    assert h.e_mean.device.type == "cpu" and h.e_mean.shape == (U, E)
    assert h.w_mean.shape == (5 + 1, h.out_dim) and h.lang_mean.shape == (L, LANG_D)
    assert h.trunk.layers[0].in_features == E + LANG_D


# ----------------------------------------------------------------------
# The phone-loop bridge
# ----------------------------------------------------------------------
def _jax_loop(dtype, mixture=False, seed=0):
    k = 2 if mixture else 1
    nset = beer_tpu.NormalSet.create(jnp.zeros(D, dtype), jnp.ones(D, dtype), size=U * P * k,
                                     cov_type="diagonal", noise_std=1.0,
                                     key=jax.random.PRNGKey(seed))
    emissions = JaxMixtureSet.create(nset, U * P) if mixture else nset
    return JaxPhoneLoop.create(U, P, emissions, dtype=dtype)


def _data(seed=2, b=5, t_len=24):
    rng = np.random.default_rng(seed)
    lengths = np.array([t_len, t_len - 5, 9, 0, P])[:b]   # P frames: the shortest complete path
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)
    return rng.normal(size=(b, t_len, D)) * 1.5, mask


@pytest.mark.parametrize("mode", ["emission", "transitions", "mixture", "mixture_transitions"])
def test_accumulate_unit_stats_vs_jax(mode):
    jl = _jax_loop(jnp.float64, mixture=mode.startswith("mixture"))
    pl = to_port(jl, torch.float64)
    x, mask = _data()
    transitions = mode.endswith("transitions")
    want, want_counts = jgsm.accumulate_unit_stats(jl, jnp.asarray(x), jnp.asarray(mask),
                                                   transitions=transitions)
    got, got_counts = tgsm.accumulate_unit_stats(pl, t(x), t(mask), transitions=transitions)
    close(got_counts, want_counts, RTOL, 1e-300)
    assert float(got_counts.sum()) == pytest.approx(mask.sum(), rel=1e-9)
    if mode == "emission":
        close(got, want, RTOL, 1e-12)
        return
    for name in ("emission", "comp_counts", "self", "adv"):
        assert (want[name] is None) == (got[name] is None), name
        if want[name] is not None:
            close(got[name], want[name], RTOL, 1e-12)
    if transitions:   # every frame but an utterance's last leaves its state by self or adv
        n_rows = float((mask.sum(-1) > 0).sum())
        assert float(got["self"].sum() + got["adv"].sum()) == pytest.approx(
            mask.sum() - n_rows + n_rows, rel=1e-9)


def test_moment_matching_solvers_vs_jax():
    rng = np.random.default_rng(9)
    y = np.concatenate([rng.uniform(-8.0, -2.3, 6), rng.uniform(-2.2, 4.0, 6)])
    close(tgsm._inv_digamma(t(y)), jgsm._inv_digamma(jnp.asarray(y)), RTOL)
    close(torch.digamma(tgsm._inv_digamma(t(y))), y, 1e-8)
    lam = rng.gamma(3.0, 1.0, size=(5, D))
    e_lam = lam + rng.uniform(0.01, 0.5, size=lam.shape)
    e_log = np.log(lam)
    e_log[0] = np.log(e_lam[0])                       # the deterministic limit: a → max_shape
    want = jgsm._gamma_from_moments(jnp.asarray(e_lam), jnp.asarray(e_log))
    got = tgsm._gamma_from_moments(t(e_lam), t(e_log))
    close(got[0], want[0], 1e-8)
    close(got[1], want[1], 1e-8)
    elogw = np.log(rng.dirichlet(np.ones(3) * 2.0, size=7)) - rng.uniform(0.05, 0.6, size=(7, 1))
    close(tgsm._dirichlet_from_elogw(t(elogw)), jgsm._dirichlet_from_elogw(jnp.asarray(elogw)),
          1e-8)


@pytest.mark.parametrize("variant", ["plain", "k2_transitions", "hierarchical_transitions"])
def test_induced_posterior_moments_vs_jax(variant):
    jg = _jax_gsm(variant)
    pg = gsm_to_port(jg)
    key = jax.random.PRNGKey(10)
    _, eps_p = _eps(jg, key, 16)
    want = jgsm.induced_posterior_moments(jg, key, 16)
    got = tgsm.induced_posterior_moments(pg, eps=eps_p)
    assert sorted(got) == sorted(want)
    for name in want:
        close(got[name], want[name], RTOL, 1e-300)


@pytest.mark.parametrize("mode", ["moments", "confidence", "transitions", "mixture"])
def test_apply_to_phoneloop_vs_jax(mode):
    variant = {"transitions": "trunk", "mixture": "k2_transitions"}.get(mode, "plain")
    jg = _jax_gsm(variant)
    jg = jg.replace(e_logvar=jnp.full_like(jg.e_logvar, -1.5),
                    w_logvar=jnp.full_like(jg.w_logvar, -3.0))   # a non-trivial spread
    pg = gsm_to_port(jg)
    jl = _jax_loop(jnp.float64, mixture=mode == "mixture")
    pl = to_port(jl, torch.float64)
    key = jax.random.PRNGKey(11)
    _, eps_p = _eps(jg, key, 64)
    conf = 50.0 if mode == "confidence" else None
    jl2 = jgsm.apply_to_phoneloop(jg, jl, key=key, nsamples=64, confidence=conf)
    out = tgsm.apply_to_phoneloop(pg, pl, eps=eps_p, confidence=conf)
    assert out is pl
    jn = jl2.modelset.modelset if mode == "mixture" else jl2.modelset
    pn = pl.modelset.modelset if mode == "mixture" else pl.modelset
    close(pn.means_precisions.posterior, jn.means_precisions.posterior, 1e-8, 1e-10)
    if mode == "mixture":
        close(pl.modelset.weights.posterior, jl2.modelset.weights.posterior, 1e-8, 1e-10)
    close(pl.base_log_trans, jl2.base_log_trans, RTOL, 1e-300)
    if jl2.log_exit is None:
        assert pl.log_exit is None
    else:
        close(pl.log_exit, jl2.log_exit, RTOL)
    if mode == "moments":   # the write-back reproduces the moments it was matched to
        mom = tgsm.induced_posterior_moments(pg, eps=eps_p)
        et = pn.means_precisions.expected_sufficient_statistics()
        for i, name in enumerate(("e_lam", "e_lam_mu", "e_lam_mu2", "e_log_lam")):
            close(et[:, i * D:(i + 1) * D], mom[name].reshape(-1, D), 2e-3, 2e-3)
    # the written-back loop still runs
    x, mask = _data()
    want = jax_vb_step(jl2, jnp.asarray(x), mask=jnp.asarray(mask))[0]
    got = bt.vb_step(pl, t(x), mask=t(mask))[0]
    close(got, want, 1e-8)


def test_outer_iteration_in_miniature_float32():
    """One subspace-HMM outer iteration (2 VB steps, statistics with
    transitions, 20 Adam steps, moment-matched write-back, one more VB
    step) in float32 on both sides with the same noise: the phone loop's
    ELBO agrees within 1e-4 per frame."""
    jl = _jax_loop(jnp.float32, seed=1)
    pl = to_port(jl, torch.float32)
    x, mask = _data(seed=4)
    xj, mj = jnp.asarray(x, jnp.float32), jnp.asarray(mask, jnp.float32)
    xp, mp = t(x, torch.float32), t(mask, torch.float32)
    frames = float(mask.sum())
    step = jax.jit(jax_vb_step)
    for _ in range(2):
        ej, jl = step(jl, xj, mask=mj)
        ep, pl = bt.vb_step(pl, xp, mask=mp)
    assert abs(float(ej) - float(ep)) / frames <= 1e-4
    sj, _ = jgsm.accumulate_unit_stats(jl, xj, mj, transitions=True)
    sp, counts = tgsm.accumulate_unit_stats(pl, xp, mp, transitions=True)
    close(sp["emission"], sj["emission"], 1e-4, 1e-3)
    close(sp["self"], sj["self"], 1e-3, 1e-3)
    assert float(counts.sum()) == pytest.approx(frames, rel=1e-5)
    jg = jgsm.GSM.create(U, E, D, states_per_unit=P, learn_transitions=True,
                         key=jax.random.PRNGKey(2))
    pg = gsm_to_port(jg)
    tx = optax.adam(5e-2)
    opt_state = tx.init(jg)
    jstep = jgsm.make_gsm_train_step(tx, nsamples=NS)
    pstep = tgsm.make_gsm_train_step(torch.optim.Adam(pg.parameters(), lr=5e-2), nsamples=NS)
    for key in jax.random.split(jax.random.PRNGKey(3), 20):
        _, eps_p = _eps(jg, key)
        gj, jg, opt_state = jstep(jg, opt_state, sj, None, key)
        gp = pstep(pg, sp, eps=eps_p)
    assert abs(float(gj) - float(gp)) <= 1e-3 * abs(float(gj))
    key = jax.random.PRNGKey(5)
    _, eps_p = _eps(jg, key, 64)
    jl = jgsm.apply_to_phoneloop(jg, jl, key=key, nsamples=64)
    tgsm.apply_to_phoneloop(pg, pl, eps=eps_p)
    ej, jl = step(jl, xj, mask=mj)
    ep, pl = bt.vb_step(pl, xp, mask=mp)
    assert np.isfinite(float(ep))
    assert abs(float(ej) - float(ep)) / frames <= 1e-4
    paths, _ = pl.decode_units(xp, mp)
    assert paths.shape == mask.shape
