"""beer_tpu_torch dists and conjugate building blocks against beer_tpu.

Same natural parameters (numpy, seeded) through both packages in
float64: E[T] = ∇A(η), KL(q‖p), the NormalSet ELLH and accumulation and
the stick-breaking unit prior agree to rtol 1e-10 (both are exact
closed forms; only summation order differs).  The NormalWishart's
log-partition goes through a matrix inverse and a Cholesky factor in
both packages, with LAPACK's rounding; it is held to rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beer_tpu
from beer_tpu import dists as jd
from beer_tpu_torch import dists as td
from beer_tpu_torch.models.categorical import Categorical, SBCategorical
from beer_tpu_torch.models.normal import NormalSet
from beer_tpu_torch.models.parameters import BayesianParameter
from beer_tpu_torch.ops import stats_kernels
from port_util import close, t

RTOL = 1e-10


def _normalgamma_nat(rng, fam, n, dim):
    mean = rng.normal(size=(n, dim))
    scale = rng.uniform(0.5, 2.0, size=(n, dim))
    shape = rng.uniform(1.0, 3.0, size=(n, dim))
    rate = rng.uniform(0.5, 2.0, size=(n, dim))
    return np.asarray(fam.to_nat(*(jnp.asarray(v) for v in (mean, scale, shape, rate))))


def _iso_nat(rng, fam, n, dim):
    mean = rng.normal(size=(n, dim))
    scale, shape, rate = (rng.uniform(lo, hi, size=n) for lo, hi in
                          ((0.5, 2.0), (1.0, 3.0), (0.5, 2.0)))
    return np.asarray(fam.to_nat(*(jnp.asarray(v) for v in (mean, scale, shape, rate))))


def _dirichlet_nat(rng, fam, n, dim):
    return rng.uniform(0.2, 3.0, size=(n, dim)) - 1.0


def _normalwishart_std(rng, n, dim):
    """(m, κ, W, ν): W positive definite, ν > D − 1."""
    q = rng.normal(size=(n, dim, dim))
    w = (q @ q.transpose(0, 2, 1) + dim * np.eye(dim)) / 10.0
    return (rng.normal(size=(n, dim)), rng.uniform(0.5, 2.0, size=n), w,
            dim + rng.uniform(0.5, 3.0, size=n))


def _normalwishart_nat(rng, fam, n, dim):
    return np.asarray(fam.to_nat(*(jnp.asarray(v) for v in _normalwishart_std(rng, n, dim))))


def _gamma_nat(rng, fam, n, dim):
    a, b = rng.uniform(0.5, 5.0, size=n), rng.uniform(0.5, 5.0, size=n)
    return np.asarray(fam.to_nat(jnp.asarray(a), jnp.asarray(b)))


NCOMP = 3   # components of the joint families


def _wishart_nat(rng, fam, n, dim):
    _, _, w, dof = _normalwishart_std(rng, n, dim)
    return np.asarray(fam.to_nat(jnp.asarray(w), jnp.asarray(dof)))


def _joint_nw_nat(rng, fam, n, dim):
    _, _, w, dof = _normalwishart_std(rng, n, dim)
    means, kappas = rng.normal(size=(n, NCOMP, dim)), rng.uniform(0.5, 2.0, size=(n, NCOMP))
    return np.asarray(fam.to_nat(*(jnp.asarray(v) for v in (means, kappas, w, dof))))


def _joint_ng_nat(rng, fam, n, dim):
    means = rng.normal(size=(n, NCOMP, dim))
    kappas = rng.uniform(0.5, 2.0, size=(n, NCOMP, dim))
    shape, rate = rng.uniform(1.0, 3.0, size=(n, dim)), rng.uniform(0.5, 2.0, size=(n, dim))
    return np.asarray(fam.to_nat(*(jnp.asarray(v) for v in (means, kappas, shape, rate))))


def _joint_iso_nat(rng, fam, n, dim):
    means, kappas = rng.normal(size=(n, NCOMP, dim)), rng.uniform(0.5, 2.0, size=(n, NCOMP))
    shape, rate = rng.uniform(1.0, 3.0, size=n), rng.uniform(0.5, 2.0, size=n)
    return np.asarray(fam.to_nat(*(jnp.asarray(v) for v in (means, kappas, shape, rate))))


FAMILIES = {
    "gamma": (lambda d: jd.Gamma(), lambda d: td.Gamma(), _gamma_nat),
    "normalgamma": (lambda d: jd.NormalGamma(dim=d), lambda d: td.NormalGamma(dim=d),
                    _normalgamma_nat),
    "isotropic_normalgamma": (lambda d: jd.IsotropicNormalGamma(dim=d),
                              lambda d: td.IsotropicNormalGamma(dim=d), _iso_nat),
    "dirichlet": (lambda d: jd.Dirichlet(dim=d), lambda d: td.Dirichlet(dim=d),
                  _dirichlet_nat),
    "beta": (lambda d: jd.Beta(), lambda d: td.Beta(), lambda r, f, n, d: _dirichlet_nat(r, f, n, 2)),
    "normalwishart": (lambda d: jd.NormalWishart(dim=d), lambda d: td.NormalWishart(dim=d),
                      _normalwishart_nat),
    "wishart": (lambda d: jd.Wishart(dim=d), lambda d: td.Wishart(dim=d), _wishart_nat),
    "joint_normalwishart": (lambda d: jd.JointNormalWishart(dim=d, ncomp=NCOMP),
                            lambda d: td.JointNormalWishart(dim=d, ncomp=NCOMP), _joint_nw_nat),
    "joint_normalgamma": (lambda d: jd.JointNormalGamma(dim=d, ncomp=NCOMP),
                          lambda d: td.JointNormalGamma(dim=d, ncomp=NCOMP), _joint_ng_nat),
    "joint_isotropic_normalgamma": (lambda d: jd.JointIsotropicNormalGamma(dim=d, ncomp=NCOMP),
                                    lambda d: td.JointIsotropicNormalGamma(dim=d, ncomp=NCOMP),
                                    _joint_iso_nat),
}
RTOLS = {"normalwishart": 1e-9, "wishart": 1e-9, "joint_normalwishart": 1e-9}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_expected_stats_and_kl_match_jax(name, rng):
    make_j, make_t, make_nat = FAMILIES[name]
    fam_j, fam_t = make_j(3), make_t(3)
    nat_q = make_nat(rng, fam_j, 5, 3)
    nat_p = make_nat(rng, fam_j, 5, 3)
    rtol = RTOLS.get(name, RTOL)
    close(fam_t.log_norm(t(nat_q)), fam_j.log_norm(jnp.asarray(nat_q)), rtol)
    close(fam_t.expected_sufficient_statistics(t(nat_q)),
          fam_j.expected_sufficient_statistics(jnp.asarray(nat_q)), rtol)
    close(fam_t.kl_div(t(nat_q), t(nat_p)),
          fam_j.kl_div(jnp.asarray(nat_q), jnp.asarray(nat_p)), rtol, atol=1e-12)


@pytest.mark.parametrize("name", ["normalgamma", "isotropic_normalgamma", "normalwishart",
                                  "wishart", "joint_normalwishart", "joint_normalgamma",
                                  "joint_isotropic_normalgamma"])
def test_to_std_round_trips(name, rng):
    _, make_t, make_nat = FAMILIES[name]
    make_j = FAMILIES[name][0]
    nat = t(make_nat(rng, make_j(4), 3, 4))
    fam = make_t(4)
    close(fam.to_nat(*fam.to_std(nat)), nat, RTOLS.get(name, RTOL))


def test_normal_wishart_to_nat_and_to_std_match_jax(rng):
    std = _normalwishart_std(rng, 4, 3)
    fam_j, fam_t = jd.NormalWishart(dim=3), td.NormalWishart(dim=3)
    nat_j = fam_j.to_nat(*(jnp.asarray(v) for v in std))
    close(fam_t.to_nat(*(t(v) for v in std)), nat_j, 1e-9)
    for got, want in zip(fam_t.to_std(t(np.asarray(nat_j))), fam_j.to_std(nat_j)):
        close(got, want, 1e-9)
    assert fam_t.nat_dim == fam_j.nat_dim == 14


def _normal_sets(rng, k=6, dim=3):
    jset = beer_tpu.NormalSet.create(
        jnp.zeros(dim), jnp.ones(dim), size=k, cov_type="diagonal",
        init_means=jnp.asarray(rng.normal(size=(k, dim))))
    mp = jset.means_precisions
    post = np.asarray(mp.posterior) + np.concatenate(
        [-np.abs(rng.normal(size=(k, dim))), np.zeros((k, 3 * dim))], axis=1)
    jset = jset.replace(means_precisions=mp.replace(posterior=jnp.asarray(post)))
    tset = NormalSet(BayesianParameter(t(mp.prior), t(post), td.NormalGamma(dim=dim)),
                     ncomp=k, dim=dim)
    return jset, tset


def test_normalset_create_matches_jax_prior(rng):
    means = rng.normal(size=(5, 3))
    jset = beer_tpu.NormalSet.create(jnp.full(3, 0.5), jnp.full(3, 2.0), size=5,
                                     prior_strength=3.0, cov_type="diagonal",
                                     init_means=jnp.asarray(means))
    tset = NormalSet.create(torch.full((3,), 0.5, dtype=torch.float64),
                            torch.full((3,), 2.0, dtype=torch.float64), size=5,
                            prior_strength=3.0, init_means=t(means))
    close(tset.means_precisions.prior, jset.means_precisions.prior, RTOL)
    close(tset.means_precisions.posterior, jset.means_precisions.posterior, RTOL)
    close(tset.means(), jset.means(), RTOL)


def test_normalset_ellh_and_accumulate_match_jax(rng):
    jset, tset = _normal_sets(rng)
    x = rng.normal(size=(2, 7, 3))
    resps = rng.dirichlet(np.ones(6), size=(14,))
    stats_j = jset.sufficient_statistics(jnp.asarray(x))
    stats_t = tset.sufficient_statistics(t(x))
    close(stats_t, stats_j, RTOL)
    close(tset.expected_log_likelihood(stats_t), jset.expected_log_likelihood(stats_j), RTOL)
    w_j, b_j = jset.ellh_matrix()
    w_t, b_t = tset.ellh_matrix()
    close(w_t, w_j, RTOL)
    close(b_t, b_j, RTOL)
    flat_j, flat_t = stats_j.reshape(14, 6), stats_t.reshape(14, 6)
    acc_j = jset.accumulate(flat_j, jnp.asarray(resps))["means_precisions"]
    acc_t = tset.accumulate(flat_t, t(resps))["means_precisions"]
    close(acc_t, acc_j, RTOL)
    close(tset.kl_div_posterior_prior(), jset.kl_div_posterior_prior(), RTOL)
    new_j = jset.vb_update({"means_precisions": acc_j}, lrate=0.7)
    tset.vb_update({"means_precisions": acc_t}, lrate=0.7)
    close(tset.means_precisions.posterior, new_j.means_precisions.posterior, RTOL)


@pytest.mark.parametrize("shape", [(7, 3), (2, 9, 39)], ids=["2d", "3d"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_diag_stats_match_jax_bit_for_bit(shape, dtype, rng):
    """The diagonal statistics [−½x², x]: the plain version of the
    ``diag_stats`` kernel and ``NormalSet.sufficient_statistics`` (which
    runs it on a CPU tensor) equal the JAX package's ``NormalSet`` to the
    bit, in float32 and float64."""
    x = (3.0 * rng.normal(size=shape)).astype(dtype)
    jset = beer_tpu.NormalSet.create(jnp.zeros(shape[-1], dtype), jnp.ones(shape[-1], dtype),
                                     size=2, cov_type="diagonal")
    want = torch.from_numpy(np.array(jset.sufficient_statistics(jnp.asarray(x))))
    frames = torch.from_numpy(x)
    tset = NormalSet.create(torch.zeros(shape[-1], dtype=frames.dtype),
                            torch.ones(shape[-1], dtype=frames.dtype), size=2)
    assert want.dtype == frames.dtype
    assert torch.equal(stats_kernels.diag_stats_plain(frames), want)
    assert torch.equal(tset.sufficient_statistics(frames), want)


def _refuse_diag_stats(*_):
    raise AssertionError("the statistics must not reach the kernel's wrapper")


def test_diag_stats_gradient_route_is_autograd(monkeypatch, rng):
    """Frames that need a gradient (the structured VAE's latent frames)
    keep the plain expression under autograd, never the kernel's wrapper:
    d/dx Σ [−½x², x] = 1 − x."""
    monkeypatch.setattr(stats_kernels, "diag_stats", _refuse_diag_stats)
    tset = NormalSet.create(torch.zeros(4, dtype=torch.float64), torch.ones(4, dtype=torch.float64),
                            size=3)
    x = t(rng.normal(size=(2, 5, 4))).requires_grad_()
    tset.sufficient_statistics(x).sum().backward()
    assert torch.equal(x.grad, 1 - x.detach())


def test_diag_stats_plain_scan_takes_the_plain_expression(monkeypatch, rng):
    """A ``NormalSet`` with ``plain_scan`` (the reference route on the card)
    computes its statistics by the plain expression, never the kernel's
    wrapper."""
    monkeypatch.setattr(stats_kernels, "diag_stats", _refuse_diag_stats)
    tset = NormalSet.create(torch.zeros(4), torch.ones(4), size=3)
    tset.plain_scan = True
    x = torch.from_numpy(rng.normal(size=(2, 5, 4)).astype(np.float32))
    assert torch.equal(tset.sufficient_statistics(x), torch.cat([-0.5 * x**2, x], dim=-1))


def test_joint_families_to_std_match_jax(rng):
    """The standard parameters each joint family and the Wishart recover
    are the JAX package's."""
    for name in ("wishart", "joint_normalwishart", "joint_normalgamma",
                 "joint_isotropic_normalgamma"):
        make_j, make_t, make_nat = FAMILIES[name]
        nat = make_nat(rng, make_j(3), 2, 3)
        for got, want in zip(make_t(3).to_std(t(nat)), make_j(3).to_std(jnp.asarray(nat))):
            close(got, want, 1e-9)
        assert make_t(3).nat_dim == make_j(3).nat_dim == nat.shape[-1], name


def test_joint_normal_wishart_tied_update_matches_textbook(rng):
    """Accumulating responsibility-weighted shared statistics is the
    textbook tied-covariance update (``tests/test_dists.py``'s oracle)."""
    d, k, n = 2, 3, 30
    x = rng.normal(size=(n, d))
    resps = rng.dirichlet(np.ones(k), size=n)
    means0, kappas0 = rng.normal(size=(k, d)), np.full(k, 1.3)
    q = rng.normal(size=(d, d))
    fam = td.JointNormalWishart(dim=d, ncomp=k)
    nat0 = fam.to_nat(t(means0), t(kappas0), t(q @ q.T + d * np.eye(d)), d + 2.0)
    acc = torch.einsum("nk,nkp->p", t(resps), td.normallik.suff_stats_shared_full(t(x), k))
    means, kappas, _, dof = fam.to_std(nat0 + acc)
    nk = resps.sum(0)
    close(kappas, kappas0 + nk, 1e-12)
    close(dof, d + 2.0 + n, 1e-12)
    close(means, (kappas0[:, None] * means0 + resps.T @ x) / (kappas0 + nk)[:, None], 1e-10)


LAYOUTS = {
    "isotropic": lambda m, x, k: m.suff_stats_isotropic(x),
    "shared_full": lambda m, x, k: m.suff_stats_shared_full(x, k),
    "shared_diag": lambda m, x, k: m.suff_stats_shared_diag(x, k),
    "shared_isotropic": lambda m, x, k: m.suff_stats_shared_isotropic(x, k),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_normallik_layouts_match_jax(layout, rng):
    from beer_tpu.dists import normallik as jl

    x = rng.normal(size=(2, 5, 3))
    close(LAYOUTS[layout](td.normallik, t(x), 4), LAYOUTS[layout](jl, jnp.asarray(x), 4), 0)


@pytest.mark.parametrize("cov_type", ["isotropic", "shared_diagonal", "shared_full",
                                      "shared_isotropic"])
def test_normalset_other_cov_types_not_ported(cov_type, rng):
    """Once refused by the port, now ported: ``create`` (priors and
    posteriors), the ELLH, the statistics, the KL, one update and the
    means of each covariance type beside diagonal and full, against the
    JAX package's at rtol 1e-10.  The shared types score raw frames where
    the JAX package builds its (N, K, P) layout."""
    x = rng.normal(size=(40, 3))
    mean, cov = x.mean(0), np.cov(x.T)
    init = rng.normal(size=(4, 3))
    jset = beer_tpu.NormalSet.create(jnp.asarray(mean), jnp.asarray(cov), size=4,
                                     prior_strength=2.0, cov_type=cov_type,
                                     init_means=jnp.asarray(init))
    tset = NormalSet.create(t(mean), t(cov), size=4, prior_strength=2.0, cov_type=cov_type,
                            init_means=t(init))
    mp_t, mp_j = tset.means_precisions, jset.means_precisions
    assert tset.cov_type == jset.cov_type and len(tset) == 4
    close(mp_t.prior, mp_j.prior, RTOL, atol=1e-13)
    close(mp_t.posterior, mp_j.posterior, RTOL, atol=1e-13)
    stats_j, stats_t = jset.sufficient_statistics(jnp.asarray(x)), tset.sufficient_statistics(t(x))
    close(tset.expected_log_likelihood(stats_t), jset.expected_log_likelihood(stats_j), RTOL)
    resps = rng.dirichlet(np.ones(4), size=40)
    acc_j = jset.accumulate(stats_j, jnp.asarray(resps))["means_precisions"]
    acc_t = tset.accumulate(stats_t, t(resps))["means_precisions"]
    close(acc_t, acc_j, RTOL, atol=1e-12)
    close(tset.kl_div_posterior_prior(), jset.kl_div_posterior_prior(), 1e-9, atol=1e-12)
    new_j = jset.vb_update({"means_precisions": acc_j}, lrate=0.7)
    tset.vb_update({"means_precisions": acc_t}, lrate=0.7)
    close(mp_t.posterior, new_j.means_precisions.posterior, RTOL, atol=1e-12)
    close(tset.means(), new_j.means(), 1e-9)
    if cov_type == "shared_full":
        alias = NormalSet.create(t(mean), t(cov), size=4, cov_type="shared", init_means=t(init))
        assert alias.cov_type == "shared_full"
    with pytest.raises(ValueError, match="unknown cov_type"):
        NormalSet.create(t(mean), t(cov), size=4, cov_type="tied")


def test_sb_categorical_matches_jax(rng):
    from beer_tpu.models.categorical import SBCategorical as JSB

    jsb = JSB.create(5, concentration=2.0, dtype=jnp.float64)
    post = np.asarray(jsb.sticks.posterior) + rng.uniform(0.0, 4.0, size=(4, 2))
    jsb = jsb.replace(sticks=jsb.sticks.replace(posterior=jnp.asarray(post)))
    tsb = SBCategorical.create(5, concentration=2.0, dtype=torch.float64, device="cpu")
    close(tsb.sticks.prior, jsb.sticks.prior, RTOL)
    tsb.sticks.posterior.copy_(t(post))
    close(tsb.expected_log_weights(), jsb.expected_log_weights(), RTOL)
    close(tsb.kl_div_posterior_prior(), jsb.kl_div_posterior_prior(), RTOL)
    close(tsb.mean(), jsb.mean(), RTOL)
    counts = rng.uniform(0.0, 10.0, size=5)
    acc_j = jsb.accumulate_counts(jnp.asarray(counts))
    acc_t = tsb.accumulate_counts(t(counts))
    close(acc_t["sticks"], acc_j["sticks"], RTOL)
    new_j = jsb.vb_update(acc_j)
    tsb.vb_update(acc_t)
    close(tsb.sticks.posterior, new_j.sticks.posterior, RTOL)


def test_gamma_moments_and_round_trip(rng):
    """E[T] = [a/b, ψ(a) − log b] (scipy), and to_std inverts to_nat."""
    from scipy import special

    a, b = rng.uniform(0.5, 5.0, size=4), rng.uniform(0.5, 5.0, size=4)
    fam = td.Gamma()
    assert fam.nat_dim == 2
    nat = fam.to_nat(t(a), t(b))
    est = fam.expected_sufficient_statistics(nat)
    close(est[..., 0], a / b, 1e-12)
    close(est[..., 1], special.digamma(a) - np.log(b), 1e-12)
    a2, b2 = fam.to_std(nat)
    close(a2, a, 1e-15)
    close(b2, b, 1e-15)


def test_sb_categorical_hyperprior_matches_jax(rng):
    """Every method of the weight-model protocol and the mean-field
    update (sticks against the expected prior, then γ), at lrate 0.7."""
    from beer_tpu.models.categorical import SBCategoricalHyperPrior as JHP
    from beer_tpu_torch.models.categorical import SBCategoricalHyperPrior

    jhp = JHP.create(5, prior_shape=2.0, prior_rate=0.5, dtype=jnp.float64)
    thp = SBCategoricalHyperPrior.create(5, prior_shape=2.0, prior_rate=0.5,
                                         dtype=torch.float64, device="cpu")
    for name in ("sticks", "concentration"):
        close(getattr(thp, name).prior, getattr(jhp, name).prior, RTOL)
        close(getattr(thp, name).posterior, getattr(jhp, name).posterior, RTOL)
    post = np.asarray(jhp.sticks.posterior) + rng.uniform(0.0, 4.0, size=(4, 2))
    g_post = np.asarray(jhp.concentration.posterior) + np.array([-0.3, 1.5])
    jhp = jhp.replace(sticks=jhp.sticks.replace(posterior=jnp.asarray(post)),
                      concentration=jhp.concentration.replace(posterior=jnp.asarray(g_post)))
    thp.sticks.posterior.copy_(t(post))
    thp.concentration.posterior.copy_(t(g_post))
    close(thp.expected_log_weights(), jhp.expected_log_weights(), RTOL)
    close(thp.kl_div_posterior_prior(), jhp.kl_div_posterior_prior(), RTOL)
    close(thp.mean(), jhp.mean(), RTOL)
    labels = rng.integers(0, 5, size=11)
    stats_t = thp.sufficient_statistics(t(labels))
    llh_t, cache_t = thp.infer(stats_t)
    llh_j, cache_j = jhp.infer(jhp.sufficient_statistics(jnp.asarray(labels)))
    close(llh_t, llh_j, RTOL)
    close(thp.accumulate(stats_t, cache_t)["sticks"],
          jhp.accumulate(None, cache_j)["sticks"], RTOL)
    counts = rng.uniform(0.0, 10.0, size=5)
    acc_j = jhp.accumulate_counts(jnp.asarray(counts))
    acc_t = thp.accumulate_counts(t(counts))
    close(acc_t["sticks"], acc_j["sticks"], RTOL)
    new_j = jhp.vb_update(acc_j, lrate=0.7)
    assert thp.vb_update(acc_t, lrate=0.7) is thp
    close(thp.sticks.posterior, new_j.sticks.posterior, RTOL)
    close(thp.concentration.posterior, new_j.concentration.posterior, RTOL)
    close(thp.kl_div_posterior_prior(), new_j.kl_div_posterior_prior(), RTOL)


def test_categorical_matches_jax(rng):
    from beer_tpu.models.categorical import Categorical as JCat

    jcat = JCat.create(4, prior_strength=1.5, dtype=jnp.float64)
    tcat = Categorical.create(4, prior_strength=1.5, dtype=torch.float64, device="cpu")
    labels = rng.integers(0, 4, size=9)
    stats_j = jcat.sufficient_statistics(jnp.asarray(labels))
    stats_t = tcat.sufficient_statistics(torch.as_tensor(labels))
    close(stats_t, stats_j, RTOL)
    llh_j, cache_j = jcat.infer(stats_j)
    llh_t, cache_t = tcat.infer(stats_t)
    close(llh_t, llh_j, RTOL)
    new_j = jcat.vb_update(jcat.accumulate(stats_j, cache_j))
    tcat.vb_update(tcat.accumulate(stats_t, cache_t))
    close(tcat.weights.posterior, new_j.weights.posterior, RTOL)
    close(tcat.mean(), new_j.mean(), RTOL)
    close(tcat.kl_div_posterior_prior(), new_j.kl_div_posterior_prior(), RTOL)


def test_expected_natural_parameters_and_zero_stats_match_jax(rng):
    """The reference-API alias and the zero statistics of a parameter set,
    against the JAX package's on the same natural parameters."""
    jset, tset = _normal_sets(rng)
    jp, tp = jset.means_precisions, tset.means_precisions
    close(tp.expected_natural_parameters(), jp.expected_natural_parameters(), RTOL)
    assert torch.equal(tp.expected_natural_parameters(), tp.expected_sufficient_statistics())
    zeros = tp.zero_stats()
    assert zeros.shape == tuple(jp.zero_stats().shape) and zeros.dtype == tp.posterior.dtype
    assert not zeros.any() and zeros.data_ptr() != tp.posterior.data_ptr()
    buf = tp.posterior.clone()
    tp.natural_update(zeros, lrate=1.0)          # a zero-statistics update lands on the prior
    close(tp.posterior, jp.natural_update(jp.zero_stats(), 1.0).posterior, RTOL)
    assert not torch.equal(buf, tp.posterior)


def test_natural_update_is_in_place():
    fam = td.Dirichlet(dim=3)
    prior = torch.zeros(3, dtype=torch.float64)
    param = BayesianParameter(prior, prior.clone(), fam)
    buf = param.posterior
    out = param.natural_update(torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64), lrate=0.5)
    assert out is param and param.posterior is buf
    close(param.posterior, [0.5, 1.0, 1.5], RTOL)
    assert set(dict(param.named_buffers())) == {"prior", "posterior"}
    assert not list(param.parameters())
