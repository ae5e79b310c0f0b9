"""beer_tpu_torch dists and conjugate building blocks against beer_tpu.

Same natural parameters (numpy, seeded) through both packages in
float64: E[T] = ∇A(η), KL(q‖p), the NormalSet ELLH and accumulation and
the stick-breaking unit prior agree to rtol 1e-10 (both are exact
closed forms; only summation order differs).
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


FAMILIES = {
    "normalgamma": (lambda d: jd.NormalGamma(dim=d), lambda d: td.NormalGamma(dim=d),
                    _normalgamma_nat),
    "isotropic_normalgamma": (lambda d: jd.IsotropicNormalGamma(dim=d),
                              lambda d: td.IsotropicNormalGamma(dim=d), _iso_nat),
    "dirichlet": (lambda d: jd.Dirichlet(dim=d), lambda d: td.Dirichlet(dim=d),
                  _dirichlet_nat),
    "beta": (lambda d: jd.Beta(), lambda d: td.Beta(), lambda r, f, n, d: _dirichlet_nat(r, f, n, 2)),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_expected_stats_and_kl_match_jax(name, rng):
    make_j, make_t, make_nat = FAMILIES[name]
    fam_j, fam_t = make_j(3), make_t(3)
    nat_q = make_nat(rng, fam_j, 5, 3)
    nat_p = make_nat(rng, fam_j, 5, 3)
    close(fam_t.log_norm(t(nat_q)), fam_j.log_norm(jnp.asarray(nat_q)), RTOL)
    close(fam_t.expected_sufficient_statistics(t(nat_q)),
          fam_j.expected_sufficient_statistics(jnp.asarray(nat_q)), RTOL)
    close(fam_t.kl_div(t(nat_q), t(nat_p)),
          fam_j.kl_div(jnp.asarray(nat_q), jnp.asarray(nat_p)), RTOL, atol=1e-12)


@pytest.mark.parametrize("name", ["normalgamma", "isotropic_normalgamma"])
def test_to_std_round_trips(name, rng):
    _, make_t, make_nat = FAMILIES[name]
    make_j = FAMILIES[name][0]
    nat = t(make_nat(rng, make_j(4), 3, 4))
    fam = make_t(4)
    close(fam.to_nat(*fam.to_std(nat)), nat, RTOL)


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


@pytest.mark.parametrize("cov_type", ["full", "isotropic", "shared_diagonal"])
def test_normalset_other_cov_types_not_ported(cov_type):
    with pytest.raises(NotImplementedError, match="A.4"):
        NormalSet.create(torch.zeros(2), torch.ones(2), size=3, cov_type=cov_type)


def test_sb_categorical_matches_jax(rng):
    from beer_tpu.models.categorical import SBCategorical as JSB

    jsb = JSB.create(5, concentration=2.0, dtype=jnp.float64)
    post = np.asarray(jsb.sticks.posterior) + rng.uniform(0.0, 4.0, size=(4, 2))
    jsb = jsb.replace(sticks=jsb.sticks.replace(posterior=jnp.asarray(post)))
    tsb = SBCategorical.create(5, concentration=2.0, dtype=torch.float64)
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


def test_categorical_matches_jax(rng):
    from beer_tpu.models.categorical import Categorical as JCat

    jcat = JCat.create(4, prior_strength=1.5, dtype=jnp.float64)
    tcat = Categorical.create(4, prior_strength=1.5, dtype=torch.float64)
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
