"""The port's model-set compositions, mean-field coordinate VB and the
routing of the new covariance types against beer_tpu.

Cases are ``tests/test_modelset.py``'s (three 2-D clusters of 300
frames; NormalSets of 2, 3 and 6 components; a 3-unit × 2-state phone
loop over 6 × 30 frames) and an ergodic 5-state HMM with learned
transitions over 4 ragged utterances, all made with numpy from a seed and
carried across from the JAX models.  Float64, rtol 1e-9: the ELLH
columns, the statistics, ``vb_update_partial`` for each mean-field group
(every field outside the group unchanged, bit for bit) and the ELBOs of
``vb_step`` / ``vb_step_coordinate`` steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beer_tpu
import beer_tpu_torch as bt
from beer_tpu.models import graph as jgraph
from beer_tpu.models.hmm import HMM as JaxHMM
from beer_tpu.models.modelset import JointModelSet as JaxJoint
from beer_tpu.models.modelset import RepeatedModelSet as JaxRepeated
from beer_tpu.models.phoneloop import PhoneLoop as JaxPhoneLoop
from beer_tpu.vbi import elbo_and_stats as jax_elbo_and_stats
from beer_tpu.vbi import vb_step as jax_vb_step
from beer_tpu.vbi import vb_step_coordinate as jax_vb_step_coordinate
from beer_tpu.vbi import vb_update_partial as jax_vb_update_partial
from beer_tpu_torch.convert import modelset_from_numpy
from port_util import (close, hmm_to_port, lengths_and_mask, mixture_to_port, normal_set_to_numpy,
                       phone_loop_to_numpy, t)

RTOL_F64 = 1e-9


def _data(seed=42, n=300):
    rng = np.random.default_rng(seed)
    means = np.array([[-3.0, 0.0], [3.0, 1.0], [0.0, -3.0]])
    return np.concatenate([rng.normal(m, 0.5, size=(n, 2)) for m in means])


def _nset(size, cov_type="diagonal", key=0, dim=2):
    return beer_tpu.NormalSet.create(jnp.zeros(dim), jnp.eye(dim), size=size, cov_type=cov_type,
                                     noise_std=1.0, key=jax.random.PRNGKey(key))


def _port_set(jax_set):
    return bt.normal_set_from_numpy(normal_set_to_numpy(jax_set), device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _close_trees(got, want, rtol=RTOL_F64):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        scale = float(np.abs(np.asarray(b)).max())
        close(a, b, rtol, atol=1e-12 * max(scale, 1.0))


@jax.jit
def _jax_step(model, x):
    return jax_vb_step(model, x)


def test_joint_modelset_matches_jax():
    """A mixture over two NormalSets side by side: ELLH columns, statistics
    and 10 VB-EM steps."""
    x = _data()
    a, b = _nset(2, key=1), _nset(3, key=2)
    jset = JaxJoint.create([a, b])
    pset = bt.JointModelSet.create([_port_set(a), _port_set(b)])
    assert len(pset) == len(jset) == 5
    stats_j, stats_t = jset.sufficient_statistics(jnp.asarray(x)), pset.sufficient_statistics(t(x))
    ellh = pset.expected_log_likelihood(stats_t)
    close(ellh, jset.expected_log_likelihood(stats_j), RTOL_F64)
    close(ellh[:, :2], pset.modelsets[0].expected_log_likelihood(stats_t), 0)
    resps = np.random.default_rng(0).dirichlet(np.ones(5), size=len(x))
    _close_trees(pset.accumulate(stats_t, t(resps)), jset.accumulate(stats_j, jnp.asarray(resps)))
    jm = beer_tpu.Mixture.create(jset)
    pm = bt.Mixture.create(pset)
    pm.categorical.weights.posterior.copy_(t(np.asarray(jm.categorical.weights.posterior)))
    for _ in range(10):
        e_j, jm = _jax_step(jm, jnp.asarray(x))
        e_t, pm = bt.vb_step(pm, t(x))
        close(e_t, e_j, RTOL_F64)
    for got, want in zip(pm.modelset.modelsets, jm.modelset.modelsets):
        close(got.means_precisions.posterior, want.means_precisions.posterior, RTOL_F64)


def test_repeated_modelset_matches_jax():
    """Repeats tile the ELLH and fold the responsibilities onto the base."""
    x = _data()
    base = _nset(3, key=3)
    jset = JaxRepeated.create(base, repeats=2)
    pset = bt.RepeatedModelSet.create(_port_set(base), repeats=2)
    assert len(pset) == len(jset) == 6
    stats_j, stats_t = jset.sufficient_statistics(jnp.asarray(x)), pset.sufficient_statistics(t(x))
    ellh = pset.expected_log_likelihood(stats_t)
    close(ellh, jset.expected_log_likelihood(stats_j), RTOL_F64)
    assert torch.equal(ellh[:, :3], ellh[:, 3:])
    resps = torch.softmax(ellh, -1)
    _close_trees(pset.accumulate(stats_t, resps),
                 jset.accumulate(stats_j, jnp.asarray(resps.numpy())))
    jm, pm = beer_tpu.Mixture.create(jset), bt.Mixture.create(pset)
    for _ in range(5):
        e_j, jm = _jax_step(jm, jnp.asarray(x))
        e_t, pm = bt.vb_step(pm, t(x))
        close(e_t, e_j, RTOL_F64)


def test_joint_modelset_rejects_layout_mismatch():
    """Members that score different statistics layouts are refused."""
    with pytest.raises(ValueError, match="layout"):
        bt.JointModelSet.create([_port_set(_nset(2, "diagonal")), _port_set(_nset(2, "full"))])
    assert len(bt.JointModelSet.create([_port_set(_nset(2, key=0)),
                                        _port_set(_nset(3, key=1))])) == 5


def test_modelset_compositions_round_trip():
    joint = bt.JointModelSet.create([_port_set(_nset(2, key=0)), _port_set(_nset(3, key=1))])
    rep = bt.RepeatedModelSet.create(_port_set(_nset(3, key=2)), repeats=4)
    for model in (joint, rep):
        back = modelset_from_numpy(model.to_numpy(), device="cpu")
        assert type(back) is type(model) and len(back) == len(model)
        for a, b in zip(back.buffers(), model.buffers()):
            assert torch.equal(a, b)


# ----------------------------------------------------------------------
# mean-field coordinate VB
# ----------------------------------------------------------------------
def _mixture():
    return beer_tpu.Mixture.create(_nset(6, key=4)), _data(), None


def _phone_loop():
    x = np.random.default_rng(1).normal(size=(6, 30, 2))
    loop = JaxPhoneLoop.create(3, 2, _nset(6, key=5), dtype=jnp.float64)
    return loop, x, np.ones((6, 30))


def _hmm():
    x = np.random.default_rng(2).normal(size=(4, 16, 2))
    hmm = JaxHMM.create(jgraph.ergodic(5).compile(jnp.float64), _nset(5, key=6),
                        learn_transitions=True)
    return hmm, x, lengths_and_mask(16)[1]


CASES = {"mixture": _mixture, "phone_loop": _phone_loop, "hmm": _hmm}
GROUPS = {"mixture": [["categorical"], ["modelset"]],
          "phone_loop": [["modelset"], ["unit_prior"]],
          "hmm": [["modelset"], ["trans_alpha_post"]]}


def _to_port(kind, model):
    if kind == "mixture":
        return mixture_to_port(model, torch.float64)
    if kind == "hmm":
        return hmm_to_port(model, torch.float64)
    return bt.phone_loop_from_numpy(phone_loop_to_numpy(model), device="cpu")


def _kw(mask, jax_side):
    if mask is None:
        return {}
    return {"mask": jnp.asarray(mask) if jax_side else t(mask)}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_mean_field_factorization_matches_jax(kind):
    jm, _, _ = CASES[kind]()
    assert _to_port(kind, jm).mean_field_factorization() == jm.mean_field_factorization() \
        == GROUPS[kind]


@pytest.mark.parametrize("group", [0, 1])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_vb_update_partial_matches_jax(kind, group):
    """One group's update (lrate 0.8) from the same statistics: the
    group's fields as the JAX package's, every other buffer unchanged."""
    jm, x, mask = CASES[kind]()
    pm = _to_port(kind, jm)
    grp = GROUPS[kind][group]
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    _, acc_j = jax_elbo_and_stats(jm, jnp.asarray(x), **_kw(mask, True))
    _, acc_t = bt.elbo_and_stats(pm, t(x), **_kw(mask, False))
    new_j = jax_vb_update_partial(jm, acc_j, grp, 0.8)
    assert bt.vb_update_partial(pm, acc_t, grp, 0.8) is pm
    changed = {key.split(".")[0] for key, value in pm.state_dict().items()
               if not torch.equal(value, before[key])}
    assert changed == set(grp), changed
    want = _to_port(kind, new_j).state_dict()
    _close_trees([v for _, v in sorted(pm.state_dict().items())],
                 [v for _, v in sorted(want.items())])


@pytest.mark.parametrize("kind", sorted(CASES))
def test_vb_step_coordinate_matches_jax(kind):
    """Five coordinate steps: each ELBO as the JAX package's, non-decreasing."""
    jm, x, mask = CASES[kind]()
    pm = _to_port(kind, jm)
    step = jax.jit(lambda m, xx, kw: jax_vb_step_coordinate(m, xx, **kw))
    got = []
    for _ in range(5):
        e_j, jm = step(jm, jnp.asarray(x), _kw(mask, True))
        e_t, pm = bt.vb_step_coordinate(pm, t(x), **_kw(mask, False))
        close(e_t, e_j, RTOL_F64)
        got.append(float(e_t))
    assert np.diff(got).min() >= -1e-6 * abs(got[-1])


# ----------------------------------------------------------------------
# the new covariance types in the sequence models
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cov_type", ["isotropic", "shared_diagonal", "full"])
def test_phone_loop_over_other_cov_types_matches_jax(cov_type):
    """A phone loop over any NormalSet but a diagonal one takes ``smooth``,
    as the JAX package routes it; two VB steps agree."""
    x = np.random.default_rng(3).normal(size=(4, 20, 2))
    mask = lengths_and_mask(20)[1]
    jm = JaxPhoneLoop.create(3, 2, _nset(6, cov_type, key=7), dtype=jnp.float64)
    pm = bt.phone_loop_from_numpy(phone_loop_to_numpy(jm), device="cpu")
    _, cache = pm.infer(pm.sufficient_statistics(t(x)), mask=t(mask))
    assert "posteriors" in cache
    step = jax.jit(lambda m, xx, mm: jax_vb_step(m, xx, mask=mm))
    for _ in range(2):
        e_j, jm = step(jm, jnp.asarray(x), jnp.asarray(mask))
        e_t, pm = bt.vb_step(pm, t(x), mask=t(mask))
        close(e_t, e_j, RTOL_F64)


@pytest.mark.parametrize("cov_type", ["shared_full", "isotropic"])
def test_hmm_over_other_cov_types_matches_jax(cov_type):
    """An HMM over the new types takes the llh route; two VB steps agree."""
    x = np.random.default_rng(4).normal(size=(4, 16, 2))
    mask = lengths_and_mask(16)[1]
    jm = JaxHMM.create(jgraph.ergodic(4).compile(jnp.float64), _nset(4, cov_type, key=8),
                       learn_transitions=True)
    pm = hmm_to_port(jm, torch.float64)
    assert pm.route() == "llh"
    step = jax.jit(lambda m, xx, mm: jax_vb_step(m, xx, mask=mm))
    for _ in range(2):
        e_j, jm = step(jm, jnp.asarray(x), jnp.asarray(mask))
        e_t, pm = bt.vb_step(pm, t(x), mask=t(mask))
        close(e_t, e_j, RTOL_F64)
