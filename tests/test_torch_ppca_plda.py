"""The port's PPCA and PLDA (bench configs 7 and 8) against beer_tpu.

Data are the JAX tests' recipes (``tests/test_ppca_plda.py``: PPCA 500
frames × 6 dims, Q = 2; PLDA 20 classes × 15 embeddings, D = 8, Q = 2),
made with numpy from a seed; the JAX models are carried across through
``convert.ppca_from_numpy`` / ``plda_from_numpy``.

Tolerances:
* float64: ``infer``, ``accumulate``, ``kl_div_posterior_prior``, one
  ``vb_update`` (joint and per mean-field group), ``vb_update_partial``
  and ``llr_score`` to rtol 1e-9.  The port takes the expected residual
  in its residual form (``models/ppca.py``), the same function with a
  different rounding;
* float32: 20 steps of ``vb_step`` and of ``vb_step_coordinate`` from
  the same start, each ELBO within 1e-4 per frame of the JAX package's,
  and non-decreasing to 1e-5 per frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beer_tpu_torch as bt
from beer_tpu.models.plda import PLDA as JaxPLDA
from beer_tpu.models.ppca import PPCA as JaxPPCA
from beer_tpu.vbi import elbo_and_stats as jax_elbo_and_stats
from beer_tpu.vbi import vb_step as jax_vb_step
from beer_tpu.vbi import vb_step_coordinate as jax_vb_step_coordinate
from beer_tpu.vbi import vb_update_partial as jax_vb_update_partial
from beer_tpu_torch.utils import load_model, save_model
from port_util import close, subspace_to_port, t

RTOL_F64 = 1e-9
ELBO_PER_FRAME_F32 = 1e-4
GROUPS = {"ppca": [None, ("w_mean", "w_cov", "mean"), ("prec",)],
          "plda": [None, ("f_mean", "f_cov", "mean"), ("prec",)]}
N_CLASSES = 20


def ppca_data(n=500, d=6, q=2, noise=0.1, seed=42):
    """``tests/test_ppca_plda.py::TestPPCA.make_data``."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d, q))
    z = rng.normal(size=(n, q))
    mu = rng.normal(size=d)
    return mu + z @ w.T + noise * rng.normal(size=(n, d))


def plda_data(n_classes=N_CLASSES, per_class=15, d=8, q=2, seed=42):
    """``tests/test_ppca_plda.py::TestPLDA.make_data``."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(d, q)) * 2.0
    mu = rng.normal(size=d)
    xs, ys = [], []
    for c in range(n_classes):
        h = rng.normal(size=q)
        xs.append(mu + h @ f.T + 0.3 * rng.normal(size=(per_class, d)))
        ys.append(np.full(per_class, c))
    return np.concatenate(xs), np.concatenate(ys).astype(np.int32)


def jax_model(kind, x, dtype):
    if kind == "ppca":
        return JaxPPCA.create(6, 2, mean=x.mean(0), key=jax.random.PRNGKey(0), dtype=dtype)
    return JaxPLDA.create(8, 2, mean=x.mean(0), key=jax.random.PRNGKey(0), dtype=dtype)


def _jax_estep(model, x, y):
    if y is None:
        return jax_elbo_and_stats(model, x)
    stats = model.sufficient_statistics(x)
    llh, cache = model.infer(stats, labels=y, n_classes=N_CLASSES)
    return llh.sum() - model.kl_div_posterior_prior(), model.accumulate(stats, cache)


@jax.jit
def jax_joint_step(model, x, y):
    if y is None:
        return jax_vb_step(model, x)
    elbo, acc = _jax_estep(model, x, y)
    return elbo, model.vb_update(acc)


def jax_coordinate_step(model, x, y):
    if y is None:
        return _jax_ppca_coordinate(model, x)
    elbo = None
    for group in model.mean_field_factorization():
        elbo, model = _jax_group_step(model, x, y, tuple(group))
    return elbo, model


_jax_ppca_coordinate = jax.jit(jax_vb_step_coordinate)


@jax.jit
def _jax_estep_jit(model, x, y):
    return _jax_estep(model, x, y)


def _jax_group_step_impl(model, x, y, group):
    elbo, acc = _jax_estep(model, x, y)
    return elbo, jax_vb_update_partial(model, acc, list(group))


_jax_group_step = jax.jit(_jax_group_step_impl, static_argnums=3)


def problem(kind, dtype):
    """(x, labels or None, a JAX model after one warm VB step)."""
    if kind == "ppca":
        x, y = ppca_data(), None
    else:
        x, y = plda_data()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    x = x.astype(np.float64 if dtype == torch.float64 else np.float32)
    yj = None if y is None else jnp.asarray(y)
    _, model = jax_joint_step(jax_model(kind, x, jdt), jnp.asarray(x), yj)
    return x, y, model


def _infer_kw(y):
    return {} if y is None else {"labels": t(y), "n_classes": N_CLASSES}


def _check_params(port, jax_m, rtol):
    for name in ("w_mean", "w_cov", "mean") if hasattr(jax_m, "w_mean") else \
            ("f_mean", "f_cov", "mean"):
        close(getattr(port, name), getattr(jax_m, name), rtol, atol=1e-12)
    close(port.prec.posterior, jax_m.prec.posterior, rtol)


@pytest.mark.parametrize("group", [0, 1, 2], ids=["joint", "subspace", "prec"])
@pytest.mark.parametrize("kind", ["ppca", "plda"])
def test_estep_and_update_match_jax_f64(kind, group):
    x, y, jm = problem(kind, torch.float64)
    pm = subspace_to_port(jm)
    stats_j = jm.sufficient_statistics(jnp.asarray(x))
    if y is None:
        llh_j, cache_j = jm.infer(stats_j)
    else:
        llh_j, cache_j = jm.infer(stats_j, labels=jnp.asarray(y), n_classes=N_CLASSES)
    llh_t, cache_t = pm.infer(pm.sufficient_statistics(t(x)), **_infer_kw(y))
    close(llh_t, llh_j, RTOL_F64)
    latent = "m" if kind == "ppca" else "m_h"
    close(cache_t[latent], cache_j[latent], RTOL_F64, atol=1e-12)
    acc_j = jm.accumulate(stats_j, cache_j)
    acc_t = pm.accumulate(t(x), cache_t)
    assert sorted(acc_t) == sorted(acc_j)
    for key in acc_j:
        scale = float(np.abs(np.asarray(acc_j[key])).max())
        close(acc_t[key], acc_j[key], RTOL_F64, atol=1e-12 * max(scale, 1.0))
    close(pm.kl_div_posterior_prior(), jm.kl_div_posterior_prior(), RTOL_F64)
    grp = GROUPS[kind][group]
    new_j = jm.vb_update(acc_j, 0.7, group=None if grp is None else list(grp))
    assert pm.vb_update(acc_t, 0.7, group=grp) is pm
    _check_params(pm, new_j, RTOL_F64)


@pytest.mark.parametrize("group", [1, 2], ids=["subspace", "prec"])
@pytest.mark.parametrize("kind", ["ppca", "plda"])
def test_vb_update_partial_matches_jax_f64(kind, group):
    """One mean-field group's update leaves the other fields bit for bit."""
    x, y, jm = problem(kind, torch.float64)
    pm = subspace_to_port(jm)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    _, acc_j = _jax_estep_jit(jm, jnp.asarray(x), None if y is None else jnp.asarray(y))
    _, acc_t = bt.elbo_and_stats(pm, t(x), **_infer_kw(y))
    grp = list(GROUPS[kind][group])
    new_j = jax_vb_update_partial(jm, acc_j, grp)
    assert bt.vb_update_partial(pm, acc_t, grp) is pm
    _check_params(pm, new_j, RTOL_F64)
    for key, value in pm.state_dict().items():
        if not any(key.startswith(g) for g in grp):
            assert torch.equal(value, before[key]), key
        elif not key.endswith("prior"):
            assert not torch.equal(value, before[key]), key


def test_llr_score_matches_jax_f64():
    x, y, jm = problem("plda", torch.float64)
    for _ in range(5):
        _, jm = jax_joint_step(jm, jnp.asarray(x), jnp.asarray(y))
    pm = subspace_to_port(jm)
    rng = np.random.default_rng(1)
    i, j = rng.integers(len(x), size=(2, 40))
    close(pm.llr_score(t(x[i]), t(x[j])), jm.llr_score(jnp.asarray(x[i]), jnp.asarray(x[j])),
          RTOL_F64)


def test_plda_one_class_default_and_repeatability():
    """``infer`` without labels is the one-class model of the JAX package;
    two calls give the same bits."""
    x, _, jm = problem("plda", torch.float64)
    pm = subspace_to_port(jm)
    llh_j, _ = jm.infer(jnp.asarray(x))
    llh_t, cache = pm.infer(t(x))
    close(llh_t, llh_j, RTOL_F64)
    assert cache["counts"].tolist() == [len(x)]
    y = t(plda_data()[1])
    a, _ = pm.infer(t(x), labels=y, n_classes=N_CLASSES)
    b, _ = pm.infer(t(x), labels=y, n_classes=N_CLASSES)
    assert torch.equal(a, b)


@pytest.mark.parametrize("step", ["joint", "coordinate"])
@pytest.mark.parametrize("kind", ["ppca", "plda"])
def test_f32_trajectory_matches_jax(kind, step):
    """20 float32 steps from one start: each ELBO within 1e-4 per frame of
    the JAX package's, and non-decreasing."""
    x, y = (ppca_data(), None) if kind == "ppca" else plda_data()
    x = x.astype(np.float32)
    jm = jax_model(kind, x, jnp.float32)
    pm = subspace_to_port(jm)
    assert pm.w_mean.dtype == torch.float32 if kind == "ppca" else pm.f_mean.dtype == torch.float32
    yj = None if y is None else jnp.asarray(y)
    jax_step = jax_joint_step if step == "joint" else jax_coordinate_step
    port_step = bt.vb_step if step == "joint" else bt.vb_step_coordinate
    got, want = [], []
    for _ in range(20):
        e_j, jm = jax_step(jm, jnp.asarray(x), yj)
        e_t, pm = port_step(pm, t(x), **_infer_kw(y))
        want.append(float(e_j) / len(x))
        got.append(float(e_t) / len(x))
    assert np.all(np.isfinite(got))
    assert max(abs(a - b) for a, b in zip(got, want)) <= ELBO_PER_FRAME_F32, (got, want)
    assert np.diff(got).min() >= -1e-5, got


def test_mean_field_factorization_and_transform():
    x, _, jm = problem("ppca", torch.float64)
    pm = subspace_to_port(jm)
    assert pm.mean_field_factorization() == jm.mean_field_factorization()
    close(pm.transform(t(x)), jm.transform(jnp.asarray(x)), RTOL_F64, atol=1e-12)
    _, _, jl = problem("plda", torch.float64)
    assert subspace_to_port(jl).mean_field_factorization() == jl.mean_field_factorization()


@pytest.mark.parametrize("kind", ["ppca", "plda"])
def test_create_conversion_and_checkpoint(kind, tmp_path):
    """``create`` draws its noise from the generator given (one seed, one
    model on every device), builds on the card unless asked for the CPU,
    and survives ``to_numpy`` / ``*_from_numpy`` and a checkpoint."""
    cls, conv = (bt.PPCA, bt.ppca_from_numpy) if kind == "ppca" else (bt.PLDA, bt.plda_from_numpy)
    a = cls.create(8, 3, device="cpu", generator=torch.Generator().manual_seed(4))
    b = cls.create(8, 3, device="cpu", generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(u, v) for u, v in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert a.obs_dim == 8 and a.latent_dim == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls.create(8, 3)
    c = conv(a.to_numpy(), device="cpu", dtype=torch.float64)
    assert next(c.buffers()).dtype == torch.float64
    save_model(c, tmp_path / "m.mdl")
    d = load_model(tmp_path / "m.mdl", device="cpu")
    assert type(d) is cls
    for key, value in c.state_dict().items():
        assert torch.equal(d.state_dict()[key], value), key
        close(value, a.state_dict()[key], 1e-6)
