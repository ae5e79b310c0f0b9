"""The port's phone-loop slice against beer_tpu: VB-EM steps and decode.

A JAX PhoneLoop (diagonal NormalSet emissions, stick-breaking unit
prior) is carried into the port with ``beer_tpu_torch.convert``; both
packages then see the same numpy data.  The port runs its fused E-step
route through the plain versions of its kernels (CPU tensors).

Tolerances:
* float64 against the JAX general path: ELBOs, log Z, statistics and
  posteriors to rtol 1e-9 (the same algorithm up to summation order);
* float32 over 3 VB-EM steps, against the JAX general path and against
  the JAX fused lane-major route (Pallas kernels in interpret mode): the
  per-frame ELBO gap is at most 1e-4 (BASELINE's correctness bar);
* decode: paths equal, scores rtol 1e-9 (float64).

Shapes: U=4 units × 3 states, D=3, B=4 (one full, two ragged and one
zero-length row), T=20.
"""

import copy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beer_tpu_torch as bt
from beer_tpu.models import phoneloop as jax_phoneloop
from beer_tpu.ops import pallas_scan
from beer_tpu.vbi import elbo_and_stats as jax_elbo_and_stats
from beer_tpu.vbi import vb_step as jax_vb_step
from port_util import (B, D, T, close, jax_phone_loop, lengths_and_mask,
                             phone_loop_to_numpy, t, to_port)

RTOL_F64 = 1e-9
ELBO_PER_FRAME_F32 = 1e-4
N_STEPS = 3


def _data(dtype_np, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(dtype_np)
    _, mask = lengths_and_mask(T)
    return x, mask.astype(dtype_np)


def _jax_steps(loop, x, mask, n=N_STEPS):
    step = jax.jit(lambda m, xx, mm: jax_vb_step(m, xx, mask=mm))
    elbos = []
    for _ in range(n):
        elbo, loop = step(loop, jnp.asarray(x), jnp.asarray(mask))
        elbos.append(float(elbo))
    return np.array(elbos), loop


def _port_steps(loop, x, mask, n=N_STEPS):
    elbos = []
    for _ in range(n):
        elbo, loop = bt.vb_step(loop, t(x), mask=t(mask))
        elbos.append(float(elbo))
    return np.array(elbos), loop


@pytest.fixture
def jax_fused_lane_major(monkeypatch):
    """Route the JAX PhoneLoop through its fused lane-major Pallas kernels
    (interpret mode on the CPU); every flag is restored afterwards."""
    monkeypatch.setattr(pallas_scan, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jax_phoneloop, "LANE_MAJOR", True)
    pallas_scan.available.cache_clear()
    yield
    pallas_scan.available.cache_clear()


def test_convert_round_trip():
    jloop = jax_phone_loop(jnp.float64)
    d = phone_loop_to_numpy(jloop)
    back = to_port(jloop, torch.float64).to_numpy()
    assert set(back) == set(d)
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(back[k], v)
        else:
            assert back[k] == v
    # the port owns copies: its in-place updates never reach the JAX arrays
    port = to_port(jloop, torch.float64)
    port.modelset.means_precisions.posterior.add_(1.0)
    np.testing.assert_array_equal(np.asarray(jloop.modelset.means_precisions.posterior),
                                  d["modelset_posterior"])


def test_graph_and_bands_match_jax():
    jloop = jax_phone_loop(jnp.float64)
    loop = to_port(jloop, torch.float64)
    jg, g = jloop._effective_graph(), loop._effective_graph()
    for name in ("log_init", "log_final", "log_trans"):
        close(getattr(g, name), getattr(jg, name), RTOL_F64)
    bands = loop._structured_trans(torch.float64)
    close(bands, np.stack([np.asarray(v) for v in jloop._structured_trans(jnp.float64)]),
          RTOL_F64)
    close(bt.ops.semiring_scan.bands_to_dense(bands), np.exp(np.asarray(jg.log_trans)),
          RTOL_F64, atol=1e-300)


@pytest.mark.parametrize("route", ["fused", "smooth"])
def test_estep_matches_jax_general_path_f64(route):
    jloop = jax_phone_loop(jnp.float64)
    loop = to_port(jloop, torch.float64)
    x, mask = _data(np.float64)
    jstats = jloop.sufficient_statistics(jnp.asarray(x))
    jlz, jcache = jloop.infer(jstats, jnp.asarray(mask))
    assert "posteriors" in jcache  # the JAX general path
    jacc = jloop.accumulate(jstats, jcache)
    stats = loop.sufficient_statistics(t(x))
    infer = loop.infer if route == "fused" else loop.smooth
    lz, cache = infer(stats, t(mask))
    acc = loop.accumulate(stats, cache)
    close(lz, jlz, RTOL_F64)
    assert float(lz[3]) == 0.0  # the zero-length row
    close(acc["modelset"]["means_precisions"], jacc["modelset"]["means_precisions"],
          RTOL_F64, atol=1e-12)
    close(acc["unit_prior"]["sticks"], jacc["unit_prior"]["sticks"], RTOL_F64, atol=1e-12)


def test_hyperprior_vb_steps_match_jax_f64():
    """A loop whose unit prior is an SBCategoricalHyperPrior (Gamma on the
    concentration), carried across by ``convert``: the fused route reads
    it through ``expected_log_weights`` and ``accumulate_counts`` alone;
    3 VB steps give the JAX ELBOs, sticks and γ posterior at rtol 1e-9,
    and ``to_numpy`` carries the hyper-prior back."""
    from beer_tpu.models.categorical import SBCategoricalHyperPrior as JHP
    from beer_tpu.models.phoneloop import PhoneLoop as JPhoneLoop

    base = jax_phone_loop(jnp.float64)
    jloop = JPhoneLoop.create(base.n_units, base.states_per_unit, base.modelset,
                              unit_prior=JHP.create(base.n_units, 2.0, 1.5, dtype=jnp.float64),
                              dtype=jnp.float64)
    loop = to_port(jloop, torch.float64)
    assert isinstance(loop.unit_prior, bt.SBCategoricalHyperPrior)
    x, mask = _data(np.float64)
    jelbos, jloop = _jax_steps(jloop, x, mask)
    elbos, loop = _port_steps(loop, x, mask)
    close(elbos, jelbos, RTOL_F64)
    assert np.all(np.diff(elbos) > 0)
    got, want = loop.to_numpy(), phone_loop_to_numpy(jloop)
    for k in ("modelset_posterior", "sticks_posterior", "concentration_posterior"):
        close(got[k], want[k], RTOL_F64, atol=1e-12)
    again = bt.phone_loop_from_numpy(got, device="cpu")
    assert isinstance(again.unit_prior, bt.SBCategoricalHyperPrior)
    close(again.unit_prior.concentration.prior, want["concentration_prior"], 0.0)


def test_vb_steps_match_jax_general_path_f64():
    jloop = jax_phone_loop(jnp.float64)
    loop = to_port(jloop, torch.float64)
    x, mask = _data(np.float64)
    jelbos, jloop = _jax_steps(jloop, x, mask)
    elbos, loop = _port_steps(loop, x, mask)
    close(elbos, jelbos, RTOL_F64)
    assert np.all(np.diff(elbos) > 0)
    got, want = loop.to_numpy(), phone_loop_to_numpy(jloop)
    for k in ("modelset_posterior", "sticks_posterior"):
        close(got[k], want[k], RTOL_F64, atol=1e-12)


@pytest.mark.parametrize("jax_route", ["general", "fused_lane_major"])
def test_vb_steps_f32_within_bar(jax_route, request):
    if jax_route == "fused_lane_major":
        request.getfixturevalue("jax_fused_lane_major")
    jloop = jax_phone_loop(jnp.float32)
    loop = to_port(jloop, torch.float32)
    x, mask = _data(np.float32)
    assert jloop._fused_estep_ok() == (jax_route != "general")
    jelbos, _ = _jax_steps(jloop, x, mask)
    elbos, _ = _port_steps(loop, x, mask)
    frames = float(mask.sum())
    assert np.all(np.isfinite(elbos))
    assert np.max(np.abs(elbos - jelbos)) / frames <= ELBO_PER_FRAME_F32


def test_decode_units_match_jax():
    jloop = jax_phone_loop(jnp.float64)
    loop = to_port(jloop, torch.float64)
    x, mask = _data(np.float64, seed=3)
    jpaths, jscores = jloop.decode_units(jnp.asarray(x), jnp.asarray(mask))
    paths, scores = loop.decode_units(t(x), t(mask))
    assert paths.dtype == torch.int32
    lengths, _ = lengths_and_mask(T)
    for b in np.flatnonzero(lengths):
        np.testing.assert_array_equal(paths[b, :lengths[b]].numpy(),
                                      np.asarray(jpaths)[b, :lengths[b]])
        close(scores[b], jscores[b], RTOL_F64)


def test_zero_length_row_contributes_nothing():
    loop = to_port(jax_phone_loop(jnp.float64), torch.float64)
    x, mask = _data(np.float64)
    lz, acc = bt.elbo_and_stats(loop, t(x), mask=t(mask))
    lz3, acc3 = bt.elbo_and_stats(loop, t(x[:3]), mask=t(mask[:3]))
    close(lz, lz3, RTOL_F64)
    for a, b in ((acc["modelset"]["means_precisions"], acc3["modelset"]["means_precisions"]),
                 (acc["unit_prior"]["sticks"], acc3["unit_prior"]["sticks"])):
        close(a, b, RTOL_F64, atol=1e-12)


def test_datasize_scaling_and_veneer_match_jax():
    jloop = jax_phone_loop(jnp.float64)
    loop = to_port(jloop, torch.float64)
    x, mask = _data(np.float64)
    jelbo, jacc = jax_elbo_and_stats(jloop, jnp.asarray(x), datasize=40,
                                     mask=jnp.asarray(mask))
    elbo = bt.evidence_lower_bound(loop, t(x), datasize=40, mask=t(mask))
    close(float(elbo), float(jelbo), RTOL_F64)
    close(elbo.acc["modelset"]["means_precisions"],
          jacc["modelset"]["means_precisions"], RTOL_F64, atol=1e-12)
    twin = copy.deepcopy(loop)
    optim = bt.VBConjugateOptimizer(loop, lrate=0.5)
    optim.init_step()
    optim.step(elbo.backward())
    bt.vb_step(twin, t(x), datasize=40, lrate=0.5, mask=t(mask))
    close(optim.model.to_numpy()["modelset_posterior"], twin.to_numpy()["modelset_posterior"],
          0.0)


def test_plain_scan_flag_keeps_results():
    """``plain_scan`` forces the plain kernel versions; on CPU tensors the
    wrappers run them anyway, so both routes agree exactly."""
    loop = to_port(jax_phone_loop(jnp.float64), torch.float64)
    plain = copy.deepcopy(loop)
    plain.plain_scan = True
    x, mask = _data(np.float64)
    e1, _ = bt.vb_step(loop, t(x), mask=t(mask))
    e2, _ = bt.vb_step(plain, t(x), mask=t(mask))
    assert float(e1) == float(e2)
    p1, _ = loop.decode(t(x), t(mask))
    p2, _ = plain.decode(t(x), t(mask))
    assert torch.equal(p1, p2)


def test_import_loads_no_jax():
    code = ("import sys, beer_tpu_torch, beer_tpu_torch.models.hmm, beer_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'beer_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_hundred_unit_loop_matches_jax_general_path_f64():
    """A 100-unit phone loop (S = 300, D = 39, P = 78), above the 95 units
    whose W and moments the first K2 held in one block: the port's fused
    route (the plain versions of K1 and K2 on the CPU, the arithmetic of
    the kernels' global placement) against ``beer_tpu``'s float64 general
    path, log Z and statistics at rtol 1e-9, then one VB step."""
    jloop = jax_phone_loop(jnp.float64, n_units=100, dim=39)
    loop = to_port(jloop, torch.float64)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 20, 39))
    mask = (np.arange(20)[None] < np.array([[20], [13]])).astype(np.float64)

    @jax.jit
    def reference(m, xx, mm):
        stats = m.sufficient_statistics(xx)
        lz, cache = m.infer(stats, mm)
        return lz, m.accumulate(stats, cache), jax_vb_step(m, xx, mask=mm)[0]

    jlz, jacc, jelbo = reference(jloop, jnp.asarray(x), jnp.asarray(mask))
    stats = loop.sufficient_statistics(t(x))
    lz, cache = loop.infer(stats, t(mask))
    assert "alpha" in cache  # the fused route
    acc = loop.accumulate(stats, cache)
    close(lz, jlz, RTOL_F64)
    close(acc["modelset"]["means_precisions"], jacc["modelset"]["means_precisions"],
          RTOL_F64, atol=1e-12)
    close(acc["unit_prior"]["sticks"], jacc["unit_prior"]["sticks"], RTOL_F64, atol=1e-12)
    elbo, _ = bt.vb_step(loop, t(x), mask=t(mask))
    close(float(elbo), float(jelbo), RTOL_F64)
