"""The port's general path (K12–K15 plain versions, routing, gradients)
against beer_tpu.

``beer_tpu_torch/ops/cuda_scan.py`` gives the general probability-space
path two kernels — K12 ``scaled_pass`` (dense forward, banded forward,
dense reverse) and K13 ``smoothing_pass`` (dense, banded) — and K5/K7
two further modes, K14 (``forward_llh_dense(return_shifts=True)``) and
K15 (``estep_gamma_dense(rows=, cols=)``).  On the CPU their wrappers run
the plain PyTorch versions, which are held here against

* the Pallas TPU kernels they replace (``forward_pass``,
  ``forward_pass_banded``, ``backward_pass``, ``backward_smoothing_pass``,
  ``backward_smoothing_banded``, ``forward_llh_pass``,
  ``phone_loop_estep_pass``) run with ``interpret=True`` in float32:
  rtol 1e-5 with atol 5e-6 (the sums over S run in another order; the
  TPU kernels of the raw-llh pair propagate through a three-pass bf16
  product and gather ξ by a one-hot product, so those two hold rtol 2e-4
  as in the JAX package's own test), on valid frames where the port
  documents that masked frames differ;
* the JAX scans ``_scaled_pass`` / ``_smoothing_scan`` and the general
  path built on them (``forward_backward_probs``, ``forward_backward``,
  both ``expected_transition_counts*``, ``phone_loop_estep_reference``,
  ``PhoneLoop.smooth`` + ``accumulate``) in float64, rtol 1e-9;
* ``jax.grad`` through the JAX general path and ``gradcheck`` for the
  ``autograd.Function`` route (kernel forward, plain recursion
  differentiated in the backward).

Shapes: S = 7 dense states with forbidden arcs and per-row init/final
vectors, or a 4-unit × 3-state phone loop's bands (S = 12); B = 4 with one
full, two ragged and one zero-length row; T = 20.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beer_tpu.ops import pallas_scan
from beer_tpu.ops import semiring_scan as jss
from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.ops import semiring_scan as tss
from port_util import (B, SPU, T, U, close, dense_problem, jax_phone_loop, lengths_and_mask,
                       scan_problem, t, to_port, underflow_problem)

S_DENSE = 7
RTOL_F32, ATOL_F32, RTOL_F64 = 1e-5, 5e-6, 1e-9
INSTANCES = ["dense_forward", "banded_forward", "dense_reverse"]


def _problem(kind: str, seed: int = 11, lengths=None) -> dict:
    """numpy operands of the general path: llh, e_llh, mask, lengths, the
    dense matrix (and the bands for ``kind`` "banded"), per-row init and
    final vectors; B rows of T frames, or a row a length of ``lengths``."""
    b, t_len = (B, T) if lengths is None else (len(lengths), max(max(lengths), 1))
    if kind == "banded":
        pb = scan_problem(seed, U, SPU, 6, b, t_len, lengths=lengths)
        s = U * SPU
        pb["trans"] = np.asarray(tss.bands_to_dense(t(pb["bands"])))
        pb["init"] = np.broadcast_to(pb["init"], (b, s)).copy()
        pb["final"] = np.broadcast_to(pb["final"], (b, s)).copy()
    else:
        pb = dense_problem(seed, S_DENSE, 6, b, t_len, lengths)
    llh = pb["stats"] @ pb["w"].T + pb["bias"]
    m = pb["mask"][..., None]
    pb["llh"] = llh
    pb["e_llh"] = np.exp(llh - llh.max(-1, keepdims=True)) * m + (1 - m)
    return pb


def _torch_ops(pb, dtype):
    f = lambda k: t(pb[k], dtype)  # noqa: E731
    out = {k: f(k) for k in ("llh", "e_llh", "mask", "trans", "init", "final")}
    out["lens"] = t(pb["lengths"], torch.int32)
    if "bands" in pb:
        out["bands"] = f("bands")
    return out


def _jax_ops(pb, dtype):
    out = {k: jnp.asarray(pb[k], dtype) for k in ("llh", "e_llh", "mask", "trans", "init", "final")}
    if "bands" in pb:
        out["bands"] = tuple(jnp.asarray(v, dtype) for v in pb["bands"])
    return out


def _port_scaled(a, instance):
    banded, reverse = instance == "banded_forward", instance == "dense_reverse"
    return cuda_scan.scaled_pass(a["e_llh"], a["lens"], a["bands"] if banded else a["trans"],
                                 a["final"] if reverse else a["init"], banded=banded,
                                 reverse=reverse)


def _port_smoothing(a, banded, a_probs):
    return cuda_scan.smoothing_pass(a["e_llh"], a_probs, a["lens"],
                                    a["bands"] if banded else a["trans"], a["final"],
                                    banded=banded)


def _valid(x, mask):
    """Zero the frames t >= len of a (B, T[, S]) array."""
    x = np.asarray(x, np.float64)
    return x * (mask[..., None] if x.ndim == 3 else mask)


# ----------------------------------------------------------------------
# float32: against the Pallas kernels in interpret mode
# ----------------------------------------------------------------------
def _scaled_vs_pallas(pb, instance):
    j, a = _jax_ops(pb, jnp.float32), _torch_ops(pb, torch.float32)
    if instance == "dense_forward":
        probs, logcs, _ = pallas_scan.forward_pass(j["e_llh"], j["trans"], j["init"], j["mask"],
                                                   interpret=True)
    elif instance == "banded_forward":
        probs, logcs, _ = pallas_scan.forward_pass_banded(j["e_llh"], j["bands"], j["init"],
                                                          j["mask"], interpret=True)
    else:
        probs, logcs, _ = pallas_scan.backward_pass(j["e_llh"], j["trans"], j["final"], j["mask"],
                                                    interpret=True)
    got = _port_scaled(a, instance)
    # masked frames repeat the carry in both: the whole arrays compare,
    # the zero-length row (normalise(vec) everywhere) included
    close(got[0], probs, RTOL_F32, ATOL_F32)
    close(got[1], logcs, RTOL_F32, ATOL_F32)


@pytest.mark.parametrize("instance", INSTANCES)
def test_scaled_pass_plain_vs_pallas_interpret(instance):
    _scaled_vs_pallas(_problem("banded" if instance == "banded_forward" else "dense"), instance)


def _smoothing_vs_pallas(pb, banded):
    j, a = _jax_ops(pb, jnp.float32), _torch_ops(pb, torch.float32)
    a_probs, _ = _port_scaled(a, "banded_forward" if banded else "dense_forward")
    ja = jnp.asarray(a_probs.numpy())
    if banded:
        want = pallas_scan.backward_smoothing_banded(j["e_llh"], j["bands"], j["final"], j["mask"],
                                                     ja, interpret=True)
    else:
        want = pallas_scan.backward_smoothing_pass(j["e_llh"], j["trans"], j["final"], j["mask"],
                                                   ja, interpret=True)
    got = _port_smoothing(a, banded, a_probs)
    for name, x, y in zip(("gamma", "w_probs", "w_sums", "post_norm"), got, want):
        np.testing.assert_allclose(_valid(x, pb["mask"]), _valid(y, pb["mask"]), rtol=RTOL_F32,
                                   atol=ATOL_F32, err_msg=name)
    assert not got[0][t(pb["mask"]) == 0].any()


@pytest.mark.parametrize("banded", [False, True], ids=["dense", "banded"])
def test_smoothing_pass_plain_vs_pallas_interpret(banded):
    _smoothing_vs_pallas(_problem("banded" if banded else "dense"), banded)


# lengths 0 to 17: every residue modulo the frames a chunk the banded kernels
# take (16, 8, 4, 2, 1) with C − 1, C and C + 1 among them, and a group of
# the dense kernels' sorted rows ending at each length
RESIDUE_LENGTHS = list(range(18))


@pytest.mark.parametrize("instance", INSTANCES + ["dense_smoothing", "banded_smoothing"])
def test_general_plain_versions_vs_pallas_interpret_at_every_residue(instance):
    """The plain versions of K12's three instances and K13's two against the
    Pallas kernels (interpret mode, this file's float32 tolerances) on rows
    of every length 0 to 17."""
    banded = instance.startswith("banded")
    pb = _problem("banded" if banded else "dense", seed=12, lengths=RESIDUE_LENGTHS)
    if instance.endswith("smoothing"):
        _smoothing_vs_pallas(pb, banded)
    else:
        _scaled_vs_pallas(pb, instance)


def test_smoothing_banded_underflow_vs_pallas_interpret():
    """Where α̂·u1 underflows (an untrained loop over long utterances,
    ``port_util.underflow_problem``; ROADMAP §C.1) γ sums to 0, and the
    plain version's per-element order (ab = α̂·(u1/ν) with ν floored, then
    Σab) gives 0 on the frames where the Pallas kernel does; elsewhere they
    agree at this file's float32 tolerances.  JAX's CPU backend flushes
    subnormals to zero and torch's does not, so the plain version runs here
    with ``torch.set_flush_denormal(True)``, the same arithmetic; on the card
    neither the kernel nor the plain version flushes, and
    ``test_torch_cuda.py`` holds them to each other on this case."""
    pb = underflow_problem()
    mask = pb["mask"]
    bands = tuple(jnp.asarray(v, jnp.float32) for v in pb["bands"])
    j = {k: jnp.asarray(pb[k], jnp.float32) for k in ("e_llh", "init", "final", "mask")}
    a = {k: t(pb[k], torch.float32) for k in ("e_llh", "init", "final", "bands")}
    lens = t(pb["lengths"], torch.int32)
    flushed = torch.set_flush_denormal(True)
    assert flushed, "this CPU cannot flush subnormals"
    try:
        a_probs, _ = cuda_scan.scaled_pass_plain(a["e_llh"], lens, a["bands"], a["init"], banded=True)
        got = cuda_scan.smoothing_pass_plain(a["e_llh"], a_probs, lens, a["bands"], a["final"], banded=True)
    finally:
        torch.set_flush_denormal(False)
    want = pallas_scan.backward_smoothing_banded(j["e_llh"], bands, j["final"], j["mask"],
                                                 jnp.asarray(a_probs.numpy()), interpret=True)
    zero_got = (got[0].numpy().sum(-1) == 0) & (mask > 0)
    zero_want = (np.asarray(want[0]).sum(-1) == 0) & (mask > 0)
    assert zero_got.sum() >= 20, "the case must underflow"
    np.testing.assert_array_equal(zero_got, zero_want)
    for name, x, y in zip(("gamma", "w_probs", "w_sums", "post_norm"), got, want):
        np.testing.assert_allclose(_valid(x, mask), _valid(y, mask), rtol=RTOL_F32, atol=ATOL_F32, err_msg=name)


def test_forward_llh_shifts_plain_vs_pallas_interpret():
    """K14's plain version against ``forward_llh_pass``: α̂ (the carry on
    masked frames), per-step norms (1 there), masked row-max shifts."""
    pb = _problem("dense")
    j, a = _jax_ops(pb, jnp.float32), _torch_ops(pb, torch.float32)
    probs, norms, shifts = pallas_scan.forward_llh_pass(
        jnp.swapaxes(j["llh"], 0, 1), j["trans"], j["init"], j["mask"], interpret=True)
    alpha, got_norms, got_shifts = tss.forward_llh(a["llh"], a["trans"], a["init"], a["lens"])
    close(alpha, jnp.swapaxes(probs, 0, 1), 2e-4, 1e-5)
    close(got_norms, norms.T, 2e-4, 1e-5)
    close(got_shifts, shifts.T, RTOL_F32, ATOL_F32)


def test_restricted_estep_plain_vs_pallas_interpret():
    """K15's plain version against ``phone_loop_estep_pass`` on the
    (unit ends × unit starts) block of a phone-loop-shaped matrix."""
    pb = _problem("banded")
    j, a = _jax_ops(pb, jnp.float32), _torch_ops(pb, torch.float32)
    s = U * SPU
    rows, cols = pb["ends"], pb["starts"]
    alpha, norms, _ = tss.forward_llh(a["llh"], a["trans"], a["init"], a["lens"])
    gamma, xi = tss.phone_loop_estep(a["llh"], alpha, norms, a["trans"], a["final"], a["lens"],
                                     t(rows, torch.int32), t(cols, torch.int32))
    sel_r = jax.nn.one_hot(rows, s, dtype=jnp.float32).T
    sel_c = jax.nn.one_hot(cols, s, dtype=jnp.float32).T
    gamma_tm, xi_ref = pallas_scan.phone_loop_estep_pass(
        jnp.swapaxes(j["llh"], 0, 1), jnp.swapaxes(jnp.asarray(alpha.numpy()), 0, 1),
        jnp.asarray(norms.numpy()).T, j["trans"], j["final"], j["mask"], sel_r, sel_c,
        interpret=True)
    close(gamma, jnp.swapaxes(gamma_tm, 0, 1), 2e-4, 1e-5)
    close(xi, xi_ref, 2e-4, 1e-5)
    assert xi.shape == (U, U)


# ----------------------------------------------------------------------
# float64: against the JAX scans and the general path built on them
# ----------------------------------------------------------------------
@pytest.mark.parametrize("instance", INSTANCES)
def test_scaled_pass_plain_vs_jax_scan_f64(instance):
    pb = _problem("banded" if instance == "banded_forward" else "dense")
    j, a = _jax_ops(pb, jnp.float64), _torch_ops(pb, torch.float64)
    reverse = instance == "dense_reverse"
    probs, logcs, _ = jss._scaled_pass(j["e_llh"], j["trans"], j["final" if reverse else "init"],
                                       j["mask"], reverse=reverse)
    got = _port_scaled(a, instance)
    close(got[0], probs, RTOL_F64, 1e-300)
    close(got[1], logcs, RTOL_F64, 1e-12)


@pytest.mark.parametrize("banded", [False, True], ids=["dense", "banded"])
def test_smoothing_pass_plain_vs_jax_scan_f64(banded):
    pb = _problem("banded" if banded else "dense")
    j, a = _jax_ops(pb, jnp.float64), _torch_ops(pb, torch.float64)
    a_probs, _, _ = jss._scaled_pass(j["e_llh"], j["trans"], j["init"], j["mask"], reverse=False)
    want = jss._smoothing_scan(j["e_llh"], j["trans"], j["final"], j["mask"], a_probs)
    got = _port_smoothing(a, banded, t(np.asarray(a_probs)))
    for name, x, y in zip(("gamma", "w_probs", "w_sums", "post_norm"), got, want):
        # the plain version runs the same recursion on masked frames too
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL_F64, atol=1e-300,
                                   err_msg=name)


def _log_graph(pb, dtype, per_utterance=False):
    """log_trans/log_init/log_final of a problem for both packages."""
    with np.errstate(divide="ignore"):
        lt, li, lf = (np.maximum(np.log(pb[k]), -1e30) for k in ("trans", "init", "final"))
    if per_utterance:
        rng = np.random.default_rng(5)
        trans = pb["trans"][None] * rng.uniform(0.5, 1.0, size=(B, 1, 1))
        lt = np.maximum(np.log(np.maximum(trans, 1e-300)), -1e30)
        lt[np.broadcast_to(pb["trans"][None] == 0, lt.shape)] = -1e30
    return lt, li, lf


@pytest.mark.parametrize("route", ["dense", "banded", "per_utterance", "plain"])
def test_forward_backward_probs_vs_jax_f64(route):
    pb = _problem("banded" if route == "banded" else "dense")
    lt, li, lf = _log_graph(pb, np.float64, per_utterance=route == "per_utterance")
    want = jss.forward_backward_probs(*(jnp.asarray(x) for x in (pb["llh"], lt, li, lf, pb["mask"])))
    bands = t(pb["bands"]) if route == "banded" else None
    got = tss.forward_backward_probs(t(pb["llh"]), t(lt), t(li), t(lf), t(pb["mask"]),
                                     structured_trans=bands, plain=route == "plain")
    close(got.log_z, want.log_z, RTOL_F64)
    close(got.posteriors, want.posteriors, RTOL_F64, 1e-300)
    close(got.probs_fwd, want.probs_fwd, RTOL_F64, 1e-300)
    close(got.fwd_log_scales, want.fwd_log_scales, RTOL_F64, 1e-12)
    for name in ("probs_w", "w_sums", "post_norm"):
        close(_valid(getattr(got, name), pb["mask"]), _valid(getattr(want, name), pb["mask"]),
              RTOL_F64, 1e-300)
    # ξ from the by-products, full and restricted
    xi = tss.expected_transition_counts_probs(got, t(lt), t(pb["mask"]))
    if route != "per_utterance":   # the JAX function weighs by one shared matrix only
        xi_ref = jss.expected_transition_counts_probs(want, jnp.asarray(lt),
                                                      jnp.asarray(pb["mask"]))
        close(xi, xi_ref, RTOL_F64, 1e-300)
    assert float(xi.sum()) == pytest.approx(float(np.maximum(pb["lengths"] - 1, 0).sum()), rel=1e-9)


@pytest.mark.parametrize("restricted", [False, True], ids=["full", "restricted"])
def test_log_domain_forward_backward_and_counts_vs_jax_f64(restricted):
    pb = _problem("banded")
    lt, li, lf = _log_graph(pb, np.float64)
    j = [jnp.asarray(x) for x in (pb["llh"], lt, li, lf, pb["mask"])]
    want = jss.forward_backward(*j)
    got = tss.forward_backward(t(pb["llh"]), t(lt), t(li), t(lf), t(pb["mask"]))
    full = pb["lengths"] > 0
    close(got.log_z[full], want.log_z[full], RTOL_F64)
    close(got.posteriors, want.posteriors, RTOL_F64, 1e-300)
    m = pb["mask"][..., None]
    close(got.log_alpha.numpy() * m, np.asarray(want.log_alpha) * m, RTOL_F64, 1e-9)
    close(got.log_beta.numpy() * m, np.asarray(want.log_beta) * m, RTOL_F64, 1e-9)
    rows, cols = (pb["ends"], pb["starts"]) if restricted else (None, None)
    opt = lambda x, mk: None if x is None else mk(x)  # noqa: E731
    xi = tss.expected_transition_counts(got.log_alpha, got.log_beta, t(pb["llh"]), t(lt),
                                        t(pb["mask"]), rows=opt(rows, t), cols=opt(cols, t))
    xi_ref = jss.expected_transition_counts(want.log_alpha, want.log_beta, j[0], j[1], want.log_z,
                                            j[4], rows=opt(rows, jnp.asarray),
                                            cols=opt(cols, jnp.asarray))
    close(xi, xi_ref, RTOL_F64, 1e-300)
    # the two ξ routes agree, and the probability-space one restricts alike
    fbp = tss.forward_backward_probs(t(pb["llh"]), t(lt), t(li), t(lf), t(pb["mask"]))
    xi_p = tss.expected_transition_counts_probs(fbp, t(lt), t(pb["mask"]), rows=opt(rows, t),
                                                cols=opt(cols, t))
    xi_p_ref = jss.expected_transition_counts_probs(
        jss.forward_backward_probs(*j), j[1], j[4], rows=opt(rows, jnp.asarray),
        cols=opt(cols, jnp.asarray))
    close(xi_p, xi_p_ref, RTOL_F64, 1e-300)
    close(xi_p, xi, 1e-8, 1e-12)


def test_fused_llh_pair_vs_jax_reference_f64():
    """forward_llh (K14) + phone_loop_estep (K15) against the JAX
    package's ``_fwd_llh_reference`` and ``phone_loop_estep_reference``,
    and against the port's own reference composition."""
    pb = _problem("banded")
    lt, li, lf = _log_graph(pb, np.float64)
    a = _torch_ops(pb, torch.float64)
    rows, cols = pb["ends"], pb["starts"]
    alpha, norms, shifts = tss.forward_llh(a["llh"], a["trans"], a["init"], a["lens"])
    p_ref, n_ref, s_ref = jss._fwd_llh_reference(
        jnp.swapaxes(jnp.asarray(pb["llh"]), 0, 1), jnp.asarray(pb["trans"]),
        jnp.asarray(pb["init"]), jnp.asarray(pb["mask"]))
    close(alpha, jnp.swapaxes(p_ref, 0, 1), RTOL_F64, 1e-300)
    close(norms, n_ref.T, 1e-8)        # the reference recovers norms as exp(Δ logc)
    close(shifts, s_ref.T, RTOL_F64, 1e-300)
    gamma, xi = tss.phone_loop_estep(a["llh"], alpha, norms, a["trans"], a["final"], a["lens"],
                                     t(rows, torch.int32), t(cols, torch.int32))
    g_ref, xi_ref = jss.phone_loop_estep_reference(
        *(jnp.asarray(x) for x in (pb["llh"], lt, li, lf, pb["mask"])), jnp.asarray(rows),
        jnp.asarray(cols))
    close(gamma, g_ref, 1e-8, 1e-300)
    close(xi, xi_ref, 1e-8, 1e-300)
    g_port, xi_port = tss.phone_loop_estep_reference(t(pb["llh"]), t(lt), t(li), t(lf),
                                                     t(pb["mask"]), t(rows), t(cols))
    close(g_port, g_ref, RTOL_F64, 1e-300)
    close(xi_port, xi_ref, RTOL_F64, 1e-300)
    # log Z = Σ log c + Σ shift + log Σ α̂_last·final
    log_z = torch.log(norms).sum(1) + shifts.sum(1) + torch.log((alpha[:, -1] * a["final"]).sum(-1))
    fb = jss.forward_backward_probs(*(jnp.asarray(x) for x in (pb["llh"], lt, li, lf, pb["mask"])))
    full = pb["lengths"] > 0
    close(log_z[full], fb.log_z[full], RTOL_F64)


def test_forward_llh_shifts_contract_on_masked_frames():
    """K14's contract where it differs from K5's: an empty row carries
    normalise(init) with norm_0 = Σ init; masked frames repeat α̂."""
    pb = _problem("dense")
    a = _torch_ops(pb, torch.float64)
    k5 = cuda_scan.forward_llh_dense(a["llh"], a["lens"], a["trans"], a["init"])
    k14 = cuda_scan.forward_llh_dense(a["llh"], a["lens"], a["trans"], a["init"],
                                      return_shifts=True)
    valid = t(pb["mask"]) > 0
    assert torch.equal(k14[0][valid], k5[0][valid]) and torch.equal(k14[1][valid], k5[1][valid])
    empty = int(np.flatnonzero(pb["lengths"] == 0)[0])
    want = a["init"][empty] / a["init"][empty].sum()
    close(k14[0][empty], want.expand(T, -1), 1e-12)
    close(k14[1][empty, 0], a["init"][empty].sum(), 1e-12)
    assert (k14[1][empty, 1:] == 1).all() and not k14[4][empty].any()
    row = 2                                           # length 5
    assert torch.equal(k14[0][row, 5:], k14[0][row, 4].expand(T - 5, -1))
    assert not k5[0][row, 5:].any()
    close(k14[3][pb["lengths"] > 0], k5[3][pb["lengths"] > 0], 1e-12)
    with pytest.raises(ValueError):
        cuda_scan.forward_llh_dense(a["llh"], a["lens"], a["trans"], a["init"], a["trans"],
                                    a["init"][0], return_shifts=True)


# ----------------------------------------------------------------------
# The gradient of the kernel route
# ----------------------------------------------------------------------
def _jax_objective(llh, lt, li, lf, mask, weights):
    fb = jss.forward_backward_probs(llh, lt, li, lf, mask)
    return (fb.log_z * (mask.sum(-1) > 0)).sum() + (fb.posteriors * weights).sum()


@pytest.mark.parametrize("banded", [False, True], ids=["dense", "banded"])
def test_general_path_gradient_vs_jax_grad(banded):
    """d/d llh and d/d log_trans of log Z + a weighted sum of posteriors:
    the port's autograd route (ScaledPass + SmoothingPass) against
    ``jax.grad`` through the JAX general path, float64."""
    pb = _problem("banded")
    lt, li, lf = _log_graph(pb, np.float64)
    weights = np.linspace(0.5, 1.5, U * SPU)
    # jax.grad gives NaN on a zero-length row (0 · ∞ in its masked steps):
    # the JAX side runs on the three rows that have frames, the port on all
    # four, where the empty row must add exactly nothing
    full_np = pb["lengths"] > 0
    g_llh, g_lt = jax.grad(_jax_objective, argnums=(0, 1))(
        jnp.asarray(pb["llh"][full_np]), jnp.asarray(lt), jnp.asarray(li[full_np]),
        jnp.asarray(lf[full_np]), jnp.asarray(pb["mask"][full_np]), jnp.asarray(weights))
    llh, log_trans = t(pb["llh"]).requires_grad_(), t(lt).requires_grad_()
    bands = t(pb["bands"]) if banded else None
    fb = tss.forward_backward_probs(llh, log_trans, t(li), t(lf), t(pb["mask"]),
                                    structured_trans=bands)
    assert isinstance(fb.probs_fwd.grad_fn, tss.ScaledPass._backward_cls)
    assert isinstance(fb.posteriors.grad_fn, tss.SmoothingPass._backward_cls)
    full = t(pb["lengths"] > 0)
    (fb.log_z[full].sum() + (fb.posteriors * t(weights)).sum()).backward()
    close(llh.grad[full], g_llh, 1e-8, 1e-12)
    assert not llh.grad[~full].any()
    if not banded:   # the bands carry the banded route's transition gradient
        close(log_trans.grad, g_lt, 1e-8, 1e-12)


@pytest.mark.parametrize("case", INSTANCES + ["smoothing_dense", "smoothing_banded"])
def test_general_path_functions_gradcheck(case):
    pb = _problem("banded", seed=13)
    a = _torch_ops(pb, torch.float64)
    sl = slice(0, 3)                                   # keep gradcheck small: 3 rows × 6 frames
    e, lens = a["e_llh"][sl, :6].clone(), torch.tensor([6, 4, 0], dtype=torch.int32)
    e[1, 4:], e[2] = 1.0, 1.0
    banded = case in ("banded_forward", "smoothing_banded")
    mat = (a["bands"] if banded else a["trans"]).clone().requires_grad_()
    init, final = a["init"][sl].clone().requires_grad_(), a["final"][sl].clone().requires_grad_()
    e.requires_grad_()
    if case.startswith("smoothing"):
        a_probs = cuda_scan.scaled_pass(e.detach(), lens, a["trans"], a["init"][sl])[0]
        a_probs = a_probs.clone().requires_grad_()
        fn = lambda e_, a_, m_, f_: tss.SmoothingPass.apply(e_, a_, m_, f_, lens, banded)  # noqa: E731
        args = (e, a_probs, mat, final)
    else:
        reverse = case == "dense_reverse"
        fn = lambda e_, m_, v_: tss.ScaledPass.apply(e_, m_, v_, lens, banded, reverse)  # noqa: E731
        args = (e, mat, final if reverse else init)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6, rtol=1e-5)


def test_general_wrappers_refuse_inputs_that_require_grad():
    pb = _problem("dense")
    a = _torch_ops(pb, torch.float64)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_scan.scaled_pass(a["e_llh"].requires_grad_(), a["lens"], a["trans"], a["init"])
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_scan.smoothing_pass(a["e_llh"].detach(), a["e_llh"].detach(), a["lens"],
                                 a["trans"].requires_grad_(), a["final"])
    with pytest.raises(NotImplementedError):
        cuda_scan.scaled_pass(a["e_llh"].detach(), a["lens"], a["trans"].detach(), a["final"],
                              banded=True, reverse=True)


def test_kernel_route_refuses_a_mask_with_a_gap():
    pb = _problem("dense")
    a = _torch_ops(pb, torch.float64)
    llh = torch.log(a["e_llh"])
    log_trans, log_vec = torch.log(a["trans"]), torch.log(a["init"].clamp_min(1e-300))
    mask = torch.ones(llh.shape[:2], dtype=llh.dtype)
    mask[0, 1] = 0.0
    with pytest.raises(ValueError, match="prefix"):
        tss.forward_backward_probs(llh, log_trans, log_vec, log_vec, mask)
    fb = tss.forward_backward_probs(llh, log_trans, log_vec, log_vec, mask, plain=True)
    assert float(fb.posteriors[0, 1].abs().sum()) == 0.0
    assert bool(torch.isfinite(fb.log_z).all())


# ----------------------------------------------------------------------
# PhoneLoop.smooth + accumulate
# ----------------------------------------------------------------------
@pytest.mark.parametrize("banded", [False, True], ids=["dense", "banded"])
def test_phone_loop_smooth_and_accumulate_vs_jax(banded):
    jl = jax_phone_loop(jnp.float64)
    loop = to_port(jl, torch.float64)
    rng = np.random.default_rng(3)
    _, mask = lengths_and_mask()
    x = rng.normal(size=(B, T, 3))
    js = jl.sufficient_statistics(jnp.asarray(x))
    lz_ref, cache_ref = jl.smooth(js, jnp.asarray(mask))
    acc_ref = jl.accumulate(js, cache_ref)
    stats = loop.sufficient_statistics(t(x))
    lz, cache = loop.smooth(stats, t(mask))
    if not banded:
        # smooth always passes the bands: the dense instances give the same cache
        fb = tss.forward_backward_probs(cache["llh_states"], cache["graph"].log_trans,
                                        cache["graph"].log_init, cache["graph"].log_final, t(mask))
        lz, cache = fb.log_z * (t(mask).sum(-1) > 0), dict(cache, posteriors=fb.posteriors, fb=fb)
    acc = loop.accumulate(stats, cache)
    close(lz, lz_ref, RTOL_F64)
    close(cache["posteriors"], cache_ref["posteriors"], RTOL_F64, 1e-300)
    close(acc["modelset"]["means_precisions"], acc_ref["modelset"]["means_precisions"], RTOL_F64,
          1e-12)
    close(acc["unit_prior"]["sticks"], acc_ref["unit_prior"]["sticks"], RTOL_F64, 1e-12)
    # the plain route is the same function
    loop.plain_scan = True
    lz_plain, cache_plain = loop.smooth(stats, t(mask))
    close(lz_plain, lz, 1e-12)
    close(cache_plain["posteriors"], cache["posteriors"], 1e-12, 1e-300)


# ----------------------------------------------------------------------
# the log-carry recursions and the associative scan
# ----------------------------------------------------------------------
def _hmm_params(rng, s):
    """``tests/test_hmm.py::random_hmm_params``: a full stochastic matrix,
    init and final vectors, in the log domain."""
    trans = rng.uniform(0.1, 1.0, size=(s, s))
    trans /= trans.sum(1, keepdims=True)
    init = rng.uniform(0.1, 1.0, size=s)
    return np.log(trans), np.log(init / init.sum()), np.log(rng.uniform(0.1, 1.0, size=s))


def _scan_case(per_utterance=False):
    """``tests/test_hmm.py``'s associative-scan case: T = 33, S = 5, lengths
    33, 20, 7 (with ``per_utterance``, one matrix per sequence)."""
    rng = np.random.default_rng(42)
    lt, li, lf = _hmm_params(rng, 5)
    if per_utterance:
        lt = np.stack([lt, _hmm_params(rng, 5)[0], _hmm_params(rng, 5)[0]])
    llh = rng.normal(size=(3, 33, 5))
    lengths = np.array([33, 20, 7])
    mask = (np.arange(33)[None] < lengths[:, None]).astype(np.float64)
    return llh, lt, li, lf, mask, lengths


@pytest.mark.parametrize("per_utterance", [False, True], ids=["shared", "per_utterance"])
def test_log_carry_forward_backward_vs_jax_f64(per_utterance):
    """``forward`` (log α and the final carry) and ``backward`` (log β) on a
    ragged batch, as the JAX package's ``lax.scan`` versions."""
    llh, lt, li, lf, mask, _ = _scan_case(per_utterance)
    a_j, last_j = jss.forward(*map(jnp.asarray, (llh, lt, li, mask)))
    a_t, last_t = tss.forward(*map(t, (llh, lt, li, mask)))
    close(a_t, a_j, 1e-10)
    close(last_t, last_j, 1e-10)
    close(tss.backward(*map(t, (llh, lt, lf, mask))),
          jss.backward(*map(jnp.asarray, (llh, lt, lf, mask))), 1e-10, atol=1e-12)
    # without a mask the final carry is log α at the last frame
    a_t, last_t = tss.forward(t(llh), t(lt), t(li))
    close(last_t, a_t[:, -1], 0)


@pytest.mark.parametrize("chunk", [None, 4, 8, 16, 33, 64])
def test_forward_assoc_vs_jax_f64(chunk):
    """The associative scan, whole or in blocks of ``chunk`` frames (ragged
    tails, chunks that do not divide T), against the JAX package's and the
    sequential ``forward``, on each sequence's valid frames."""
    llh, lt, li, _, mask, lengths = _scan_case()
    args_t, args_j = map(t, (llh, lt, li, mask)), map(jnp.asarray, (llh, lt, li, mask))
    a_t, last_t = tss.forward_assoc(*args_t, chunk=chunk)
    a_j, last_j = jss.forward_assoc(*args_j, chunk=chunk)
    seq, last_seq = tss.forward(*map(t, (llh, lt, li, mask)))
    close(last_t, last_j, 1e-9)
    close(last_t, last_seq, 1e-9)
    for i, n in enumerate(lengths):
        close(a_t[i, :n], a_j[i, :n], 1e-9)
        close(a_t[i, :n], seq[i, :n], 1e-9)
