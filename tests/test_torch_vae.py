"""The port's structured VAE (BASELINE config 5) against beer_tpu.

JAX models and nnet parameters are carried into the port with
``beer_tpu_torch.convert.vae_from_numpy`` (the flax trees); both packages
see the same numpy data, and the reparameterisation noise ε is drawn on
the JAX side exactly as ``normal_rsample`` draws it and injected into the
port (``eps``): JAX's random streams cannot be reproduced in torch.  The
port runs on the CPU, so its kernel wrappers run their plain versions;
the JAX side takes its general path (no Pallas kernel on the CPU), which
differentiates log Z by autodiff where the port uses the Fisher identity.

Tolerances: float64 throughout rtol 1e-9 (the same algorithm up to
summation order; an absolute floor of 1e-12 for entries that cancel to
~0), nnet building blocks rtol 1e-12; the float32 10-step trajectory
within 1e-4 ELBO per frame (BASELINE's correctness bar).

Shapes: B=4 utterances (one full, two ragged, one empty), T=12, D=5,
dz=2, hidden ≤ 8; the phone-loop prior has 2 units × 2 states, the HMM
prior 4 ergodic states, the frame-level priors a full-covariance Normal
and a 3-component full-covariance GMM.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import beer_tpu
import beer_tpu_torch as bt
from beer_tpu import nnet as jnnet
from beer_tpu.models import graph as jgraph
from beer_tpu.models.hmm import HMM as JaxHMM
from beer_tpu.models.vae import VAE as JaxVAE
from beer_tpu.models.vae import SequenceVAE as JaxSequenceVAE
from beer_tpu.models.vae import make_vae_train_step as jax_train_step
from beer_tpu.nnet import flows as jflows
from beer_tpu.ops import semiring_scan as jss
from beer_tpu.ops import stats_kernels as jsk
from beer_tpu_torch import nnet
from beer_tpu_torch.nnet import flows
from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.ops import semiring_scan as tss
from beer_tpu_torch.ops import stats_kernels as sk
from port_util import (close, dense_args, dense_problem, full_problem, hmm_to_numpy,
                       jax_phone_loop, mixture_to_numpy, normal_set_to_numpy, phone_loop_to_numpy,
                       port_args, scan_problem, t)

RTOL, ATOL = 1e-9, 1e-12
B, T, D_OBS, DZ, HIDDEN = 4, 12, 5, 2, (8, 8)
LENGTHS = np.array([T, T - 5, 4, 0])
F64, F32 = jnp.float64, jnp.float32


def _data(seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D_OBS)).astype(dtype)
    mask = (np.arange(T)[None] < LENGTHS[:, None]).astype(dtype)
    return x, mask


def _cast(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _np64(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float64)


def _close_trees(got, want, rtol=RTOL, atol=ATOL):
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(_np64(g), _np64(w), rtol=rtol, atol=atol, err_msg=path)


# ----------------------------------------------------------------------
# The models of each case, in JAX, and their port
# ----------------------------------------------------------------------
def _jax_prior(kind, dtype):
    if kind == "phone_loop":
        return jax_phone_loop(dtype, n_units=2, spu=2, dim=DZ, seed=5)
    if kind == "hmm":
        nset = beer_tpu.NormalSet.create(jnp.zeros(DZ, dtype), jnp.ones(DZ, dtype), size=4,
                                         cov_type="diagonal", noise_std=0.5,
                                         key=jax.random.PRNGKey(6))
        return JaxHMM.create(jgraph.ergodic(4).compile(dtype), nset, learn_transitions=True)
    mean, cov = jnp.zeros(DZ, dtype), 4.0 * jnp.eye(DZ, dtype=dtype)
    if kind == "normal":
        return beer_tpu.Normal.create(mean, cov, cov_type="full")
    nset = beer_tpu.NormalSet.create(mean, cov, size=3, cov_type="full", noise_std=1.0,
                                     key=jax.random.PRNGKey(7))
    return beer_tpu.Mixture.create(nset)


LATENT = {"phone_loop": ("PhoneLoop", phone_loop_to_numpy), "hmm": ("HMM", hmm_to_numpy),
          "normal": ("Normal", lambda m: dict(normal_set_to_numpy(m), type="Normal")),
          "gmm": ("Mixture", mixture_to_numpy)}


@functools.cache
def _jax_vae(kind, dtype, flows_=(0, 0)):
    """The JAX VAE of each case (made once per process: JAX models are
    immutable; the flax initialisation runs under jit, which is faster
    than eagerly)."""
    cls = JaxSequenceVAE if kind in ("phone_loop", "hmm") else JaxVAE
    prior = _jax_prior(kind, dtype)
    vae = jax.jit(lambda: cls.create(
        obs_dim=D_OBS, latent_dim=DZ, latent_model=prior, hidden=HIDDEN, nsamples=1,
        n_flow_planar=flows_[0], n_flow_iaf=flows_[1], key=jax.random.PRNGKey(8)))()
    return vae.replace(nnet_params=_cast(vae.nnet_params, dtype))


def _to_port(jvae, kind, dtype):
    latent_type, to_np = LATENT[kind]
    d = {"type": type(jvae).__name__, "latent_type": latent_type,
         "latent_model": to_np(jvae.latent_model), "nsamples": jvae.nsamples,
         **jax.tree.map(np.asarray, dict(jvae.nnet_params))}
    return bt.vae_from_numpy(d, device="cpu", dtype=dtype)


def _port_tree(vae, grads=False):
    out = {"encoder": {"params": nnet.flax_tree(vae.encoder, grads)},
           "decoder": {"params": nnet.flax_tree(vae.decoder, grads)}}
    if vae.flow is not None:
        out["flow"] = {"params": nnet.flax_tree(vae.flow, grads)}
    return out


def _inputs(kind, dtype):
    x, mask = _data(dtype=np.float64 if dtype == F64 else np.float32)
    if kind in ("normal", "gmm"):
        return x.reshape(-1, D_OBS), None
    return x, mask


def _jax_elbo_grads(jvae, x, key, mask):
    def loss_fn(params):
        elbo, acc = jvae.replace(nnet_params=params).elbo_and_stats(x, key, None, mask)
        return -elbo, acc

    (neg, acc), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jvae.nnet_params)
    return -neg, acc, grads


# ----------------------------------------------------------------------
# One hybrid step in float64: ELBO, nnet gradients, latent statistics
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["phone_loop", "hmm", "normal", "gmm"])
def test_elbo_gradients_and_statistics_match_jax_f64(kind):
    flows_ = (1, 1) if kind == "normal" else (0, 0)   # the flow posterior on one case
    jvae = _jax_vae(kind, F64, flows_)
    port = _to_port(jvae, kind, torch.float64)
    x, mask = _inputs(kind, F64)
    key = jax.random.PRNGKey(3)
    elbo_ref, acc_ref, grads_ref = _jax_elbo_grads(jvae, jnp.asarray(x), key,
                                                   None if mask is None else jnp.asarray(mask))
    eps = jax.random.normal(key, (1, *x.shape[:-1], DZ), F64)
    elbo, acc = port.elbo_and_stats(t(x), None, None, None if mask is None else t(mask),
                                    eps=t(eps))
    (-elbo).backward()
    close(elbo.detach(), elbo_ref, RTOL)
    _close_trees(_port_tree(port, grads=True), grads_ref)
    _close_trees(acc, acc_ref)
    assert not any(v.requires_grad for _, v in _leaves(acc))


@pytest.mark.parametrize("kind", ["phone_loop", "hmm"])
def test_adam_steps_match_optax_f64(kind):
    """5 hybrid steps (Adam + conjugate update) against optax.adam + the
    JAX package's jitted step, parameters compared after each step."""
    lr = 1e-2
    jvae = _jax_vae(kind, F64)
    port = _to_port(jvae, kind, torch.float64)
    x, mask = _inputs(kind, F64)
    tx = optax.adam(lr)
    opt_state = tx.init(jvae.nnet_params)
    jstep = jax_train_step(tx)
    step = bt.make_vae_train_step(torch.optim.Adam(port.parameters(), lr=lr, eps=1e-8))
    key = jax.random.PRNGKey(11)
    for _ in range(5):
        key, sub = jax.random.split(key)
        eps = jax.random.normal(sub, (1, B, T, DZ), F64)
        elbo_ref, jvae, opt_state = jstep(jvae, opt_state, jnp.asarray(x), sub, jnp.asarray(mask))
        elbo = step(port, t(x), None, t(mask), eps=t(eps))
        close(elbo, elbo_ref, RTOL)
        _close_trees(_port_tree(port), jvae.nnet_params)


def test_trajectory_f32_matches_jax():
    """10 hybrid steps of the phone-loop SVAE in float32: the per-frame
    ELBO within 1e-4 of the JAX float32 run at every step."""
    jvae = _jax_vae("phone_loop", F32)
    port = _to_port(jvae, "phone_loop", torch.float32)
    x, mask = _inputs("phone_loop", F32)
    frames = float(mask.sum())
    tx = optax.adam(3e-3)
    opt_state = tx.init(jvae.nnet_params)
    jstep = jax_train_step(tx)
    step = bt.make_vae_train_step(torch.optim.Adam(port.parameters(), lr=3e-3))
    key = jax.random.PRNGKey(12)
    gaps = []
    for _ in range(10):
        key, sub = jax.random.split(key)
        eps = jax.random.normal(sub, (1, B, T, DZ), F32)
        elbo_ref, jvae, opt_state = jstep(jvae, opt_state, jnp.asarray(x), sub, jnp.asarray(mask))
        elbo = step(port, t(x), None, t(mask), eps=t(eps))
        gaps.append(abs(float(elbo) - float(elbo_ref)) / frames)
    assert max(gaps) <= 1e-4, gaps


@pytest.mark.parametrize("kind", ["phone_loop", "hmm"])
def test_latent_decode_and_infer_match_jax_f64(kind):
    jvae = _jax_vae(kind, F64)
    port = _to_port(jvae, kind, torch.float64)
    x, mask = _inputs(kind, F64)
    labels_ref, scores_ref = jax.jit(jvae.latent_decode)(jnp.asarray(x), jnp.asarray(mask))
    labels, scores = port.latent_decode(t(x), t(mask))
    full = LENGTHS > 0
    for b in np.flatnonzero(full):
        np.testing.assert_array_equal(labels[b, :LENGTHS[b]].numpy(),
                                      np.asarray(labels_ref)[b, :LENGTHS[b]])
    close(scores[full], np.asarray(scores_ref)[full], RTOL)
    eps = jax.random.normal(jax.random.PRNGKey(0), (1, B, T, DZ), F64)
    terms_ref, _ = jax.jit(jvae.infer)(jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        terms, cache = port.infer(t(x), t(mask), eps=t(eps))
    close(terms, terms_ref, RTOL, atol=ATOL)
    assert set(cache) == {"posterior"}


def test_vae_round_trips_through_numpy():
    jvae = _jax_vae("normal", F64, (2, 1))
    port = _to_port(jvae, "normal", torch.float64)
    d = port.to_numpy()
    _close_trees({k: d[k] for k in ("encoder", "decoder", "flow")}, jvae.nnet_params, 0.0, 0.0)
    again = bt.vae_from_numpy(d, device="cpu")
    _close_trees(_port_tree(again), _port_tree(port), 0.0, 0.0)
    assert type(again.latent_model) is bt.Normal and again.latent_dim == DZ
    assert len(again.flow.planar) == 2 and len(again.flow.iaf) == 1


# ----------------------------------------------------------------------
# The differentiable log Z and ELLH against jax.grad of the general path
# ----------------------------------------------------------------------
def _logv(v):
    return np.where(v > 0, np.log(np.maximum(v, 1e-300)), -1e30)


def _phone_loop_case(seed=21):
    pb = scan_problem(seed, 3, 2, 4, B, T, lengths=LENGTHS)
    return pb, port_args(pb, torch.float64), np.random.default_rng(seed).normal(size=B)


def test_phone_loop_logz_gradient_matches_jax_f64():
    pb, a, c = _phone_loop_case()
    leaf = {k: a[k].clone().requires_grad_() for k in ("stats", "w", "bias")}
    log_z, gamma, _, _ = tss.PhoneLoopLogZ.apply(
        leaf["stats"], a["lens"], leaf["w"], leaf["bias"], a["bands"], a["init"], a["final"],
        a["ends"], a["starts"], True)
    (t(c) * log_z).sum().backward()
    dense = np.asarray(jss.bands_to_dense(tuple(jnp.asarray(v) for v in pb["bands"])))
    full = jnp.asarray(LENGTHS > 0)

    def f(stats, w, bias):
        fb = jss.forward_backward_probs(stats @ w.T + bias, jnp.asarray(_logv(dense)),
                                        jnp.asarray(_logv(pb["init"])),
                                        jnp.asarray(_logv(pb["final"])), jnp.asarray(pb["mask"]))
        return (jnp.asarray(c) * jnp.where(full, fb.log_z, 0.0)).sum()

    args = tuple(jnp.asarray(pb[k]) for k in ("stats", "w", "bias"))
    grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*args)
    for name, want in zip(("stats", "w", "bias"), grads):
        close(leaf[name].grad, want, RTOL, atol=ATOL)
    assert not leaf["stats"].grad[3].any() and not leaf["stats"].grad[1, LENGTHS[1]:].any()
    assert log_z[3] == 0 and not gamma.requires_grad


def test_hmm_logz_gradient_matches_jax_f64():
    pb = dense_problem(22, 5, 4, B, T, lengths=LENGTHS)
    a = dense_args(pb, torch.float64)
    c = np.random.default_rng(22).normal(size=B)
    llh = a["llh"].clone().requires_grad_()
    log_z, gamma, _ = tss.HMMLogZ.apply(llh, a["lens"], a["trans"], a["init"], a["final"], True)
    (t(c) * log_z).sum().backward()
    full = jnp.asarray(LENGTHS > 0)

    def f(llh_j):
        fb = jss.forward_backward_probs(llh_j, jnp.asarray(_logv(pb["trans"])),
                                        jnp.asarray(_logv(pb["init"])),
                                        jnp.asarray(_logv(pb["final"])), jnp.asarray(pb["mask"]))
        return (jnp.asarray(c) * jnp.where(full, fb.log_z, 0.0)).sum()

    close(llh.grad, jax.jit(jax.grad(f))(jnp.asarray(a["llh"].numpy())), RTOL, atol=ATOL)
    close(llh.grad, gamma * t(c)[:, None, None], 0.0)


def test_ellh_full_gradient_matches_jax_f64():
    pb = full_problem(23, 3, 4, 20)
    x = t(pb["x"]).requires_grad_()
    ct = np.random.default_rng(23).normal(size=(20, 4))
    (t(ct) * sk.EllhFull.apply(x, t(pb["e"]), True)).sum().backward()
    want = jax.grad(lambda xj: (jnp.asarray(ct) * jsk.ellh_full_xla(xj, jnp.asarray(pb["e"]), 3))
                    .sum())(jnp.asarray(pb["x"]))
    close(x.grad, want, RTOL, atol=ATOL)


def _gradcheck_cases():
    pb, a, _ = _phone_loop_case(seed=24)
    d = dense_args(dense_problem(25, 4, 3, B, T, lengths=LENGTHS), torch.float64)
    f = full_problem(26, 2, 3, 6)
    return {
        "PhoneLoopLogZ": (lambda stats, w, bias: tss.PhoneLoopLogZ.apply(
            stats, a["lens"], w, bias, a["bands"], a["init"], a["final"], a["ends"], a["starts"],
            True)[0], (a["stats"], a["w"], a["bias"])),
        "HMMLogZ": (lambda llh: tss.HMMLogZ.apply(llh, d["lens"], d["trans"], d["init"],
                                                   d["final"], True)[0], (d["llh"],)),
        "EllhFull": (lambda x: sk.EllhFull.apply(x, t(f["e"]), True), (t(f["x"]),)),
    }


@pytest.mark.parametrize("name", ["PhoneLoopLogZ", "HMMLogZ", "EllhFull"])
def test_gradcheck_plain_route(name):
    fn, args = _gradcheck_cases()[name]
    args = tuple(x.detach().clone().requires_grad_() for x in args)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-7, rtol=1e-5)


# ----------------------------------------------------------------------
# The wrappers refuse inputs that require grad (no silent graph break)
# ----------------------------------------------------------------------
def _wrapper_calls():
    """Each kernel wrapper with valid float32 CPU operands; the first
    argument is the one marked to require grad."""
    a = port_args(scan_problem(1, 2, 2, 4, 3, 6), torch.float32)
    d = dense_args(dense_problem(2, 4, 4, 3, 6), torch.float32)
    f = {k: t(v, torch.float32) for k, v in full_problem(3, 2, 3, 5).items()}
    with torch.no_grad():
        alpha, norms, _, _ = cuda_scan.forward_llh_banded(a["stats"], a["lens"], a["w"],
                                                          a["bias"], a["bands"], a["init"])
        d_alpha, d_norms, _, _ = cuda_scan.forward_llh_dense(d["llh"], d["lens"], d["trans"],
                                                             d["init"])
    llh = (a["stats"] @ a["w"].T + a["bias"]).contiguous()
    lb, li, lf = (tss.log_bands(a[k]) for k in ("bands", "init", "final"))
    est = (a["lens"], a["w"], a["bias"], a["bands"], a["final"], alpha, norms, a["ends"],
           a["starts"])
    ch, ex, al = cuda_scan.viterbi_fwd_banded_plain(llh, a["lens"], lb, li)
    e_llh = torch.exp(d["llh"] - d["llh"].max(-1, keepdim=True).values)
    ids = torch.arange(2, dtype=torch.int32)
    return {
        "forward_llh_banded": (cuda_scan.forward_llh_banded, a["stats"],
                               (a["lens"], a["w"], a["bias"], a["bands"], a["init"])),
        "estep_acc_banded": (cuda_scan.estep_acc_banded, a["stats"], est),
        "estep_gamma_banded": (cuda_scan.estep_gamma_banded, a["stats"], est),
        "viterbi_fwd_banded": (cuda_scan.viterbi_fwd_banded, llh, (a["lens"], lb, li)),
        "viterbi_backtrace_banded": (lambda al_, *rest: cuda_scan.viterbi_backtrace_banded(
            ch, ex, al_, *rest), al, (lf,)),
        "forward_llh_dense": (cuda_scan.forward_llh_dense, d["llh"],
                              (d["lens"], d["trans"], d["init"])),
        "estep_acc_dense": (cuda_scan.estep_acc_dense, d["stats"],
                            (d["lens"], d["w"], d["bias"], d["trans"], d["final"], d_alpha,
                             d_norms)),
        "estep_gamma_dense": (cuda_scan.estep_gamma_dense, d["llh"],
                              (d["lens"], d["trans"], d["final"], d_alpha, d_norms)),
        "forward_llh_shifts_dense": (
            lambda *args: cuda_scan.forward_llh_dense(*args, return_shifts=True), d["llh"],
            (d["lens"], d["trans"], d["init"])),
        "estep_gamma_dense_restricted": (
            lambda *args: cuda_scan.estep_gamma_dense(*args, rows=ids, cols=ids), d["llh"],
            (d["lens"], d["trans"], d["final"], d_alpha, d_norms)),
        "scaled_pass": (cuda_scan.scaled_pass, e_llh, (d["lens"], d["trans"], d["init"])),
        "smoothing_pass": (cuda_scan.smoothing_pass, e_llh,
                           (d_alpha, d["lens"], d["trans"], d["final"])),
        "gmm_estep_full": (sk.gmm_estep_full, f["x"], (f["e"], f["log_w"])),
        "ellh_full": (sk.ellh_full, f["x"], (f["e"],)),
        "accumulate_full": (sk.accumulate_full, f["x"], (f["r"],)),
        "diag_stats": (sk.diag_stats, f["x"], ()),
    }


@pytest.mark.parametrize("kernel", sorted(cuda_scan.KERNELS))
def test_wrapper_refuses_inputs_that_require_grad(kernel):
    fn, first, rest = _wrapper_calls()[kernel]
    marked = first.clone().requires_grad_()
    with pytest.raises(RuntimeError, match=f"{kernel}: an input requires grad"):
        fn(marked, *rest)
    with torch.no_grad():
        fn(marked, *rest)                           # grad mode off: no graph to break
    fn(first, *rest)


# ----------------------------------------------------------------------
# nnet building blocks: outputs and log-dets in float64
# ----------------------------------------------------------------------
TRUNKS = ["mlp:8,6", "mlp:7:relu", "resmlp:6x2:gelu", "mlp:5,4:sigmoid"]
HEADS = ["normal", "normal_iso", "bernoulli"]


def _x(n_in, seed=0):
    return np.random.default_rng(seed).normal(size=(7, n_in)) * 2.0


@pytest.mark.parametrize("spec", TRUNKS)
def test_trunks_match_flax_f64(spec):
    jtrunk = jnnet.build_trunk(spec)
    params = _cast(jtrunk.init(jax.random.PRNGKey(1), jnp.zeros((1, 5))), F64)
    trunk = nnet.load_flax_tree(nnet.build_trunk(spec, 5, dtype=torch.float64), params["params"])
    x = _x(5)
    close(trunk(t(x)).detach(), jtrunk.apply(params, jnp.asarray(x)), 1e-12)


@pytest.mark.parametrize("spec", HEADS)
def test_heads_and_densities_match_flax_f64(spec):
    jhead = jnnet.build_head(spec, 3)
    params = _cast(jhead.init(jax.random.PRNGKey(2), jnp.zeros((1, 6))), F64)
    head = nnet.load_flax_tree(nnet.build_head(spec, 6, 3, dtype=torch.float64), params["params"])
    x, y = _x(6, 1), _x(3, 2)
    out, ref = head(t(x)), jhead.apply(params, jnp.asarray(x))
    _close_trees(out, ref, 1e-12, 0.0)
    if spec == "bernoulli":
        close(nnet.bernoulli_log_likelihood(out, t(y > 0)).detach(),
              jnnet.bernoulli_log_likelihood(ref, jnp.asarray(y > 0)), 1e-12)
        return
    close(nnet.normal_log_likelihood(out, t(y)).detach(),
          jnnet.normal_log_likelihood(ref, jnp.asarray(y)), 1e-12)
    close(nnet.normal_entropy(out).detach(), jnnet.normal_entropy(ref), 1e-12)
    key = jax.random.PRNGKey(3)
    eps = jax.random.normal(key, (2, 7, 3), F64)
    close(nnet.normal_rsample(out, nsamples=2, eps=t(eps)).detach(),
          jnnet.normal_rsample(ref, key, 2), 1e-12)


@pytest.mark.parametrize("flow", ["planar", "iaf", "stack"])
def test_flows_match_flax_f64(flow):
    dim = 3
    jflow = {"planar": jflows.PlanarFlow(dim), "iaf": jflows.AffineAutoregressiveFlow(dim, 5),
             "stack": jflows.FlowStack(dim, n_planar=2, n_iaf=1)}[flow]
    params = _cast(jflow.init(jax.random.PRNGKey(4), jnp.zeros((1, dim))), F64)
    # noise at a scale where tanh, the clip and the masks all matter
    params = jax.tree.map(lambda p: p + 0.3 * jax.random.normal(jax.random.PRNGKey(5), p.shape, F64),
                          params)
    port = {"planar": flows.PlanarFlow(dim, dtype=torch.float64),
            "iaf": flows.AffineAutoregressiveFlow(dim, 5, dtype=torch.float64),
            "stack": flows.FlowStack(dim, 2, 1, dtype=torch.float64)}[flow]
    nnet.load_flax_tree(port, params["params"])
    z = _x(dim, 6).reshape(7, dim)
    (z_new, logdet), (z_ref, logdet_ref) = port(t(z)), jax.jit(jflow.apply)(params,
                                                                            jnp.asarray(z))
    close(z_new.detach(), z_ref, 1e-12)
    close(logdet.detach(), logdet_ref, 1e-12)
    if flow == "stack":
        q = {"mean": jnp.asarray(_x(dim, 7)), "logvar": jnp.asarray(0.3 * _x(dim, 8))}
        key = jax.random.PRNGKey(9)
        z_k, log_q = flows.flow_rsample(port, {k: t(v) for k, v in q.items()}, nsamples=2,
                                        eps=t(jax.random.normal(key, (2, 7, dim), F64)))
        z_kr, log_qr = jax.jit(lambda p, q_, k: jflows.flow_rsample(jflow, p, q_, k, 2))(
            params, q, key)
        close(z_k.detach(), z_kr, 1e-12)
        close(log_q.detach(), log_qr, 1e-12)


def test_spec_parsers_reject_unknown_specs():
    with pytest.raises(ValueError):
        nnet.build_trunk("conv:3", 4)
    with pytest.raises(ValueError):
        nnet.build_head("poisson", 4, 2)
    with pytest.raises(ValueError):
        nnet.build_trunk("resmlp:8,4", 4)
