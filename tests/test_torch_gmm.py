"""The port's full-covariance slice against beer_tpu: kernels' plain
versions, the Bayesian GMM (config 1) and full-covariance HMM emissions.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU, where the wrappers of K8–K10
(``beer_tpu_torch.ops.stats_kernels``) run their plain versions.

Tolerances:
* the plain versions against the JAX Pallas kernels in interpret mode, in
  float32: the tolerances of ``tests/test_stats_kernels.py`` (2e-5 for the
  ELLH, 2e-4 for the statistics, the log-marginals and the counts); the
  kernels sum in another order and the E-step's joint goes through bf16
  limbs that rebuild the f32 products exactly;
* the plain versions against the JAX ``*_xla`` functions and the packing
  against the plain versions, float64: rtol 1e-9 (the same sums in
  another order);
* Mixture VB-EM and the full-covariance HMM against the JAX general path,
  float64: ELBOs, posteriors and statistics to rtol 1e-9; decode paths
  equal;
* float32 over 10 VB-EM steps on clustered data against the JAX fused
  route (Pallas in interpret mode): at most 1e-4 per frame (BASELINE's
  correctness bar), and monotone after two burn-in steps to 1e-6 per
  frame.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beer_tpu
import beer_tpu_torch as bt
from beer_tpu import dists as jd
from beer_tpu.models import graph as jgraph
from beer_tpu.models import mixture as jmixture
from beer_tpu.models.hmm import HMM as JaxHMM
from beer_tpu.ops import stats_kernels as jsk
from beer_tpu.vbi import elbo_and_stats as jax_elbo_and_stats
from beer_tpu.vbi import vb_step as jax_vb_step
from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.ops import stats_kernels as sk
from port_util import (close, hmm_to_numpy, hmm_to_port, lengths_and_mask, mixture_to_numpy,
                       mixture_to_port, modelset_to_numpy, normal_set_to_numpy, t)

RTOL_F64 = 1e-9
ELBO_PER_FRAME_F32 = 1e-4
D, K = 5, 3


def kernel_inputs(seed, t_len, d=D, k=K, dtype=np.float32):
    """Frames, responsibilities, E[T] of K random NormalWisharts, E[log w]
    and a mask with about a fifth of the frames off (the recipe of
    ``tests/test_stats_kernels.py``)."""
    rng = np.random.default_rng(seed)
    fam = jd.NormalWishart(dim=d)
    nats = []
    for _ in range(k):
        q = rng.normal(size=(d, d))
        nats.append(fam.to_nat(jnp.asarray(rng.normal(size=d)), 2.0,
                               jnp.asarray((q @ q.T + d * np.eye(d)) / 20.0), d + 2.0))
    return dict(x=rng.normal(size=(t_len, d)).astype(dtype),
                r=rng.dirichlet(np.ones(k), size=t_len).astype(dtype),
                e=np.asarray(fam.expected_sufficient_statistics(jnp.stack(nats))).astype(dtype),
                log_w=np.log(rng.dirichlet(np.ones(k))).astype(dtype),
                mask=(rng.uniform(size=t_len) > 0.2).astype(dtype))


def _jax_and_port(name, a, interpret):
    """(JAX outputs, port outputs) of one kernel's function on ``a``."""
    j = {k: jnp.asarray(v) for k, v in a.items()}
    p = {k: t(v) for k, v in a.items()}
    if name == "ellh":
        want = (jsk.fused_ellh_full(j["x"], j["e"], D, interpret=True) if interpret
                else jsk.ellh_full_xla(j["x"], j["e"], D))
        return [want], [sk.ellh_full(p["x"], p["e"])]
    if name == "accumulate":
        want = (jsk.fused_accumulate_full(j["x"], j["r"], interpret=True) if interpret
                else jsk.accumulate_full_xla(j["x"], j["r"]))
        return [want], [sk.accumulate_full(p["x"], p["r"])]
    mask = name == "gmm_estep_masked"
    fn = functools.partial(jsk.fused_gmm_estep, interpret=True) if interpret else jsk.gmm_estep_xla
    want = fn(j["x"], j["e"], j["log_w"], D, mask=j["mask"] if mask else None)
    return want, sk.gmm_estep_full(p["x"], p["e"], p["log_w"], p["mask"] if mask else None)


NAMES = ["ellh", "accumulate", "gmm_estep", "gmm_estep_masked"]


@pytest.mark.parametrize("name", NAMES)
def test_plain_versions_match_pallas_interpret_f32(name):
    """T = GMM_TILE_T + 33 is a multiple of neither tile."""
    a = kernel_inputs(0, jsk.GMM_TILE_T + 33)
    want, got = _jax_and_port(name, a, interpret=True)
    tol = 2e-5 if name == "ellh" else 2e-4
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        close(g, w, tol, atol=tol)


@pytest.mark.parametrize("name", NAMES)
def test_plain_versions_match_xla_f64(name):
    a = kernel_inputs(1, jsk.TILE_T + 17, dtype=np.float64)
    want, got = _jax_and_port(name, a, interpret=False)
    for g, w in zip(got, want):
        close(g, w, RTOL_F64, atol=1e-12)


def test_packing_matches_jax_and_reproduces_the_plain_versions():
    """What the kernels compute from the packing — S(x)·W, softmax,
    rᵀ·S(x) gathered back to the natural layout — equals the plain
    versions; the lane order, W and the unpack index are the JAX
    package's."""
    a = kernel_inputs(2, 200, d=D, k=K, dtype=np.float64)
    x, e, log_w, mask = (t(a[k]) for k in ("x", "e", "log_w", "mask"))
    np.testing.assert_array_equal(sk.ut_pairs(D), np.array(jsk._ut_pairs(D)))
    np.testing.assert_array_equal(sk.ut_unpack_index(D), jsk._ut_unpack_index(D))
    _, w_jax, n_ut = jsk._gmm_pack_inputs(jnp.asarray(a["x"]), jnp.asarray(a["e"]),
                                          jnp.asarray(a["log_w"]), D)
    w = sk.pack_weights(e, D, log_w)
    close(w, w_jax, 1e-15)
    assert w.shape == (sk.packed_width(D), K) and n_ut == D * (D + 1) // 2
    s = sk.packed_stats(x)
    close(s @ sk.pack_weights(e, D), sk.ellh_full_plain(x, e), RTOL_F64, atol=1e-12)
    close(sk.unpack_acc(t(a["r"]).T @ s, D)[0], sk.accumulate_full_plain(x, t(a["r"])),
          RTOL_F64, atol=1e-12)
    joint = s @ w
    llh = torch.logsumexp(joint, -1)
    r = torch.exp(joint - llh[:, None]) * mask[:, None]
    acc, counts = sk.unpack_acc(r.T @ s, D)
    for g, p in zip((llh * mask, acc, counts), sk.gmm_estep_full_plain(x, e, log_w, mask)):
        close(g, p, RTOL_F64, atol=1e-12)


# ----------------------------------------------------------------------
# The full-covariance NormalSet
# ----------------------------------------------------------------------
def _jax_nset(dtype, size, seed, dim=D, noise_std=0.5, mean=None, cov=None, cov_type="full"):
    mean = jnp.zeros(dim, dtype) if mean is None else jnp.asarray(mean, dtype)
    cov = jnp.eye(dim, dtype=dtype) if cov is None else jnp.asarray(cov, dtype)
    if cov_type == "diagonal":
        cov = jnp.diagonal(cov)
    return beer_tpu.NormalSet.create(mean, cov, size=size, cov_type=cov_type, noise_std=noise_std,
                                     key=jax.random.PRNGKey(seed))


def test_full_normalset_create_matches_jax_prior(rng):
    means = rng.normal(size=(5, 3))
    q = rng.normal(size=(3, 3))
    cov = q @ q.T + 3 * np.eye(3)
    jset = beer_tpu.NormalSet.create(jnp.full(3, 0.5), jnp.asarray(cov), size=5, prior_strength=3.0,
                                     cov_type="full", init_means=jnp.asarray(means))
    tset = bt.NormalSet.create(torch.full((3,), 0.5, dtype=torch.float64), t(cov), size=5,
                               prior_strength=3.0, cov_type="full", init_means=t(means))
    assert isinstance(tset.means_precisions.family, bt.dists.NormalWishart)
    close(tset.means_precisions.prior, jset.means_precisions.prior, RTOL_F64)
    close(tset.means_precisions.posterior, jset.means_precisions.posterior, RTOL_F64)
    close(tset.means(), jset.means(), RTOL_F64)


def test_full_normalset_ellh_and_accumulate_match_jax(rng):
    jset = _jax_nset(jnp.float64, 6, 1)
    tset = bt.normal_set_from_numpy(normal_set_to_numpy(jset), device="cpu")
    x = rng.normal(size=(2, 7, D))
    resps = rng.dirichlet(np.ones(6), size=14)
    jstats = jset.sufficient_statistics(jnp.asarray(x))       # (2, 7, D²+D+2) off the TPU
    stats = tset.sufficient_statistics(t(x))
    assert torch.equal(stats, t(x))                           # raw frames on every device
    close(tset.expected_log_likelihood(stats), jset.expected_log_likelihood(jstats), RTOL_F64)
    acc_j = jset.accumulate(jstats.reshape(14, -1), jnp.asarray(resps))["means_precisions"]
    acc_t = tset.accumulate(stats.reshape(14, D), t(resps))["means_precisions"]
    close(acc_t, acc_j, RTOL_F64, atol=1e-12)
    close(tset.kl_div_posterior_prior(), jset.kl_div_posterior_prior(), RTOL_F64)
    new_j = jset.vb_update({"means_precisions": acc_j}, lrate=0.7)
    tset.vb_update({"means_precisions": acc_t}, lrate=0.7)
    close(tset.means_precisions.posterior, new_j.means_precisions.posterior, RTOL_F64, atol=1e-12)
    for method, args in (("ellh_matrix", ()), ("accumulate_from_moments", (None, None))):
        with pytest.raises(ValueError, match="diagonal"):
            getattr(tset, method)(*args)


# ----------------------------------------------------------------------
# Mixture VB-EM (config 1 in miniature)
# ----------------------------------------------------------------------
def _clusters(seed, n=300, d=D, n_centres=3, spread=3.0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(n_centres, d)) * spread
    return centres[rng.integers(0, n_centres, size=n)] + rng.normal(size=(n, d))


def _jax_gmm(data, dtype, k=4, cov_type="full"):
    nset = _jax_nset(dtype, k, 3, dim=data.shape[-1], noise_std=1.0, mean=data.mean(0),
                     cov=np.cov(data.T), cov_type=cov_type)
    return beer_tpu.Mixture.create(nset)


@pytest.mark.parametrize("case", ["full", "full_masked", "diagonal"])
def test_mixture_vb_steps_match_jax_general_path_f64(case):
    """Three VB-EM steps: the fused route (full covariance; K8's plain
    version) or the logsumexp route (diagonal) against the JAX general
    path: ELBOs, accumulated statistics and posteriors."""
    data = _clusters(4)
    mask = (np.arange(len(data)) % 7 != 3).astype(np.float64) if case == "full_masked" else None
    jgmm = _jax_gmm(data, jnp.float64, cov_type="diagonal" if case == "diagonal" else "full")
    gmm = mixture_to_port(jgmm, torch.float64)
    assert gmm._fused() == (case != "diagonal")
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else t(mask)
    for _ in range(3):
        jelbo, jacc = jax_elbo_and_stats(jgmm, jnp.asarray(data), mask=jm)
        elbo, acc = bt.elbo_and_stats(gmm, t(data), mask=tm)
        close(elbo, jelbo, RTOL_F64)
        close(acc["categorical"]["weights"], jacc["categorical"]["weights"], RTOL_F64)
        close(acc["modelset"]["means_precisions"], jacc["modelset"]["means_precisions"],
              RTOL_F64, atol=1e-12)
        _, jgmm = jax_vb_step(jgmm, jnp.asarray(data), mask=jm)
        bt.vb_step(gmm, t(data), mask=tm)
    post = gmm.posteriors(t(data))
    close(post, jgmm.posteriors(jnp.asarray(data)), RTOL_F64, atol=1e-12)
    close(post.sum(-1), np.ones(len(data)), 1e-12)
    close(gmm.weights(), jgmm.weights(), RTOL_F64)
    got, want = gmm.to_numpy(), mixture_to_numpy(jgmm)
    close(got["posterior"], want["posterior"], RTOL_F64)
    close(got["modelset"]["posterior"], want["modelset"]["posterior"], RTOL_F64, atol=1e-12)


def test_mixture_f32_trajectory_tracks_jax_fused_route(monkeypatch):
    """Ten f32 VB-EM steps on clustered data with sharpening precisions
    (the recipe of ``tests/test_gmm.py::test_fused_route_trajectory_tracks_exact``:
    d = 8, k = 8, 4000 frames, centres × 3) against the JAX fused
    single-kernel route in interpret mode."""
    d, k, t_len = 8, 8, 4000
    rng = np.random.default_rng(42)
    centres = rng.normal(size=(4, d)) * 3.0
    x = (centres[rng.integers(0, 4, size=t_len)] + rng.normal(size=(t_len, d))).astype(np.float32)
    monkeypatch.setattr(jsk, "fused_gmm_estep",
                        functools.partial(jsk.fused_gmm_estep, interpret=True))
    monkeypatch.setattr(jmixture.Mixture, "_fused_gmm", lambda self: True)
    nset = _jax_nset(jnp.float32, k, 2, dim=d)
    jgmm = beer_tpu.Mixture.create(nset.replace(fused=True))
    gmm = mixture_to_port(jgmm, torch.float32)
    jelbos, elbos = [], []
    for _ in range(10):
        e, jgmm = jax_vb_step(jgmm, jnp.asarray(x))
        jelbos.append(float(e) / t_len)
        e, gmm = bt.vb_step(gmm, t(x))
        elbos.append(float(e) / t_len)
    elbos = np.array(elbos)
    assert np.isfinite(elbos).all()
    assert np.abs(elbos - np.array(jelbos)).max() <= ELBO_PER_FRAME_F32
    assert np.diff(elbos[2:]).min() >= -1e-6, elbos


def test_mixture_api():
    data = _clusters(5, n=60)
    gmm = mixture_to_port(_jax_gmm(data, jnp.float64), torch.float64)
    assert gmm.mean_field_factorization() == [["categorical"], ["modelset"]]
    close(gmm.weights().sum(), 1.0, 1e-12)
    stats = gmm.sufficient_statistics(t(data))
    llh, cache = gmm.infer(stats)
    assert set(cache) == {"gmm_acc", "gmm_counts"} and llh.shape == (60,)
    close(cache["gmm_counts"].sum(), 60.0, 1e-12)
    plain = mixture_to_port(_jax_gmm(data, jnp.float64), torch.float64)
    plain.plain_scan = True
    close(plain.infer(stats)[0], llh, 0.0)
    veneer = bt.VBConjugateOptimizer(gmm)
    elbo = bt.evidence_lower_bound(veneer.model, t(data), datasize=60).backward()
    veneer.step(elbo)
    diag = bt.Mixture.create(bt.NormalSet.create(torch.zeros(2, dtype=torch.float64),
                                                 torch.ones(2, dtype=torch.float64), size=3))
    assert not diag._fused()
    assert diag.categorical.weights.posterior.dtype == torch.float64


# ----------------------------------------------------------------------
# Full-covariance HMM emissions (the recognizer layout in miniature)
# ----------------------------------------------------------------------
B, T, DH = 4, 16, 3
N_PHONES, SPP, NCOMP = 3, 2, 2
TRANSCRIPTIONS = [[0, 1, 2], [2, 0], [1], [0, 2, 1]]


def jax_full_hmm(kind, dtype):
    """``mixture``: a MixtureSet of NCOMP full-covariance components per
    state (``examples/recognizer_demo.py``'s layout) on shared
    transcription graphs; ``normal``: a bare full-covariance NormalSet."""
    graphs = jgraph.transcription_graphs(TRANSCRIPTIONS, N_PHONES, SPP, dtype=dtype)
    if kind == "mixture":
        nset = _jax_nset(dtype, N_PHONES * SPP * NCOMP, 2, dim=DH)
        return JaxHMM.create(graphs, jmixture.MixtureSet.create(nset, nmix=N_PHONES * SPP))
    return JaxHMM.create(graphs, _jax_nset(dtype, N_PHONES * SPP, 3, dim=DH))


def _hmm_data(seed):
    x = np.random.default_rng(seed).normal(size=(B, T, DH))
    return x, lengths_and_mask(T)[1]


@pytest.mark.parametrize("kind", ["mixture", "normal"])
def test_full_cov_hmm_estep_matches_jax_f64(kind):
    jh = jax_full_hmm(kind, jnp.float64)
    hmm = hmm_to_port(jh, torch.float64)
    assert hmm.route() == "llh"
    x, mask = _hmm_data(0)
    jstats = jh.sufficient_statistics(jnp.asarray(x))
    jlz, jcache = jh.infer(jstats, jnp.asarray(mask))
    jacc = jh.accumulate(jstats, jcache)
    stats = hmm.sufficient_statistics(t(x))
    lz, cache = hmm.infer(stats, t(mask))
    acc = hmm.accumulate(stats, cache)
    close(lz, jlz, RTOL_F64)
    for a, b in zip(jax.tree.leaves(acc["modelset"]), jax.tree.leaves(jacc["modelset"])):
        close(a, b, RTOL_F64, atol=1e-12)
    close(hmm.posteriors(t(x), t(mask)), jh.posteriors(jnp.asarray(x), jnp.asarray(mask)),
          RTOL_F64, atol=1e-12)


@pytest.mark.parametrize("kind", ["mixture", "normal"])
def test_full_cov_hmm_vb_steps_match_jax_f64(kind):
    jh = jax_full_hmm(kind, jnp.float64)
    hmm = hmm_to_port(jh, torch.float64)
    x, mask = _hmm_data(1)
    step = jax.jit(lambda m, xx, mm: jax_vb_step(m, xx, mask=mm))
    jelbos, elbos = [], []
    for _ in range(3):
        e, jh = step(jh, jnp.asarray(x), jnp.asarray(mask))
        jelbos.append(float(e))
        e, hmm = bt.vb_step(hmm, t(x), mask=t(mask))
        elbos.append(float(e))
    close(elbos, jelbos, RTOL_F64)
    assert np.all(np.diff(elbos) > 0)
    got, want = hmm.to_numpy(), hmm_to_numpy(jh)
    for a, b in zip(jax.tree.leaves(got["modelset"]), jax.tree.leaves(want["modelset"])):
        if isinstance(b, np.ndarray):
            close(a, b, RTOL_F64, atol=1e-12)


@pytest.mark.parametrize("kind", ["mixture", "normal"])
def test_full_cov_hmm_decode_matches_jax(kind):
    jh = jax_full_hmm(kind, jnp.float64)
    hmm = hmm_to_port(jh, torch.float64)
    x, mask = _hmm_data(2)
    jpaths, jscores = jh.decode(jnp.asarray(x), jnp.asarray(mask))
    paths, scores = hmm.decode(t(x), t(mask))
    lengths = mask.sum(-1).astype(int)
    for b in np.flatnonzero(lengths):
        np.testing.assert_array_equal(paths[b, :lengths[b]].numpy(),
                                      np.asarray(jpaths)[b, :lengths[b]])
        close(scores[b], jscores[b], RTOL_F64)


# ----------------------------------------------------------------------
# Weights carried across; entry points on the card by default
# ----------------------------------------------------------------------
ROUND_TRIPS = {
    "normal_set": lambda: (normal_set_to_numpy(_jax_nset(jnp.float64, 4, 1)),
                           lambda d: bt.normal_set_from_numpy(d, device="cpu")),
    "mixture_set": lambda: (modelset_to_numpy(jmixture.MixtureSet.create(
        _jax_nset(jnp.float64, 6, 2), nmix=3)), lambda d: bt.mixture_set_from_numpy(d, device="cpu")),
    "mixture": lambda: (mixture_to_numpy(_jax_gmm(_clusters(6), jnp.float64)),
                        lambda d: bt.mixture_from_numpy(d, device="cpu")),
    "hmm": lambda: (hmm_to_numpy(jax_full_hmm("mixture", jnp.float64)),
                    lambda d: bt.hmm_from_numpy(d, device="cpu")),
}


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_convert_round_trip_full_covariance(name):
    want, load = ROUND_TRIPS[name]()
    got = load(want).to_numpy()
    flat_got, tree_got = jax.tree.flatten(got)
    flat_want, tree_want = jax.tree.flatten(want)
    assert tree_got == tree_want
    for a, b in zip(flat_got, flat_want):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_convert_rejects_a_width_that_does_not_match_the_cov_type():
    d = normal_set_to_numpy(_jax_nset(jnp.float64, 4, 1))
    with pytest.raises(ValueError, match="width"):
        bt.normal_set_from_numpy(dict(d, cov_type="diagonal"), device="cpu")
    # the isotropic and tied types are ported: their widths are checked too
    for cov_type in ("isotropic", "shared_full", "shared_diagonal", "shared_isotropic"):
        with pytest.raises(ValueError, match="width"):
            bt.normal_set_from_numpy(dict(d, cov_type=cov_type), device="cpu")


ENTRY_POINTS = {
    "phone_loop_from_numpy": lambda: bt.phone_loop_from_numpy({}),
    "normal_set_from_numpy": lambda: bt.normal_set_from_numpy({}),
    "mixture_set_from_numpy": lambda: bt.mixture_set_from_numpy({}),
    "mixture_from_numpy": lambda: bt.mixture_from_numpy({}),
    "hmm_from_numpy": lambda: bt.hmm_from_numpy({}),
    "Graph.compile": lambda: bt.ergodic(3).compile(),
    "transcription_graphs": lambda: bt.transcription_graphs(TRANSCRIPTIONS, N_PHONES, SPP),
    "Categorical.create": lambda: bt.Categorical.create(3),
    "SBCategorical.create": lambda: bt.SBCategorical.create(3),
    "PPCA.create": lambda: bt.PPCA.create(3, 2),
    "PLDA.create": lambda: bt.PLDA.create(3, 2),
    "ppca_from_numpy": lambda: bt.ppca_from_numpy({}),
    "plda_from_numpy": lambda: bt.plda_from_numpy({}),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """With no device given an entry point builds on the CUDA card; with
    none available it raises instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


# ----------------------------------------------------------------------
# K9's and K10's launch geometry (pure functions of the shapes)
# ----------------------------------------------------------------------
ELLH_TILE_K = {1: 16, 4: 16, 60: 64, 64: 64, 65: 128, 200: 128}
# 128-frame tiles once ⌈T/128⌉ · ⌈K/tile_k⌉ reaches 4 waves of 132 SMs
ELLH_TILE_T = {(0, 1): 64, (1, 1): 64, (127, 1): 64, (38_400, 1): 64, (256_000, 1): 128,
               (0, 2): 64, (1, 2): 64, (127, 2): 64, (38_400, 2): 128, (256_000, 2): 128}


@pytest.mark.parametrize("t_len", [0, 1, 127, 38_400, 256_000])
@pytest.mark.parametrize("k", list(ELLH_TILE_K))
def test_ellh_tiles(t_len, k):
    tile_t, tile_k = sk.ellh_tiles(t_len, k)
    assert tile_k == ELLH_TILE_K[k]
    assert tile_t == ELLH_TILE_T[(t_len, -(-k // tile_k))]


# K8's geometry: (D, K) -> (joint component tile, frames a supertile)
ESTEP_TILES = {(1, 1): (32, 256), (1, 64): (64, 256), (1, 65): (128, 128), (1, 256): (128, 64),
               (39, 1): (32, 256), (39, 64): (64, 128), (39, 65): (128, 64), (39, 256): (128, 64),
               (128, 1): (32, 256), (128, 64): (64, 128), (128, 65): (128, 64), (128, 256): (128, 64)}


@pytest.mark.parametrize("d", [1, 39, 128])
@pytest.mark.parametrize("k", [1, 64, 65, 256])
def test_estep_tiles(d, k):
    """K8 joins K9's 8192-output joint tile to K10's accumulation: the
    component tile holds K (up to 128), a supertile is a whole number of
    joint tiles, two blocks share an SM where they fit (config 1: 128
    frames), and every (D, K) the kernel takes fits one block."""
    tile_k, frames = sk.estep_tiles(d, k)
    assert (tile_k, frames) == ESTEP_TILES[(d, k)]
    tile_t = sk.ESTEP_TILE_OUTPUTS // tile_k
    assert frames % tile_t == 0 and frames % sk.ACC_FRAMES == 0
    pad = sk.estep_k_pad(k, tile_k)
    assert pad >= k and pad % tile_k == 0 and pad % sk.accumulate_tile_k(k) == 0
    smem = sk.estep_smem_bytes(d, k, tile_k, frames)
    assert smem <= cuda_scan.SMEM_LIMIT
    assert smem <= sk.ESTEP_TWO_BLOCKS or frames == tile_t


@pytest.mark.parametrize("case", [
    # (T, D, K, resident blocks) -> (component tile, slices, frames a slice)
    ((256_000, 39, 64, 528), (64, 75, 3424)),     # config 1: 7 lane chunks
    ((38_400, 39, 60, 528), (64, 75, 512)),       # the recognizer
    ((512, 16, 4, 660), (32, 16, 32)),            # the GMM prior of config 5: one tile a slice
    ((1, 2, 1, 528), (32, 1, 32)),
    ((0, 39, 64, 528), (64, 0, 32)),
    ((1000, 39, 200, 8), (64, 1, 1024)),          # fewer resident blocks than output tiles
], ids=["config1", "recognizer", "gmm_prior", "one_frame", "empty", "few_blocks"])
def test_accumulate_tiles(case):
    (t_len, d, k, resident), want = case
    tile_k, n_slices, slice_len = sk.accumulate_tiles(t_len, d, k, resident)
    assert (tile_k, n_slices, slice_len) == want
    assert slice_len % sk.ACC_FRAMES == 0 and n_slices * slice_len >= t_len
    assert t_len == 0 or (n_slices - 1) * slice_len < t_len   # no slice is empty
