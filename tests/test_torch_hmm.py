"""The port's Bayesian HMM slice against beer_tpu: graphs, E-step, VB-EM, decode.

JAX HMMs (diagonal NormalSet or MixtureSet emissions) are carried into
the port with ``beer_tpu_torch.convert``; both packages then see the same
numpy data.  The port runs its fused routes through the plain versions of
its kernels (CPU tensors):

* config 2 in miniature — an ergodic HMM with learned transitions takes
  the stats route (K5 with in-kernel ELLH + K6);
* config 3 in miniature — a 3-phone × 2-state recognizer on shared
  transcription graphs takes the llh route (K5 + K7); per-utterance
  (unshared) graphs take the general path.

Tolerances:
* float64 against the JAX general path: log Z, statistics, ξ counts,
  ELBOs and posteriors to rtol 1e-9 (the same algorithm up to summation
  order);
* float32 over 3 VB-EM steps against the JAX fused lane-major route
  (Pallas kernels in interpret mode): the per-frame ELBO gap is at most
  1e-4 (BASELINE's correctness bar);
* decode: paths equal on valid frames, scores rtol 1e-9 (float64).

Shapes: B=4 (one full, two ragged, one zero-length row), T=16, D=3;
S=5 (ergodic) or 6 (recognizer).
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
from beer_tpu.models.mixture import MixtureSet as JaxMixtureSet
from beer_tpu.ops import pallas_scan
from beer_tpu.vbi import vb_step as jax_vb_step
from beer_tpu_torch.ops import semiring_scan
from port_util import close, hmm_to_numpy, hmm_to_port, lengths_and_mask, modelset_to_numpy, t

RTOL_F64 = 1e-9
ELBO_PER_FRAME_F32 = 1e-4
N_STEPS = 3
B, T, D = 4, 16, 3
S_ERGODIC = 5
N_PHONES, SPP = 3, 2
TRANSCRIPTIONS = [[0, 1, 2], [2, 0], [1], [0, 2, 1]]


def _data(dtype_np, seed=0, t_len=T):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, t_len, D)).astype(dtype_np)
    _, mask = lengths_and_mask(t_len)
    return x, mask.astype(dtype_np)


def _nset(dtype, size, seed):
    return beer_tpu.NormalSet.create(
        jnp.zeros(D, dtype), jnp.ones(D, dtype), size=size, cov_type="diagonal",
        noise_std=0.5, key=jax.random.PRNGKey(seed))


def jax_hmm(kind, dtype):
    """The JAX model of each case (see the module docstring)."""
    if kind == "ergodic":           # config 2: stats route
        return JaxHMM.create(jgraph.ergodic(S_ERGODIC).compile(dtype), _nset(dtype, S_ERGODIC, 1),
                             learn_transitions=True)
    if kind == "mixture":           # MixtureSet emissions: llh route
        ms = JaxMixtureSet.create(_nset(dtype, 2 * S_ERGODIC, 2), nmix=S_ERGODIC)
        return JaxHMM.create(jgraph.ergodic(S_ERGODIC).compile(dtype), ms, learn_transitions=True)
    shared = not kind.startswith("recognizer_per_utt")
    graphs = jgraph.transcription_graphs(TRANSCRIPTIONS, N_PHONES, SPP, dtype=dtype,
                                         shared=shared)
    return JaxHMM.create(graphs, _nset(dtype, N_PHONES * SPP, 3),
                         learn_transitions=kind.endswith("_learned"))


ROUTES = {"ergodic": "stats", "mixture": "llh", "recognizer": "llh",
          "recognizer_learned": "llh", "recognizer_per_utt": "general",
          "recognizer_per_utt_learned": "general"}


def _jax_steps(model, x, mask, n=N_STEPS):
    step = jax.jit(lambda m, xx, mm: jax_vb_step(m, xx, mask=mm))
    elbos = []
    for _ in range(n):
        elbo, model = step(model, jnp.asarray(x), jnp.asarray(mask))
        elbos.append(float(elbo))
    return np.array(elbos), model


def _port_steps(model, x, mask, n=N_STEPS):
    elbos = []
    for _ in range(n):
        elbo, model = bt.vb_step(model, t(x), mask=t(mask))
        elbos.append(float(elbo))
    return np.array(elbos), model


# ----------------------------------------------------------------------
# graphs
# ----------------------------------------------------------------------
LM = ([[0.6, 0.3, 0.1], [0.2, 0.2, 0.6], [0.5, 0.0, 0.5]], [0.2, 0.3, 0.5])
GRAPHS = {
    "left_to_right": lambda g: g.left_to_right(4, first_pdf=2, self_loop=0.7).compile,
    "ergodic": lambda g: g.ergodic(5, self_loop=0.6).compile,
    "phone_loop_bigram": lambda g: g.phone_loop_graph(
        3, 2, lm_trans=np.array(LM[0]), lm_init=np.array(LM[1])).compile,
    "transcriptions_shared": lambda g: lambda dtype, **kw: g.transcription_graphs(
        TRANSCRIPTIONS, N_PHONES, SPP, dtype=dtype, shared=True, **kw),
    "transcriptions_per_utt": lambda g: lambda dtype, **kw: g.transcription_graphs(
        TRANSCRIPTIONS, N_PHONES, SPP, dtype=dtype, shared=False, **kw),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_builders_match_jax(name):
    want = GRAPHS[name](jgraph)(jnp.float64)
    got = GRAPHS[name](bt)(torch.float64, device="cpu")
    for field in ("log_init", "log_final", "log_trans"):
        close(getattr(got, field), getattr(want, field), 0.0)
    np.testing.assert_array_equal(got.pdf_ids.numpy(), np.asarray(want.pdf_ids))
    assert (got.n_states, got.n_pdfs) == (want.n_states, want.n_pdfs)
    assert got.l2r_banded == bool(getattr(want, "l2r_banded", False))


def test_bigram_lm_and_builder_api_match_jax():
    seqs = [[0, 1, 2, 1], [2, 2, 0], [], [1]]
    for got, want in zip(bt.bigram_lm(seqs, 3), jgraph.bigram_lm(seqs, 3)):
        np.testing.assert_array_equal(got, want)
    graphs = []
    for mod in (bt, jgraph):
        g = mod.Graph()
        a, b_, c = g.add_state(0), g.add_state(1), g.add_state(1)
        g.add_arc(a, b_, 2.0)
        g.add_arc(a, c, 1.0)
        g.add_arc(a, c, 1.0)
        g.add_arc(b_, b_)
        g.set_init(a, 3.0)
        g.set_init(b_)
        g.set_final(c, 0.5)
        g.normalize()
        graphs.append(g.compile(torch.float64, device="cpu") if mod is bt else g.compile(jnp.float64))
    for field in ("log_init", "log_final", "log_trans"):
        close(getattr(graphs[0], field), getattr(graphs[1], field), 0.0)


def test_expand_llh_is_an_exact_gather():
    graphs = bt.transcription_graphs(TRANSCRIPTIONS, N_PHONES, SPP, dtype=torch.float32,
                                     device="cpu")
    per_pdf = torch.randn(B, T, N_PHONES * SPP, generator=torch.Generator().manual_seed(0))
    got = graphs.expand_llh(per_pdf)
    want = jgraph.transcription_graphs(TRANSCRIPTIONS, N_PHONES, SPP).expand_llh(
        jnp.asarray(per_pdf.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    erg = bt.ergodic(4).compile(device="cpu")
    assert torch.equal(erg.expand_llh(per_pdf[..., :4]), per_pdf[..., :4])


# ----------------------------------------------------------------------
# E-step and VB-EM against the JAX general path (float64)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", list(ROUTES))
def test_estep_matches_jax_general_path_f64(kind):
    jh = jax_hmm(kind, jnp.float64)
    hmm = hmm_to_port(jh, torch.float64)
    assert hmm.route() == ROUTES[kind]
    x, mask = _data(np.float64)
    jstats = jh.sufficient_statistics(jnp.asarray(x))
    jlz, jcache = jh.infer(jstats, jnp.asarray(mask))
    assert "posteriors" in jcache  # the JAX general path
    jacc = jh.accumulate(jstats, jcache)
    stats = hmm.sufficient_statistics(t(x))
    lz, cache = hmm.infer(stats, t(mask))
    acc = hmm.accumulate(stats, cache)
    close(lz, jlz, RTOL_F64)
    assert float(lz[3]) == 0.0  # the zero-length row
    for a, b in zip(jax.tree.leaves(acc["modelset"]), jax.tree.leaves(jacc["modelset"])):
        close(a, b, RTOL_F64, atol=1e-12)
    assert ("trans" in acc) == ("trans" in jacc)
    if "trans" in acc:
        close(acc["trans"], jacc["trans"], RTOL_F64, atol=1e-12)
    if not kind.startswith("recognizer_per_utt"):
        # for (B, S, S) matrices the JAX package returns the batch-summed
        # outer products times each utterance's own matrix, (B, S, S); the
        # port sums each utterance's own ξ (held against the shared graph
        # in test_shared_and_per_utterance_graphs_agree)
        close(hmm.expected_transition_counts(cache), jh.expected_transition_counts(jcache),
              RTOL_F64, atol=1e-12)
    close(hmm.posteriors(t(x), t(mask)), jh.posteriors(jnp.asarray(x), jnp.asarray(mask)),
          RTOL_F64, atol=1e-12)
    close(hmm.kl_div_posterior_prior(), jh.kl_div_posterior_prior(), RTOL_F64)


@pytest.mark.parametrize("kind", list(ROUTES))
def test_vb_steps_match_jax_general_path_f64(kind):
    jh = jax_hmm(kind, jnp.float64)
    hmm = hmm_to_port(jh, torch.float64)
    x, mask = _data(np.float64, seed=1)
    jelbos, jh = _jax_steps(jh, x, mask)
    elbos, hmm = _port_steps(hmm, x, mask)
    close(elbos, jelbos, RTOL_F64)
    assert np.all(np.diff(elbos) > 0)
    got, want = hmm.to_numpy(), hmm_to_numpy(jh)
    for a, b in zip(jax.tree.leaves(got["modelset"]), jax.tree.leaves(want["modelset"])):
        if isinstance(b, np.ndarray):
            close(a, b, RTOL_F64, atol=1e-12)
    if want["trans_alpha_post"] is not None:
        close(got["trans_alpha_post"], want["trans_alpha_post"], RTOL_F64, atol=1e-12)


# ----------------------------------------------------------------------
# float32 against the JAX fused lane-major route (Pallas, interpret mode)
# ----------------------------------------------------------------------
@pytest.fixture
def jax_fused_lane_major(monkeypatch):
    """Route the JAX HMM through its fused lane-major Pallas kernels
    (interpret mode on the CPU); every flag is restored afterwards."""
    monkeypatch.setattr(pallas_scan, "FORCE_INTERPRET", True)
    monkeypatch.setattr(pallas_scan, "LANE_MAJOR", True)
    pallas_scan.available.cache_clear()
    yield
    pallas_scan.available.cache_clear()


@pytest.mark.parametrize("kind", ["ergodic", "recognizer"])
def test_vb_steps_f32_within_bar_of_fused_lane_major(kind, jax_fused_lane_major):
    jh = jax_hmm(kind, jnp.float32)
    hmm = hmm_to_port(jh, torch.float32)
    x, mask = _data(np.float32, seed=2)
    assert jh._fused_estep_ok()
    assert jh._stats_path_ok(B, jh.graph.n_states) == (kind == "ergodic")
    jelbos, _ = _jax_steps(jh, x, mask)
    elbos, _ = _port_steps(hmm, x, mask)
    frames = float(mask.sum())
    assert np.all(np.isfinite(elbos))
    assert np.max(np.abs(elbos - jelbos)) / frames <= ELBO_PER_FRAME_F32


# ----------------------------------------------------------------------
# the recognizer: shared vs per-utterance graphs, decode
# ----------------------------------------------------------------------
def test_shared_and_per_utterance_graphs_agree():
    """The shared transcription graph (llh route, K5 + K7 plain versions)
    and the per-utterance (B, S, S) oracle (general path) give the same
    ELBO trajectory, statistics and alignments."""
    x, mask = _data(np.float64, seed=4)
    runs = {}
    for kind in ("recognizer", "recognizer_per_utt"):
        hmm = hmm_to_port(jax_hmm(kind, jnp.float64), torch.float64)
        stats = hmm.sufficient_statistics(t(x))
        lz, cache = hmm.infer(stats, t(mask))
        acc = hmm.accumulate(stats, cache)
        xi = hmm.expected_transition_counts(cache)
        paths, scores = hmm.decode(t(x), t(mask))
        elbos, _ = _port_steps(hmm, x, mask)
        runs[kind] = (lz, acc["modelset"]["means_precisions"], xi, paths, scores, elbos)
    shared, per_utt = runs["recognizer"], runs["recognizer_per_utt"]
    close(shared[0], per_utt[0], 1e-10, atol=1e-10)
    close(shared[1], per_utt[1], 1e-10, atol=1e-10)
    close(shared[2], per_utt[2], 1e-10, atol=1e-10)
    valid = mask > 0
    np.testing.assert_array_equal(shared[3].numpy()[valid], per_utt[3].numpy()[valid])
    close(shared[4][:3], per_utt[4][:3], 1e-10)
    close(shared[5], per_utt[5], 1e-10)


def _banded_recognizer(dtype):
    """Transcriptions of 34, 33, 32 and 1 phones × 2 states: S = 68."""
    rng = np.random.default_rng(5)
    seqs = [list(rng.integers(N_PHONES, size=n)) for n in (34, 33, 32, 1)]
    graphs = jgraph.transcription_graphs(seqs, N_PHONES, SPP, dtype=dtype)
    return JaxHMM.create(graphs, _nset(dtype, N_PHONES * SPP, 6))


@pytest.mark.parametrize("case", ["ergodic", "recognizer", "banded_l2r"])
def test_decode_matches_jax(case):
    if case == "banded_l2r":
        jh, t_len, lengths = _banded_recognizer(jnp.float64), 80, np.array([80, 72, 66, 0])
    else:
        jh, t_len, lengths = jax_hmm(case, jnp.float64), T, lengths_and_mask(T)[0]
    hmm = hmm_to_port(jh, torch.float64)
    assert (hmm.n_states >= 64) == (case == "banded_l2r")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, t_len, D))
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)
    jpaths, jscores = jh.decode(jnp.asarray(x), jnp.asarray(mask))
    paths, scores = hmm.decode(t(x), t(mask))
    assert paths.dtype == torch.int32 and paths.shape == (B, t_len)
    for b in np.flatnonzero(lengths):
        np.testing.assert_array_equal(paths[b, :lengths[b]].numpy(),
                                      np.asarray(jpaths)[b, :lengths[b]])
        close(scores[b], jscores[b], RTOL_F64)


ENTRY_ROUTES = {
    "ergodic": ["hmm_forward", "hmm_estep_gamma", "viterbi"],
    "recognizer": ["hmm_forward", "hmm_estep_gamma", "viterbi_banded"],
    "recognizer_per_utt": ["forward_backward_probs", "viterbi"],
}


@pytest.mark.parametrize("kind", list(ENTRY_ROUTES))
def test_posteriors_and_decode_take_the_kernel_routes(kind, monkeypatch):
    """``posteriors`` on one shared (S, S) matrix runs K5 + K7, ``decode``
    of a shared left-to-right graph K3 + K4 at any S; per-utterance
    graphs and ergodic decode take the plain-torch recursions."""
    calls = []
    for name in ("hmm_forward", "hmm_estep_gamma", "forward_backward_probs", "viterbi",
                 "viterbi_banded"):
        fn = getattr(semiring_scan, name)
        monkeypatch.setattr(semiring_scan, name,
                            lambda *a, _fn=fn, _name=name, **k: calls.append(_name) or _fn(*a, **k))
    hmm = hmm_to_port(jax_hmm(kind, jnp.float64), torch.float64)
    x, mask = _data(np.float64)
    hmm.posteriors(t(x), t(mask))
    hmm.decode(t(x), t(mask))
    assert calls == ENTRY_ROUTES[kind]


# ----------------------------------------------------------------------
# MixtureSet, conversion, flags
# ----------------------------------------------------------------------
def test_mixture_set_matches_jax():
    jms = JaxMixtureSet.create(_nset(jnp.float64, 6, 8), nmix=3)
    ms = bt.mixture_set_from_numpy(modelset_to_numpy(jms), device="cpu", dtype=torch.float64)
    x, _ = _data(np.float64, seed=9)
    flat = x.reshape(-1, D)
    jstats = jms.sufficient_statistics(jnp.asarray(flat))
    stats = ms.sufficient_statistics(t(flat))
    close(stats, jstats, 0.0)
    close(ms.expected_log_likelihood(stats), jms.expected_log_likelihood(jstats), RTOL_F64)
    resps = np.random.default_rng(10).dirichlet(np.ones(3), size=flat.shape[0])
    acc = ms.accumulate(stats, t(resps))
    jacc = jms.accumulate(jstats, jnp.asarray(resps))
    close(acc["weights"], jacc["weights"], RTOL_F64)
    close(acc["modelset"]["means_precisions"], jacc["modelset"]["means_precisions"], RTOL_F64,
          atol=1e-12)
    close(ms.kl_div_posterior_prior(), jms.kl_div_posterior_prior(), RTOL_F64)
    ms.vb_update(acc)
    jms = jms.vb_update(jacc)
    close(ms.weights.posterior, jms.weights.posterior, RTOL_F64)
    close(ms.modelset.means_precisions.posterior, jms.modelset.means_precisions.posterior,
          RTOL_F64, atol=1e-12)


@pytest.mark.parametrize("kind", ["ergodic", "mixture", "recognizer",
                                  "recognizer_per_utt_learned"])
def test_convert_round_trip(kind):
    want = hmm_to_numpy(jax_hmm(kind, jnp.float64))
    got = hmm_to_port(jax_hmm(kind, jnp.float64), torch.float64).to_numpy()
    flat_got, tree_got = jax.tree.flatten(got)
    flat_want, tree_want = jax.tree.flatten(want)
    assert tree_got == tree_want
    for a, b in zip(flat_got, flat_want):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_plain_scan_flag_keeps_results():
    """``plain_scan`` forces the plain kernel versions; on CPU tensors the
    wrappers run them anyway, so both routes agree exactly."""
    x, mask = _data(np.float64)
    for kind in ("ergodic", "recognizer"):
        hmm = hmm_to_port(jax_hmm(kind, jnp.float64), torch.float64)
        plain = hmm_to_port(jax_hmm(kind, jnp.float64), torch.float64)
        plain.plain_scan = True
        e1, _ = bt.vb_step(hmm, t(x), mask=t(mask))
        e2, _ = bt.vb_step(plain, t(x), mask=t(mask))
        assert float(e1) == float(e2)


@pytest.mark.parametrize("kind", ["ergodic", "recognizer"])
def test_zero_length_row_contributes_nothing(kind):
    hmm = hmm_to_port(jax_hmm(kind, jnp.float64), torch.float64)
    x, mask = _data(np.float64)
    if kind == "recognizer":  # three utterances need three transcription graphs
        trimmed = hmm_to_port(jax_hmm(kind, jnp.float64), torch.float64)
        for name in ("graph_log_final", "graph_pdf_ids"):
            setattr(trimmed, name, getattr(trimmed, name)[:3])
    else:
        trimmed = hmm
    e4, acc4 = bt.elbo_and_stats(hmm, t(x), mask=t(mask))
    e3, acc3 = bt.elbo_and_stats(trimmed, t(x[:3]), mask=t(mask[:3]))
    close(e4, e3, RTOL_F64)
    close(acc4["modelset"]["means_precisions"], acc3["modelset"]["means_precisions"], RTOL_F64,
          atol=1e-12)


@pytest.mark.parametrize("shared", [True, False])
def test_tied_states_sum_into_their_pdf(shared):
    """The one-hot product that sums the states sharing a pdf equals a
    scatter-add, on shared and per-utterance pdf maps (phones repeat, so
    states tie)."""
    repeats = [[0, 1, 0], [2, 2], [1], [0, 2, 0]]
    graphs = bt.transcription_graphs(repeats, N_PHONES, SPP, shared=shared, device="cpu")
    nset = bt.NormalSet.create(torch.zeros(D), torch.ones(D), size=N_PHONES * SPP)
    hmm = bt.HMM.create(graphs, nset)
    post = np.random.default_rng(7).random((B, 5, hmm.n_states))
    ids = np.broadcast_to(hmm.graph_pdf_ids.numpy(), (B, hmm.n_states))
    assert max(np.bincount(row).max() for row in ids) > 1
    want = np.zeros((B, 5, hmm.n_pdfs))
    for b in range(B):
        for s in range(hmm.n_states):
            want[b, :, ids[b, s]] += post[b, :, s]
    close(hmm._pdf_posteriors(t(post)), want, RTOL_F64)


def test_learned_transitions_need_a_shared_graph():
    """Learned transitions take a shared (S, S) graph or per-utterance
    (B, S, S) graphs, with a prior of the graph's shape."""
    graphs = bt.transcription_graphs(TRANSCRIPTIONS, N_PHONES, SPP, shared=False, device="cpu")
    nset = bt.NormalSet.create(torch.zeros(D), torch.ones(D), size=N_PHONES * SPP)
    per_utt = bt.HMM.create(graphs, nset, learn_transitions=True, trans_prior_strength=3.0)
    assert per_utt.trans_alpha_prior.shape == graphs.log_trans.shape == (B, 6, 6)
    close(per_utt.trans_alpha_prior, 3.0 * torch.exp(graphs.log_trans) * (graphs.log_trans > -1e9),
          0.0)
    assert per_utt.route() == "general"
    hmm = bt.HMM.create(bt.ergodic(3), bt.NormalSet.create(torch.zeros(D), torch.ones(D), size=3),
                        learn_transitions=True, trans_prior_strength=2.0)
    close(hmm.trans_alpha_prior, 2.0 * torch.exp(hmm.graph_log_trans), 0.0)
    assert hmm.graph_log_trans.dtype == torch.float32


# ----------------------------------------------------------------------
# learned transitions on per-utterance (B, S, S) graphs
# ----------------------------------------------------------------------
def test_per_utterance_learned_transitions_match_jax():
    """3 VB steps of the recognizer on per-utterance graphs with learned
    transitions (general path): ELBO (KL included), the (B, S, S)
    Dirichlet, posteriors and decode against the JAX package in float64,
    then one coordinate step and the conversion round trip."""
    from beer_tpu.vbi import vb_step_coordinate as jax_vb_step_coordinate

    jh = jax_hmm("recognizer_per_utt_learned", jnp.float64)
    hmm = hmm_to_port(jh, torch.float64)
    assert hmm.trans_alpha_post.shape == (B, 6, 6) and hmm.route() == "general"
    x, mask = _data(np.float64, seed=11)
    jelbos, jh = _jax_steps(jh, x, mask)
    elbos, hmm = _port_steps(hmm, x, mask)
    close(elbos, jelbos, RTOL_F64)
    close(hmm.trans_alpha_post, jh.trans_alpha_post, RTOL_F64, atol=1e-12)
    close(hmm.kl_div_posterior_prior(), jh.kl_div_posterior_prior(), RTOL_F64)
    close(hmm.posteriors(t(x), t(mask)), jh.posteriors(jnp.asarray(x), jnp.asarray(mask)),
          RTOL_F64, atol=1e-12)
    jpaths, jscores = jh.decode(jnp.asarray(x), jnp.asarray(mask))
    paths, scores = hmm.decode(t(x), t(mask))
    lengths = mask.sum(1).astype(int)
    for b in np.flatnonzero(lengths):
        np.testing.assert_array_equal(paths[b, :lengths[b]].numpy(),
                                      np.asarray(jpaths)[b, :lengths[b]])
        close(scores[b], jscores[b], RTOL_F64)
    jelbo, jh = jax_vb_step_coordinate(jh, jnp.asarray(x), mask=jnp.asarray(mask))
    elbo, hmm = bt.vb_step_coordinate(hmm, t(x), mask=t(mask))
    close(elbo, jelbo, RTOL_F64)
    close(hmm.trans_alpha_post, jh.trans_alpha_post, RTOL_F64, atol=1e-12)
    got, want = hmm.to_numpy(), hmm_to_numpy(jh)
    close(got["trans_alpha_post"], want["trans_alpha_post"], RTOL_F64, atol=1e-12)
    back = bt.hmm_from_numpy(got, device="cpu")
    for a, b in zip(jax.tree.leaves(back.to_numpy()), jax.tree.leaves(got)):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)


def test_reference_fault_pooled_transition_counts():
    """ROADMAP §C, fault (a), in both packages: on per-utterance graphs
    each utterance's Dirichlet gains the batch's summed ξ outer products
    times its own matrix, not its own ξ, whose sum is its number of
    transitions."""
    jh = jax_hmm("recognizer_per_utt_learned", jnp.float64)
    hmm = hmm_to_port(jh, torch.float64)
    x, mask = _data(np.float64, seed=12)
    jstats = jh.sufficient_statistics(jnp.asarray(x))
    jacc = jh.accumulate(jstats, jh.infer(jstats, jnp.asarray(mask))[1])
    stats = hmm.sufficient_statistics(t(x))
    lz, cache = hmm.infer(stats, t(mask))
    acc = hmm.accumulate(stats, cache)
    close(acc["trans"], jacc["trans"], RTOL_F64, atol=1e-12)
    lengths = mask.sum(1).astype(int)
    for b in np.flatnonzero(lengths):
        one = hmm_to_port(jh, torch.float64)
        for name in ("graph_log_init", "graph_log_final", "graph_log_trans", "graph_pdf_ids",
                     "trans_alpha_prior", "trans_alpha_post"):
            setattr(one, name, getattr(one, name)[b:b + 1])
        _, c1 = one.infer(one.sufficient_statistics(t(x[b:b + 1])), t(mask[b:b + 1]))
        own = one.expected_transition_counts(c1)
        close(own.sum(), lengths[b] - 1, 1e-10)
        assert abs(float(acc["trans"][b].sum()) - (lengths[b] - 1)) > 0.1
        assert float((acc["trans"][b] - own).abs().max()) > 0.1


def _dirichlet_kl_rows(a_q, a_p):
    """Σ over rows of KL(Dir(a_q[row]) ‖ Dir(a_p[row])) over each row's
    allowed arcs (a_p > 0), each row against its own sum."""
    total = 0.0
    for q, p in zip(a_q.reshape(-1, a_q.shape[-1]), a_p.reshape(-1, a_p.shape[-1])):
        on = p > 0
        if not bool(on.any()):
            continue
        q, p = q[on], p[on]
        total += float(torch.lgamma(q.sum()) - torch.lgamma(q).sum() - torch.lgamma(p.sum())
                       + torch.lgamma(p).sum()
                       + ((q - p) * (torch.digamma(q) - torch.digamma(q.sum()))).sum())
    return total


def test_reference_fault_transition_kl_axis():
    """ROADMAP §C, fault (b), in both packages: on (B, S, S) concentrations
    the transition KL subtracts the digamma of column j's row sum from
    entry (b, i, j), so it differs from the KL taken row by row; on a
    shared (S, S) matrix the two agree."""
    x, mask = _data(np.float64, seed=13)
    for kind, faulty in (("recognizer_per_utt_learned", True), ("recognizer_learned", False)):
        jh = jax_hmm(kind, jnp.float64)
        jh = _jax_steps(jh, x, mask, n=1)[1]
        hmm = hmm_to_port(jh, torch.float64)
        kl = float(hmm._trans_kl())
        close(kl, float(jh._trans_kl()), RTOL_F64)
        per_row = _dirichlet_kl_rows(hmm.trans_alpha_post, hmm.trans_alpha_prior)
        if faulty:
            assert abs(kl - per_row) > 0.1 * abs(per_row)
        else:
            close(kl, per_row, 1e-10)
