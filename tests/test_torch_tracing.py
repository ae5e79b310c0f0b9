"""The port's spans (``beer_tpu_torch.utils.profiling``), on the CPU.

With no profiler recording a span enters no ``record_function``,
synchronises nothing and reads no clock.  Under ``torch.profiler`` one
VB step, one decode and every kernel wrapper emit the ``beer.*`` spans
the benchmark's readers take, nested as the calls are, under names that
never equal one of the benchmark's own spans; and a profiled step
computes the same bits as an unprofiled one.
"""

import copy
import time
from collections import Counter

import pytest
import torch

import beer_tpu_torch as bt
from beer_tpu_torch.ops import cuda_scan, semiring_scan
from beer_tpu_torch.utils import profiling

# the spans the benchmark puts around its calls into the program
BENCHMARK_SPANS = {"window", "step", "estep", "mstep", "call", "decode", "to_host"}
U, SPU, D, S_HMM, B, T = 4, 3, 3, 5, 4, 12


def _data(seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, D, generator=gen)
    lens = torch.tensor([T, T - 3, 1, T - 7])
    mask = (torch.arange(T)[None] < lens[:, None]).float()
    return x, mask


def _nset(size, cov_type="diagonal"):
    gen = torch.Generator().manual_seed(size)
    cov = torch.eye(D) if cov_type == "full" else torch.ones(D)
    return bt.NormalSet.create(torch.zeros(D), cov, size=size, noise_std=0.5, cov_type=cov_type,
                               generator=gen)


def _phone_loop():
    return bt.PhoneLoop.create(U, SPU, _nset(U * SPU))


def _hmm():
    return bt.HMM.create(bt.ergodic(S_HMM), _nset(S_HMM), learn_transitions=True)


MODELS = {"phone_loop": _phone_loop, "hmm": _hmm}


def _svae_step(nsamples=2):
    """A structured VAE over the phone loop (latent dim D, one tanh layer
    of 8) and its hybrid step (Adam, conjugate learning rate 0.1)."""
    vae = bt.SequenceVAE.create(D, D, _phone_loop(), hidden=(8,), nsamples=nsamples)
    step = bt.make_vae_train_step(torch.optim.Adam(vae.parameters(), lr=1e-3), datasize=2 * B,
                                  lrate=0.1)
    return vae, step


def _spans(fn):
    """The user spans that ``fn()`` emits under a CPU profiler, as (name,
    start, end) by start, and ``fn``'s result."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.is_user_annotation]
    return sorted(spans, key=lambda s: (s[1], -s[2])), out


def _inside(spans, inner, outer):
    """Every span named ``inner`` lies inside some span named ``outer``."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    return all(any(s <= a and b <= e for s, e in outs) for n, a, b in spans if n == inner)


def _well_named(spans):
    names = {n for n, _, _ in spans}
    assert all(n.startswith("beer.") for n in names), names
    assert not names & BENCHMARK_SPANS
    kernels = {n for n in names if n.startswith("beer.kernel.")}
    assert kernels <= {f"beer.kernel.{k}" for k in cuda_scan.KERNELS}, kernels


def test_no_record_function_sync_or_clock_without_a_profiler(monkeypatch):
    """With no profiler recording the spans of a VB step of either model,
    a decode and a kernel wrapper enter no ``record_function``, call no
    synchronise, read no clock and never ask a span's name."""
    def refuse(*_, **__):
        raise AssertionError("called with no profiler recording")

    models = {name: make() for name, make in MODELS.items()}
    x, mask = _data()
    named = profiling.scoped(refuse)(lambda v: v + 1)
    with monkeypatch.context() as m:
        for owner in (torch.profiler, torch.autograd.profiler):
            m.setattr(owner, "record_function", refuse)
        m.setattr(torch.cuda, "synchronize", refuse)
        for clock in ("time", "perf_counter", "monotonic", "perf_counter_ns", "time_ns"):
            m.setattr(time, clock, refuse)
        for model in models.values():
            bt.vb_step(model, x, mask=mask)
        with torch.no_grad():
            models["phone_loop"].decode_units(x, mask)
        with profiling.named_scope("beer.test"):
            assert named(1) == 2
    assert profiling.named_scope("beer.test") is profiling.named_scope("beer.other")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_vb_step_spans(name):
    """One ``vb_step``: beer.vb_step ⊃ beer.estep ⊃ {beer.stats, beer.infer
    ⊃ beer.operands, beer.kl, beer.accumulate}, then beer.vb_update, and
    the statistics kernel (in beer.stats) and the two E-step kernels, each
    once; the phone loop's operands hold its wait on the card,
    beer.sync.structured_trans."""
    model = MODELS[name]()
    x, mask = _data()
    spans, _ = _spans(lambda: bt.vb_step(model, x, mask=mask))
    _well_named(spans)
    kernels = {"phone_loop": ("forward_llh_banded", "estep_acc_banded"),
               "hmm": ("forward_llh_dense", "estep_acc_dense")}[name]
    want = Counter({"beer.vb_step": 1, "beer.estep": 1, "beer.stats": 1, "beer.infer": 1,
                    "beer.operands": 1, "beer.kl": 1, "beer.accumulate": 1, "beer.vb_update": 1,
                    "beer.kernel.diag_stats": 1, **{f"beer.kernel.{k}": 1 for k in kernels}})
    if name == "phone_loop":
        want["beer.sync.structured_trans"] = 1
        assert _inside(spans, "beer.sync.structured_trans", "beer.operands")
    assert Counter(n for n, _, _ in spans) == want
    assert _inside(spans, "beer.estep", "beer.vb_step")
    assert _inside(spans, "beer.vb_update", "beer.vb_step")
    for inner in ("beer.stats", "beer.infer", "beer.kl", "beer.accumulate"):
        assert _inside(spans, inner, "beer.estep"), inner
    assert _inside(spans, "beer.operands", "beer.infer")
    assert _inside(spans, "beer.kernel.diag_stats", "beer.stats")
    assert _inside(spans, f"beer.kernel.{kernels[0]}", "beer.infer")
    assert _inside(spans, f"beer.kernel.{kernels[1]}", "beer.accumulate")
    estep = next((s, e) for n, s, e in spans if n == "beer.estep")
    update = next((s, e) for n, s, e in spans if n == "beer.vb_update")
    assert estep[1] <= update[0]


def test_svae_hybrid_step_spans():
    """One hybrid step: beer.svae.encode, beer.svae.prior ⊃ beer.operands (⊃
    the band write's wait) and the K1 and K11 wrappers, beer.svae.decode,
    beer.kl, beer.accumulate, beer.svae.backward, beer.svae.optim (⊃
    torch's own span of the Adam step), beer.vb_update, each once and in
    that order; the nnets' frame counter advances by B·T·(1 + nsamples)."""
    from beer_tpu_torch.models import vae as vae_mod

    vae, step = _svae_step()
    x, mask = _data()
    before = vae_mod.NNET_FRAMES.frames
    spans, _ = _spans(lambda: step(vae, x, torch.Generator().manual_seed(0), mask=mask))
    assert vae_mod.NNET_FRAMES.frames - before == B * T * (1 + 2)
    ours = [s for s in spans if s[0].startswith("beer.")]
    _well_named(ours)
    order = ["beer.svae.encode", "beer.svae.prior", "beer.operands", "beer.sync.structured_trans",
             "beer.kernel.forward_llh_banded", "beer.kernel.estep_gamma_banded",
             "beer.svae.decode", "beer.kl", "beer.accumulate", "beer.svae.backward",
             "beer.svae.optim", "beer.vb_update"]
    assert [n for n, _, _ in ours] == order
    for inner in ("beer.operands", "beer.sync.structured_trans", "beer.kernel.forward_llh_banded",
                  "beer.kernel.estep_gamma_banded"):
        assert _inside(spans, inner, "beer.svae.prior"), inner
    assert _inside(spans, "beer.sync.structured_trans", "beer.operands")
    assert _inside(spans, "Optimizer.step#Adam.step", "beer.svae.optim")
    top = [s for s in ours if s[0] in ("beer.svae.encode", "beer.svae.prior", "beer.svae.decode",
                                       "beer.svae.backward", "beer.svae.optim", "beer.vb_update")]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))


def test_svae_spans_closed_without_a_profiler(monkeypatch):
    """With no profiler recording, a hybrid step opens none of the
    program's spans (torch's own optimizer span aside), synchronises
    nothing, and its counter still counts."""
    from beer_tpu_torch.models import vae as vae_mod

    def refuse(*_, **__):
        raise AssertionError("called with no profiler recording")

    vae, step = _svae_step(nsamples=1)
    x, mask = _data()
    before = vae_mod.NNET_FRAMES.frames
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.cuda, "synchronize", refuse)
        step(vae, x, torch.Generator().manual_seed(0), mask=mask)
    assert vae_mod.NNET_FRAMES.frames - before == 2 * B * T


def test_decode_spans():
    """One ``PhoneLoop.decode``: beer.decode ⊃ {beer.operands (the graph,
    the bands with their wait on the card, E[T] and the Viterbi's
    operands), beer.stats ⊃ the statistics kernel, beer.ellh, the two
    Viterbi kernels}."""
    model = _phone_loop()
    x, mask = _data()
    with torch.no_grad():
        spans, _ = _spans(lambda: model.decode(x, mask))
    _well_named(spans)
    assert Counter(n for n, _, _ in spans) == Counter({
        "beer.decode": 1, "beer.operands": 4, "beer.sync.structured_trans": 1, "beer.stats": 1,
        "beer.ellh": 1, "beer.kernel.diag_stats": 1,
        "beer.kernel.viterbi_fwd_banded": 1, "beer.kernel.viterbi_backtrace_banded": 1})
    for inner in {n for n, _, _ in spans} - {"beer.decode"}:
        assert _inside(spans, inner, "beer.decode"), inner
    assert _inside(spans, "beer.sync.structured_trans", "beer.operands")
    assert _inside(spans, "beer.kernel.diag_stats", "beer.stats")


def _full_set_step():
    x, _ = _data()
    nset = _nset(3, "full")
    stats = nset.sufficient_statistics(x)
    llh = nset.expected_log_likelihood(stats)
    return nset.accumulate(stats, torch.softmax(llh, -1))


def _restricted_estep():
    loop = _phone_loop()
    x, mask = _data()
    llh = loop.modelset.expected_log_likelihood(loop.sufficient_statistics(x))
    graph = loop._effective_graph()
    lens = mask.sum(-1).to(torch.int32)
    trans = torch.exp(graph.log_trans)
    init = torch.exp(graph.log_init).expand(B, -1).contiguous()
    final = torch.exp(graph.log_final).expand(B, -1).contiguous()
    alpha, norms, _ = semiring_scan.forward_llh(llh, trans, init, lens)
    ends, starts = loop._ends().to(torch.int32), loop._starts().to(torch.int32)
    return semiring_scan.phone_loop_estep(llh, alpha, norms, trans, final, lens, ends, starts)


def _phone_loop_grad():
    loop = _phone_loop()
    x, mask = _data()
    stats = loop.sufficient_statistics(x).requires_grad_()
    log_z, _ = loop.infer(stats, mask)
    log_z.sum().backward()


def _hmm_posteriors():
    x, mask = _data()
    return _hmm().posteriors(x, mask)


def _smooth():
    loop = _phone_loop()
    x, mask = _data()
    return loop.smooth(loop.sufficient_statistics(x), mask)


def _gmm_step():
    x, _ = _data()
    return bt.vb_step(bt.Mixture.create(_nset(3, "full")), x.reshape(-1, D))


def _vb_step(make):
    x, mask = _data()
    return bt.vb_step(make(), x, mask=mask)


def _decode():
    x, mask = _data()
    with torch.no_grad():
        return _phone_loop().decode(x, mask)


# code path → the kernel wrappers it calls (their KERNELS keys)
KERNEL_CASES = {
    "phone_loop_vb_step": (lambda: _vb_step(_phone_loop),
                           {"diag_stats", "forward_llh_banded", "estep_acc_banded"}),
    "phone_loop_grad": (_phone_loop_grad, {"diag_stats", "forward_llh_banded", "estep_gamma_banded"}),
    "phone_loop_decode": (_decode, {"diag_stats", "viterbi_fwd_banded", "viterbi_backtrace_banded"}),
    "phone_loop_smooth": (_smooth, {"diag_stats", "scaled_pass", "smoothing_pass"}),
    "hmm_vb_step": (lambda: _vb_step(_hmm), {"diag_stats", "forward_llh_dense", "estep_acc_dense"}),
    "hmm_posteriors": (_hmm_posteriors, {"diag_stats", "forward_llh_dense", "estep_gamma_dense"}),
    "restricted_estep": (_restricted_estep,
                         {"diag_stats", "forward_llh_shifts_dense", "estep_gamma_dense_restricted"}),
    "gmm_full_vb_step": (_gmm_step, {"gmm_estep_full"}),
    "full_set_ellh_and_accumulate": (_full_set_step, {"ellh_full", "accumulate_full"}),
}


def test_every_kernel_has_a_span_case():
    assert set().union(*(want for _, want in KERNEL_CASES.values())) == set(cuda_scan.KERNELS)


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_spans_carry_the_launch_counters_names(case):
    """Each wrapper a path calls on CPU tensors (its plain version) runs
    inside ``beer.kernel.<its KERNELS key>``, the K14 and K15 modes
    under their own keys, and launches nothing."""
    fn, want = KERNEL_CASES[case]
    cuda_scan.reset_launch_counts()
    spans, _ = _spans(fn)
    _well_named(spans)
    assert {n for n, _, _ in spans if n.startswith("beer.kernel.")} == {
        f"beer.kernel.{k}" for k in want}
    assert all(k.launches == 0 for k in cuda_scan.KERNELS.values())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_profiled_step_is_bitwise_the_unprofiled_one(name):
    """Two VB steps under the profiler and two without, from copies of one
    model, give the same ELBOs and posteriors bit for bit."""
    model = MODELS[name]()
    twin = copy.deepcopy(model)
    x, mask = _data()

    def two_steps(m):
        return [bt.vb_step(m, x, mask=mask)[0] for _ in range(2)]

    spans, traced = _spans(lambda: two_steps(model))
    assert spans
    plain = two_steps(twin)
    assert all(torch.equal(a, b) for a, b in zip(traced, plain))
    for (key, a), (_, b) in zip(model.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(a, b), key
