"""The plain reference against a float64 brute force at a tiny size: every
state path of every utterance enumerated."""

import itertools
import math

import pytest
import torch

from benchmark.reference import common
from benchmark.reference import hmm as ref_hmm
from benchmark.reference import phone_loop as ref_loop

F64 = common.Precision("float64")
LOOP = {"units": 2, "states_per_unit": 2, "components": 4, "dim": 2, "prior_mean": 0.0,
        "prior_var": 1.0, "prior_strength": 1.0, "concentration": 1.0, "self_loop": 0.5}
ERGODIC = {"states": 3, "components": 3, "dim": 2, "prior_mean": 0.0, "prior_var": 1.0,
           "prior_strength": 1.0, "self_loop": 0.6, "final_weight": 0.1,
           "trans_prior_strength": 2.0}


def _data(k, seed=0):
    gen = torch.Generator().manual_seed(seed)
    means = 0.7 * torch.randn((k, 2), generator=gen, dtype=torch.float64)
    x = torch.randn((3, 4, 2), generator=gen, dtype=torch.float64)
    return means, x, torch.tensor([4, 2, 3])


def _brute(x, lens, w, bias, trans, init, final):
    """log Z, Σγ⊗stats, Σγ, Σγ₀, Σξ and the best paths by enumeration."""
    s = trans.shape[0]
    stats = common.reduced_stats(x, torch.float64)
    llh = stats @ w + bias
    log_z, acc2 = [], torch.zeros(s, stats.shape[-1], dtype=torch.float64)
    counts, gamma0, xi = (torch.zeros(s, dtype=torch.float64), torch.zeros(s, dtype=torch.float64),
                          torch.zeros(s, s, dtype=torch.float64))
    best, paths = [], []
    for b, n in enumerate(lens.tolist()):
        weights = {}
        for path in itertools.product(range(s), repeat=n):
            p = init[path[0]] * final[path[-1]] * math.exp(sum(llh[b, t, q] for t, q in enumerate(path)))
            for t in range(1, n):
                p = p * trans[path[t - 1], path[t]]
            weights[path] = float(p)
        z = sum(weights.values())
        log_z.append(math.log(z))
        top = max(weights, key=weights.get)
        best.append(math.log(weights[top]))
        paths.append(top)
        for path, p in weights.items():
            g = p / z
            gamma0[path[0]] += g
            for t, q in enumerate(path):
                acc2[q] += g * stats[b, t]
                counts[q] += g
                if t:
                    xi[path[t - 1], q] += g
    return ((torch.tensor(log_z, dtype=torch.float64), acc2, counts, gamma0, xi),
            torch.tensor(best, dtype=torch.float64), paths)


def _family(family, seed):
    """(configuration, reference module, params, frames, lengths, (trans,
    init, final) probabilities, the label of each state) of ``family``."""
    if family == "phone_loop":
        means, x, lens = _data(4, seed)
        params = ref_loop.initial(LOOP, means)
        arcs = ref_loop.graph(LOOP, params["post"])
        return LOOP, ref_loop, params, x, lens, arcs, lambda q: q // LOOP["states_per_unit"]
    means, x, lens = _data(3, seed)
    params = ref_hmm.initial(ERGODIC, means)
    _, init, final = ref_hmm.arcs(ERGODIC, torch.float64, "cpu")
    trans = torch.exp(common.dirichlet_expected_log(params["post"]["transitions"]))
    return ERGODIC, ref_hmm, params, x, lens, (trans, init, final), lambda q: q


@pytest.mark.parametrize("family", ["phone_loop", "hmm"])
def test_forward_backward(family):
    _, _, params, x, lens, arcs, _ = _family(family, seed=0 if family == "phone_loop" else 1)
    w, bias = common.ellh_affine(params["post"]["modelset"])
    got = common.forward_backward(x, lens, w, bias, *arcs, F64, block=2)
    want, _, _ = _brute(x, lens, w, bias, *arcs)
    for g, e in zip((got.log_z, got.acc2, got.counts, got.gamma0, got.xi), want):
        torch.testing.assert_close(g, e, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("family", ["phone_loop", "hmm"])
def test_viterbi(family):
    cfg, ref, params, x, lens, arcs, label = _family(family, seed=2)
    w, bias = common.ellh_affine(params["post"]["modelset"])
    _, best, paths = _brute(x, lens, w, bias, *arcs)
    labels, scores = ref.decode(cfg, params, x, lens, F64)
    torch.testing.assert_close(scores, best, rtol=1e-12, atol=1e-12)
    for b, n in enumerate(lens.tolist()):
        assert labels[b, :n].tolist() == [label(q) for q in paths[b]]
    _, through = ref.decode(cfg, params, x, lens, F64, labels=labels)
    torch.testing.assert_close(through, best, rtol=1e-12, atol=1e-12)
    moved = labels.clone()
    moved[:, 0] = moved[:, 0] ^ 1
    _, off = ref.decode(cfg, params, x, lens, F64, labels=moved)
    assert bool((off < best - 1e-9).all())


def test_phone_loop_step_counts_unit_entries():
    means, x, lens = _data(4, seed=3)
    params = ref_loop.initial(LOOP, means)
    trans, init, final = ref_loop.graph(LOOP, params["post"])
    w, bias = common.ellh_affine(params["post"]["modelset"])
    (log_z, acc2, counts, gamma0, xi), _, _ = _brute(x, lens, w, bias, trans, init, final)
    elbo, stats = ref_loop.estep(LOOP, params, x, lens, F64)
    torch.testing.assert_close(elbo, log_z.sum() - ref_loop.kl(params))
    entries = xi[[1, 3]][:, [0, 2]].sum(0) + gamma0[[0, 2]]        # ends (1, 3) → starts (0, 2)
    torch.testing.assert_close(stats["unit_prior"], torch.stack([entries[:1], entries[1:]], -1))
    torch.testing.assert_close(stats["modelset"], common.ng_stats(acc2, counts))
    new = ref_loop.update(params, stats)
    torch.testing.assert_close(new["post"]["modelset"], params["prior"]["modelset"] + stats["modelset"])


def test_closed_forms_are_the_log_normaliser_gradients():
    means, _, _ = _data(4)
    nat = ref_loop.initial(LOOP, means)["post"]["modelset"]
    grad = torch.func.grad(lambda n: common.ng_log_norm(n).sum())(nat)
    torch.testing.assert_close(common.ng_expected_stats(nat), grad)
    alpha = torch.tensor([[1.5, 2.0, 0.7], [3.0, 0.2, 1.1]], dtype=torch.float64)
    log_norm = lambda a: (torch.lgamma(a).sum(-1) - torch.lgamma(a.sum(-1))).sum()  # noqa: E731
    torch.testing.assert_close(common.dirichlet_expected_log(alpha), torch.func.grad(log_norm)(alpha))
    assert float(common.ng_kl(nat, nat)) == pytest.approx(0.0, abs=1e-12)
    assert float(common.dirichlet_kl(alpha, alpha + 1.0)) > 0.0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -3.0 - 2.0**-12])
    assert common.to_tf32(x).tolist() == [1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9, -3.0]
