"""The program's dense Viterbi (``HMM.decode``, which ``hmm-decode``
times) against the plain reference, and the decode numbers that decide
``correct``, at a small size on the CPU."""

import json

import pytest
import torch

from benchmark import corpus, harness
from benchmark.families import hmm
from benchmark.reference import common
from benchmark.reference import hmm as ref_hmm
from benchmark.tasks import decode as decode_task

CFG = {"family": "hmm", "states": 4, "components": 4, "dim": 3, "dtype": "float32",
       "prior_mean": 0.0, "prior_var": 1.0, "prior_strength": 1.0, "noise_std": 0.5,
       "self_loop": 0.5, "final_weight": 0.1, "trans_prior_strength": 1.0}
SMALL = {"utterances": 6, "min_frames": 20, "max_frames": 40}


def _random_posteriors(cfg, seed):
    """Emission natural parameters (S, 4D) and transition concentrations
    (S, S) drawn from ``seed``, far from the prior."""
    gen = torch.Generator().manual_seed(seed)
    s, d = cfg["states"], cfg["dim"]
    u = lambda *shape: torch.rand(shape, generator=gen, dtype=torch.float64)  # noqa: E731
    nat = common.ng_natural(torch.randn((s, d), generator=gen, dtype=torch.float64),
                            0.5 + 2 * u(s, d), 1.0 + 5 * u(s, d), 0.5 + 2 * u(s, d))
    return nat.float(), (0.05 + 3 * u(s, s)).float()


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_program_decode_matches_reference(seed):
    gen = torch.Generator().manual_seed(seed)
    means = torch.randn((CFG["components"], CFG["dim"]), generator=gen)
    model = hmm.build(CFG, means)
    nat, alpha = _random_posteriors(CFG, seed)
    model.modelset.means_precisions.posterior.copy_(nat)
    model.trans_alpha_post.copy_(alpha)
    lens = torch.tensor([9, 1, 14, 5])
    x = 1.5 * torch.randn((4, 14, CFG["dim"]), generator=gen)
    mask = (torch.arange(14)[None, :] < lens[:, None]).float()

    params = ref_hmm.initial(CFG, means, torch.float32)
    params["post"] = {"modelset": nat, "transitions": alpha}
    torch.testing.assert_close(model._effective_log_trans(),
                               common.dirichlet_expected_log(alpha), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        labels, scores = hmm.decode(model, x, mask)
    want_labels, want = ref_hmm.decode(CFG, params, x, lens, common.Precision("float32"))
    assert labels.dtype == torch.int32 and labels.shape == x.shape[:2]
    torch.testing.assert_close(scores, want, rtol=1e-5, atol=1e-4)
    for b, n in enumerate(lens.tolist()):
        assert labels[b, :n].tolist() == want_labels[b, :n].tolist()


def test_decode_gaps_read_the_program_labels():
    cell = harness.cell("hmm-decode", 2**31 + 23, "cpu", SMALL)
    cell.corpus = corpus.make(cell.traffic, cell.cfg, cell.seed, "cpu")
    model = cell.family.build(cell.cfg, cell.corpus.init_means)
    with torch.no_grad():
        labels, scores = cell.family.decode(model, cell.corpus.x, cell.corpus.mask)
    rows = torch.arange(SMALL["utterances"])
    gaps = decode_task.reference_gaps(cell, rows, labels, scores)
    limits = json.loads((harness.HERE / "workloads" / "hmm-decode.json").read_text())["limits"]
    assert gaps["path_gap"] == 0.0 and gaps["score_gap"] <= limits["score_gap"]

    # one label a row moved to another state, at a frame the seed draws
    gen = torch.Generator().manual_seed(5)
    moved = labels.clone()
    for b, n in enumerate(cell.corpus.lens.tolist()):
        t = int(torch.randint(n, (1,), generator=gen))
        moved[b, t] = moved[b, t] ^ 1
    gaps = decode_task.reference_gaps(cell, rows, moved, scores)
    assert gaps["path_gap"] > max(1e-3, 10 * limits["path_gap"])
