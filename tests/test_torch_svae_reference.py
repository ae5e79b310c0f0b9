"""The port's hybrid step of the structured VAE against the benchmark's
plain reference (``benchmark/reference/svae.py``), on the CPU in float64.

A ``SequenceVAE`` over a phone loop of 3 units × 3 states in a 4-dim
latent space, tanh nnets of 2 × 16, 6 utterances of at most 20 frames,
the noise ε injected, seeded random weights carried to the reference as
tensors: the ELBO, the nnet gradients and the conjugate statistics of one
step, the nnet weights and the posteriors after three hybrid steps (Adam
and the conjugate update at learning rate 0.1), each on a batch with
padding and on one without; and the reference's Fisher-identity gradient
of log Z against autograd through a plain log-space forward.
"""

import sys
from pathlib import Path

import pytest
import torch

import beer_tpu_torch as bt

ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.families import svae as family  # noqa: E402
from benchmark.reference import svae as ref  # noqa: E402
from benchmark.reference.common import Precision, ellh_affine  # noqa: E402
from benchmark.reference.phone_loop import graph  # noqa: E402

CFG = {"units": 3, "states_per_unit": 3, "components": 9, "dim": 5, "latent_dim": 4,
       "hidden": [16, 16], "nsamples": 1, "adam_lr": 1e-3, "lrate": 0.1, "prior_mean": 0.0,
       "prior_var": 1.0, "prior_strength": 1.0, "concentration": 1.0, "self_loop": 0.5}
B, T, DATASIZE = 6, 20, 24
LENS = {"masked": [20, 17, 9, 20, 3, 12], "unmasked": [T] * B}
F64 = Precision("float64")


def _setup(kind, seed=3):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, CFG["dim"], generator=gen, dtype=torch.float64)
    lens = torch.tensor(LENS[kind])
    mask = (torch.arange(T)[None] < lens[:, None]).double()
    init_means = 0.5 * torch.randn(CFG["components"], CFG["dim"], generator=gen,
                                   dtype=torch.float64)
    eps = torch.randn(3, 1, B, T, CFG["latent_dim"], generator=gen, dtype=torch.float64)
    dz = CFG["latent_dim"]
    nset = bt.NormalSet.create(torch.zeros(dz, dtype=torch.float64),
                               torch.ones(dz, dtype=torch.float64), size=CFG["components"],
                               prior_strength=1.0, init_means=init_means[:, :dz])
    latent = bt.PhoneLoop.create(CFG["units"], CFG["states_per_unit"], nset)
    vae = bt.SequenceVAE.create(CFG["dim"], dz, latent, hidden=tuple(CFG["hidden"]),
                                generator=torch.Generator().manual_seed(seed))
    params = ref.initial(CFG, init_means, family.nnet_state(vae))
    return vae, params, x, lens, mask, eps


def _log_z_plain(stats, lens, w, bias, trans, init, final):
    """log Z (B,) by a plain log-space forward (logsumexp a frame); a
    missing arc is −1e30, not −inf, so that no state's logsumexp is over
    −inf alone."""
    llh = stats @ w + bias
    log_trans, log_init, log_final = (torch.where(v > 0, torch.log(v), -1e30)
                                      for v in (trans, init, final))
    prev = log_init + llh[:, 0]
    for t in range(1, llh.shape[1]):
        new = torch.logsumexp(prev[:, :, None] + log_trans, 1) + llh[:, t]
        prev = torch.where((t < lens)[:, None], new, prev)
    return torch.logsumexp(prev + log_final, -1)


def _close(got, want, rtol=1e-9):
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=rtol * float(want[k].abs().max()))


@pytest.mark.parametrize("kind", sorted(LENS))
def test_one_step_elbo_gradients_and_statistics(kind):
    vae, params, x, lens, mask, eps = _setup(kind)
    elbo, acc = vae.elbo_and_stats(x, None, DATASIZE, mask, eps[0])
    (-elbo).backward()
    want_elbo, want_grads, want_stats = ref.step(CFG, params, x, lens, eps[0], F64,
                                                 scale=DATASIZE / B, block=4)
    assert float(elbo.detach()) == pytest.approx(float(want_elbo), rel=1e-11)
    _close(family.nnet_state(vae, grads=True), want_grads)
    _close({"modelset": acc["modelset"]["means_precisions"],
            "unit_prior": acc["unit_prior"]["sticks"]}, want_stats)


@pytest.mark.parametrize("kind", sorted(LENS))
def test_three_hybrid_steps_weights_and_posteriors(kind):
    vae, params, x, lens, mask, eps = _setup(kind)
    opt = torch.optim.Adam(vae.parameters(), lr=CFG["adam_lr"])
    step = bt.make_vae_train_step(opt, datasize=DATASIZE, lrate=CFG["lrate"])
    for i in range(3):
        step(vae, x, mask=mask, eps=eps[i])
        _, grads, stats = ref.step(CFG, params, x, lens, eps[i], F64, scale=DATASIZE / B)
        params = ref.update(ref.adam(params, grads, CFG["adam_lr"]), stats, CFG["lrate"])
    _close(family.nnet_state(vae), params["nnet"], rtol=1e-8)
    _close(family.posteriors(vae), params["post"], rtol=1e-8)


@pytest.mark.parametrize("kind", sorted(LENS))
def test_fisher_identity_gradient_of_log_z(kind):
    """γ·Wᵀ, the reference's gradient of log Z in the statistics, equals
    autograd's through a plain log-space forward, and the two log Z agree."""
    _, params, x, lens, _, eps = _setup(kind)
    lcfg = dict(CFG, dim=CFG["latent_dim"])
    w, bias = ellh_affine(params["post"]["modelset"])
    trans, init, final = graph(lcfg, params["post"])
    stats = torch.cat([-0.5 * eps[0, 0] ** 2, eps[0, 0]], -1).requires_grad_()
    log_z, gamma, _, _ = ref.posteriors(stats.detach(), lens, w, bias, trans, init, final, F64)
    plain = _log_z_plain(stats, lens, w, bias, trans, init, final)
    (grad,) = torch.autograd.grad(plain.sum(), stats)
    torch.testing.assert_close(log_z, plain.detach(), rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(gamma @ w.T, grad, rtol=1e-9, atol=1e-11)
    assert torch.all(gamma[torch.arange(T)[None] >= lens[:, None]] == 0)
