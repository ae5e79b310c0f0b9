"""Plain PyTorch pieces shared by the benchmark's references.

Nothing here imports the program under test: the references work every
quantity out again from the configuration's numbers, the seed-made
initial means and the seed-made frames.

* :class:`Precision` — the arithmetic a reference runs in: ``float64``
  (the reference itself), ``float32`` (TF32 off) or ``tf32``, the
  control: float32 storage whose matrix products take their inputs
  rounded to TF32's 10-bit mantissa, as the card's tensor cores do with
  TF32 on, accumulating in float32.  The rounding is done here, bit by
  bit, so the control means the same on the CPU and on the card.
* the conjugate families' closed forms: the diagonal Normal-Gamma and
  the Dirichlet (Beta) — expected sufficient statistics, log-partition,
  KL as a Bregman divergence.
* :func:`forward_backward` — the scaled forward-backward over a dense
  (S, S) transition matrix, frame by frame, reducing the posteriors to
  the emission moments and the expected transition counts on the way.
* :func:`viterbi` — the dense (max, +) recursion with a backtrace.
"""

from __future__ import annotations

import dataclasses
import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits), to
    nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    """``name`` is "float64", "float32" or "tf32"."""

    name: str = "float64"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "float64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return to_tf32(a) @ to_tf32(b)
        return a @ b


def tf32_off() -> None:
    """float32 products in full float32 on the card (the tf32 control
    rounds its own inputs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------------
# Diagonal Normal-Gamma: per dimension N(μ | m, (κλ)⁻¹) Gamma(λ | a, b),
# T(θ) = [λ, λμ, λμ², log λ], η = [−(b + ½κm²), κm, −κ/2, a − ½]
# ----------------------------------------------------------------------
def ng_natural(mean, scale, shape, rate) -> torch.Tensor:
    mean, scale, shape, rate = torch.broadcast_tensors(mean, scale, shape, rate)
    return torch.cat([-(rate + 0.5 * scale * mean**2), scale * mean, -0.5 * scale, shape - 0.5], -1)


def _ng_std(nat: torch.Tensor):
    e1, e2, e3, e4 = nat.chunk(4, dim=-1)
    scale = -2.0 * e3
    mean = e2 / scale
    shape = e4 + 0.5
    rate = -e1 - 0.5 * scale * mean**2
    return mean, scale, shape, rate


def ng_expected_stats(nat: torch.Tensor) -> torch.Tensor:
    """E[T(θ)] (..., 4D) in closed form."""
    mean, scale, shape, rate = _ng_std(nat)
    e_lam = shape / rate
    return torch.cat([e_lam, e_lam * mean, 1.0 / scale + e_lam * mean**2,
                      torch.digamma(shape) - torch.log(rate)], -1)


def ng_log_norm(nat: torch.Tensor) -> torch.Tensor:
    _, scale, shape, rate = _ng_std(nat)
    return (torch.lgamma(shape) - shape * torch.log(rate) - 0.5 * torch.log(scale)
            + 0.5 * LOG_2PI).sum(-1)


def ng_kl(nat_q: torch.Tensor, nat_p: torch.Tensor) -> torch.Tensor:
    """Σ KL(q‖p) over the leading axes."""
    return (((nat_q - nat_p) * ng_expected_stats(nat_q)).sum(-1)
            - ng_log_norm(nat_q) + ng_log_norm(nat_p)).sum()


def ellh_affine(nat: torch.Tensor):
    """(W (2D, K), bias (K,)) with E[log N(x | θ_k)] = [−½x², x]·W[:, k] +
    bias_k for the K components of ``nat`` (K, 4D)."""
    e = ng_expected_stats(nat)
    d = nat.shape[-1] // 4
    bias = -0.5 * e[:, 2 * d:3 * d].sum(-1) + 0.5 * e[:, 3 * d:].sum(-1) - 0.5 * d * LOG_2PI
    return e[:, :2 * d].T, bias


def ng_stats(acc2: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Natural-space statistics (K, 4D) from Σγ⊗[−½x², x] and Σγ."""
    d = acc2.shape[-1] // 2
    c = counts[:, None].expand(-1, d)
    return torch.cat([acc2, -0.5 * c, 0.5 * c], -1)


# ----------------------------------------------------------------------
# Dirichlet over the last axis: T = log π, η = α − 1
# ----------------------------------------------------------------------
def dirichlet_expected_log(alpha: torch.Tensor) -> torch.Tensor:
    return torch.digamma(alpha) - torch.digamma(alpha.sum(-1, keepdim=True))


def dirichlet_kl(alpha_q: torch.Tensor, alpha_p: torch.Tensor) -> torch.Tensor:
    """Σ KL(Dir(α_q)‖Dir(α_p)) over the leading axes."""
    log_norm = lambda a: torch.lgamma(a).sum(-1) - torch.lgamma(a.sum(-1))  # noqa: E731
    return (((alpha_q - alpha_p) * dirichlet_expected_log(alpha_q)).sum(-1)
            - log_norm(alpha_q) + log_norm(alpha_p)).sum()


# ----------------------------------------------------------------------
# Recursions
# ----------------------------------------------------------------------
@dataclasses.dataclass
class EStep:
    """What one E-step gives: per-utterance log Z (B,), Σγ⊗[−½x², x]
    (S, 2D), Σγ (S,), Σ_b γ₀ (S,) and the expected transition counts
    (S, S), all summed over the batch."""

    log_z: torch.Tensor
    acc2: torch.Tensor
    counts: torch.Tensor
    gamma0: torch.Tensor
    xi: torch.Tensor


def reduced_stats(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    x = x.to(dtype)
    return torch.cat([-0.5 * x * x, x], -1)


def forward_backward(x, lens, w, bias, trans, init, final, prec: Precision,
                     block: int = 4096) -> EStep:
    """Scaled forward-backward of B utterances ``x`` (B, T, D) of lengths
    ``lens`` under state log-likelihoods [−½x², x]·W + bias, transitions
    ``trans`` (S, S) (probabilities, 0 for a missing arc), ``init`` and
    ``final`` (S,), in ``prec``; rows in blocks of ``block``."""
    parts = [_forward_backward(x[i:i + block], lens[i:i + block], w, bias, trans, init, final,
                               prec) for i in range(0, x.shape[0], block)]
    return EStep(torch.cat([p.log_z for p in parts]), sum(p.acc2 for p in parts),
                 sum(p.counts for p in parts), sum(p.gamma0 for p in parts),
                 sum(p.xi for p in parts))


def _forward_backward(x, lens, w, bias, trans, init, final, prec: Precision) -> EStep:
    tf32_off()
    dt = prec.dtype
    b, t_len, _ = x.shape
    s = trans.shape[0]
    w, bias, trans, init, final = (v.to(dt) for v in (w, bias, trans, init, final))
    lens = lens.to(x.device).long()
    n_t = int(lens.max())

    def scaled_emissions(t):
        stats = reduced_stats(x[:, t], dt)
        llh = prec.mm(stats, w) + bias
        shift = llh.max(-1, keepdim=True).values
        return stats, torch.exp(llh - shift), shift[:, 0]

    # forward: α̂_t = normalised (α̂_{t−1}·A) ⊙ e_t; log Z = Σ log n_t + shift_t
    alpha = torch.empty(b, n_t, s, dtype=dt, device=x.device)
    norms = torch.ones(b, n_t, dtype=dt, device=x.device)
    log_z = torch.zeros(b, dtype=dt, device=x.device)
    prev = init.expand(b, s)
    for t in range(n_t):
        valid = t < lens
        _, e, shift = scaled_emissions(t)
        a = (prev if t == 0 else prec.mm(prev, trans)) * e
        n = a.sum(-1)
        a = a / n[:, None]
        prev = torch.where(valid[:, None], a, prev)
        alpha[:, t] = prev
        norms[:, t] = torch.where(valid, n, 1.0)
        log_z = log_z + torch.where(valid, torch.log(n) + shift, 0.0)
    end = (alpha[torch.arange(b, device=x.device), lens - 1] * final).sum(-1)
    log_z = log_z + torch.log(end)

    # backward: β̂_{L−1} = final, β̂_t = A·(e_{t+1} ⊙ β̂_{t+1}) / n_{t+1};
    # γ_t = α̂_t ⊙ β̂_t / ζ with ζ = α̂_{L−1}·final for every t
    zeta = end
    acc2 = torch.zeros(s, w.shape[0], dtype=dt, device=x.device)
    counts = torch.zeros(s, dtype=dt, device=x.device)
    xi = torch.zeros(s, s, dtype=dt, device=x.device)
    beta = final.expand(b, s)
    carry = None                          # e_{t+1} ⊙ β̂_{t+1} / n_{t+1}
    for t in range(n_t - 1, -1, -1):
        valid = t < lens
        last = t == lens - 1
        stats, e, _ = scaled_emissions(t)
        if carry is not None:
            beta = torch.where(last[:, None], final.expand(b, s), prec.mm(carry, trans.T))
        gamma = torch.where(valid[:, None], alpha[:, t] * beta / zeta[:, None], 0.0)
        acc2 = acc2 + prec.mm(gamma.T, stats)
        counts = counts + gamma.sum(0)
        if t == 0:
            gamma0 = gamma.sum(0)
        carry = torch.where(valid[:, None], e * beta / norms[:, t, None], 0.0)
        if t > 0:
            # ξ_t(i, j) = α̂_{t−1}(i) A_ij e_t(j) β̂_t(j) / (n_t ζ)
            xi = xi + prec.mm(alpha[:, t - 1].T, carry / zeta[:, None]) * trans
    return EStep(log_z, acc2, counts, gamma0, xi)


def viterbi(llh: torch.Tensor, lens: torch.Tensor, log_trans: torch.Tensor,
            log_init: torch.Tensor, log_final: torch.Tensor, backtrace: bool = True,
            log_trans_factor: torch.Tensor | None = None):
    """Best state paths (B, T) (frames past a row's end repeat its last
    state; None without ``backtrace``) and scores (B,) = max over paths of
    Σ llh + log transitions + log init + log final, by the dense (max, +)
    recursion in ``llh``'s dtype.  −inf marks a missing arc.  A transition
    that is a product of two factors takes the second in
    ``log_trans_factor`` (0 elsewhere): a candidate is then (δ + log a) +
    log b, added in that order."""
    tf32_off()
    b, t_len, s = llh.shape
    lens = lens.to(llh.device).long()
    n_t = int(lens.max())
    delta = log_init + llh[:, 0]
    choices = torch.zeros(b, n_t, s, dtype=torch.int16, device=llh.device) if backtrace else None
    for t in range(1, n_t):
        valid = t < lens
        cand = delta[:, :, None] + log_trans
        if log_trans_factor is not None:
            cand = cand + log_trans_factor
        best, arg = cand.max(1)
        new = best + llh[:, t]
        delta = torch.where(valid[:, None], new, delta)
        if backtrace:
            choices[:, t] = torch.where(valid[:, None], arg, torch.arange(s, device=llh.device))
    scores, state = (delta + log_final).max(-1)
    if not backtrace:
        return None, scores
    paths = torch.zeros(b, t_len, dtype=torch.long, device=llh.device)
    paths[:, n_t:] = state[:, None]
    rows = torch.arange(b, device=llh.device)
    for t in range(n_t - 1, -1, -1):
        paths[:, t] = state
        if t > 0:
            state = torch.where(t < lens, choices[rows, t, state].long(), state)
    return paths, scores
