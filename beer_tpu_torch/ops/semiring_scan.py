"""HMM recursions for the phone loop (PyTorch).

Counterpart of the parts of ``beer_tpu/ops/semiring_scan.py`` that the
phone-loop slice needs:

* the general probability-space path — :func:`forward_backward_probs`
  and :func:`expected_transition_counts_probs` over a dense (S, S)
  transition matrix, plain torch loops over time.  It is the oracle the
  fused route is held against and the body of ``PhoneLoop.smooth``;
* the fused phone-loop E-step ops :func:`phone_loop_forward` and
  :func:`phone_loop_estep_acc` and the banded decode
  :func:`viterbi_banded`.  Each runs the hand-written CUDA kernel
  (:mod:`beer_tpu_torch.ops.cuda_scan`) on CUDA tensors and its plain
  PyTorch version on CPU tensors; ``plain=True`` asks for the plain
  version on any device (the on-card reference route).

Conventions: ``llh`` (B, T, S) frame log-likelihoods; ``log_trans``
(S, S) with [i, j] = log p(j | i); ``log_init`` / ``log_final`` (S,);
``mask`` (B, T) prefix masks, 1.0 on real frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from beer_tpu_torch.ops import cuda_scan

_NEG_INF = -1e30  # avoids (-inf) - (-inf) = nan in masked/unreachable states


class FBProbs(NamedTuple):
    """Probability-space smoothing result (see the JAX package's FBProbs)."""

    probs_fwd: torch.Tensor       # (B, T, S) α̂ (per-frame normalized)
    posteriors: torch.Tensor      # (B, T, S) γ, zero on padded frames
    probs_w: torch.Tensor         # (B, T, S) normalize(e_llh·β̂) per frame
    w_sums: torch.Tensor          # (B, T) Σ_s e_llh_t(s)·β̂_t(s)
    post_norm: torch.Tensor       # (B, T) Σ_s α̂_t(s)·β̂_t(s) (pre-mask)
    fwd_log_scales: torch.Tensor  # (B, T) cumulative log-scale of α̂
    log_z: torch.Tensor           # (B,)


def _clamp(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=_NEG_INF)


def _scaled_forward(e_llh, trans, init_vec, mask):
    """Scaled forward recursion: normalized carries plus cumulative log-scale.

    Returns (probs (B, T, S), logcs (B, T), (last prob, last logc));
    masked steps copy the carry."""
    tiny = torch.finfo(e_llh.dtype).tiny
    prob = init_vec * e_llh[:, 0]
    norm = prob.sum(-1, keepdim=True).clamp_min(tiny)
    prob, logc = prob / norm, torch.log(norm[:, 0])
    probs, logcs = [prob], [logc]
    for t in range(1, e_llh.shape[1]):
        m_t = mask[:, t, None]
        raw = torch.matmul(prob, trans) * e_llh[:, t]
        norm = raw.sum(-1, keepdim=True).clamp_min(tiny)
        prob = m_t * (raw / norm) + (1 - m_t) * prob
        logc = m_t[:, 0] * (logc + torch.log(norm[:, 0])) + (1 - m_t[:, 0]) * logc
        probs.append(prob)
        logcs.append(logc)
    return torch.stack(probs, 1), torch.stack(logcs, 1), (prob, logc)


def _smoothing_scan(e_llh, trans, final_vec, mask, a_probs):
    """v-space backward recursion with the smoothing outputs in-step:
    (γ, ŵ, Σ e·β̂ (w_sums), Σ α̂·β̂ (post_norm)), each per frame."""
    b, t_len, _ = e_llh.shape
    tiny = torch.finfo(e_llh.dtype).tiny
    final = final_vec.expand(b, -1)
    mask_next = torch.cat([mask[:, 1:], mask.new_zeros(b, 1)], dim=1)
    v_hat = final / final.sum(-1, keepdim=True).clamp_min(tiny)
    outs = []
    for t in range(t_len - 1, -1, -1):
        m_t, mn_t = mask[:, t, None], mask_next[:, t, None]
        is_last = m_t * (1.0 - mn_t)
        u1 = torch.matmul(v_hat, trans.T)
        u1 = is_last * final + (1.0 - is_last) * u1
        nu = u1.sum(-1, keepdim=True).clamp_min(tiny)
        ab = a_probs[:, t] * (u1 / nu)
        pn = ab.sum(-1, keepdim=True)
        gamma = (ab / pn.clamp_min(tiny)) * m_t
        v = e_llh[:, t] * u1
        sv = v.sum(-1, keepdim=True).clamp_min(tiny)
        w = v / sv
        v_hat = m_t * w + (1.0 - m_t) * v_hat
        outs.append((gamma, w, (sv / nu)[:, 0], pn[:, 0]))
    gamma, w, wsum, pnorm = (torch.stack(x[::-1], 1) for x in zip(*outs))
    return gamma, w, wsum, pnorm


def forward_backward_probs(
    llh: torch.Tensor,
    log_trans: torch.Tensor,
    log_init: torch.Tensor,
    log_final: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> FBProbs:
    """Probability-space smoothing over a dense (S, S) transition matrix.

    γ_t = α̂_t·β̂_t / Σ_s α̂_t(s)·β̂_t(s) is exactly softmax(logα + logβ);
    ξ-counts come from :func:`expected_transition_counts_probs` on the
    same by-products."""
    b, t_len, s = llh.shape
    if mask is None:
        mask = llh.new_ones(b, t_len)
    tiny = torch.finfo(llh.dtype).tiny
    m_e = mask[..., None]
    m_llh = llh.max(-1, keepdim=True).values
    e_llh = torch.exp(llh - m_llh) * m_e + (1 - m_e) * 1.0
    shift_total = (m_llh[..., 0] * mask).sum(1)
    trans = torch.exp(log_trans)
    init_vec = torch.exp(_clamp(log_init)).expand(b, s)
    final_vec = torch.exp(_clamp(log_final)).expand(b, s)
    a_probs, a_logcs, (a_last, a_logc_last) = _scaled_forward(e_llh, trans, init_vec, mask)
    gamma, w, wsum, pnorm = _smoothing_scan(e_llh, trans, final_vec, mask, a_probs)
    log_z = a_logc_last + shift_total + torch.log(
        (a_last * final_vec).sum(-1).clamp_min(tiny))
    return FBProbs(a_probs, gamma, w, wsum, pnorm, a_logcs, log_z)


def expected_transition_counts_probs(
    fbp: FBProbs,
    log_trans: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    rows: Optional[torch.Tensor] = None,
    cols: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Σ_t ξ_t over the batch from :func:`forward_backward_probs`'s carries,
    optionally restricted to the block ``[rows][:, cols]``.

    The per-frame normalizer uᵀAw_{t+1} is recovered exactly from pass
    by-products: c_{t+1} · Σ α̂_{t+1}β̂_{t+1} / Σ e_{t+1}β̂_{t+1}."""
    tiny = torch.finfo(fbp.probs_fwd.dtype).tiny
    logcs = fbp.fwd_log_scales
    b, t_len = fbp.w_sums.shape
    u = fbp.probs_fwd[:, :-1]
    w = fbp.probs_w[:, 1:]
    step_norm = torch.exp(logcs[:, 1:] - logcs[:, :-1])
    denom = step_norm * fbp.post_norm[:, 1:] / fbp.w_sums[:, 1:].clamp_min(tiny)
    m_tail = u.new_ones(b, t_len - 1) if mask is None else mask[:, 1:]
    weight = torch.where(denom > 1e-30, m_tail / denom.clamp_min(1e-30), 0.0)
    trans_prob = torch.exp(log_trans)
    if rows is not None:
        # an exact gather: no selection product, so no rounding of ξ
        u, w = u[..., rows], w[..., cols]
        trans_prob = trans_prob[rows][:, cols]
    return torch.einsum("bti,btj,bt->ij", u, w, weight) * trans_prob


def bands_to_dense(bands) -> torch.Tensor:
    """(a_self, a_adv, exit, w) → the dense (S, S) probability matrix
    ``diag(a_self) + superdiag(a_adv) + outer(exit, w)``."""
    a_self, a_adv, exit_v, w_v = bands
    return torch.diag(a_self) + torch.diag(a_adv[:-1], 1) + exit_v[:, None] * w_v[None, :]


# ----------------------------------------------------------------------
# Fused phone-loop E-step and banded decode (kernel or plain version)
# ----------------------------------------------------------------------
def phone_loop_forward(stats, lens, w, bias, bands, init, plain: bool = False):
    """Scaled banded forward with llh = stats @ wᵀ + bias computed in the
    kernel: (α̂ (B, T, S), norms (B, T), last (B, S), logz_base (B,)).
    See :func:`cuda_scan.forward_llh_banded`."""
    fn = cuda_scan.forward_llh_banded_plain if plain else cuda_scan.forward_llh_banded
    return fn(stats, lens, w, bias, bands, init)


def phone_loop_estep_acc(stats, lens, w, bias, bands, final, alpha, norms, ends, starts,
                         plain: bool = False):
    """Accumulating smoothing pass over the stored forward: (acc2 (S, P),
    counts (S,), γ0 (B, S), xi_raw (U, U)).  See
    :func:`cuda_scan.estep_acc_banded`."""
    fn = cuda_scan.estep_acc_banded_plain if plain else cuda_scan.estep_acc_banded
    return fn(stats, lens, w, bias, bands, final, alpha, norms, ends, starts)


def log_bands(bands: torch.Tensor) -> torch.Tensor:
    """log of the band vectors, −1e30 where a band is 0."""
    return torch.where(bands > 0, torch.log(bands.clamp_min(1e-37)), _NEG_INF)


def viterbi_banded(llh, bands, log_init, log_final, mask=None, plain: bool = False):
    """Best-path decoding through the band + rank-1 factorisation.

    ``bands`` (4, S) probability-space vectors with ``bands_to_dense``
    equal to exp(log_trans) and no overlapping contributions (the
    phone-loop guarantee).  Returns ``(paths (B, T) int32, best
    log-prob (B,))``."""
    b, t_len, _ = llh.shape
    if mask is None:
        lens = torch.full((b,), t_len, dtype=torch.int32, device=llh.device)
    else:
        lens = mask.sum(-1).to(torch.int32)
    if plain:
        fwd, back = cuda_scan.viterbi_fwd_banded_plain, cuda_scan.viterbi_backtrace_banded_plain
    else:
        fwd, back = cuda_scan.viterbi_fwd_banded, cuda_scan.viterbi_backtrace_banded
    choices, exarg, alpha_last = fwd(llh.contiguous(), lens, log_bands(bands).contiguous(),
                                     _clamp(log_init).contiguous())
    return back(choices, exarg, alpha_last, log_final.contiguous())
