"""HMM recursions (PyTorch).

Counterpart of the parts of ``beer_tpu/ops/semiring_scan.py`` that the
phone-loop and HMM slices need:

* the general path — :func:`forward_backward_probs` (probability space)
  and :func:`forward_backward` (log domain) with their ξ counts
  :func:`expected_transition_counts_probs` /
  :func:`expected_transition_counts`, over a shared (S, S) or
  per-utterance (B, S, S) transition matrix, and the dense (max,+)
  :func:`viterbi`.  On one shared matrix the recursions are the kernels
  K12 (``scaled_pass``: dense forward, banded forward, dense reverse) and
  K13 (``smoothing_pass``: dense, banded) on CUDA tensors, with a
  gradient through :class:`ScaledPass` / :class:`SmoothingPass`;
  per-utterance matrices take plain torch loops over time.  It is the
  oracle the fused routes are held against, the body of
  ``PhoneLoop.smooth`` (the materialised posteriors of the subspace-HMM
  statistics bridge) and of the per-utterance-graph E-step and posteriors;
* :func:`forward_llh` (K14) and :func:`phone_loop_estep` (K15): the
  llh-stream scaled forward with the row-max shifts written out, and the
  γ-emitting dense backward with ξ restricted to a block;
* the fused phone-loop E-step ops :func:`phone_loop_forward` and
  :func:`phone_loop_estep_acc` and the banded decode
  :func:`viterbi_banded`, and the fused dense-transition HMM E-step ops
  :func:`hmm_forward`, :func:`hmm_estep_acc` and :func:`hmm_estep_gamma`.
  Each runs the hand-written CUDA kernel
  (:mod:`beer_tpu_torch.ops.cuda_scan`) on CUDA tensors and its plain
  PyTorch version on CPU tensors; ``plain=True`` asks for the plain
  version on any device (the on-card reference route);
* the log-carry recursions :func:`forward` and :func:`backward` (the
  readable reference of the scaled passes) and :func:`forward_assoc`,
  log α as a scan of (S, S) log-semiring operators: sequential over
  blocks of ``chunk`` frames, a log-depth tree of products within each
  block.  Plain torch on every device; no ported path calls them;
* the differentiable log Z of both fused routes, :class:`PhoneLoopLogZ`
  (K1 + K11) and :class:`HMMLogZ` (K5 + K7): ``torch.autograd.Function`` classes
  whose backward is the Fisher identity ∂log Z/∂llh = γ, the
  structured VAE's gradient through its latent sequence model.

Conventions: ``llh`` (B, T, S) frame log-likelihoods; ``log_trans``
(S, S) or (B, S, S) with [..., i, j] = log p(j | i); ``log_init`` /
``log_final`` (S,) or (B, S); ``mask`` (B, T) prefix masks, 1.0 on real
frames.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.utils.profiling import named_scope

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


class FBResult(NamedTuple):
    """Log-domain smoothing result (see the JAX package's FBResult)."""

    log_alpha: torch.Tensor   # (B, T, S)
    log_beta: torch.Tensor    # (B, T, S)
    log_z: torch.Tensor       # (B,)
    posteriors: torch.Tensor  # (B, T, S) γ, zero on padded frames


def _clamp(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=_NEG_INF)


def _scaled_likelihoods(llh, mask):
    """e_llh = exp(llh − rowmax), 1 on masked frames, and the masked row
    maxima (B, T) that go back into the log-scales."""
    m_e = mask[..., None]
    m_llh = llh.max(-1, keepdim=True).values
    return torch.exp(llh - m_llh) * m_e + (1 - m_e), m_llh[..., 0] * mask


def _recompute_vjp(fn, tensors, needs, cts):
    """Gradients of ``fn(*tensors)`` (a plain, differentiable recursion)
    recomputed from the saved inputs: one per tensor, None where
    ``needs`` says no gradient is asked for."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(need) for x, need in zip(tensors, needs)]
        pairs = [(out, ct) for out, ct in zip(fn(*inputs), cts) if out.requires_grad]
        grads = torch.autograd.grad([out for out, _ in pairs],
                                    [x for x in inputs if x.requires_grad],
                                    [ct for _, ct in pairs], allow_unused=True)
    it = iter(grads)
    return tuple(next(it) if need else None for need in needs)


class ScaledPass(torch.autograd.Function):
    """K12 with a gradient: the kernel in the forward, and in the backward
    the plain recursion recomputed from the saved inputs and differentiated
    (the counterpart of the JAX package's ``_make_pallas_diffable``).

    ``ScaledPass.apply(e_llh, trans, vec, lens, banded, reverse) ->
    (probs, logcs)``; see :func:`cuda_scan.scaled_pass`."""

    @staticmethod
    def forward(ctx, e_llh, trans, vec, lens, banded, reverse):
        ctx.save_for_backward(e_llh, trans, vec, lens)
        ctx.flags = (banded, reverse)
        return cuda_scan.scaled_pass(e_llh, lens, trans, vec, banded, reverse)

    @staticmethod
    def backward(ctx, *cts):
        *tensors, lens = ctx.saved_tensors
        banded, reverse = ctx.flags
        grads = _recompute_vjp(
            lambda e, a, v: cuda_scan.scaled_pass_plain(e, lens, a, v, banded, reverse),
            tensors, ctx.needs_input_grad[:3], cts)
        return (*grads, None, None, None)


class SmoothingPass(torch.autograd.Function):
    """K13 with a gradient, as :class:`ScaledPass` (the JAX package's
    ``_make_smoothing_diffable``).

    ``SmoothingPass.apply(e_llh, a_probs, trans, final, lens, banded) ->
    (gamma, w_probs, w_sums, post_norm)``; see
    :func:`cuda_scan.smoothing_pass`."""

    @staticmethod
    def forward(ctx, e_llh, a_probs, trans, final, lens, banded):
        ctx.save_for_backward(e_llh, a_probs, trans, final, lens)
        ctx.banded = banded
        return cuda_scan.smoothing_pass(e_llh, a_probs, lens, trans, final, banded)

    @staticmethod
    def backward(ctx, *cts):
        *tensors, lens = ctx.saved_tensors
        banded = ctx.banded
        grads = _recompute_vjp(
            lambda e, a, m, f: cuda_scan.smoothing_pass_plain(e, a, lens, m, f, banded),
            tensors, ctx.needs_input_grad[:4], cts)
        return (*grads, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def _general_passes(e_llh, mask, log_trans, structured_trans, plain):
    """The scaled pass and the smoothing pass of the general path on these
    operands, as ``(run_scaled(vec, reverse), run_smoothing(a_probs,
    final))``.

    One shared (S, S) matrix goes through K12/K13 (the kernels on CUDA
    tensors, their plain versions on CPU tensors; banded when
    ``structured_trans`` is given, except for the reverse pass, which has
    no banded instance), by way of :class:`ScaledPass` /
    :class:`SmoothingPass` when an input requires grad.  Per-utterance
    (B, S, S) matrices, and ``plain``, take the plain torch loops on any
    device."""
    trans = torch.exp(log_trans)
    if trans.ndim == 3 or plain:
        if trans.ndim == 3:
            steps = (lambda p: torch.bmm(p[:, None], trans)[:, 0],
                     lambda v: torch.bmm(trans, v[..., None])[..., 0])
            dense_steps = steps
        else:
            dense_steps = cuda_scan._general_steps(trans, False)
            steps = dense_steps if structured_trans is None else \
                cuda_scan._general_steps(structured_trans, True)

        def run_scaled(vec, reverse=False):
            step = dense_steps[1] if reverse else steps[0]
            return cuda_scan.scaled_loop(e_llh, mask, vec, step, reverse)

        def run_smoothing(a_probs, final):
            return cuda_scan.smoothing_loop(e_llh, mask, final, a_probs, steps[1])

        return run_scaled, run_smoothing

    lens = mask.sum(-1).to(torch.int32)
    if not bool((mask == cuda_scan._prefix_mask(lens, mask.shape[1], mask)).all()):
        raise ValueError("the general-path kernels take the lengths of prefix masks: this mask "
                         "has a gap; pass plain=True for a mask that is honoured frame by frame")
    banded = structured_trans is not None
    mat = structured_trans.to(e_llh.dtype).contiguous() if banded else trans.contiguous()
    dense = trans.contiguous()

    def run_scaled(vec, reverse=False):
        use_bands = banded and not reverse
        args = (e_llh, mat if use_bands else dense, vec.contiguous())
        if _needs_grad(*args):
            return ScaledPass.apply(*args, lens, use_bands, reverse)
        return cuda_scan.scaled_pass(args[0], lens, args[1], args[2], use_bands, reverse)

    def run_smoothing(a_probs, final):
        args = (e_llh, a_probs, mat, final.contiguous())
        if _needs_grad(*args):
            return SmoothingPass.apply(*args, lens, banded)
        return cuda_scan.smoothing_pass(args[0], args[1], lens, args[2], args[3], banded)

    return run_scaled, run_smoothing


def _fb_operands(llh, log_init, log_final, mask):
    b, t_len, s = llh.shape
    if mask is None:
        mask = llh.new_ones(b, t_len)
    e_llh, shifts = _scaled_likelihoods(llh, mask)
    init_vec = torch.exp(_clamp(log_init)).expand(b, s).to(llh.dtype)
    final_vec = torch.exp(_clamp(log_final)).expand(b, s).to(llh.dtype)
    return mask, e_llh.contiguous(), shifts, init_vec, final_vec


def forward_backward_probs(
    llh: torch.Tensor,
    log_trans: torch.Tensor,
    log_init: torch.Tensor,
    log_final: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    structured_trans: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> FBProbs:
    """Probability-space smoothing over a dense (S, S) or per-utterance
    (B, S, S) transition matrix, with (S,) or (B, S) init/final vectors.

    γ_t = α̂_t·β̂_t / Σ_s α̂_t(s)·β̂_t(s) is exactly softmax(logα + logβ);
    ξ-counts come from :func:`expected_transition_counts_probs` on the
    same by-products.

    One shared matrix runs the scaled forward (K12) and the smoothing
    backward (K13) as kernels on CUDA tensors — through the band + rank-1
    instances when ``structured_trans`` (4, S) = [a_self, a_adv, exit, w]
    is given (it must densify to exp(log_trans); a phone loop guarantees
    it) — and differentiably (see :class:`ScaledPass`).  The kernels take
    the lengths of prefix masks: a ``mask`` with a gap raises.  Per-utterance
    matrices, and ``plain=True`` on any device, take the plain torch loops
    over time.  On frames t >= len only ``posteriors`` (0),
    ``probs_fwd`` and ``fwd_log_scales`` (the last valid values) are
    defined; the other by-products differ between the routes there."""
    mask, e_llh, shifts, init_vec, final_vec = _fb_operands(llh, log_init, log_final, mask)
    tiny = torch.finfo(llh.dtype).tiny
    run_scaled, run_smoothing = _general_passes(e_llh, mask, log_trans, structured_trans, plain)
    a_probs, a_logcs = run_scaled(init_vec)
    gamma, w, wsum, pnorm = run_smoothing(a_probs, final_vec)
    log_z = a_logcs[:, -1] + shifts.sum(1) + torch.log(
        (a_probs[:, -1] * final_vec).sum(-1).clamp_min(tiny))
    return FBProbs(a_probs, gamma, w, wsum, pnorm, a_logcs, log_z)


def forward_backward(
    llh: torch.Tensor,
    log_trans: torch.Tensor,
    log_init: torch.Tensor,
    log_final: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> FBResult:
    """Full smoothing pass in the log domain: log α, log β, log Z and the
    per-frame state posteriors softmax(log α + log β).

    Runs the scaled forward and the scaled β̂ pass (K12, dense forward and
    dense reverse, on a shared (S, S) matrix on CUDA tensors; the plain
    loops otherwise, as :func:`forward_backward_probs`) and recovers the
    log-domain arrays with one vectorised log over the stored outputs."""
    mask, e_llh, shifts, init_vec, final_vec = _fb_operands(llh, log_init, log_final, mask)
    tiny = torch.finfo(llh.dtype).tiny
    shift_fwd = torch.cumsum(shifts, dim=1)
    run_scaled, _ = _general_passes(e_llh, mask, log_trans, None, plain)
    a_probs, a_logcs = run_scaled(init_vec)
    log_alpha = torch.log(a_probs.clamp_min(tiny)) + (a_logcs + shift_fwd)[..., None]
    b_probs, b_logcs = run_scaled(final_vec, reverse=True)
    # the shift of β_t: the row maxima of the valid frames t+1 … T−1
    shift_bwd = shift_fwd[:, -1:] - shift_fwd
    log_beta = torch.log(b_probs.clamp_min(tiny)) + (b_logcs + shift_bwd)[..., None]
    log_z = a_logcs[:, -1] + shift_fwd[:, -1] + torch.log(
        (a_probs[:, -1] * final_vec).sum(-1).clamp_min(tiny))
    posteriors = torch.softmax(log_alpha + log_beta, dim=-1) * mask[..., None]
    return FBResult(log_alpha, log_beta, log_z, posteriors)


def _xi_outer(u, w, weight, trans_prob, rows, cols, pooled=False):
    """Σ_t weight_t · outer(u_t, w_t) ⊙ A over the batch, optionally
    restricted to ``[rows][:, cols]`` (shared (S, S) matrix only; a
    per-utterance (B, S, S) one weighs each utterance's outer products by
    its own matrix, or with ``pooled`` multiplies the batch's summed outer
    products by each utterance's matrix, (B, S, S))."""
    if trans_prob.ndim == 3:
        if pooled:
            return torch.einsum("bti,btj,bt->ij", u, w, weight) * trans_prob
        return torch.einsum("bti,btj,bt,bij->ij", u, w, weight, trans_prob)
    if rows is not None:
        # an exact gather: no selection product, so no rounding of ξ
        u, w = u[..., rows], w[..., cols]
        trans_prob = trans_prob[rows][:, cols]
    return torch.einsum("bti,btj,bt->ij", u, w, weight) * trans_prob


def expected_transition_counts_probs(
    fbp: FBProbs,
    log_trans: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    rows: Optional[torch.Tensor] = None,
    cols: Optional[torch.Tensor] = None,
    pooled: bool = False,
) -> torch.Tensor:
    """Σ_t ξ_t over the batch from :func:`forward_backward_probs`'s carries,
    optionally restricted to the block ``[rows][:, cols]``.

    ``pooled`` (per-utterance (B, S, S) matrices only) returns the JAX
    package's quantity instead: the batch's summed outer products times
    each utterance's own matrix, (B, S, S) — not each utterance's ξ
    (ROADMAP §C, in both packages).

    The per-frame normalizer uᵀAw_{t+1} is recovered exactly from pass
    by-products: c_{t+1} · Σ α̂_{t+1}β̂_{t+1} / Σ e_{t+1}β̂_{t+1}, with the
    per-step scale c_{t+1} = exp(logc_{t+1} − logc_t) taken from the
    cumulative log-scales (in float32 that difference loses digits as logc
    grows: ξ agrees with a float64 run to about 1e-4, relative)."""
    tiny = torch.finfo(fbp.probs_fwd.dtype).tiny
    logcs = fbp.fwd_log_scales
    b, t_len = fbp.w_sums.shape
    u = fbp.probs_fwd[:, :-1]
    w = fbp.probs_w[:, 1:]
    step_norm = torch.exp(logcs[:, 1:] - logcs[:, :-1])
    denom = step_norm * fbp.post_norm[:, 1:] / fbp.w_sums[:, 1:].clamp_min(tiny)
    m_tail = u.new_ones(b, t_len - 1) if mask is None else mask[:, 1:]
    weight = torch.where(denom > 1e-30, m_tail / denom.clamp_min(1e-30), 0.0)
    return _xi_outer(u, w, weight, torch.exp(log_trans), rows, cols, pooled)


def expected_transition_counts(
    log_alpha: torch.Tensor,
    log_beta: torch.Tensor,
    llh: torch.Tensor,
    log_trans: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    rows: Optional[torch.Tensor] = None,
    cols: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Σ_t ξ_t over the batch from :func:`forward_backward`'s log-domain
    arrays: ξ_t = outer(u_t, w_{t+1}) ⊙ A / (u_tᵀ A w_{t+1}) with u =
    softmax(log α_t) and w = softmax(llh_{t+1} + log β_{t+1}), so the
    result depends on no absolute scale of the recursions."""
    b, t_len, _ = llh.shape
    if mask is None:
        mask = llh.new_ones(b, t_len)
    u = torch.softmax(log_alpha[:, :-1], dim=-1)
    w = torch.softmax(_clamp(llh[:, 1:] + log_beta[:, 1:]), dim=-1)
    trans_prob = torch.exp(log_trans)
    spec = "bti,bij,btj->bt" if trans_prob.ndim == 3 else "bti,ij,btj->bt"
    denom = torch.einsum(spec, u, trans_prob, w)
    weight = torch.where(denom > 1e-30, mask[:, 1:] / denom.clamp_min(1e-30), 0.0)
    return _xi_outer(u, w, weight, trans_prob, rows, cols)


def _log_matvec(carry: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """log(exp(carry) @ trans) per row, shifted by the row maximum, for
    (S, S) or per-utterance (B, S, S) probabilities ``trans``."""
    shift = carry.max(-1, keepdim=True).values
    scaled = torch.exp(carry - shift)
    prod = (torch.einsum("bs,bst->bt", scaled, trans) if trans.ndim == 3
            else scaled @ trans)
    return shift + torch.log(prod.clamp_min(torch.finfo(carry.dtype).tiny))


def forward(llh, log_trans, log_init, mask=None):
    """Batched forward recursion with a log-domain carry: (log α (B, T, S),
    the final carry (B, S)).  Padded steps pass the carry through, so the
    final carry is each sequence's log α at its last frame."""
    b, t_len, s = llh.shape
    if mask is None:
        mask = llh.new_ones(b, t_len)
    trans = torch.exp(log_trans)
    carry = _clamp(log_init + llh[:, 0]) * mask[:, :1]
    alphas = [carry]
    for t in range(1, t_len):
        m_t = mask[:, t, None]
        new = _clamp(llh[:, t] + _log_matvec(carry, trans))
        carry = m_t * new + (1 - m_t) * carry
        alphas.append(carry)
    return torch.stack(alphas, dim=1), carry


def backward(llh, log_trans, log_final, mask=None):
    """Batched backward recursion with a log-domain carry; log β (B, T, S).
    Padded frames carry the final vector back unchanged, so β at each
    sequence's last frame is ``log_final``."""
    b, t_len, s = llh.shape
    if mask is None:
        mask = llh.new_ones(b, t_len)
    trans_t = torch.exp(log_trans).transpose(-1, -2)
    carry = _clamp(log_final).expand(b, s).to(llh.dtype)
    betas = [carry]
    for t in range(t_len - 1, 0, -1):
        m_t = mask[:, t, None]
        new = _clamp(_log_matvec(_clamp(llh[:, t] + carry), trans_t))
        carry = m_t * new + (1 - m_t) * carry
        betas.append(carry)
    return torch.stack(betas[::-1], dim=1)


def _semiring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(logsumexp, +) product of batched (..., S, S) log-matrices."""
    a_shift = a.max(-1, keepdim=True).values     # rows of a
    b_shift = b.max(-2, keepdim=True).values     # columns of b
    prod = torch.exp(a - a_shift) @ torch.exp(b - b_shift)
    return _clamp(a_shift + b_shift + torch.log(prod.clamp_min(1e-37)))


def _prefix_products(ops: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along axis 1 of (B, C, S, S) operators,
    ops_0 ⊗ … ⊗ ops_t, in ⌈log2 C⌉ rounds of products (recursive
    doubling)."""
    off = 1
    while off < ops.shape[1]:
        ops = torch.cat([ops[:, :off], _semiring_matmul(ops[:, :-off], ops[:, off:])], dim=1)
        off *= 2
    return ops


def forward_assoc(llh, log_trans, log_init, mask=None, chunk: Optional[int] = None):
    """log α via prefix products of transition operators (log depth in T).

    The operator of step t > 0 is M_t[i, j] = log A[i, j] + llh[t, j]
    (the identity on padded steps); the t = 0 operator holds α_0 in every
    row, so row 0 of the prefix product ending at t is α_t.  ``chunk=None``
    holds (B, T, S, S) operators at once; ``chunk=C`` bounds them at (B,
    C, S, S): blocks of C frames run one after the other, each a
    log-depth product tree applied to the carry of the block before.
    Returns (log α (B, T, S), log α at each sequence's last frame (B, S))."""
    b, t_len, s = llh.shape
    if mask is None:
        mask = llh.new_ones(b, t_len)
    eye = torch.full((s, s), _NEG_INF, dtype=llh.dtype, device=llh.device)
    eye.fill_diagonal_(0.0)
    alpha0 = _clamp(log_init + llh[:, 0])

    def operators(llh_b, m_b):
        ops = log_trans + llh_b[:, :, None, :]
        return torch.where(m_b[:, :, None, None] > 0, ops, eye)

    if chunk is None or chunk >= t_len:
        ops = operators(llh, mask)
        ops[:, 0] = alpha0[:, None, :].expand(b, s, s)
        log_alpha = _prefix_products(ops)[:, :, 0, :]
    else:
        # the first block's t = 0 operator holds α_0 in every row and the
        # carry into it is −log S per state (logsumexp 0), so α_0 is exact
        carry = llh.new_full((b, s), -math.log(s))
        blocks = []
        for start in range(0, t_len, chunk):
            ops = operators(llh[:, start:start + chunk], mask[:, start:start + chunk])
            if start == 0:
                ops[:, 0] = alpha0[:, None, :].expand(b, s, s)
            prefix = _prefix_products(ops)
            alpha_b = torch.logsumexp(carry[:, None, :, None] + prefix, dim=2)
            carry = alpha_b[:, -1]
            blocks.append(alpha_b)
        log_alpha = torch.cat(blocks, dim=1)
    last = (mask.sum(1) - 1).long().clamp_min(0)
    return log_alpha, log_alpha[torch.arange(b, device=llh.device), last]


def viterbi(llh, log_trans, log_init, log_final, mask=None):
    """Batched best-path decoding over a dense (S, S) or per-utterance
    (B, S, S) transition matrix, (S,) or (B, S) init/final.

    Returns ``(paths (B, T) int32, best log-prob (B,))``; paths are valid
    where mask = 1 (padded frames repeat the last state).  Arg-maxes take
    the first index on ties, as the JAX package's ``jnp.argmax`` does."""
    b, t_len, s = llh.shape
    if mask is None:
        mask = llh.new_ones(b, t_len)
    score = _clamp(log_init + llh[:, 0]).expand(b, s)
    ids = torch.arange(s, device=llh.device).expand(b, s)
    lt = log_trans if log_trans.ndim == 3 else log_trans[None]
    bps = []
    for t in range(1, t_len):
        valid = mask[:, t, None] > 0
        best, best_prev = (score[:, :, None] + lt).max(dim=1)   # over S_prev
        score = torch.where(valid, _clamp(llh[:, t] + best), score)
        bps.append(torch.where(valid, best_prev, ids))           # identity on pads
    best_score, state = (score + log_final).max(dim=-1)
    paths = torch.empty(b, t_len, dtype=torch.int32, device=llh.device)
    if t_len == 0:
        return paths, best_score
    paths[:, -1] = state
    for t in range(t_len - 1, 0, -1):
        state = bps[t - 1].gather(1, state[:, None])[:, 0]
        paths[:, t - 1] = state
    return paths, best_score


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


def hmm_forward(x, lens, trans, init, w=None, bias=None, plain: bool = False):
    """Scaled dense forward: (α̂ (B, T, S), norms (B, T), last (B, S),
    logz_base (B,)) from the llh stream ``x`` (B, T, S), or from the
    reduced stats ``x`` (B, T, P) with llh = x @ wᵀ + bias computed in
    the kernel.  See :func:`cuda_scan.forward_llh_dense`."""
    fn = cuda_scan.forward_llh_dense_plain if plain else cuda_scan.forward_llh_dense
    return fn(x, lens, trans, init, w, bias)


def hmm_estep_acc(stats, lens, w, bias, trans, final, alpha, norms, plain: bool = False):
    """Accumulating dense smoothing pass over the stored forward: (acc2
    (S, P), counts (S,), γ0 (B, S), xi_raw (S, S)).  See
    :func:`cuda_scan.estep_acc_dense`."""
    fn = cuda_scan.estep_acc_dense_plain if plain else cuda_scan.estep_acc_dense
    return fn(stats, lens, w, bias, trans, final, alpha, norms)


def hmm_estep_gamma(llh, lens, trans, final, alpha, norms, plain: bool = False):
    """γ-emitting dense smoothing pass over the stored forward: (γ (B, T,
    S), xi_raw (S, S)).  See :func:`cuda_scan.estep_gamma_dense`."""
    fn = cuda_scan.estep_gamma_dense_plain if plain else cuda_scan.estep_gamma_dense
    return fn(llh, lens, trans, final, alpha, norms)


def forward_llh(llh, trans, init, lens, plain: bool = False):
    """Scaled dense forward from the raw llh stream (B, T, S): (α̂ (B, T, S),
    per-step norms (B, T), masked row-max shifts (B, T)), with
    log Z = Σ_t log norm_t + Σ_t shift_t + log Σ α̂[:, −1]·final.  Masked
    frames repeat the last valid α̂ with norm 1 and shift 0, and frame 0
    fires on every row.  Batch-major and over lengths, like the port's
    other fused ops (the JAX function is time-major over a mask).  Not
    differentiable: :class:`HMMLogZ` is the gradient route over an llh
    stream.  See :func:`cuda_scan.forward_llh_dense` (``return_shifts``)."""
    fn = cuda_scan.forward_llh_dense_plain if plain else cuda_scan.forward_llh_dense
    alpha, norms, _, _, shifts = fn(llh, lens, trans, init, return_shifts=True)
    return alpha, norms, shifts


def phone_loop_estep(llh, alpha, norms, trans, final, lens, rows, cols, plain: bool = False):
    """γ-emitting dense smoothing pass with ξ restricted in the kernel:
    (γ (B, T, S), xi_raw (n_r, n_c)) from the llh stream and
    :func:`forward_llh`'s α̂ and norms; multiply ``xi_raw`` by
    ``trans[rows][:, cols]`` for the expected counts.  ``rows``/``cols``
    are int32 state indices.  See :func:`cuda_scan.estep_gamma_dense`."""
    fn = cuda_scan.estep_gamma_dense_plain if plain else cuda_scan.estep_gamma_dense
    return fn(llh, lens, trans, final, alpha, norms, rows, cols)


def phone_loop_estep_reference(llh, log_trans, log_init, log_final, mask, rows, cols):
    """The general-path composition equal to :func:`forward_llh` +
    :func:`phone_loop_estep`: (γ (B, T, S), raw ξ outer (n_r, n_c))."""
    fbp = forward_backward_probs(llh, log_trans, log_init, log_final, mask, plain=True)
    xi = expected_transition_counts_probs(fbp, log_trans, mask, rows=rows, cols=cols)
    trans_blk = torch.exp(log_trans)[rows][:, cols]
    xi_raw = torch.where(trans_blk > 0,
                         xi / trans_blk.clamp_min(torch.finfo(llh.dtype).tiny), 0.0)
    return fbp.posteriors, xi_raw


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
    with named_scope("beer.operands"):
        if mask is None:
            lens = torch.full((b,), t_len, dtype=torch.int32, device=llh.device)
        else:
            lens = mask.sum(-1).to(torch.int32)
        operands = (llh.contiguous(), lens, log_bands(bands).contiguous(),
                    _clamp(log_init).contiguous())
    if plain:
        fwd, back = cuda_scan.viterbi_fwd_banded_plain, cuda_scan.viterbi_backtrace_banded_plain
    else:
        fwd, back = cuda_scan.viterbi_fwd_banded, cuda_scan.viterbi_backtrace_banded
    choices, exarg, alpha_last = fwd(*operands)
    return back(choices, exarg, alpha_last, log_final.contiguous())


# ----------------------------------------------------------------------
# Differentiable log Z (the Fisher identity)
# ----------------------------------------------------------------------
def log_z_from_forward(logz_base, last, final, lens):
    """log Z = logz_base + log Σ last·final from a scaled forward's
    outputs, 0 for empty rows."""
    tiny = torch.finfo(last.dtype).tiny
    log_z = logz_base + torch.log((last * final).sum(-1).clamp_min(tiny))
    return torch.where(lens > 0, log_z, 0.0)


class PhoneLoopLogZ(torch.autograd.Function):
    """Differentiable log Z of the phone loop through its fused kernels.

    Counterpart of the JAX package's ``phone_loop_logz_stats_lm`` /
    ``phone_loop_logz_stats_alpha_lm`` custom VJPs.  The forward runs K1
    (scaled banded forward, llh = stats @ wᵀ + bias in the kernel), then
    K11 over K1's stored α̂ and norms: the state posteriors γ (B, T, S),
    γ0 (B, S) and the loop-back ``xi_raw`` (U, U) of
    :func:`cuda_scan.estep_gamma_banded`.  They come out detached (the
    accumulation reduces them) and γ is kept for the backward.  K11 runs
    in the forward, not in the backward as on the TPU, so that one pass
    serves both the statistics and the gradient.

    The backward is the Fisher identity ∂log Z_b/∂llh_b = γ_b: d_stats =
    (γ·ct) @ w, and d_w = (γ·ct)ᵀ stats, d_bias = Σ γ·ct when those need
    a gradient.  Transitions, init and final get none: they are trained
    by the conjugate update (as in the JAX package).  Frames t >= len and
    empty rows get zero gradient; their log Z is 0.

    ``PhoneLoopLogZ.apply(stats (B, T, P), lens (B,) int32, w (S, P), bias
    (S,), bands (4, S), init (S,), final (S,), ends (U,), starts (U,),
    plain) -> (log_z (B,), gamma, gamma0, xi_raw)``.
    """

    @staticmethod
    def forward(ctx, stats, lens, w, bias, bands, init, final, ends, starts, plain=False):
        alpha, norms, last, logz_base = phone_loop_forward(stats, lens, w, bias, bands, init,
                                                           plain=plain)
        fn = cuda_scan.estep_gamma_banded_plain if plain else cuda_scan.estep_gamma_banded
        gamma, gamma0, xi_raw = fn(stats, lens, w, bias, bands, final, alpha, norms, ends, starts)
        ctx.save_for_backward(gamma, stats, w)
        ctx.mark_non_differentiable(gamma, gamma0, xi_raw)
        return log_z_from_forward(logz_base, last, final, lens), gamma, gamma0, xi_raw

    @staticmethod
    def backward(ctx, ct, *_):
        gamma, stats, w = ctx.saved_tensors
        g = gamma * ct[:, None, None]
        need = ctx.needs_input_grad
        d_stats = torch.matmul(g, w) if need[0] else None
        d_w = g.flatten(0, 1).T @ stats.flatten(0, 1) if need[2] else None
        d_bias = g.sum((0, 1)) if need[3] else None
        return d_stats, None, d_w, d_bias, None, None, None, None, None, None


class HMMLogZ(torch.autograd.Function):
    """Differentiable log Z of an HMM over one shared (S, S) matrix.

    Counterpart of the JAX package's ``forward_llh_ckpt_lm`` and
    ``hmm_logz_stats_lm`` custom VJPs, over the llh stream: the forward
    runs K5 (llh mode), then K7, which gives γ (B, T, S) and the full
    ``xi_raw`` (S, S), both detached; γ is kept for the backward,
    d_llh = γ·ct (the Fisher identity).  Autograd carries it on through
    the pdf map and the emissions' ELLH.  The transition matrix, init and
    final get no gradient (conjugate-trained).

    ``HMMLogZ.apply(llh (B, T, S), lens (B,) int32, trans (S, S), init
    (B, S), final (B, S), plain) -> (log_z (B,), gamma, xi_raw)``.
    """

    @staticmethod
    def forward(ctx, llh, lens, trans, init, final, plain=False):
        alpha, norms, last, logz_base = hmm_forward(llh, lens, trans, init, plain=plain)
        gamma, xi_raw = hmm_estep_gamma(llh, lens, trans, final, alpha, norms, plain=plain)
        ctx.save_for_backward(gamma)
        ctx.mark_non_differentiable(gamma, xi_raw)
        return log_z_from_forward(logz_base, last, final, lens), gamma, xi_raw

    @staticmethod
    def backward(ctx, ct, *_):
        (gamma,) = ctx.saved_tensors
        return gamma * ct[:, None, None], None, None, None, None, None
