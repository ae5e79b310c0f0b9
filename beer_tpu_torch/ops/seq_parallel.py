"""Sequence-parallel HMM inference: time sharded over a mesh dimension.

Counterpart of ``beer_tpu/ops/seq_parallel.py`` (plain torch; the JAX
module has no Pallas kernel either).  The forward recursion runs as a
blockwise temporal parallelisation (the prefix-product formulation of
arXiv:2102.05743, distributed):

1. each rank folds its block of frames into (S, S) log-semiring
   transition operators and takes their inclusive prefix products
   (:func:`~beer_tpu_torch.ops.semiring_scan._prefix_products`, ⌈log2
   T_local⌉ rounds);
2. the block products are combined across ranks by a Hillis-Steele scan
   whose rounds are point-to-point exchanges (``batch_isend_irecv``)
   within the mesh dimension's group (⌈log2 n⌉ rounds);
3. the exclusive rank prefix seeds the block's α with one batched
   semiring product.

The backward runs the same machinery on suffix products, with the final
vector folded in as a column-constant operator, so α, β, log Z and the
posteriors are all available time-sharded
(:func:`forward_backward_time_sharded`).  On a 2-D ``("data", "seq")``
mesh the batch can be split over ``"data"`` at the same time.  Work is
O(T·S³/n) a rank against O(T·S²) for the sequential scan: worth it when
T is huge or the scan's T serial steps dominate.

:func:`forward_time_sharded`, :func:`backward_time_sharded` and
:func:`forward_backward_time_sharded` take a rank's own block of frames;
:func:`make_sharded_forward` and :func:`make_sharded_forward_backward`
build callers that take the whole (B, T, S) on every rank, use their
block and return the whole arrays on every rank.  A dimension of size 1
runs no point-to-point round (NCCL has no send to oneself).

Conventions: ``llh`` (B, T, S); ``log_trans`` (S, S); ``log_init`` /
``log_final`` (S,); ``mask`` (B, T) prefix masks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from beer_tpu_torch.ops.semiring_scan import _NEG_INF, _clamp, _prefix_products, _semiring_matmul


class _Axis:
    """A mesh dimension as this rank sees it: its group, size, this
    rank's coordinate and the global ranks along it."""

    def __init__(self, mesh, axis_name: str):
        dim = mesh.mesh_dim_names.index(axis_name)
        self.group = mesh.get_group(axis_name)
        self.size = mesh.size(dim)
        self.index = mesh.get_local_rank(axis_name)
        coord = mesh.get_coordinate()
        line = tuple(slice(None) if d == dim else c for d, c in enumerate(coord))
        self.ranks = mesh.mesh[line].tolist()

    def shift(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        """Every rank sends ``x`` to the rank ``offset`` further along the
        dimension (cyclically) and returns what it received from the rank
        ``offset`` back: ``ppermute`` with ``i → i + offset``."""
        if self.size == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, self.ranks[(self.index + offset) % self.size],
                          self.group),
               dist.P2POp(dist.irecv, out, self.ranks[(self.index - offset) % self.size],
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def max(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def gather_time(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks of every rank along axis 1, in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)


def _identity_op(s: int, like: torch.Tensor) -> torch.Tensor:
    eye = torch.full((s, s), _NEG_INF, dtype=like.dtype, device=like.device)
    return eye.fill_diagonal_(0.0)


def forward_time_sharded(llh, log_trans, log_init, mask, mesh, axis_name: str = "seq"):
    """Distributed forward over this rank's block of frames: (log α of the
    block (B, T_local, S), its last frame (B, S)).  Padded frames are
    identity operators, so the last rank's last frame holds every
    sequence's final α."""
    ax = _Axis(mesh, axis_name)
    b, _, s = llh.shape
    eye = _identity_op(s, llh)
    # the operator of step t: M_t[i, j] = log A[i, j] + llh_t(j); on the
    # first rank step 0 holds α_0 in every row, so every product that
    # starts there has constant rows and its row 0 is α
    ops = torch.where(mask[:, :, None, None] > 0, log_trans + llh[:, :, None, :], eye)
    if ax.index == 0:
        ops[:, 0] = _clamp(log_init + llh[:, 0])[:, None, :].expand(b, s, s)
    prefix = _prefix_products(ops)
    incl = prefix[:, -1]                         # the product of this block
    shift = 1
    while shift < ax.size:                       # inclusive scan over ranks
        recv = ax.shift(incl, shift)
        if ax.index >= shift:
            incl = _semiring_matmul(recv, incl)
        shift *= 2
    excl = ax.shift(incl, 1)                     # the previous rank's inclusive product
    if ax.index == 0:
        excl = eye.expand(b, s, s)
    log_alpha = _semiring_matmul(excl[:, None], prefix)[:, :, 0, :]
    return log_alpha, log_alpha[:, -1]


def _suffix_products(ops: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix products along axis 1 in order, ops_t ⊗ … ⊗ ops_{C-1}:
    prefix products of the time-reversed transposes, since the product is
    not commutative and (A ⊗ B)ᵀ = Bᵀ ⊗ Aᵀ."""
    rev_t = ops.flip(1).transpose(-1, -2)
    return _prefix_products(rev_t).transpose(-1, -2).flip(1)


def backward_time_sharded(llh, log_trans, log_final, mask, mesh, axis_name: str = "seq"):
    """Distributed backward over this rank's block of frames: log β of the
    block (B, T_local, S).

    The mirror of :func:`forward_time_sharded`: suffix products of the
    operators N_t[i, j] = log A[i, j] + llh_{t+1}(j), with the final vector
    as a column-constant operator on the global last step (so every
    suffix product has constant columns and β_t is column 0), and the
    rank scan run from the right."""
    ax = _Axis(mesh, axis_name)
    b, _, s = llh.shape
    eye = _identity_op(s, llh)
    # step t's operator needs llh at t + 1: the block's last step takes
    # the next rank's first frame
    llh_next = torch.cat([llh[:, 1:], ax.shift(llh[:, :1], -1)], dim=1)
    mask_next = torch.cat([mask[:, 1:], ax.shift(mask[:, :1], -1)], dim=1)
    ops = torch.where(mask_next[:, :, None, None] > 0, log_trans + llh_next[:, :, None, :], eye)
    if ax.index == ax.size - 1:
        ops[:, -1] = _clamp(log_final)[None, :, None].to(llh.dtype).expand(b, s, s)
    suffix = _suffix_products(ops)
    incl = suffix[:, 0]                          # the product of this block
    shift = 1
    while shift < ax.size:                       # inclusive scan from the right
        recv = ax.shift(incl, -shift)
        if ax.index < ax.size - shift:
            incl = _semiring_matmul(incl, recv)
        shift *= 2
    excl = ax.shift(incl, -1)                    # the next rank's inclusive product
    if ax.index == ax.size - 1:
        excl = eye.expand(b, s, s)
    return _semiring_matmul(suffix, excl[:, None])[:, :, :, 0]


def forward_backward_time_sharded(llh, log_trans, log_init, log_final, mask, mesh,
                                  axis_name: str = "seq"):
    """Full time-sharded smoothing over this rank's block: (log α, log β,
    log Z (B,), posteriors), the sequence-parallel counterpart of
    :func:`beer_tpu_torch.ops.semiring_scan.forward_backward`."""
    log_alpha, _ = forward_time_sharded(llh, log_trans, log_init, mask, mesh, axis_name)
    log_beta = backward_time_sharded(llh, log_trans, log_final, mask, mesh, axis_name)
    ax = _Axis(mesh, axis_name)
    if ax.index == ax.size - 1:
        contrib = log_alpha[:, -1] + _clamp(log_final)
    else:
        contrib = torch.full_like(log_alpha[:, -1], _NEG_INF)
    log_z = torch.logsumexp(ax.max(contrib), dim=-1)
    log_post = log_alpha + log_beta - log_z[:, None, None]
    posteriors = torch.exp(log_post.clamp_max(0.0)) * mask[..., None]
    return log_alpha, log_beta, log_z, posteriors


def _block(mesh, axis_name, *arrays):
    """This rank's block of frames of each (B, T, ...) array."""
    ax = _Axis(mesh, axis_name)
    t_len = arrays[0].shape[1]
    if t_len % ax.size:
        raise ValueError(f"{t_len} frames do not split over {ax.size} ranks of {axis_name!r}")
    n = t_len // ax.size
    return ax, [a[:, ax.index * n:(ax.index + 1) * n] for a in arrays]


def make_sharded_forward_backward(mesh, axis_name: str = "seq"):
    """``fn(llh, log_trans, log_init, log_final, mask) -> (log α, log β,
    log Z, posteriors)`` over the whole (B, T, S) on every rank, each rank
    computing its block of frames of ``axis_name``."""

    @torch.no_grad()
    def fn(llh, log_trans, log_init, log_final, mask):
        ax, (llh_l, mask_l) = _block(mesh, axis_name, llh, mask)
        la, lb, log_z, post = forward_backward_time_sharded(
            llh_l, log_trans, log_init, log_final, mask_l, mesh, axis_name)
        return ax.gather_time(la), ax.gather_time(lb), log_z, ax.gather_time(post)

    return fn


def make_sharded_forward(mesh, axis_name: str = "seq"):
    """``fn(llh, log_trans, log_init, log_final, mask) -> (log α (B, T, S),
    log Z (B,))`` over the whole (B, T, S) on every rank, each rank
    computing its block of frames of ``axis_name``."""

    @torch.no_grad()
    def fn(llh, log_trans, log_init, log_final, mask):
        ax, (llh_l, mask_l) = _block(mesh, axis_name, llh, mask)
        log_alpha, last = forward_time_sharded(llh_l, log_trans, log_init, mask_l, mesh,
                                               axis_name)
        # padded steps are identity operators, so the last block's last
        # frame holds every sequence's final α
        if ax.index != ax.size - 1:
            last = torch.full_like(last, _NEG_INF)
        log_z = torch.logsumexp(ax.max(last) + log_final, dim=-1)
        return ax.gather_time(log_alpha), log_z

    return fn
