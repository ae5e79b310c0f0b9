"""Data-parallel VB-EM: each rank's rows, one ``all_reduce`` of the statistics.

Counterpart of ``beer_tpu/parallel/data_parallel.py``.  The E-step is
embarrassingly parallel over utterances and the statistics are a fixed
small tree (O(components · stats_dim)), so one ``all_reduce`` per dtype
per step replaces the reference's statistics-file reduce exactly (the
same sum, a different wire).  After it every rank applies the same
deterministic conjugate update in place, so the model stays replicated
without a broadcast.

The step builders return callables with the JAX package's signatures.
Each takes the whole padded batch, as ``shard_map`` with ``P(axis)``
does, and uses only its rank's rows (moved to the model's device), so a
call site reads the same on one rank and on many.  The rows must split
evenly over the mesh dimension: :func:`shard_batch` pads a batch with
empty rows, which contribute nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from beer_tpu_torch.device import resolve_device
from beer_tpu_torch.vbi import _scale

# graph field → its rank in the per-utterance (batched) form
_BATCHED_RANK = {"log_init": 2, "log_final": 2, "log_trans": 3, "pdf_ids": 2}


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data", device=None):
    """A 1-D :class:`~torch.distributed.device_mesh.DeviceMesh` named
    ``axis_name`` over the current process group, of device type
    ``device``'s (default: the CUDA card; ``device="cpu"`` for gloo ranks
    on the CPU).  ``n_devices`` must be the group's size when given."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first (torchrun does not)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a process group of {world}")
    return init_device_mesh(device.type, (world,), mesh_dim_names=(axis_name,))


def shard_batch(x, n_shards: int):
    """Pad the leading (batch) axis to a multiple of ``n_shards``.

    Returns ``(padded_x, valid (B',))``: padded rows are zeros and get
    ``valid`` 0, so a mask multiplied by it keeps them out of every
    statistic."""
    b = x.shape[0]
    pad = -(-b // n_shards) * n_shards - b
    x_p = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)]) if pad else x
    valid = np.concatenate([np.ones(b, x.dtype), np.zeros(pad, x.dtype)])
    return x_p, valid


def _axis(mesh, axis_name: Optional[str]):
    """(group, size, this rank's coordinate) of a mesh dimension (the
    only one of a 1-D mesh when ``axis_name`` is None)."""
    if axis_name is None:
        (axis_name,) = mesh.mesh_dim_names
    dim = mesh.mesh_dim_names.index(axis_name)
    return mesh.get_group(axis_name), mesh.size(dim), mesh.get_local_rank(axis_name)


def _rank_rows(mesh, axis_name, b: int) -> slice:
    _, n, r = _axis(mesh, axis_name)
    if b % n:
        raise ValueError(f"a batch of {b} rows does not split over {n} ranks: "
                         "pad it with shard_batch")
    k = b // n
    return slice(r * k, (r + 1) * k)


def _model_device(model) -> torch.device:
    for t in model.buffers():
        return t.device
    return next(model.parameters()).device


def _local(model, x, mask, mesh, axis_name):
    """This rank's rows of ``x`` and ``mask`` on the model's device."""
    rows = _rank_rows(mesh, axis_name, x.shape[0])
    device = _model_device(model)
    x_l = x[rows].to(device, non_blocking=True)
    m_l = None if mask is None else mask[rows].to(device, non_blocking=True)
    return x_l, m_l


def _tensors(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return tree


def _all_reduce_tree(tree, group):
    """``tree`` summed over ``group``: its tensors flattened into one
    buffer per dtype (float64 statistics stay float64), one
    ``all_reduce`` per buffer, then unflattened."""
    leaves = _tensors(tree, [])
    by_dtype = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    out = list(leaves)
    for idx in by_dtype.values():
        buf = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(buf, group=group)
        offset = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = buf[offset:offset + n].view(leaves[i].shape)
            offset += n
    return _rebuild(tree, iter(out))


@torch.no_grad()
def data_parallel_elbo_and_stats(model, x, mask, mesh, datascale: float = 1.0,
                                 axis_name: Optional[str] = None):
    """The E-step of this rank's ``x`` / ``mask`` (already its rows), then
    the llh sum and the statistics summed over the mesh dimension in one
    ``all_reduce`` per dtype.  Returns the replicated ``(elbo, acc)``.

    ``mask`` zeroes padded utterances and padded frames (``None`` for a
    model without one, e.g. a GMM over frames).  The ELBO is summed in
    float64, as :func:`beer_tpu_torch.vbi.elbo_and_stats` sums it, and
    the KL term is taken once from the replicated parameters, outside the
    reduction."""
    stats = model.sufficient_statistics(x)
    llh, cache = (model.infer(stats) if mask is None else model.infer(stats, mask=mask))
    if mask is not None and mask.ndim > 1:
        llh = llh * (mask.sum(-1) > 0)        # padded utterances contribute nothing
    acc = model.accumulate(stats, cache)
    group = _axis(mesh, axis_name)[0]
    llh_sum, acc = _all_reduce_tree((llh.sum(dtype=torch.float64).reshape(1), acc), group)
    elbo = datascale * llh_sum[0] - model.kl_div_posterior_prior().double()
    if datascale != 1.0:
        acc = _scale(acc, datascale)
    return elbo, acc


def make_vb_train_step(mesh, axis_name: str = "data", lrate: float = 1.0,
                       datascale: float = 1.0):
    """The data-parallel VB-EM step ``step(model, x, mask) -> (elbo,
    model)``.  Usage::

        mesh = make_mesh()
        step = make_vb_train_step(mesh)
        x, valid = shard_batch(data, mesh.size())    # (B', T, D)
        mask = mask * valid[:, None]
        for epoch in range(E):
            elbo, model = step(model, x, mask)

    The model is updated in place on every rank with the same reduced
    statistics, so it stays replicated."""

    @torch.no_grad()
    def step(model, x, mask):
        x_l, m_l = _local(model, x, mask, mesh, axis_name)
        elbo, acc = data_parallel_elbo_and_stats(model, x_l, m_l, mesh, datascale, axis_name)
        return elbo, model.vb_update(acc, lrate)

    return step


def make_vb_minibatch_step(mesh, axis_name: str = "data", lrate: float = 1.0):
    """The data-parallel stochastic VB step ``step(model, x, mask,
    datascale) -> (elbo, model)``: :func:`make_vb_train_step` with the
    ``datasize / n_valid`` statistics scale given per call (ragged tail
    batches).  ``datascale = 1.0`` and ``lrate = 1.0`` are full-batch VB
    on one batch."""

    @torch.no_grad()
    def step(model, x, mask, datascale):
        x_l, m_l = _local(model, x, mask, mesh, axis_name)
        elbo, acc = data_parallel_elbo_and_stats(model, x_l, m_l, mesh, float(datascale),
                                                 axis_name)
        return elbo, model.vb_update(acc, lrate)

    return step


def make_vb_estep(mesh, axis_name: str = "data"):
    """The data-parallel E-step ``estep(model, x, mask) -> (elbo, acc)``.
    The statistics come back replicated, so a caller can sum them over
    minibatches and make one conjugate update an epoch (exact full-batch
    VB streamed through minibatches: ``--accumulate-batches``)."""

    @torch.no_grad()
    def estep(model, x, mask):
        x_l, m_l = _local(model, x, mask, mesh, axis_name)
        return data_parallel_elbo_and_stats(model, x_l, m_l, mesh, 1.0, axis_name)

    return estep


def make_supervised_vb_train_step(mesh, axis_name: str = "data", lrate: float = 1.0):
    """Data-parallel supervised training on per-utterance graphs:
    ``step(emissions, graphs, x, mask) -> (elbo, emissions)``.

    ``graphs`` is :func:`~beer_tpu_torch.models.graph.transcription_graphs`'s
    result for the whole padded batch, in either form: a field whose rank
    is its per-utterance rank (``log_init``, ``log_final``, ``pdf_ids`` 2,
    ``log_trans`` 3) is split with the batch, any other field (the shared
    form's (S, S) chain and (S,) init) is replicated.  The emissions are
    updated in place on every rank."""
    from beer_tpu_torch.models.hmm import HMM

    @torch.no_grad()
    def step(emissions, graphs, x, mask):
        x_l, m_l = _local(emissions, x, mask, mesh, axis_name)
        rows = _rank_rows(mesh, axis_name, x.shape[0])
        device = x_l.device
        local = dataclasses.replace(graphs, **{
            name: (field[rows] if field.ndim == rank else field).to(device)
            for name, rank in _BATCHED_RANK.items()
            for field in (getattr(graphs, name),)})
        model = HMM(local, emissions)
        elbo, acc = data_parallel_elbo_and_stats(model, x_l, m_l, mesh, 1.0, axis_name)
        return elbo, model.vb_update(acc, lrate).modelset

    return step
