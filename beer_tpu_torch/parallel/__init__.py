"""Data-parallel VB-EM over a ``torch.distributed`` device mesh.

Counterpart of ``beer_tpu/parallel``: the reference's Kaldi-style
map-reduce (shard the utterances, accumulate statistics per job, sum
them, one conjugate update) as one ``all_reduce`` of the statistics per
step over a 1-D ``data`` mesh dimension (NCCL between cards, gloo
between CPU processes).  Every rank runs the E-step of its rows through
the model's usual routes — the hand-written kernels on the card — and
then the same deterministic update, so the model stays replicated
without a broadcast.
"""

from beer_tpu_torch.parallel.data_parallel import (
    data_parallel_elbo_and_stats,
    make_mesh,
    make_supervised_vb_train_step,
    make_vb_estep,
    make_vb_minibatch_step,
    make_vb_train_step,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "make_vb_train_step",
    "make_vb_minibatch_step",
    "make_vb_estep",
    "make_supervised_vb_train_step",
    "data_parallel_elbo_and_stats",
    "shard_batch",
]
