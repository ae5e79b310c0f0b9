"""Train a model with VB-EM (reference: ``beer hmm train``).

Stage-gated like the reference recipes: checkpoints ``epochN.mdl`` per
epoch in the output directory; rerunning resumes from the latest.
Utterances are padded into one batch and each epoch is one VB step on
the card, or — with ``--batch-size``, or automatically when the padded
corpus would exceed ``--max-padded-gb`` — minibatches read from a
``.bar`` archive by :class:`beer_tpu_torch.io.BatchLoader`.  With
``--transcriptions`` the model is ``hmm mkphones`` emissions and each
epoch is one full-batch VB step of an HMM on the utterances' shared
transcription graphs (the supervised recognizer); its checkpoints hold
the emissions, and the graphs are rebuilt on resume.

Data-parallel training, the JAX verb's, runs over a
``torch.distributed`` process group (NCCL between cards, gloo between
CPU processes): each rank takes its rows of every batch and the
statistics are summed over the ranks before every update
(:mod:`beer_tpu_torch.parallel`).  The verb uses the process group that
is set up when it starts (a caller's, or the one it sets up itself
under ``torchrun``); with several visible cards, no group and no
``--single-device`` it starts one rank per card itself.  Full batch,
minibatches (the batch size rounded up to a multiple of the ranks;
``--accumulate-batches`` and automatic streaming) and
``--transcriptions`` all run data-parallel; rank 0 alone prints and
writes, and the checkpoints are those of one device, so a run may
resume under another device count.
"""

from __future__ import annotations

import os
import re
import time
from pathlib import Path

import numpy as np


def setup(parser):
    parser.add_argument("model", help="input model (.mdl)")
    parser.add_argument("feats", help="feature archive (.npz or .bar)")
    parser.add_argument("outdir", help="output/checkpoint directory")
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--lrate", type=float, default=1.0)
    parser.add_argument(
        "--single-device", action="store_true",
        help="train on one device even when several are visible or a "
        "process group is set up (no data parallelism)",
    )
    parser.add_argument(
        "--batch-size", type=int, default=0,
        help="stochastic VB: train on shuffled minibatches of this many "
        "utterances (0 = full batch). Statistics are scaled by "
        "datasize/batch (the reference's datasize convention); use "
        "--lrate < 1 for stable stochastic updates.",
    )
    parser.add_argument(
        "--buckets", type=int, default=1,
        help="length buckets for minibatch padding (each bucket pads to "
        "its own rounded maximum instead of the corpus maximum)",
    )
    parser.add_argument(
        "--accumulate-batches", action="store_true",
        help="exact full-batch VB streamed through minibatches: "
        "accumulate statistics over the whole epoch, then one conjugate "
        "update — identical math to full batch, but the corpus never "
        "has to fit in one padded array (requires --batch-size)",
    )
    parser.add_argument(
        "--nan-guard", action="store_true",
        help="guard the training step: any non-finite value in the "
        "updated parameters or ELBO raises with its location instead of "
        "silently corrupting the run",
    )
    parser.add_argument(
        "--transcriptions", default=None,
        help="supervised training: 'uttid ph1 ph2 ...' per line; the input "
        "model must be mkphones emissions (BASELINE config 3)",
    )
    parser.add_argument(
        "--max-padded-gb", type=float, default=4.0,
        help="if padding the whole corpus into one (B, T_max, D) array "
        "would exceed this many GB, automatically switch to exact "
        "streamed full-batch VB (bucketed minibatches + statistics "
        "accumulation, one conjugate update per epoch)",
    )


def pad_archive(path_or_npz):
    """(keys, data (B, T, D), mask (B, T)) of a path (``.bar`` or
    ``.npz``) or of an opened ``.npz``, each utterance zero-padded to the
    longest."""
    from beer_tpu_torch import io as bio

    return bio.load_padded(path_or_npz)


def _sync(device) -> None:
    """Wait for the card, so a host-clock time holds its work."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _upload(array: np.ndarray, device):
    """A host batch on ``device``; to the card through pinned memory,
    asynchronously (each batch is a fresh array, never refilled)."""
    import torch

    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _Ranks:
    """The ranks of a data-parallel run as the verb sees them (one rank
    without a process group): rank 0 alone prints and writes, and every
    write is followed by a barrier, so no rank reads a file before it is
    whole."""

    def __init__(self, parallel: bool):
        import torch.distributed as dist

        self.parallel = parallel
        self.rank = dist.get_rank() if parallel else 0
        self.size = dist.get_world_size() if parallel else 1

    def print(self, line: str) -> None:
        if self.rank == 0:
            print(line)

    def write(self, fn, *args) -> None:
        import torch.distributed as dist

        if self.rank == 0:
            fn(*args)
        if self.parallel:
            dist.barrier()

    def logger(self, outdir):
        from beer_tpu_torch.utils import MetricsLogger

        return MetricsLogger(outdir / "log" if self.rank == 0 else None, stdout=False)


def _convert_once(npz_path, bar_path) -> None:
    """``io.convert_npz`` unless the archive is already there."""
    from beer_tpu_torch import io as bio

    if not Path(bar_path).exists():
        bio.convert_npz(npz_path, bar_path)


def _train_minibatch(args, model, outdir, device, ranks, start_epoch=0):
    """Minibatches from a ``.bar`` archive through ``io.BatchLoader``.

    Stochastic VB scales the statistics by ``n_utts / n_valid`` (the
    tail batch is padded with zero-mask utterances to the batch size);
    ``--accumulate-batches`` sums the unscaled statistics over the epoch
    and makes one conjugate update, full-batch VB exactly.  Data-parallel,
    every rank reads the same batches and uses its rows of each."""
    from beer_tpu_torch import io as bio
    from beer_tpu_torch import parallel
    from beer_tpu_torch.utils import save_model
    from beer_tpu_torch.utils.debug import nan_guard
    from beer_tpu_torch.vbi import elbo_and_stats, tree_add, vb_step

    if args.feats.endswith(".bar"):
        bar_path = args.feats
    else:  # convert once next to the npz for mmap'd minibatch reads
        bar_path = args.feats + ".bar"
        # rank 0 alone looks for the archive: a rank that looked after it
        # was written would skip the barrier that the others wait in
        ranks.write(_convert_once, args.feats, bar_path)
    archive = bio.Archive(bar_path)
    n_utts = len(archive)

    if ranks.parallel:
        # batches split evenly over the ranks
        args.batch_size = -(-args.batch_size // ranks.size) * ranks.size
        mesh = parallel.make_mesh(device=device)
        dp_step = parallel.make_vb_minibatch_step(mesh, lrate=args.lrate)
        estep = parallel.make_vb_estep(mesh)
        ranks.print(f"minibatch data-parallel over {ranks.size} devices")

        def step(m, x, msk, ds):
            return dp_step(m, x, msk, ds / x.shape[0])
    else:
        def step(m, x, msk, ds):
            return vb_step(m, x, datasize=ds, lrate=args.lrate, mask=msk)

        def estep(m, x, msk):
            return elbo_and_stats(m, x, mask=msk)

    if args.nan_guard:
        tag = "[dp]" if ranks.parallel else ""
        step, estep = nan_guard(step, "vb_step" + tag), nan_guard(estep, "elbo_and_stats" + tag)
    loader = bio.BatchLoader(archive, args.batch_size, seed=0,
                             buckets=args.buckets)
    logger = ranks.logger(outdir)
    for epoch in range(start_epoch + 1, args.epochs + 1):
        t0 = time.time()
        total_frames, n_batches = 0.0, 0
        batch_elbos = []  # device scalars, read once after the epoch
        epoch_acc = None
        for data, mask in loader:
            n_valid = data.shape[0]
            if n_valid < args.batch_size:  # pad the tail batch to the batch size
                pad = args.batch_size - n_valid
                data = np.concatenate([data, np.zeros((pad,) + data.shape[1:],
                                                      data.dtype)])
                mask = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:],
                                                      mask.dtype)])
            x, msk = _upload(data, device), _upload(mask, device)
            if args.accumulate_batches:
                elbo, acc = estep(model, x, msk)
                epoch_acc = acc if epoch_acc is None else tree_add(epoch_acc, acc)
            else:
                # scale = datasize/B inside vb_step: datasize n_utts·B/n_valid
                # makes it n_utts/n_valid (padded rows carry no statistics)
                elbo, model = step(model, x, msk, n_utts * args.batch_size / n_valid)
            batch_elbos.append(elbo)
            total_frames += float(mask.sum())
            n_batches += 1
        total_elbo = sum(e.item() for e in batch_elbos)
        if args.accumulate_batches:
            kl = model.kl_div_posterior_prior().item()
            model = model.vb_update(epoch_acc, args.lrate)
            # each batch ELBO subtracts the KL once; keep it once
            total_elbo += kl * (n_batches - 1)
            per_frame = total_elbo / max(total_frames, 1)
        else:
            # each batch ELBO estimates the full-corpus ELBO; report the
            # mean estimate normalized by the corpus frame count
            per_frame = total_elbo / max(n_batches, 1) / max(total_frames, 1)
        _sync(device)
        dt = time.time() - t0
        ranks.print(f"epoch {epoch}: elbo/frame = {per_frame:.6f}")
        ranks.write(lambda: logger.log(epoch, elbo_per_frame=per_frame,
                                       frames_per_sec=total_frames / dt))
        ranks.write(save_model, model, outdir / f"epoch{epoch:04d}.mdl")
    logger.close()
    ranks.write(save_model, model, outdir / "final.mdl")
    ranks.print(f"wrote {outdir / 'final.mdl'}")


def _pad_graphs(graphs, n: int, pad: int):
    """Per-utterance graph fields of ``n`` utterances with the first
    utterance's graph repeated for ``pad`` padded (zero-mask) ones."""
    import dataclasses

    import torch

    from beer_tpu_torch.parallel.data_parallel import _BATCHED_RANK

    return dataclasses.replace(graphs, **{
        name: torch.cat([field, field[:1].expand(pad, *field.shape[1:])])
        for name, rank in _BATCHED_RANK.items()
        for field in (getattr(graphs, name),) if field.ndim == rank and field.shape[0] == n})


def _train_supervised(args, model, outdir, keys, data, mask, device, ranks, start_epoch=0):
    """Full-batch VB of an HMM on shared transcription graphs (K5 + K7,
    the llh route); ``model`` is the emissions MixtureSet, which each
    checkpoint holds.  Data-parallel, the graphs split with the batch."""
    import json
    import shutil

    import torch

    from beer_tpu_torch import parallel
    from beer_tpu_torch.cli.subcommands.hmm_mkphones import read_transcriptions
    from beer_tpu_torch.models.graph import transcription_graphs
    from beer_tpu_torch.models.hmm import HMM
    from beer_tpu_torch.utils import save_model
    from beer_tpu_torch.vbi import vb_step

    meta = json.loads(Path(args.model + ".phones.json").read_text())
    phone_idx = {p: i for i, p in enumerate(meta["phones"])}
    trans = read_transcriptions(args.transcriptions)
    seqs = [[phone_idx[p] for p in trans[k]] for k in keys]
    dtype = next(model.buffers()).dtype     # the features follow the emissions' dtype
    graphs = transcription_graphs(seqs, len(meta["phones"]), meta["states_per_phone"],
                                  dtype=dtype, device=device)
    n_frames = float(mask.sum())
    if ranks.parallel:
        data, valid = parallel.shard_batch(data, ranks.size)
        mask, _ = parallel.shard_batch(mask, ranks.size)
        mask = mask * valid[:, None]
        if data.shape[0] > len(seqs):  # a graph for each padded (zero-mask) utterance
            graphs = _pad_graphs(graphs, len(seqs), data.shape[0] - len(seqs))
        dp_step = parallel.make_supervised_vb_train_step(parallel.make_mesh(device=device),
                                                         lrate=args.lrate)
        ranks.print(f"supervised data-parallel over {ranks.size} devices")

        def step(emissions, x, m):
            return dp_step(emissions, graphs, x, m)
    else:
        hmm = HMM.create(graphs, model)

        def step(emissions, x, m):
            return vb_step(hmm, x, lrate=args.lrate, mask=m)[0], emissions
    x = torch.from_numpy(data).to(device, dtype)
    m = torch.from_numpy(mask).to(device)
    for epoch in range(start_epoch + 1, args.epochs + 1):
        elbo, model = step(model, x, m)
        ranks.print(f"epoch {epoch}: elbo/frame = {elbo.item() / n_frames:.6f}")
        ranks.write(save_model, model, outdir / f"epoch{epoch:04d}.mdl")
    # the final artifact is the trained emissions (the graph is per corpus)
    ranks.write(save_model, model, outdir / "final.mdl")
    ranks.write(shutil.copy, args.model + ".phones.json", outdir / "final.mdl.phones.json")
    ranks.print(f"wrote {outdir / 'final.mdl'}")


def _spawned_rank(rank: int, world: int, store: str, args) -> None:
    """One rank of a run the verb started itself: card ``rank``, NCCL."""
    import torch
    import torch.distributed as dist

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        _train(args, device, parallel=True)
    finally:
        dist.destroy_process_group()


def _spawn(args, n_cards: int) -> None:
    """Train with one rank per visible card, each in a process of its own
    (the spawn start method: no fork after CUDA is initialised)."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="beer_torch_dp_") as tmp:
        mp.start_processes(_spawned_rank, args=(n_cards, f"{tmp}/store", args),
                           nprocs=n_cards, start_method="spawn")


def main(args):
    import torch
    import torch.distributed as dist

    from beer_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.single_device or dist.is_initialized():
        return _train(args, device, parallel=not args.single_device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # started by torchrun
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        try:
            return _train(args, device, parallel=True)
        finally:
            dist.destroy_process_group()
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return _spawn(args, torch.cuda.device_count())
    return _train(args, device, parallel=False)


def _train(args, device, parallel: bool):
    import torch

    from beer_tpu_torch import io as bio
    from beer_tpu_torch import parallel as dp
    from beer_tpu_torch.utils import latest_checkpoint, load_model, save_model
    from beer_tpu_torch.utils.debug import nan_guard
    from beer_tpu_torch.vbi import vb_step

    ranks = _Ranks(parallel)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    ckpt = latest_checkpoint(outdir)
    start_epoch = 0
    if ckpt is not None:
        model = load_model(ckpt, device)
        start_epoch = int(re.search(r"epoch(\d+)", ckpt.name).group(1))
        ranks.print(f"resuming from {ckpt} (epoch {start_epoch})")
    else:
        model = load_model(args.model, device)
    if parallel:   # every rank has read the checkpoint before rank 0 writes the next
        torch.distributed.barrier()

    # supervised training is always full batch: --transcriptions comes
    # before the minibatch and streaming branches
    if not args.transcriptions:
        if args.batch_size:
            _train_minibatch(args, model, outdir, device, ranks, start_epoch=start_epoch)
            return
        # Scalable by default: if the padded corpus would blow past
        # --max-padded-gb, stream it instead — bucketed minibatches with
        # statistics accumulated over the epoch and one conjugate update.
        n, t_max, d, _ = bio.archive_geometry(args.feats)
        padded_gb = n * t_max * d * 4 / 2**30
        if padded_gb > args.max_padded_gb:
            bytes_per_utt = max(t_max * d * 4, 1)
            budget = args.max_padded_gb * 2**30 / 4
            args.batch_size = int(min(max(budget / bytes_per_utt, 1), 1024))
            args.accumulate_batches = True
            args.buckets = max(args.buckets, 8)
            ranks.print(
                f"corpus pads to {padded_gb:.1f} GB > "
                f"--max-padded-gb {args.max_padded_gb:g}; streaming exact "
                f"full-batch VB (batch-size {args.batch_size}, "
                f"{args.buckets} buckets, accumulate-batches)"
            )
            _train_minibatch(args, model, outdir, device, ranks, start_epoch=start_epoch)
            return

    keys, data, mask = bio.load_padded(args.feats)
    if args.transcriptions:
        _train_supervised(args, model, outdir, keys, data, mask, device, ranks,
                          start_epoch=start_epoch)
        return

    n_frames = float(mask.sum())
    if parallel:
        data, valid = dp.shard_batch(data, ranks.size)
        mask, _ = dp.shard_batch(mask, ranks.size)
        mask = mask * valid[:, None]
        step = dp.make_vb_train_step(dp.make_mesh(device=device), lrate=args.lrate)
        ranks.print(f"data-parallel over {ranks.size} devices")
    else:
        def step(m, x, msk):
            return vb_step(m, x, lrate=args.lrate, mask=msk)

    if args.nan_guard:
        step = nan_guard(step, "vb_step[dp]" if parallel else "vb_step")
    x, m = torch.from_numpy(data).to(device), torch.from_numpy(mask).to(device)
    logger = ranks.logger(outdir)
    for epoch in range(start_epoch + 1, args.epochs + 1):
        t0 = time.time()
        elbo, model = step(model, x, m)
        elbo_val = elbo.item()
        _sync(device)  # the update after the ELBO too, before the clock
        dt = time.time() - t0
        ranks.print(f"epoch {epoch}: elbo/frame = {elbo_val / n_frames:.6f}")
        ranks.write(lambda: logger.log(epoch, elbo_per_frame=elbo_val / n_frames,
                                       frames_per_sec=n_frames / dt))
        ranks.write(save_model, model, outdir / f"epoch{epoch:04d}.mdl")
    logger.close()
    ranks.write(save_model, model, outdir / "final.mdl")
    ranks.print(f"wrote {outdir / 'final.mdl'}")
