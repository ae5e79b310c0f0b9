"""Accumulate VB statistics for one shard of a corpus (map step).

Reference parity: the reference's only scale-out mechanism is the
recipe-level ``utils/parallel/`` job arrays (SGE or local) that split the
utterance list into N shards, run one accumulation job per shard, write
the statistics to disk, and reduce them into a single natural-parameter
update (SURVEY.md §2.10 — Kaldi-style file-based map-reduce).  This
subcommand is the map step: ``beer-torch hmm accumulate model feats
out.acc --shard 3/8`` scores every 3rd-of-8 utterance and writes the
accumulated statistics (+ ELBO and frame count) to ``out.acc``.

``beer-torch hmm update`` is the reduce step.  The pair is exact: summed
shard statistics followed by one conjugate update is one full-batch
``vb_step``.  The ``.acc`` file is the port's checkpoint format
(:mod:`beer_tpu_torch.utils.checkpoint`), like its ``.mdl``: an ``.acc``
of the JAX package does not load here.  Like every verb this one runs on
the CUDA card unless given ``--device cpu``; several shard processes may
share one card.
"""

from __future__ import annotations

from pathlib import Path


def setup(parser):
    parser.add_argument("model", help="input model (.mdl)")
    parser.add_argument("feats", help="feature archive (.npz or .bar)")
    parser.add_argument("out", help="output statistics file (.acc)")
    parser.add_argument(
        "--shard", default="1/1",
        help="'i/N' (1-based): accumulate utterances i-1, i-1+N, ... "
        "(strided so shards balance across a length-sorted corpus)",
    )
    parser.add_argument(
        "--batch-size", type=int, default=512,
        help="utterances per scoring batch (0 = whole shard at once); "
        "each batch pads to its own longest utterance",
    )


def _parse_shard(spec: str):
    try:
        i, n = spec.split("/")
        i, n = int(i), int(n)
    except ValueError:
        raise SystemExit(f"--shard must be 'i/N', got {spec!r}")
    if not 1 <= i <= n:
        raise SystemExit(f"--shard index out of range: {spec}")
    return i, n


def main(args):
    import torch

    from beer_tpu_torch import io as bio
    from beer_tpu_torch.device import resolve_device
    from beer_tpu_torch.utils import load_model, save_model
    from beer_tpu_torch.vbi import elbo_and_stats, tree_add

    device = resolve_device(args.device)
    shard, n_shards = _parse_shard(args.shard)

    if args.feats.endswith(".bar"):
        archive = bio.Archive(args.feats)
    else:  # convert once next to the npz for mmap'd shard reads
        bar_path = args.feats + ".bar"
        if not Path(bar_path).exists():
            bio.convert_npz(args.feats, bar_path)
        archive = bio.Archive(bar_path)

    indices = list(range(shard - 1, len(archive), n_shards))
    if not indices:
        raise SystemExit(
            f"shard {args.shard}: no utterances (corpus has {len(archive)})"
        )
    model = load_model(args.model, device)

    # No batch is padded up to the batch size or to a rounded length:
    # the kernels take any shape, so a 5-utterance shard is one batch of 5.
    batch = min(args.batch_size or len(indices), len(indices))
    total_elbo, total_frames, n_batches = 0.0, 0.0, 0
    acc_sum = None
    with torch.no_grad():
        for lo in range(0, len(indices), batch):
            data, mask = archive.padded_batch(indices[lo : lo + batch])
            elbo, acc = elbo_and_stats(model, torch.from_numpy(data).to(device),
                                       mask=torch.from_numpy(mask).to(device))
            acc_sum = acc if acc_sum is None else tree_add(acc_sum, acc)
            total_elbo += elbo.item()
            total_frames += float(mask.sum())
            n_batches += 1
        # each batch ELBO subtracts the full KL(q||p) once; keep it exactly
        # once in the shard total so the reduce step can account per shard
        total_elbo += model.kl_div_posterior_prior().item() * (n_batches - 1)

    save_model(
        {
            "acc": acc_sum,
            "elbo": total_elbo,
            "frames": total_frames,
            "n_utts": len(indices),
            "shard": shard,
            "n_shards": n_shards,
        },
        args.out,
    )
    print(
        f"shard {args.shard}: {len(indices)} utts, "
        f"{total_frames:.0f} frames, elbo/frame = "
        f"{total_elbo / max(total_frames, 1):.6f} -> {args.out}"
    )
