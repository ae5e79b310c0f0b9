"""Reduce accumulated VB statistics into one conjugate update.

Reference parity: the reduce half of the reference's ``utils/parallel/``
file-based map-reduce (SURVEY.md §2.10): sum the per-shard statistics
written by ``beer-torch hmm accumulate`` and apply a single
natural-parameter update — mathematically identical to one full-batch
``vb_step`` over the whole corpus.  ``beer-torch hmm update model
out.mdl shard1.acc shard2.acc …``
"""

from __future__ import annotations


def setup(parser):
    parser.add_argument("model", help="input model (.mdl)")
    parser.add_argument("outmodel", help="updated model (.mdl)")
    parser.add_argument("accs", nargs="+", help="shard statistics (.acc)")
    parser.add_argument("--lrate", type=float, default=1.0)
    parser.add_argument(
        "--allow-partial", action="store_true",
        help="reduce even if the .acc files do not form one complete "
        "i/N shard set (default: hard error, so stale shards from a "
        "crashed run with a different --shard N cannot be summed in)",
    )


def main(args):
    import torch

    from beer_tpu_torch.device import resolve_device
    from beer_tpu_torch.utils import load_model, save_model
    from beer_tpu_torch.vbi import tree_add

    device = resolve_device(args.device)
    model = load_model(args.model, device)

    acc_sum, total_elbo, total_frames, total_utts = None, 0.0, 0.0, 0
    seen = set()
    for path in args.accs:
        payload = load_model(path, device)
        key = (int(payload["shard"]), int(payload["n_shards"]))
        if key in seen:
            raise SystemExit(f"duplicate shard {key[0]}/{key[1]}: {path}")
        seen.add(key)
        acc_sum = payload["acc"] if acc_sum is None else tree_add(acc_sum, payload["acc"])
        total_elbo += float(payload["elbo"])
        total_frames += float(payload["frames"])
        total_utts += int(payload["n_utts"])
    n_shards = {n for _, n in seen}
    if len(n_shards) != 1 or len(seen) != next(iter(n_shards)):
        msg = (
            f"reducing {len(seen)} acc files with shard specs "
            f"{sorted(seen)} — not a complete i/N set"
        )
        if not args.allow_partial:
            raise SystemExit(
                f"error: {msg}; stale .acc files from an earlier run "
                "with a different shard count would be silently summed "
                "in. Remove them, or pass --allow-partial to reduce "
                "exactly the statistics given."
            )
        print(f"warning: {msg}; the update uses exactly the statistics given")

    with torch.no_grad():
        # per-shard ELBOs each subtract the full KL(q||p) once; keep it once
        total_elbo += model.kl_div_posterior_prior().item() * (len(args.accs) - 1)
        updated = model.vb_update(acc_sum, args.lrate)
    save_model(updated, args.outmodel)
    print(
        f"reduced {len(args.accs)} shards ({total_utts} utts, "
        f"{total_frames:.0f} frames): elbo/frame = "
        f"{total_elbo / max(total_frames, 1):.6f} -> {args.outmodel}"
    )
