"""Subspace-HMM training (reference: ``beer shmm train``).

Alternates, per outer iteration (SURVEY.md §3.5):
1. phone-loop VB-EM epochs on each language's data (warm start /
   re-estimation under the current subspace constraint),
2. phone-loop E-step accumulation of per-unit statistics (emissions,
   and with ``--learn-transitions`` the per-state self-loop/advance
   counts),
3. reparameterization-trick gradient steps on the GSM ELBO (one
   ``torch.optim.Adam`` whose state lives across outer iterations),
   through ``make_gsm_train_scan``: on the card the whole inner loop is
   one captured CUDA graph replayed ``--inner-iters`` times; with
   ``--device cpu`` the same steps run eagerly,
4. moment-matched write-back of the subspace posterior into the loop(s).

Single language trains a :class:`beer_tpu_torch.models.gsm.GSM`; adding
``--extra-lang NAME:MODEL:FEATS`` switches to the multilingual
:class:`HierarchicalGSM` (H-SHMM, ICASSP'21): one shared subspace, one
embedding per language, units concatenated across languages.

The models are drawn from a CPU ``torch.Generator`` seeded 0, the
gradient steps' and write-backs' noise from ``train_key(1)``, a
generator seeded 1 on the compute device, so two runs on one device are
identical.

Input: trained phone-loop ``.mdl`` (diagonal covariance) + features;
output: subspace-constrained loops (``final.mdl`` / ``final_NAME.mdl``)
and the GSM itself (``gsm.mdl``).
"""

from __future__ import annotations

from pathlib import Path


def setup(parser):
    parser.add_argument("model", help="trained phone-loop model (.mdl)")
    parser.add_argument("feats", help="feature archive (.npz or .bar)")
    parser.add_argument("outdir", help="output directory")
    parser.add_argument("--embed-dim", type=int, default=10)
    parser.add_argument("--outer-iters", type=int, default=5)
    parser.add_argument("--inner-iters", type=int, default=500)
    parser.add_argument("--loop-epochs", type=int, default=2,
                        help="phone-loop VB epochs per outer iteration")
    parser.add_argument("--lrate", type=float, default=5e-2)
    parser.add_argument("--learn-transitions", action="store_true",
                        help="subspace also generates per-state self-loop "
                        "probabilities")
    parser.add_argument("--trunk", default=None,
                        help="nnet transform config (e.g. 'mlp:32,32:tanh')")
    parser.add_argument("--lang-dim", type=int, default=2,
                        help="language-embedding dim (multilingual)")
    parser.add_argument("--extra-lang", action="append", default=[],
                        metavar="NAME:MODEL:FEATS",
                        help="additional language (repeatable) -> H-SHMM")
    parser.add_argument("--writeback-samples", type=int, default=64)


def cat_stats(per_lang):
    """Concatenate per-language unit statistics along the unit axis."""
    import torch

    if isinstance(per_lang[0], dict):
        return {k: (torch.cat([s[k] for s in per_lang]) if per_lang[0][k] is not None else None)
                for k in per_lang[0]}
    return torch.cat(per_lang)


def main(args):
    import torch

    from beer_tpu_torch import io as bio
    from beer_tpu_torch.device import resolve_device
    from beer_tpu_torch.models.gsm import (
        GSM,
        HierarchicalGSM,
        accumulate_unit_stats,
        apply_to_phoneloop,
        make_gsm_train_scan,
        slice_gsm,
        train_key,
    )
    from beer_tpu_torch.utils import load_model, save_model
    from beer_tpu_torch.vbi import vb_step

    device = resolve_device(args.device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    langs = [("main", args.model, args.feats)]
    for spec in args.extra_lang:
        name, model, feats = spec.split(":")
        langs.append((name, model, feats))

    loops, datas, masks = [], [], []
    for _, model_path, feats_path in langs:
        loops.append(load_model(model_path, device))
        _, data, mask = bio.load_padded(feats_path)
        datas.append(torch.from_numpy(data).to(device))
        masks.append(torch.from_numpy(mask).to(device))
    d = datas[0].shape[-1]
    n_units = loops[0].n_units
    spp = loops[0].states_per_unit
    for lp in loops[1:]:
        if lp.n_units != n_units or lp.states_per_unit != spp:
            raise ValueError("all languages need the same loop topology")

    init = torch.Generator().manual_seed(0)      # GSM.create draws on the CPU
    multilingual = len(langs) > 1
    if multilingual:
        unit_lang = sum(([i] * n_units for i in range(len(langs))), [])
        gsm = HierarchicalGSM.create(
            n_units * len(langs), args.embed_dim, d,
            lang_dim=args.lang_dim, n_langs=len(langs), unit_lang=unit_lang,
            states_per_unit=spp, learn_transitions=args.learn_transitions,
            trunk=args.trunk, generator=init, device=device,
        )
    else:
        gsm = GSM.create(
            n_units, args.embed_dim, d, states_per_unit=spp,
            learn_transitions=args.learn_transitions, trunk=args.trunk,
            generator=init, device=device,
        )
    # capturable: Adam's step count stays on the card, as a captured step needs
    optimizer = torch.optim.Adam(gsm.parameters(), lr=args.lrate,
                                 capturable=device.type == "cuda")
    grun = make_gsm_train_scan(optimizer)
    noise = train_key(1, device)

    for outer in range(args.outer_iters):
        # 1. VB re-estimation of each loop under the current constraint
        for i in range(len(loops)):
            for _ in range(args.loop_epochs):
                vb_step(loops[i], datas[i], mask=masks[i])

        # 2. accumulate per-unit statistics
        per_lang = [accumulate_unit_stats(loops[i], datas[i], masks[i],
                                          transitions=args.learn_transitions)
                    for i in range(len(loops))]
        stats = cat_stats([st for st, _ in per_lang])
        counts = torch.cat([ct for _, ct in per_lang])

        # 3. subspace training: on the card the whole inner loop is one
        # captured graph, replayed
        elbo = grun(gsm, stats, counts, generator=noise, nsteps=args.inner_iters)

        # 4. moment-matched write-back per language
        if multilingual:
            for i in range(len(loops)):
                apply_to_phoneloop(slice_gsm(gsm, i, n_units), loops[i], generator=noise,
                                   nsamples=args.writeback_samples)
        else:
            apply_to_phoneloop(gsm, loops[0], generator=noise, nsamples=args.writeback_samples)
        print(f"outer {outer}: gsm elbo = {elbo.item():.2f}")

    for (name, _, _), loop in zip(langs, loops):
        out = "final.mdl" if name == "main" else f"final_{name}.mdl"
        save_model(loop, outdir / out)
    save_model(gsm, outdir / "gsm.mdl")
    print(f"wrote {outdir / 'final.mdl'} and {outdir / 'gsm.mdl'}")
