"""Readings that the limits on ``svae-train``'s ``correct`` are set from,
at the cell's own size, many seeds in one process:

    python3 benchmark/control_svae.py --kinds program,control,half,nofisher,noadam,noupdate \\
        --seeds 11,12,13 [--workload svae-train] [--out readings.jsonl]

Each kind gives the numbers the cell compares, against the float64
reference of :mod:`benchmark.reference.svae`, with each leaf's gap:

* ``program`` — the program's own steps (the sound runs: the lower
  readings);
* ``control`` — the reference put in the program's place, computed one
  precision below the configuration's float32: TF32 products (inputs
  rounded to 10 mantissa bits, the nnets' backward products too),
  float32 elsewhere;
* ``half`` — the program on the first half of each minibatch, its data
  terms doubled (the step's scale is the corpus over the rows it got);
* ``nofisher`` — the program with ``PhoneLoopLogZ``'s backward giving no
  gradient: the latent prior pulls nothing back into the nnets;
* ``noadam`` — the program with Adam's step skipped (``param_gap`` 1);
* ``noupdate`` — the program with the conjugate update skipped
  (``change_gap`` 1).

The benchmark's own runs run none of this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import checks, corpus, harness  # noqa: E402
from benchmark.reference.common import Precision  # noqa: E402
from benchmark.tasks import svae_train as task  # noqa: E402

KINDS = ("program", "control", "half", "nofisher", "noadam", "noupdate")


@contextlib.contextmanager
def fault(kind: str):
    """The program broken as ``kind`` says (``nofisher``, ``noadam``,
    ``noupdate``) while the context lasts; any other kind patches
    nothing."""
    from beer_tpu_torch.models.vae import VAE
    from beer_tpu_torch.ops.semiring_scan import PhoneLoopLogZ

    def no_gradient(ctx, ct, *_):
        return (None,) * 10

    def no_step(self, closure=None):
        return None

    def no_update(self, acc, lrate=1.0):
        return self

    owner, name, value = {
        "nofisher": (PhoneLoopLogZ, "backward", staticmethod(no_gradient)),
        "noadam": (torch.optim.Adam, "step", no_step),
        "noupdate": (VAE, "vb_update", no_update)}.get(kind, (None, None, None))
    if owner is None:
        yield
        return
    saved = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def _free(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def readings(workload: str, seed: int, kind: str, device,
             traffic_overrides: dict | None = None) -> dict:
    if kind not in KINDS:
        raise ValueError(f"no reading {kind!r}")
    cell = harness.cell(workload, seed, device, traffic_overrides)
    cell.corpus = corpus.make(cell.traffic, cell.cfg, seed, cell.device)
    n = cell.spec["check_steps"]
    if kind == "control":
        weights = cell.family.nnet_state(cell.family.build(cell.cfg, cell.corpus.init_means, seed))
        got = task.reference_steps(cell, n, Precision("tf32"), weights)
    else:
        with fault(kind):
            model, opt, step, weights, got = task.program_steps(
                cell, n, rows=0.5 if kind == "half" else 1.0)
        del model, opt, step
    _free(cell.device)
    want = task.reference_steps(cell, n, Precision("float64"), weights)
    out = dict(task.gaps(got, want, task.elbo_frames(cell, n)),
               stats_leaves=checks.leaf_gaps(got["stats"], want["stats"]),
               change_leaves=checks.leaf_gaps(got["change"], want["change"]))
    cell.corpus = None
    _free(cell.device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="svae-train")
    p.add_argument("--kinds", default="program,control")
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="append one JSON line a reading here")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    for kind in args.kinds.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            line = {"workload": args.workload, "kind": kind, "seed": seed,
                    **readings(args.workload, seed, kind, args.device),
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
