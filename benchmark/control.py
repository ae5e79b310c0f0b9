"""Readings that the limits on ``correct`` are set from, at a cell's own
size, many seeds in one process:

    python3 benchmark/control.py --workload aud-train --kinds program,control,half \\
        --seeds 11,12,13 [--out readings.jsonl]

Each kind gives the numbers the cell compares, against the plain
reference (float64 for training, the configuration's float32 for
decoding; training readings also give each leaf's gap):

* ``program`` — the program's own outputs (the sound runs: the lower
  readings);
* ``control`` — the reference put in the program's place, computed one
  precision below the configuration's float32: TF32 products (inputs
  rounded to 10 mantissa bits), float32 elsewhere;
* ``half`` (training) — the reference in the program's place with half
  of the batch left out and the other half's data terms doubled;
* ``altered`` (decoding) — the program's labels with the first frame of
  every row moved to the next unit.

A state left unchanged reads 1 by ``change_gap`` and needs no run.  The
benchmark's own runs run none of this.
"""

from __future__ import annotations

import argparse
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
from benchmark.tasks import decode as decode_task  # noqa: E402
from benchmark.tasks import train as train_task  # noqa: E402


def _free(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def train_readings(cell, kind: str) -> dict:
    n = cell.spec["check_steps"]
    if kind == "program":
        model, got = train_task.program_steps(cell, n)
        del model
    elif kind == "control":
        got = train_task.reference_steps(cell, n, Precision("tf32"))
    elif kind == "half":
        got = train_task.reference_steps(cell, n, Precision("float64"), scale_rows=0.5)
    else:
        raise ValueError(f"no reading {kind!r} for a training cell")
    _free(cell.device)
    want = train_task.reference_steps(cell, n, Precision("float64"))
    return dict(checks.train_gaps(got, want, cell.corpus.n_frames),
                stats_leaves=checks.leaf_gaps(got["stats"], want["stats"]),
                change_leaves=checks.leaf_gaps(got["change"], want["change"]))


def decode_readings(cell, kind: str) -> dict:
    cor = cell.corpus
    rows = corpus.sample_rows(cor, cell.spec["check_rows"], cell.seed)
    if kind in ("program", "altered"):
        model = cell.family.build(cell.cfg, cor.init_means)
        with torch.no_grad():
            labels, scores = cell.family.decode(model, cor.x, cor.mask)
        labels, scores = labels.cpu(), scores.cpu()
        del model
        if kind == "altered":
            labels[:, 0] = (labels[:, 0] + 1) % cell.cfg["units"]
    elif kind == "control":
        sel = rows.to(cor.x.device)
        params = cell.reference.initial(cell.cfg, cor.init_means, torch.float32)
        got_labels, got_scores = cell.reference.decode(
            cell.cfg, params, cor.x[sel], cor.lens[sel], Precision("tf32"))
        labels = torch.zeros(cor.x.shape[:2], dtype=torch.long)
        scores = torch.zeros(cor.x.shape[0], dtype=torch.float64)
        labels[rows], scores[rows] = got_labels.cpu(), got_scores.double().cpu()
    else:
        raise ValueError(f"no reading {kind!r} for a decoding cell")
    _free(cell.device)
    return decode_task.reference_gaps(cell, rows, labels, scores)


def readings(workload: str, seed: int, kind: str, device,
             traffic_overrides: dict | None = None) -> dict:
    cell = harness.cell(workload, seed, device, traffic_overrides)
    cell.corpus = corpus.make(cell.traffic, cell.cfg, seed, cell.device)
    read = train_readings if cell.traffic["task"] == "train" else decode_readings
    out = read(cell, kind)
    cell.corpus = None
    _free(cell.device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
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
