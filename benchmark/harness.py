"""The benchmark harness: one cell, one seed, one window, one result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives:

* ``benchmark/configs/<config>.json`` — the configuration as it is run;
  its ``family`` names ``benchmark/families/<family>.py`` (the model
  built through the program, and its work counts) and
  ``benchmark/reference/<family>.py`` (the plain reference);
* ``benchmark/traffic/<traffic>.json`` — the traffic mix, read by
  :mod:`benchmark.corpus`; its ``task`` names ``benchmark/tasks/<task>.py``,
  the loop that drives the window;
* ``benchmark/workloads/<cell>.json`` — the cell's limits on the numbers
  that decide ``correct``, and how many rows the check samples;
* ``benchmark/metrics/<metric>.py`` — a per-layer metric's reader: a
  ``read(trace)`` that returns the number, or None where the trace holds
  nothing for it.

A run: make the corpus and the initial means on the device from the
seed, build the program's model, run the task's set-up and window, read
the peak memory, check the outputs against the reference, and print the
result as the last line of standard output, after the compared numbers
as the last lines of standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType

import torch

from benchmark import checks
from benchmark import corpus as corpus_mod
from benchmark import peaks

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "beer_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict           # the cell's entry in BENCHMARK.json
    cfg: dict
    traffic: dict
    spec: dict            # benchmark/workloads/<cell>.json
    family: ModuleType
    reference: ModuleType
    task: ModuleType
    seed: int
    device: torch.device
    corpus: corpus_mod.Corpus | None = None

    def work(self) -> dict:
        return self.family.work(self.cfg, self.corpus.lens.cpu(), self.corpus.x.shape[1])


@dataclasses.dataclass
class Outcome:
    """What a task hands back: its end-to-end numbers, the calls attempted
    and failed in the window, when the window started, the peak memory,
    the traced stretch (or None), the compared numbers with their limits,
    and details for standard error."""

    metrics: dict
    attempted: int
    failed: int
    window_start: float
    memory_peak_bytes: int
    trace: object
    checks: dict
    details: dict


def quartiles_ms(marks: list) -> list:
    """Quartiles of the gaps between ``marks`` (the times a loop's
    iterations ended; the traced stretch counts as one), in milliseconds."""
    gaps = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return statistics.quantiles(gaps, n=4) if len(gaps) > 1 else gaps


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, seed: int, device, traffic_overrides: dict | None = None) -> Cell:
    man = manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    cfg = load_json(ROOT / conf["file"])
    traffic = dict(load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                   **(traffic_overrides or {}))
    spec = load_json(HERE / "workloads" / f"{name}.json")
    return Cell(name, entry, cfg, traffic, spec,
                importlib.import_module(f"benchmark.families.{cfg['family']}"),
                importlib.import_module(f"benchmark.reference.{cfg['family']}"),
                importlib.import_module(f"benchmark.tasks.{traffic['task']}"),
                seed, torch.device(device))


def reader(metric: str) -> ModuleType:
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(kind: str, cell_name: str) -> list:
    """The manifest's ``kind`` ("end_to_end" or "per_layer") metrics that
    this cell reports."""
    man = manifest()
    e2e = [m for m in man["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in names else [])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card(chips: int) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        limit, sm, sm_max = (v.strip() for v in smi.stdout.strip().split(","))
        out.update(power_limit_w=float(limit), clock_sm_mhz=float(sm), clock_sm_max_mhz=float(sm_max))
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return out


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
        traffic_overrides: dict | None = None) -> tuple[dict, list]:
    """One run of cell ``name``: (the result line as a dict, the lines of
    details and compared numbers for standard error)."""
    c = cell(name, seed, device, traffic_overrides)
    c.corpus = corpus_mod.make(c.traffic, c.cfg, seed, c.device)
    out: Outcome = c.task.run(c, seconds, trace)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(kind, name):
        if trace:
            value = reader(m["name"]).read(out.trace)
        elif m["name"] == "setup_s":
            value = out.window_start - t0
        else:
            value = out.metrics.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = checks.passed(out.checks)
    device_info = (_card(c.entry["chips"]) if c.device.type == "cuda"
                   else {"platform": "cpu", "kind": "cpu", "count": 1})
    device_info["memory_peak_bytes"] = out.memory_peak_bytes
    if trace:
        device_info.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                        for k, v in out.checks.items()}
    lines = [json.dumps({"details": out.details})]
    lines += [f"check {k}: {_number(v['value'])} (limit {v['limit']})" for k, v in out.checks.items()]
    return result, lines


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description="Run one benchmark cell on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    entry = next((w for w in manifest()["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"this cell needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    result, lines = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
