"""The result line: its keys and their order, the metrics each cell reports,
and the runs that must print no result."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"utterances": 4, "min_frames": 10, "max_frames": 16}


@pytest.mark.parametrize("cell", ["aud-train", "hmm-train", "aud-decode"])
def test_result_line(cell):
    result, lines = harness.run(cell, 2**31 + 11, 0.2, False, "cpu", time.perf_counter(), SMALL)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert isinstance(result["correct"], bool) and result["attempted"] >= 1 and result["failed"] == 0
    want = {m["name"]: m["unit"] for m in harness.cell_metrics("end_to_end", cell)}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    limits = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())["limits"]
    assert set(result["checks"]) == set(limits)
    assert [ln.split(":")[0] for ln in lines[-len(limits):]] == [f"check {k}" for k in result["checks"]]
    json.dumps(result, allow_nan=False)


def test_per_layer_metrics_by_cell():
    names = lambda cell: {m["name"] for m in harness.cell_metrics("per_layer", cell)}  # noqa: E731
    assert names("aud-train") == names("hmm-train") == {
        "mfu_pct.train", "estep_roofline", "mstep_ms", "launches.train", "idle_pct.train"}
    assert names("aud-decode") == {"mfu_pct.decode", "decode_roofline", "launches.decode",
                                   "idle_pct.decode"}


def test_same_seed_same_inputs():
    c = harness.cell("aud-train", 2**31 + 3, "cpu", SMALL)
    a, b = (harness.corpus_mod.make(c.traffic, c.cfg, c.seed, "cpu") for _ in range(2))
    assert torch.equal(a.x, b.x) and torch.equal(a.lens, b.lens) and torch.equal(a.init_means, b.init_means)
    other = harness.corpus_mod.make(c.traffic, c.cfg, c.seed + 1, "cpu")
    assert sorted(other.lens.tolist()) == sorted(a.lens.tolist())   # the same work, another order
    assert not torch.equal(other.x, a.x)


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "aud-train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    code = harness.main(["--workload", "aud-train", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert code != 0 and capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["aud-train", "aud-decode"])
def test_traced_result_line_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = harness.run(cell, 7, 1.0, True, "cuda", time.perf_counter(),
                            {"utterances": 64, "min_frames": 50, "max_frames": 100})
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
    assert set(result["metrics"]) == {m["name"] for m in harness.cell_metrics("per_layer", cell)}
    assert len(result["breakdown"]["device_ops"]) <= 10 and len(result["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("cell", ["aud-train", "hmm-train"])
def test_traced_step_is_the_timed_step(cell):
    """A traced run's window splits each step around its update: the same
    ELBO and the same posterior as ``vb_step`` from the same start."""
    from beer_tpu_torch import vbi

    from benchmark.tasks import train

    c = harness.cell(cell, 2**31 + 5, "cpu", SMALL)
    c.corpus = harness.corpus_mod.make(c.traffic, c.cfg, c.seed, "cpu")
    a, b = (c.family.build(c.cfg, c.corpus.init_means) for _ in range(2))
    totals = {"mstep_s": 0.0, "mstep_calls": 0}
    for _ in range(2):
        want, _ = vbi.vb_step(a, c.corpus.x, mask=c.corpus.mask)
        got = train._split_step(b, c.corpus.x, c.corpus.mask, c.device, totals)
        assert got == float(want)
    for k, v in c.family.posteriors(a).items():
        assert torch.equal(c.family.posteriors(b)[k], v)
    assert totals["mstep_calls"] == 2 and totals["mstep_s"] > 0
