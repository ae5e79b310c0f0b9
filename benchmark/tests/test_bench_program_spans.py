"""The readers of the program's own spans (``beer.*``) on synthetic Chrome
traces: each gives its hand-worked value over nested, repeated and
overlapping spans clipped to the window, returns None where the trace
holds no such span (a program that opens none), and the program's idle
share never exceeds the whole idle share."""

import json
import random

import pytest

from benchmark import harness, peaks, program_spans, tracing

READERS = ("program_idle_pct.train", "program_idle_pct.decode", "prep_ms.train",
           "prep_ms.decode", "update_host_ms")

# µs: window 0–1000, two calls; the benchmark's own spans as a traced
# training stretch puts them; device busy 150–300, 400–450, 600–700
BENCH = [("user_annotation", "step", 0, 500), ("user_annotation", "step", 500, 500),
         ("user_annotation", "estep", 50, 300), ("user_annotation", "estep", 550, 200),
         ("user_annotation", "mstep", 350, 150), ("user_annotation", "mstep", 750, 250),
         ("kernel", "k2", 150, 150), ("kernel", "k1", 600, 100), ("gpu_memset", "fill", 400, 50),
         ("cpu_op", "aten::fill_", 120, 10), ("cuda_runtime", "cudaLaunchKernel", 300, 20)]
# the program's: operands nested in the E-step and overlapping each other
# and the KL, a wait on the card inside them, a nested repeat of the
# update, an update running past the window's end and operands wholly
# after it
PROGRAM = [("user_annotation", "beer.estep", 60, 280), ("user_annotation", "beer.estep", 560, 180),
           ("user_annotation", "beer.operands", 100, 60), ("user_annotation", "beer.operands", 120, 60),
           ("user_annotation", "beer.kl", 170, 20), ("user_annotation", "beer.operands", 580, 20),
           ("user_annotation", "beer.sync.structured_trans", 130, 20),
           ("user_annotation", "beer.kernel.estep_acc_banded", 300, 30),
           ("user_annotation", "beer.vb_update", 360, 120),
           ("user_annotation", "beer.vb_update", 400, 20),
           ("user_annotation", "beer.vb_update", 760, 140),
           ("user_annotation", "beer.vb_update", 950, 150),
           ("user_annotation", "beer.operands", 1100, 100)]


def _trace(tmp_path, task, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        for cat, name, ts, dur in [("user_annotation", "window", 0, 1000)] + events]}))
    device, host, spans = tracing._read(str(path))
    window = spans.pop("window")[0]
    return tracing.Trace(task, 2, window, device, spans, host, {}, peaks.H100)


def _read(name, trace):
    return harness.reader(name).read(trace)


@pytest.mark.parametrize("task", ["train", "decode"])
def test_hand_worked_values(tmp_path, task):
    t = _trace(tmp_path, task, BENCH + PROGRAM)
    # union of every beer.* span in the window: 60–340, 360–480, 560–740,
    # 760–900, 950–1000; less the device's 150–300, 400–450, 600–700:
    # 130 + 70 + 80 + 140 + 50 = 470 µs idle of 1000
    assert program_spans.seconds(program_spans.union(t)) == pytest.approx(770e-6)
    # operands ∪ KL: 100–190 and 580–600, less the wait 130–150: 90 µs over
    # two calls
    assert _read(f"prep_ms.{task}", t) == pytest.approx(0.045)
    assert _read(f"program_idle_pct.{task}", t) == pytest.approx(47.0)
    assert _read(f"idle_pct.{task}", t) == pytest.approx(70.0)
    other = "decode" if task == "train" else "train"
    assert _read(f"prep_ms.{other}", t) is None and _read(f"program_idle_pct.{other}", t) is None
    # the update: 360–480 (the nested repeat once), 760–900, 950–1000
    assert _read("update_host_ms", t) == (pytest.approx(0.155) if task == "train" else None)


def test_breakdown_names_the_programs_span(tmp_path):
    """An idle gap is put down to the innermost span, the program's where
    the host is inside one."""
    b = _trace(tmp_path, "train", BENCH + PROGRAM).breakdown()
    gaps = dict((g[0], g[1]) for g in b["idle_gaps"])
    # gaps 0–150, 300–400, 450–600 and 700–1000, named at their starts
    assert gaps == {"step/python": pytest.approx(150e-6),
                    "beer.kernel.estep_acc_banded/cudaLaunchKernel": pytest.approx(100e-6),
                    "beer.vb_update/python": pytest.approx(150e-6),
                    "beer.estep/python": pytest.approx(300e-6)}


@pytest.mark.parametrize("task", ["train", "decode"])
def test_none_without_the_programs_spans(tmp_path, task):
    """On a trace with only the benchmark's spans, as from a program that
    opens none, every reader returns None; the existing ones still read."""
    t = _trace(tmp_path, task, BENCH + [("user_annotation", "beerx", 100, 100)])
    assert all(_read(name, t) is None for name in READERS)
    assert _read(f"idle_pct.{task}", t) == pytest.approx(70.0)


@pytest.mark.parametrize("seed", range(8))
def test_program_idle_within_idle(tmp_path, seed):
    rng = random.Random(seed)

    def spans(cat, name, n):
        out = []
        for _ in range(n):
            start = rng.randrange(-100, 1000)
            out.append((cat, name, start, rng.randrange(1, 300)))
        return out

    events = spans("kernel", "k", 12) + spans("user_annotation", "beer.operands", 6) + \
        spans("user_annotation", "beer.estep", 3)
    t = _trace(tmp_path, "train", events)
    assert 0.0 <= _read("program_idle_pct.train", t) <= _read("idle_pct.train", t) + 1e-9
    whole = _trace(tmp_path, "train", events + [("user_annotation", "beer.vb_step", -5, 1010)])
    assert _read("program_idle_pct.train", whole) == pytest.approx(_read("idle_pct.train", whole))


@pytest.mark.parametrize("cell,names", [
    ("aud-train", {"program_idle_pct.train", "prep_ms.train", "update_host_ms"}),
    ("hmm-train", {"program_idle_pct.train", "prep_ms.train", "update_host_ms"}),
    ("aud-decode", {"program_idle_pct.decode", "prep_ms.decode"})])
def test_cells_report_the_program_span_metrics(cell, names):
    """Each reader is listed for the cells where the program opens its
    spans, with the end-to-end metric it moves reported there."""
    ours = {m["name"] for m in harness.cell_metrics("per_layer", cell) if m["name"] in READERS}
    assert ours == names
    moves = {m["name"] for m in harness.cell_metrics("end_to_end", cell)}
    assert {m["moves"] for m in harness.cell_metrics("per_layer", cell) if m["name"] in names} <= moves
