"""The work counts against hand counts at a small shape, and the trace
reduction and the per-layer readers against a trace written by hand."""

import json

import pytest
import torch

from benchmark import harness, peaks, tracing
from benchmark.families import hmm, phone_loop

LOOP = {"units": 2, "states_per_unit": 3, "components": 6, "dim": 2}
ERGODIC = {"states": 3, "components": 3, "dim": 2}
LENS = torch.tensor([3, 5])            # N = 8 valid frames, B = 2, T = 5


def test_phone_loop_counts():
    w = phone_loop.work(LOOP, LENS, 5)
    # a frame: ELLH 2·6·4 = 48, accumulation 48, forward 8·6, backward 12·6, ξ 2·2²
    assert w["estep_flops"] == 8 * (48 + 48 + 48 + 72 + 8)
    # decode a frame: ELLH 48, (max, +) 6·6, backtrace 2
    assert w["decode_flops"] == 8 * (48 + 36 + 2)
    params = 4 * (6 * 8 + 1 * 2)       # emissions 6 × 4D, one stick (α, β)
    assert w["estep_bytes"] == 4 * (8 * 2 + 2) + 2 * params
    assert w["decode_bytes"] == 4 * (8 * 2 + 2) + params + 4 * (2 * 5 + 2)


def test_hmm_counts():
    w = hmm.work(ERGODIC, LENS, 5)
    # a frame: ELLH 2·3·4 = 24, accumulation 24, forward 2·9 + 12,
    # backward 2·9 + 30, ξ 2·9
    assert w["estep_flops"] == 8 * (24 + 24 + 30 + 48 + 18)
    params = 4 * (3 * 8 + 9)
    assert w["estep_bytes"] == 4 * (8 * 2 + 2) + 2 * params


def _trace_file(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur} for cat, name, ts, dur in events]}))
    return str(path)


def _trace(tmp_path, task, work):
    # µs: window 0–1000; two steps; estep kernels 100–300 and 600–700,
    # an mstep fill 400–450; host op during the gap 300–400
    events = [("user_annotation", "window", 0, 1000),
              ("user_annotation", "step", 0, 500), ("user_annotation", "step", 500, 500),
              ("user_annotation", "estep", 50, 300), ("user_annotation", "estep", 550, 200),
              ("user_annotation", "mstep", 350, 150), ("user_annotation", "mstep", 750, 250),
              ("kernel", "k2", 100, 200), ("kernel", "k1", 600, 100),
              ("gpu_memset", "fill", 400, 50), ("cpu_op", "aten::digamma", 300, 100)]
    device, host, spans = tracing._read(_trace_file(tmp_path, events))
    window = spans.pop("window")[0]
    return tracing.Trace(task, 2, window, device, spans, host, work, peaks.H100)


def test_trace_reduction(tmp_path):
    t = _trace(tmp_path, "train", {})
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(350e-6)
    assert [op.name for op in t.device_in("estep")] == ["k2", "k1"]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k2", pytest.approx(200e-6)]
    assert b["idle_gaps"][0] == ["estep/python", pytest.approx(300e-6)]  # 700–1000
    assert ["estep/aten::digamma", pytest.approx(100e-6)] in b["idle_gaps"]


def test_readers(tmp_path):
    work = {"estep_flops": 67e6, "estep_bytes": 0.0, "step_flops": 67e6}
    t = _trace(tmp_path, "train", work)
    read = lambda name: harness.reader(name).read(t)  # noqa: E731
    # 67 MFLOP a step at 67 TFLOP/s: 1 µs a step, 2 µs over 300 µs of estep device time
    assert read("estep_roofline") == pytest.approx(100 * 2e-6 / 300e-6)
    assert read("mfu_pct.train") == pytest.approx(100 * 2e-6 / 1e-3)
    assert read("mstep_ms") is None                  # no update timed over the window
    t.totals.update(mstep_s=0.9, mstep_calls=450)
    assert read("mstep_ms") == pytest.approx(2.0)
    assert read("launches.train") == pytest.approx(3 / 2)
    assert read("idle_pct.train") == pytest.approx(65.0)
    assert read("decode_roofline") is None and read("idle_pct.decode") is None
