"""The traced stretch of a run: ``torch.profiler`` over a few calls in the
steady part of the window, read back from its Chrome trace.

The benchmark puts its own spans (``torch.profiler.record_function``)
around its calls into the program: ``window`` around the stretch and,
inside it, one span a call (``step`` or ``decode`` and their parts, named
by the task).  Each span ends after a ``torch.cuda.synchronize()``, so
the device work a span caused runs inside its host interval, and a device
operation belongs to the span whose interval holds it.

:class:`Trace` holds what the per-layer readers under
``benchmark/metrics`` read: the window, the device operations (kernels,
copies and fills), the spans, the host operations, the calls traced,
the work counts of the cell, and the task's own sums over the whole
window (``totals``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Callable

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Op:
    name: str
    start: float   # seconds, the profiler's clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    task: str
    calls: int                 # calls traced (steps or decodes)
    window: Op
    device: list               # Op, by start
    spans: dict                # span name → [Op]
    host: list                 # Op
    work: dict                 # the cell's work counts a call
    peaks: dict
    totals: dict = dataclasses.field(default_factory=dict)  # the task's own sums over the window

    @property
    def window_s(self) -> float:
        return self.window.seconds

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the window."""
        out = []
        for op in self.device:
            s, e = max(op.start, self.window.start), min(op.end, self.window.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_in(self, span: str) -> list:
        """The device operations inside the intervals of ``span``."""
        ivs = self.spans.get(span, [])
        return [op for op in self.device
                if any(iv.start <= op.start and op.end <= iv.end for iv in ivs)]

    def least_s(self, flops: float, n_bytes: float) -> float:
        """The least time of ``flops`` float32 operations and ``n_bytes``
        bytes on the card: the larger of the two bounds."""
        return max(flops / self.peaks["float32_flops"], n_bytes / self.peaks["hbm_bytes_per_s"])

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps inside the window named by the span and the innermost host
        operation that was running at the gap's start."""
        by_name: dict = {}
        for op in self.device:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.seconds
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        busy = self.busy_intervals()
        edges = [self.window.start] + [x for iv in busy for x in iv] + [self.window.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[name[:120], s] for name, s in ops],
                "idle_gaps": [[self._host_at(s), e - s] for s, e in gaps]}

    def _host_at(self, t: float) -> str:
        spans = [op for ops in self.spans.values() for op in ops if op.start <= t < op.end]
        inner = [op for op in self.host if op.start <= t < op.end]
        span = min(spans, key=lambda o: o.seconds).name if spans else "window"
        op = min(inner, key=lambda o: o.seconds).name if inner else "python"
        return f"{span}/{op}"[:120]


def _read(path: str):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device, host, spans = [], [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        op = Op(ev["name"], ev["ts"] * 1e-6, (ev["ts"] + ev["dur"]) * 1e-6)
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(op)
        elif cat == "user_annotation":
            spans.setdefault(op.name, []).append(op)
        elif cat in HOST_CATS:
            host.append(op)
    device.sort(key=lambda o: o.start)
    return device, host, spans


def capture(stretch: Callable[[], int], task: str, work: dict, peaks: dict,
            tries: int = 3) -> Trace:
    """Run ``stretch`` (which makes the traced calls inside its spans and
    returns how many it made) under the profiler, inside a ``window`` span;
    a trace that holds no device time is taken again, up to ``tries``
    times, and then the run fails."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("window"):
                calls = stretch()
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            device, host, spans = _read(path)
        if device and "window" in spans:
            window = spans.pop("window")[0]
            trace = Trace(task, calls, window, device, spans, host, work, peaks)
            if trace.busy_s > 0:
                return trace
    raise RuntimeError(f"no device time in {tries} traces of the window")
