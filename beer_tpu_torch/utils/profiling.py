"""Tracing and profiling hooks.

Counterpart of ``beer_tpu/utils/profiling.py``: named regions for the
profiler (:func:`named_scope`, ``torch.profiler.record_function``), a
trace context (:func:`trace`, ``torch.profiler.profile`` written as a
Chrome trace) and host-clock spans as JSONL (:class:`SpanTimer`), which
synchronise the CUDA card at both ends of a span so it bounds the
device's work too.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch


def named_scope(name: str):
    """Annotate a region for ``torch.profiler`` (usable as a context)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, when a card is
    in use, CUDA activity into ``logdir/trace.json`` (Chrome trace)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SpanTimer:
    """Host-clock spans written as JSONL.  Each span starts and ends with
    ``torch.cuda.synchronize()`` when the card is in use, so a span holds
    the device time of its work."""

    def __init__(self, path=None):
        self.path = Path(path) if path else None
        self.spans = []

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        _sync()
        t0 = time.time()
        try:
            yield
        finally:
            _sync()
            rec = {"name": name, "start": t0, "dur_s": time.time() - t0, **meta}
            self.spans.append(rec)
            if self.path:
                with open(self.path, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
