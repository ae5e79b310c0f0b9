"""Decoding the corpus: the model that set-up builds decodes every
utterance to per-frame unit labels, ``family.decode`` (for the phone
loop ``model.decode_units(x, m)``), again and again, the labels and
scores brought to the host each call.  Unlike ``hmm decode``, whose
``.cpu()`` copies into pageable memory on the default thread pool, the
copy goes into page-locked buffers made at set-up, and ``run.py`` keeps
CPU operators to one thread: a pageable copy runs at the host's memory
speed, which other work on a shared host moves by tens of per cent from
run to run, so the cell leaves that cost of the verb unmeasured.  End-to-end:
``decode_frames_per_s``, the valid frames of every decode completed in the
window over the window's seconds.

The traced stretch puts a call under the span ``call``, with the decode
under ``decode`` and the copy of the labels and scores under
``to_host``.  The check takes the labels and scores of the window's last
call, on a sample of rows drawn from the seed.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import checks, corpus, peaks, tracing
from benchmark.harness import Outcome, quartiles_ms
from benchmark.reference.common import Precision

METRIC = "decode_frames_per_s"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=like.is_cuda)


def _call(cell, model, host):
    """One decode, its labels and scores copied into ``host``."""
    with torch.no_grad():
        labels, scores = cell.family.decode(model, cell.corpus.x, cell.corpus.mask)
    host[0].copy_(labels)
    host[1].copy_(scores)


def _traced_calls(cell, model, n, host) -> int:
    rf = torch.profiler.record_function
    for _ in range(n):
        with rf("call"):
            with rf("decode"):
                with torch.no_grad():
                    labels, scores = cell.family.decode(model, cell.corpus.x, cell.corpus.mask)
                _sync(cell.device)
            with rf("to_host"):
                host[0].copy_(labels)
                host[1].copy_(scores)
    return n


def reference_gaps(cell, rows, labels, scores) -> dict:
    """The decode numbers of ``labels`` (B, T) and ``scores`` (B,) on
    ``rows``, against the plain reference in the configuration's own
    precision (float32, TF32 off): a best-path score is a float32 sum over
    hundreds of frames, whose rounding (~0.06 nats an utterance) a float64
    reference would read as a gap and so hide the control's."""
    ref, cor = cell.reference, cell.corpus
    prec = Precision(cell.cfg["dtype"])
    params = ref.initial(cell.cfg, cor.init_means, prec.dtype)
    x, lens = cor.x[rows.to(cor.x.device)], cor.lens[rows.to(cor.x.device)]
    _, best = ref.decode(cell.cfg, params, x, lens, prec)
    _, path_best = ref.decode(cell.cfg, params, x, lens, prec,
                              labels=torch.as_tensor(labels)[rows])
    return checks.decode_gaps(torch.as_tensor(scores)[rows], best, path_best, lens)


def run(cell, seconds: float, trace: bool):
    device, cor = cell.device, cell.corpus
    model = cell.family.build(cell.cfg, cor.init_means)
    with torch.no_grad():                     # warms every shape of the call
        host = [_host(v) for v in cell.family.decode(model, cor.x, cor.mask)]
    _call(cell, model, host)
    _sync(device)
    calls, failed, traced = 0, 0, None
    valid = cor.lens.cpu() > 0
    t0 = time.perf_counter()
    marks = [t0]
    while True:
        if trace and traced is None and time.perf_counter() - t0 >= seconds / 3:
            work = cell.work()
            traced = tracing.capture(
                lambda: _traced_calls(cell, model, cell.traffic["trace_calls"], host),
                "decode", work, peaks.H100)
            calls += traced.calls
        else:
            _call(cell, model, host)
            calls += 1
        marks.append(time.perf_counter())
        failed += int(not bool(torch.isfinite(host[1][valid]).all()))
        if time.perf_counter() - t0 >= seconds and (traced is not None or not trace):
            break
    window = time.perf_counter() - t0
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rows = corpus.sample_rows(cor, cell.spec["check_rows"], cell.seed)
    gaps = reference_gaps(cell, rows, host[0], host[1])
    return Outcome(
        metrics={METRIC: calls * cor.n_frames / window},
        attempted=calls, failed=failed, window_start=t0, memory_peak_bytes=memory,
        trace=traced, checks=checks.verdict(gaps, cell.spec["limits"]),
        details={"window_s": window, "calls": calls, "valid_frames": cor.n_frames,
                 "loop_ms_quartiles": quartiles_ms(marks),
                 "checked_rows": len(rows)})
