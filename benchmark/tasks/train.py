"""Full-batch VB-EM training: ``beer_tpu_torch.vbi.vb_step(model, x,
mask=m)`` over the whole corpus, one epoch a call, learning rate 1, the
model updated in place, each step's ELBO read back as ``hmm train`` logs
it.  End-to-end: ``train_frames_per_s``, the valid frames of every step
completed in the window over the window's seconds.

The window keeps the card fed while the host stands still: each ELBO is
read once its step was dispatched ``AHEAD_S`` seconds ago, not at once,
so the host runs up to that far ahead of the card (less where CUDA's
launch queue fills first).  When the time is up nothing more is
dispatched, the window waits for every step that was, and reads the
clock after that wait: every dispatched step counts, over all of that
time.

Set-up builds the one model object, drives it through the first
``check_steps`` steps (the steps the reference follows; they also warm
every shape and the conjugate update's first ``torch.func.grad``), and
hands it to the window.  A traced run splits every step of its window
into the calls ``vb_step`` makes, ``vbi.elbo_and_stats`` and
``model.vb_update``, with a synchronise between them: the update's wall
time is summed over the whole window (``totals``, hundreds of
milliseconds, where one update lasts under one), and the profiled
stretch puts the two calls under the spans ``estep`` and ``mstep``
inside ``step``.
"""

from __future__ import annotations

import collections
import math
import time

import torch

from benchmark import checks, peaks, tracing
from benchmark.harness import Outcome, quartiles_ms
from benchmark.reference.common import Precision

METRIC = "train_frames_per_s"
AHEAD_S = 4.0      # how far the host may dispatch ahead of the ELBO it reads


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _split_step(model, x, m, device, totals) -> float:
    """One step as ``vb_step`` makes it, a synchronise after the E-step
    and after the update, the update's seconds added to ``totals``."""
    from beer_tpu_torch import vbi

    rf = torch.profiler.record_function
    with torch.no_grad():
        with rf("estep"):
            elbo, acc = vbi.elbo_and_stats(model, x, mask=m)
            _sync(device)
        t = time.perf_counter()
        with rf("mstep"):
            model.vb_update(acc, 1.0)
            _sync(device)
    totals["mstep_s"] += time.perf_counter() - t
    totals["mstep_calls"] += 1
    return float(elbo)


def _traced_steps(model, x, m, n, elbos, device, totals) -> int:
    for _ in range(n):
        with torch.profiler.record_function("step"):
            elbos.append(_split_step(model, x, m, device, totals))
    return n


def program_steps(cell, n: int):
    """Build the program's model and run its first ``n`` steps: (model,
    {"elbos", "stats", "change"}) — the statistics worked out from the
    posterior after one step, the change after all ``n``."""
    from beer_tpu_torch import vbi

    fam, cor = cell.family, cell.corpus
    model = fam.build(cell.cfg, cor.init_means)
    post, prior = fam.posteriors(model), fam.priors(model)
    start = {k: v.detach().double().clone() for k, v in post.items()}
    got = {"elbos": []}
    for i in range(n):
        elbo, model = vbi.vb_step(model, cor.x, mask=cor.mask)
        got["elbos"].append(float(elbo))
        if i == 0:
            got["stats"] = {k: post[k].double() - prior[k].double() for k in post}
    got["change"] = {k: post[k].double() - start[k] for k in post}
    return model, got


def reference_steps(cell, n: int, prec: Precision, scale_rows: float = 1.0):
    """The plain reference's first ``n`` steps from the same initial means
    and frames, in ``prec``; with ``scale_rows`` < 1 only the first rows of
    the batch, their data terms scaled up to the whole (a fault)."""
    ref, cor = cell.reference, cell.corpus
    rows = int(round(cor.x.shape[0] * scale_rows))
    x, lens = cor.x[:rows], cor.lens[:rows]
    params = ref.initial(cell.cfg, cor.init_means, prec.dtype)
    start = {k: v.double().clone() for k, v in params["post"].items()}
    want = {"elbos": []}
    for i in range(n):
        elbo, stats = ref.estep(cell.cfg, params, x, lens, prec, scale=cor.x.shape[0] / rows)
        want["elbos"].append(float(elbo))
        if i == 0:
            want["stats"] = stats
        params = ref.update(params, stats)
    want["change"] = {k: params["post"][k].double() - start[k] for k in start}
    return want


def run(cell, seconds: float, trace: bool):
    device, cor = cell.device, cell.corpus
    n_check = cell.spec["check_steps"]
    model, got = program_steps(cell, n_check)
    from beer_tpu_torch import vbi

    _sync(device)
    elbos, steps, failed, traced = [], 0, 0, None
    pending = collections.deque()             # (ELBO on the card, when its step was dispatched)
    ahead = 0                                 # the most steps dispatched and not yet read
    totals = {"mstep_s": 0.0, "mstep_calls": 0}
    t0 = time.perf_counter()
    marks = [t0]
    while True:
        if trace and traced is None and time.perf_counter() - t0 >= seconds / 3:
            work = cell.work()
            work = dict(work, step_flops=work["estep_flops"])
            traced = tracing.capture(
                lambda: _traced_steps(model, cor.x, cor.mask, cell.traffic["trace_calls"],
                                      elbos, device, totals), "train", work, peaks.H100)
            steps += traced.calls
        elif trace:
            elbos.append(_split_step(model, cor.x, cor.mask, device, totals))
            steps += 1
        else:
            elbo, model = vbi.vb_step(model, cor.x, mask=cor.mask)
            now = time.perf_counter()
            pending.append((elbo, now))
            while now - pending[0][1] >= AHEAD_S:
                elbos.append(float(pending.popleft()[0]))
            ahead = max(ahead, len(pending))
            steps += 1
        marks.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds and (traced is not None or not trace):
            break
    _sync(device)
    window = time.perf_counter() - t0
    elbos.extend(float(e) for e, _ in pending)
    if traced is not None:
        traced.totals.update(totals)
    failed = sum(not math.isfinite(e) for e in elbos)
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()

    want = reference_steps(cell, n_check, Precision("float64"))
    gaps = checks.train_gaps(got, want, cor.n_frames)
    return Outcome(
        metrics={METRIC: steps * cor.n_frames / window},
        attempted=steps, failed=failed, window_start=t0, memory_peak_bytes=memory,
        trace=traced, checks=checks.verdict(gaps, cell.spec["limits"]),
        details={"window_s": window, "steps": steps, "valid_frames": cor.n_frames,
                 "loop_ms_quartiles": quartiles_ms(marks), "steps_ahead_max": ahead,
                 "elbo_per_frame_first_last": [elbos[0] / cor.n_frames, elbos[-1] / cor.n_frames],
                 "checked_elbos": got["elbos"], "reference_elbos": want["elbos"]})
