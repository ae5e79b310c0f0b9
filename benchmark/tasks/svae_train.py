"""Minibatch training of the structured VAE: the program's hybrid step,
``beer_tpu_torch.models.vae.make_vae_train_step(adam, datasize, lrate)``
(the encoder, the latent phone loop's K1 + K11, the decoder, the
backward through both nnets and ``PhoneLoopLogZ``, an Adam step and the
conjugate update), over the corpus in minibatches of ``minibatch`` rows
in the seed's order, each padded to the corpus's longest frame, the data
terms scaled to ``datasize`` utterances.  End-to-end:
``train_frames_per_s``, the valid frames of every step completed in the
window over the window's seconds.

Set-up builds the model (the nnets from the seed) and ``torch.optim.Adam``
and runs the first ``check_steps`` steps on minibatches 0, 1, 2, … with
the noise ε drawn from the seed and injected (the steps the reference
follows; they also warm every shape).  The window continues the same
objects over the next minibatches, the noise drawn from a device
generator seeded with the seed, as the verb draws it; each ELBO is read
``train.AHEAD_S`` late, and the window closes after the wait for every
dispatched step, as :mod:`benchmark.tasks.train` does.

A traced run cuts each step of its profiled stretch into the benchmark's
spans ``step`` ⊃ ``forward`` (``elbo_and_stats``), ``backward`` (to the
``torch.optim`` step), ``update`` (``VBOptimizer.step``: Adam and the
conjugate update), each ending in a synchronise, and sums the program's
count of nnet frames (``NNET_FRAMES``, where the program keeps one) over
the stretch into ``totals``.

The numbers that decide ``correct`` (against the float64 reference of
:mod:`benchmark.reference.svae`, after the window):

* ``elbo_gap`` — the widest |ELBO − reference| of the checked steps, in
  nats a frame the scaled ELBO stands for (the minibatch's valid frames
  times ``datasize`` over its rows);
* ``grad_gap`` — the first step's nnet gradients, the worst weight
  tensor's ‖g − r‖ / ‖r‖;
* ``stats_gap`` — the first step's conjugate statistics, worked out
  from the posterior after one step, by :func:`checks.worst_leaf_gap`;
* ``param_gap`` — the nnet weights' change over the checked steps, the
  worst tensor's ‖Δp − Δr‖ / ‖Δr‖, over the weights whose first-step
  reference gradient is at least ``SIGN_FLOOR`` of its tensor's RMS:
  Adam's first step moves a weight by lr·sign(g), so float32 rounding
  can reverse the whole step of a weight whose gradient is rounding-sized
  (left out: under 0.02 % of the weights);
* ``change_gap`` — the posterior's change over the checked steps, by
  :func:`checks.worst_leaf_gap`.
"""

from __future__ import annotations

import collections
import math
import time

import torch

from benchmark import checks, peaks, tracing
from benchmark.harness import Outcome, quartiles_ms
from benchmark.reference.common import Precision, tf32_off
from benchmark.tasks.train import AHEAD_S, _sync  # the training cells' read delay and wait

METRIC = "train_frames_per_s"
TASK = "svae_train"
SIGN_FLOOR = 1e-4   # of a weight tensor's RMS first-step gradient, in param_gap


def n_minibatches(cell) -> int:
    return cell.traffic["utterances"] // cell.traffic["minibatch"]


def minibatch(cell, i: int, rows: float = 1.0):
    """(x, mask, lens) of minibatch ``i`` (modulo their number), its first
    ``rows`` share of rows."""
    size = cell.traffic["minibatch"]
    lo = (i % n_minibatches(cell)) * size
    hi = lo + int(round(size * rows))
    cor = cell.corpus
    return cor.x[lo:hi], cor.mask[lo:hi], cor.lens[lo:hi]


def check_eps(cell, i: int) -> torch.Tensor:
    """The noise of checked step ``i``, (nsamples, minibatch, T, dz), drawn
    on the device from the seed."""
    cor, cfg = cell.corpus, cell.cfg
    gen = torch.Generator(device=cor.x.device).manual_seed((cell.seed * 8 + i + 1) % 2**63)
    return torch.randn((cfg["nsamples"], cell.traffic["minibatch"], cor.x.shape[1],
                        cfg["latent_dim"]), generator=gen, device=cor.x.device)


def nnet_frames():
    """The program's count of frames its nnets ran over, or None where the
    program keeps none."""
    from beer_tpu_torch.models import vae

    count = getattr(vae, "NNET_FRAMES", None)
    return None if count is None else count.frames


def rel_gap(got: dict, want: dict) -> float:
    """The worst tensor's ‖got − want‖ / ‖want‖."""
    return max(float(torch.linalg.vector_norm(got[k].double() - want[k].double())
                     / torch.linalg.vector_norm(want[k].double())) for k in want)


def elbo_frames(cell, n: int) -> list:
    """The frames each of the first ``n`` steps' scaled ELBO stands for."""
    return [cell.traffic["datasize"] / cell.traffic["minibatch"] * float(minibatch(cell, i)[2].sum())
            for i in range(n)]


def gaps(got: dict, want: dict, frames: list) -> dict:
    def signed(change):       # the weights whose first Adam step has a sign to keep
        out = {}
        for k, v in change.items():
            g = want["grads"][k].double()
            out[k] = v[g.abs() >= SIGN_FLOOR * g.pow(2).mean().sqrt()]
        return out

    return {"elbo_gap": max(abs(a - b) / f for a, b, f in zip(got["elbos"], want["elbos"], frames)),
            "grad_gap": rel_gap(got["grads"], want["grads"]),
            "stats_gap": checks.worst_leaf_gap(got["stats"], want["stats"]),
            "param_gap": rel_gap(signed(got["params"]), signed(want["params"])),
            "change_gap": checks.worst_leaf_gap(got["change"], want["change"])}


def program_steps(cell, n: int, rows: float = 1.0):
    """Build the program's model, Adam and hybrid step and run the first
    ``n`` steps with the seed's noise, on the first ``rows`` share of each
    minibatch (the data terms scaled to ``datasize`` all the same): (model,
    optimizer, step, the initial nnet weights, {"elbos", "grads",
    "stats", "params", "change"})."""
    from beer_tpu_torch.models.vae import make_vae_train_step

    fam, cfg = cell.family, cell.cfg
    tf32_off()
    model = fam.build(cfg, cell.corpus.init_means, cell.seed)
    opt = torch.optim.Adam(model.parameters(), lr=cfg["adam_lr"])
    step = make_vae_train_step(opt, datasize=cell.traffic["datasize"], lrate=cfg["lrate"])
    post, prior = fam.posteriors(model), fam.priors(model)
    start = {k: v.detach().double().clone() for k, v in post.items()}
    weights = fam.nnet_state(model)
    got = {"elbos": []}
    for i in range(n):
        x, m, _ = minibatch(cell, i, rows)
        elbo = step(model, x, mask=m, eps=check_eps(cell, i)[:, :x.shape[0]])
        got["elbos"].append(float(elbo))
        if i == 0:
            got["grads"] = fam.nnet_state(model, grads=True)
            # the statistics as the update took them: post₁ = post₀ + ρ(prior + stats − post₀)
            got["stats"] = {k: (post[k].double() - start[k]) / cfg["lrate"] + start[k]
                            - prior[k].double() for k in post}
    got["change"] = {k: post[k].double() - start[k] for k in post}
    got["params"] = {k: v.double() - weights[k].double()
                     for k, v in fam.nnet_state(model).items()}
    return model, opt, step, weights, got


def reference_steps(cell, n: int, prec: Precision, weights: dict):
    """The plain reference's first ``n`` steps from the same initial means,
    nnet weights, minibatches and noise, in ``prec``."""
    ref, cfg = cell.reference, cell.cfg
    params = ref.initial(cfg, cell.corpus.init_means, weights, prec.dtype)
    start_post = {k: v.double().clone() for k, v in params["post"].items()}
    start_nnet = {k: v.double().clone() for k, v in params["nnet"].items()}
    want = {"elbos": []}
    for i in range(n):
        x, _, lens = minibatch(cell, i)
        elbo, grads, stats = ref.step(cfg, params, x, lens, check_eps(cell, i), prec,
                                      scale=cell.traffic["datasize"] / x.shape[0])
        want["elbos"].append(float(elbo))
        if i == 0:
            want["grads"], want["stats"] = grads, stats
        params = ref.update(ref.adam(params, grads, cfg["adam_lr"]), stats, cfg["lrate"])
    want["change"] = {k: params["post"][k].double() - start_post[k] for k in start_post}
    want["params"] = {k: params["nnet"][k].double() - start_nnet[k] for k in start_nnet}
    return want


def traced_step(step, model, opt, x, m, gen, device) -> float:
    """One call of the program's hybrid step, cut into the benchmark's
    spans by a synchronise at each boundary: ``forward`` around
    ``elbo_and_stats``, ``backward`` from its return to the ``torch.optim``
    step, ``update`` from there to the step's return, inside ``step``."""
    rf = torch.profiler.record_function
    open_span = []
    elbo_and_stats, adam_step = model.elbo_and_stats, opt.step

    def forward(*args, **kw):
        with rf("forward"):
            out = elbo_and_stats(*args, **kw)
            _sync(device)
        open_span.append(rf("backward").__enter__())
        return out

    def update(*args, **kw):
        _sync(device)
        open_span.pop().__exit__(None, None, None)
        open_span.append(rf("update").__enter__())
        return adam_step(*args, **kw)

    model.elbo_and_stats, opt.step = forward, update
    try:
        with rf("step"):
            elbo = step(model, x, gen, mask=m)
            _sync(device)
            open_span.pop().__exit__(None, None, None)
    finally:
        del model.elbo_and_stats, opt.step
    return float(elbo)


def _traced_steps(step, model, opt, batches, gen, device, elbos, totals) -> int:
    before = nnet_frames()
    for x, m in batches:
        elbos.append(traced_step(step, model, opt, x, m, gen, device))
    if before is not None:
        totals["nnet_frames"] = nnet_frames() - before
    return len(batches)


def run(cell, seconds: float, trace: bool):
    device, cor = cell.device, cell.corpus
    n_check = cell.spec["check_steps"]
    model, opt, step, weights, got = program_steps(cell, n_check)
    gen = torch.Generator(device=device).manual_seed(cell.seed)
    valid = [int(minibatch(cell, i)[2].sum()) for i in range(n_minibatches(cell))]
    _sync(device)
    elbos, steps, frames, traced, totals = [], 0, 0, None, {}
    pending = collections.deque()             # (ELBO on the card, when its step was dispatched)
    ahead = 0                                 # the most steps dispatched and not yet read
    i = n_check                               # the next minibatch
    t0 = time.perf_counter()
    marks = [t0]
    while True:
        if trace and traced is None and time.perf_counter() - t0 >= seconds / 3:
            ids = [i + k for k in range(cell.traffic["trace_calls"])]
            works = [cell.family.work(cell.cfg, minibatch(cell, j)[2].cpu(), cor.x.shape[1])
                     for j in ids]
            work = {k: sum(w[k] for w in works) / len(works) for k in works[0]}
            batches = [minibatch(cell, j)[:2] for j in ids]
            traced = tracing.capture(
                lambda: _traced_steps(step, model, opt, batches, gen, device, elbos, totals),
                TASK, work, peaks.H100)
            steps += traced.calls
            frames += sum(valid[j % len(valid)] for j in ids[:traced.calls])
            i += traced.calls
        else:
            x, m, _ = minibatch(cell, i)
            elbo = step(model, x, gen, mask=m)
            if trace:
                elbos.append(float(elbo))
            else:
                now = time.perf_counter()
                pending.append((elbo, now))
                while now - pending[0][1] >= AHEAD_S:
                    elbos.append(float(pending.popleft()[0]))
                ahead = max(ahead, len(pending))
            steps += 1
            frames += valid[i % len(valid)]
            i += 1
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
    del model, opt, step, pending
    if device.type == "cuda":
        torch.cuda.empty_cache()

    want = reference_steps(cell, n_check, Precision("float64"), weights)
    readings = gaps(got, want, elbo_frames(cell, n_check))
    return Outcome(
        metrics={METRIC: frames / window},
        attempted=steps, failed=failed, window_start=t0, memory_peak_bytes=memory,
        trace=traced, checks=checks.verdict(readings, cell.spec["limits"]),
        details={"window_s": window, "steps": steps, "valid_frames": frames,
                 "minibatch_valid_frames": valid, "loop_ms_quartiles": quartiles_ms(marks),
                 "steps_ahead_max": ahead,
                 "elbo_per_frame_first_last": [elbos[0] / cor.n_frames, elbos[-1] / cor.n_frames],
                 "checked_elbos": got["elbos"], "reference_elbos": want["elbos"]})
