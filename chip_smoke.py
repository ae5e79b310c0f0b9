#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU.

    python3 chip_smoke.py

Runs BASELINE config 4 (phone-loop acoustic-unit discovery: 50 units ×
3 states, diagonal NormalSet over 39-dim frames, stick-breaking unit
prior) at the bench shape (B=512 utterances, T ≤ 500 frames, lengths
uniform in [250, 500]), then the Bayesian HMM of configs 2 (ergodic
30-state HMM with learned transitions, the same data shape) and 3
(10-phone × 3-state recognizer on shared transcription graphs, B=128,
T=300), then config 1 (the full-covariance Bayesian GMM, K=64 over all
256,000 frames of the bench data), the recognizer with
full-covariance GMM emissions (2 components per state), then config 5
(the structured VAE: a SequenceVAE with tanh MLPs of 2 × 128 over a
phone-loop latent prior of 10 units × 3 states, dz = 16, on the first
256 × 250 frames of the bench data), then the subspace-HMM (one outer
iteration on config 4's loop and data: phone-loop E-step with
materialised posteriors, per-unit statistics, 200 gradient steps of a
GSM with an 8-dim embedding and learned transitions, moment-matched
write-back; and the H-SHMM gradient step at bench config 6's shape, 3
languages × 50 units), then (phase 18) the dense kernels at sizes whose
operands no block's shared memory holds, with random data and weights
from fixed seeds, then (phase 19) the AUD recipe through the port's CLI
on the recipe's own synthetic data and configurations, then (phases 20
and 21) the supervised recipe, map-reduce VB and the subspace-HMM recipe
through the same CLI, then (phase 22) PPCA and PLDA at bench configs 7
and 8, mean-field coordinate VB through the kernels and a GMM over each
further covariance type, then (phase 23) data-parallel VB-EM, ``hmm
train`` across ranks and sequence-parallel inference over a
world-size-1 NCCL process group and learned transitions on
per-utterance graphs, in twenty-three phases, each printing one line
(phase 22 two):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the hand-written CUDA kernels from the sources in
   ``beer_tpu_torch/csrc`` and loads them;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it (plus two zero-length rows); K1,
   K2, K11 and K3 alone (profiler device time of the kernel, K2's and
   K11's with their batch sum) and wrapped, with their launch geometry,
   K2 beside the unfused route (K11 + γᵀ·stats, TF32 off), held to the
   same tolerances; K3's mismatches against its plain version (choices,
   exit indices, α_last) are counted; K1, K3 and K11 called twice must
   agree bitwise;
4. slice: 5 VB-EM steps and a unit decode through the kernels, with the
   launch counters read around that run; the ELBO must be finite and
   non-decreasing and match the plain route's; a small problem is held
   against the float64 general path on the CPU;
5. times: CUDA-event medians of each kernel, one vb_step and one decode,
   kernel route beside plain route;
6. hmm kernels: K5–K7 (dense transitions) against their plain versions
   at the config-2 and config-3 shapes (plus two zero-length rows, and
   per-row final vectors with padding states), with CUDA-event medians,
   K5, K6 and K7 also alone (profiler device time); K7 called twice must
   agree bitwise;
7. hmm slice: per config, 5 VB-EM steps, a decode, the posteriors and
   the ξ counts through the kernels with the launch counters read
   around that run, the same on the plain route; the ELBO must be
   finite and non-decreasing and within 1e-4 per frame of the plain
   route, decode paths equal, posteriors within 1e-4 of the plain
   route's and summing to 1, ξ counts summing to the number of
   transitions; small problems are held against the float64 general
   path on the CPU;
8. hmm times: one vb_step, one decode and one posteriors call per
   config, kernel route beside plain route;
9. gmm kernels: K8–K10 (full covariance) against their plain versions
   at the config-1 shape (a ragged last tile and a masked stretch of
   frames) and K9/K10 at the recognizer's, with CUDA-event medians of
   each kernel, its plain version and a yardstick matmul on
   materialised statistics;
10. gmm slice: config 1, 5 VB-EM steps and the posteriors through the
   kernels with the launch counters read around them; a 10-step
   trajectory on clustered data at production magnitudes (D=39, K=64)
   against the plain route; the full-covariance recognizer (5 steps,
   decode, posteriors, ξ counts); small problems of both against the
   float64 path on the CPU;
11. gmm times: one vb_step and one posteriors call for config 1, one
   vb_step and one decode for the recognizer, kernel route beside plain
   route, and config 1's E-step frames/s;
12. svae kernels: K1 and K11 (the γ-emitting banded backward) against
   their plain versions at the config-5 shape plus two zero-length rows,
   and K3 on the latent decode's operands, each alone and wrapped with
   its launch geometry;
13. svae slice: 5 hybrid steps of config 5 (Adam on the nnets, the
   conjugate update of the phone loop) through K1 and K11 with the
   launch counters read around them (K1 5, K11 5, K2 0), then the
   latent decode (K3 + K4); the same steps on the plain route with the
   same noise: ELBO within 1e-4 per frame, every nnet gradient of the
   first step within rel 1e-4 (each step's gap is printed); the share of
   frames whose γ underflows (Σγ < 0.5) before and after the steps; an
   HMM-prior SequenceVAE (ergodic, 30 states, K5 + K7) and the
   frame-level VAE over a full-covariance GMM prior (K9, K10) the same
   way; small problems of each against the float64 plain route on the
   CPU;
14. svae times: one hybrid step of each of the three, kernel route beside
   plain route, config 5's frames/s, and a ``torch.profiler`` trace of
   one config-5 step: device time by kernel, the launch count and the
   device's busy share of the step's wall time (under the profiler).

15. general kernels: K12 ``scaled_pass`` (dense forward, banded
   forward, dense reverse) and K13 ``smoothing_pass`` (dense, banded)
   against their plain versions at config 4's shape plus two zero-length
   rows, all also at S = 450 (150 units × 3; the dense ones there read
   their matrix from device memory) and against each other, at S = 300
   (100 units: dense global, banded on the block chain) and at S = 30
   (why ``PhoneLoop.smooth`` always takes the banded pair), each with the
   launch geometry its wrapper took; K14 (K5 writing the row-max shifts)
   and K15 (K7 with ξ restricted to a block) at config 2's and config 4's
   shapes; CUDA-event medians of every instance and its plain version,
   K12, K13 and K15 also alone (profiler device time);
16. gsm slice: one subspace-HMM outer iteration at config 4's full shape:
   2 VB steps, ``accumulate_unit_stats`` with transitions through K12 +
   K13 (launch counters read around it: K12 1, K13 1, K1 and K2 0)
   against the plain route, 200 Adam steps of the GSM ELBO through
   ``make_gsm_train_scan``'s CUDA graph (it must rise), held against the
   eager loop on the same noise (bitwise where two eager runs are, else
   every step's ELBO within 1e-5 and the parameters within 1e-4
   relative; the graph drawing its own noise from a registered generator
   is compared with the eager loop, printed), the moment-matched
   write-back (the loop's E[T] must equal the
   Monte-Carlo moments), one more VB step and a decode, and the launch
   counts are read there; after that, off the path, the log-domain
   ``forward_backward`` (K12 forward + reverse) against
   ``forward_backward_probs``; K14 + K15 through ``forward_llh`` /
   ``phone_loop_estep`` against the general path; small problems against
   the float64 general path on the CPU; 50 H-SHMM gradient steps at
   bench config 6's shape through the graph (finite and rising), held
   against the eager loop as the GSM's;
17. gsm times: ``PhoneLoop.smooth`` (banded instances), the same work
   through the dense ones and on the plain route, ``accumulate_unit_stats``, the GSM
   and the H-SHMM gradient step eager and through the CUDA graph
   (ms/step, steps/s, in turns: eager, graph, graph, eager), the
   write-back, two outer iterations through
   the scan (the first captures the graph), and ``torch.profiler`` traces
   of the statistics bridge, of one eager step and of 50 graph steps
   (device time, launches, busy share);
18. large dense: every dense kernel (K5 on statistics and on llh, K6,
   K7, K14, K15, K12 dense forward and reverse, K13 dense) against its
   plain version on an ergodic HMM at S = 150 and S = 300 (B = 64, T =
   200), each timed and named by the placement its wrapper took (at 300
   all read their operands from device memory; K7 and K15 also alone);
   then a VB step, the
   posteriors and the ξ counts of that HMM at S = 300 and of a shared
   60-phone × 3-state transcription chain (S = 180) through the kernels,
   with the launch counters read around them, against the plain route;
   then K1, K2 and K11 against their plain versions on phone loops of
   100 units (S = 300, above the 95 that K2 first took) and 250 units (S
   = 750: K1 and K11 in their global placement too; K1 and K11 also
   alone), and two VB steps of
   the 100-unit loop through K1 + K2 against the plain route (ELBOs
   within 1e-4/frame; the second reads the update K2's statistics
   made), their launches read around them; last, K3 on config 3's
   recognizer decode (S = 18) and on a 3,200-unit loop's decode (S =
   9,600, near the largest S its per-frame kernel took), alone and
   wrapped, its mismatches counted;
19. cli: ``recipes/aud/run.sh``'s five verbs through
   ``beer_tpu_torch.cli.main.main`` in this process, with no
   ``--device`` flag: ``recipes/aud/local/make_synthetic_data.py`` (512
   training and 64 held-out utterances) into a temporary directory,
   ``dataset create`` and ``features extract`` (``conf/features.yml``:
   fbank, 26 filters and deltas, D = 78) for both splits, ``hmm
   mkphoneloop`` (``conf/hmm.yml``: 40 units × 3 states, S = 120),
   ``hmm train --epochs 3`` then ``--epochs 5`` (resumed), the same
   training streamed (``--batch-size 128 --buckets 4
   --accumulate-batches``, 2 epochs, through ``.bar`` and
   ``BatchLoader``), ``hmm decode --per-frame`` on the held-out split;
   the launch counters read around the trainings (K1, K2) and the decode
   (K3, K4) must be above 0; the ELBO per frame of ``train/log`` must be
   finite, non-decreasing and within 1e-4 of 5 steps of the plain twin
   of ``init.mdl`` on the same padded data; the streamed model within
   2e-4 of each array's largest entry of the full-batch one at epoch 2;
   the decoded labels equal to the plain route's on every frame; the
   card's features within 1e-3 of the CPU's; the native archive reader;
   one line of each verb's host-clock seconds and train frames/s;
20. supervised: ``recipes/supervised/run.sh``'s verbs in this process
   with no ``--device``: ``recipes/aud/local/make_synthetic_data.py
   --name sup --write-trans`` (512 training and 64 held-out utterances;
   the recipe's default is 40), ``dataset create`` and ``features
   extract`` (``recipes/aud/conf/features.yml``: D = 78) for both splits
   into ``.bar`` archives, as the recipe writes them,
   ``hmm mkphones`` (``conf/phones.yml``: 8 phones × 3 states × 2
   diagonal components), ``hmm train --transcriptions --epochs 3`` then
   ``--epochs 5`` resumed (the recipe trains 20), ``hmm decode
   --phone-lm --lm-transcriptions`` of both splits (collapsed, as the
   recipe, and per frame on the card and with ``--device cpu``), ``hmm
   align`` of the training split, ``local/score_per.py``'s PER (printed,
   not gated); the launch counters read around the training (K5, K7)
   and the alignment (K3, K4) must be above 0; the ELBO per frame finite,
   non-decreasing and within 1e-4 of 5 plain-route steps of
   ``emissions.mdl`` on the same padded data; the alignment equal to the
   plain route's and the card's per-frame decode equal to the CPU's on
   every frame (mismatches counted and printed); ROADMAP §C.1's share of
   frames whose γ sums below 0.5, under ``emissions.mdl`` and after
   epoch 5, on both routes; one line of each verb's seconds, train
   frames/s and the dense (max, +) Viterbi's share of the phone-LM
   decode (plain torch, timed around ``semiring_scan.viterbi``);
21. map-reduce and subspace-HMM: ``hmm accumulate --shard i/4`` (i = 1–4)
   in this process and then two concurrent ``python -m
   beer_tpu_torch.cli hmm accumulate --shard i/2`` processes on the
   card, each set reduced by ``hmm update``, on phase 19's ``init.mdl``
   and features: every array within 2e-4 of its largest entry of one
   full-batch ``vb_step`` and the reduced ELBO within 1e-5 a frame, K1
   and K2 read around the in-process shards; then
   ``recipes/shmm/run.sh``'s verbs: ``local/make_multilingual_data.py``
   at its defaults, ``dataset create`` and ``features extract``
   (``conf/features.yml``) for A, B, C and C_eval, ``hmm mkphoneloop``
   (``conf/hmm.yml``: 20 units × 3 states) and ``hmm train --epochs 5``
   per language (the recipe trains 20 and 30), ``shmm train`` on C with
   ``--extra-lang`` A and B, ``--embed-dim 8 --lang-dim 2
   --learn-transitions --loop-epochs 3 --outer-iters 2 --inner-iters
   200`` (the recipe runs 6 × 600), ``hmm decode --per-frame`` of C's
   held-out split and ``local/score.py``'s NMI (printed, not gated); K1,
   K2, K12 and K13 read around ``shmm train`` must be above 0, its inner
   loops must run through ``make_gsm_train_scan`` (one run an outer
   iteration, no eager loop); every GSM
   ELBO finite, the last above the first, ``final_A.mdl``,
   ``final_B.mdl`` and ``gsm.mdl`` written, the GSM an H-SHMM of 60 units
   and 3 languages, the transitions written back; one line of each
   verb's seconds, the outer iteration's seconds and GSM steps/s;
22. subspace: config 7 (PPCA, N = 262,144, D = 256, Q = 64, bench.py's
   data recipe) and config 8 (PLDA, 512 classes × 64 embeddings, D = 256,
   Q = 64, its labels): 10 ``vb_step``s then 10 ``vb_step_coordinate``
   steps in float32 and one E-step after them, beside a float64 model
   run on its own from the same start and beside the same step of a
   float64 copy of the model as it stood (every ELBO within 1e-4 a frame
   of both), every ELBO finite and non-decreasing to 1e-5 a frame; PLDA's ``infer``
   twice, bitwise equal, and ``llr_score`` on 1,000 same-class and 1,000
   different-class trials (same-class scores higher on average, over 90 %
   of trials on the right side of the median); CUDA-event medians of one
   joint and one coordinate step, frames/s, a ``torch.profiler`` trace of
   one joint step (device ms, launches, busy share) and its least time;
   then 3 ``vb_step_coordinate`` steps on config 4's loop (K1 + K2) and
   config 2's HMM (K5 + K6) with the launch counters read around them (2
   E-steps a step, each kernel once an E-step), ELBOs within 1e-4 a
   frame of the plain route's; and 5 ``vb_step``s of a 64-component GMM
   over config 1's 256,000 frames for each of the isotropic and tied
   ("shared_*") covariance types, non-decreasing; the card's name and
   power limit on each line;
23. parallel: over a world-size-1 NCCL process group (a ``FileStore`` in
   the temporary directory; a failed set-up fails the phase, there is no
   gloo fallback): ``parallel.make_vb_train_step`` on config 4 at full
   width, 5 steps, every ELBO within 1e-6 a frame of ``vb_step`` from
   the same start and the model within 2e-4 of each array's largest
   entry, K1 and K2 read once a step around them;
   ``make_vb_minibatch_step`` and ``make_vb_estep`` (one update) over 4
   minibatches of config 4 against their single-device twins (and the
   streamed ELBO against the full batch's); ``make_vb_estep`` on config
   2 (K5 + K6 once); ``make_supervised_vb_train_step`` on config 3, 3
   steps on the shared graphs (K5 + K7) and on ``shared=False``;
   ``hmm train`` through its data-parallel branch on phase 19's data
   against ``--single-device`` (ELBO 1e-5 a frame, arrays 2e-4);
   ``seq_parallel.make_sharded_forward_backward`` in float64 at the
   bench shape of ``tests/test_seq_parallel.py`` (a 50 × 3 phone loop,
   B = 8, T = 200, its lengths) against the unsharded general path (log
   Z rtol 1e-8, posteriors rtol 1e-6 / atol 1e-9); then 3 ``vb_step``s
   of config 3's recognizer on per-utterance graphs with learned
   transitions in float32 beside a float64 twin from the
   same start (printed; ROADMAP §C.1 moves it) and beside the same runs
   on the CPU (float32 within 1e-4 a frame, float64 rtol 1e-9); one line
   with the CUDA-event medians of the data-parallel
   and the single-device config-4 step and the card's name and power
   limit.

K8–K10 are timed twice in phase 9: ``ms`` is the kernel alone (the bare
foreign call on operands packed and a launch geometry computed in
advance), ``wrapper_ms`` the whole wrapper call.

Then one JSON line describing the kernels (each with its least time on
the card, ``bound_ms``: the larger of its bytes over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, counting the valid frames of this
run's inputs), and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; without a CUDA device it exits non-zero before
printing a result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

import beer_tpu_torch as bt
from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.ops import semiring_scan as tss
from beer_tpu_torch.ops import stats_kernels as sk

B, T, D = 512, 500, 39
N_UNITS, STATES_PER_UNIT = 50, 3
HMM_S = 30                                  # config 2 (bench.py:295)
REC_B, REC_T, REC_PHONES, REC_SPP = 128, 300, 10, 3   # config 3 (bench.py:348-349)
REC_NCOMP = 2                               # components per state (examples/recognizer_demo.py:16)
GMM_K = 64                                  # config 1 (bench.py:222)
SVAE_B, SVAE_T, SVAE_DZ, SVAE_H = 256, 250, 16, 128   # config 5 (bench.py:416-418)
SVAE_UNITS, SVAE_SPU = 10, 3
GVAE_N, GVAE_D, GVAE_DZ, GVAE_K, GVAE_H = 512, 16, 2, 4, 64   # examples/svae_demo.py
GSM_EMBED, GSM_LANG_DIM, GSM_LANGS, GSM_NSAMPLES = 8, 2, 3, 4   # config 6 (bench.py:679-680)
GSM_STEPS, GSM_LR, GSM_WRITEBACK_SAMPLES = 200, 5e-2, 64      # bench.py:724
BIG_UNITS = 150                             # a large phone loop: S = 450, banded instances only
SEED = 0
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM (NVIDIA data sheet)
F32_FLOPS = 67e12                           # float32 outside the tensor cores
N_STEPS = 5
REPS = 5
KERNEL_REPS = 20                            # CUDA-event runs of a kernel timed alone

# kernel → the Pallas TPU kernel body it replaces
REPLACES = {
    "forward_llh_banded": "beer_tpu/ops/pallas_scan.py:1640",
    "estep_acc_banded": "beer_tpu/ops/pallas_scan.py:2083",
    "viterbi_fwd_banded": "beer_tpu/ops/pallas_scan.py:2596",
    "viterbi_backtrace_banded": "beer_tpu/ops/pallas_scan.py:2707",
    "forward_llh_dense": "beer_tpu/ops/pallas_scan.py:1640",
    "estep_acc_dense": "beer_tpu/ops/pallas_scan.py:2083",
    "estep_gamma_dense": "beer_tpu/ops/pallas_scan.py:1844",
    "gmm_estep_full": "beer_tpu/ops/stats_kernels.py:295",
    "ellh_full": "beer_tpu/ops/stats_kernels.py:62",
    "accumulate_full": "beer_tpu/ops/stats_kernels.py:119",
    "estep_gamma_banded": "beer_tpu/ops/pallas_scan.py:1844",
    "scaled_pass": "beer_tpu/ops/pallas_scan.py:329",    # the rows' instance: banded, PhoneLoop.smooth's
    "smoothing_pass": "beer_tpu/ops/pallas_scan.py:384",
    "forward_llh_shifts_dense": "beer_tpu/ops/pallas_scan.py:845",
    "estep_gamma_dense_restricted": "beer_tpu/ops/pallas_scan.py:2407",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def make_data(b, t, d, seed=SEED):
    """The bench's data: N(0, 1) frames, lengths uniform in [t/2, t]."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = rng.integers(t // 2, t + 1, size=b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return data, mask


def config4(device, n_units=N_UNITS, spu=STATES_PER_UNIT, dim=D, dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(1)
    nset = bt.NormalSet.create(torch.zeros(dim, dtype=dtype, device=device),
                               torch.ones(dim, dtype=dtype, device=device),
                               size=n_units * spu, noise_std=0.5, generator=gen)
    return bt.PhoneLoop.create(n_units, spu, nset)


def cuda_ms(fn, reps=REPS):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, name, reps=REPS):
    """Mean device time of one launch of the kernel whose name contains
    ``name``, which ``fn`` launches once (``torch.profiler`` over ``reps``
    calls after one warm-up, divided by the launches it recorded): a
    kernel's time without its wrapper's host work.  A trace can miss a
    kernel (one run's phase 6 recorded no launch of K5), so a trace
    without it is taken again, up to three times, and then the call is
    timed by CUDA events instead, wrapper included (said on stderr)."""
    return _traced_ms(fn, (name,), reps)


def entry_ms(fn, names, reps=KERNEL_REPS):
    """Device ms a call of ``fn`` spends in the kernels whose names contain
    one of ``names``, each launched once a call (``torch.profiler`` over
    ``reps`` calls after one warm-up; each kernel's mean over the launches
    the trace recorded): a C entry point's kernels (a scan kernel and its
    batch sum) without the wrapper's host work and tensor preparation.
    A trace can miss launches (one run's phase 12 recorded only K11's
    batch sum), so the mean is taken over the recorded ones, a trace
    without the first of ``names`` (the scan kernel) is taken again, up
    to three times, and then the call is timed by CUDA events."""
    return _traced_ms(fn, names, reps)


def _traced_ms(fn, names, reps):
    """The sum over ``names`` of each kernel's mean device ms a launch, from
    the first of three traces that holds device time of ``names[0]``; the
    CUDA-event time of a call where none does."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages() if any(n in e.key for n in names) and e.count > 0]
        if any(names[0] in e.key and e.self_device_time_total > 0 for e in seen):
            return sum(e.self_device_time_total / e.count for e in seen) / 1e3
    print(f"chip_smoke: no device time of {names[0]} in three traces; timed by CUDA events, "
          "wrapper included", file=sys.stderr)
    return cuda_ms(fn, reps)


def unfused_estep(est):
    """K2's outputs through the unfused route, K11's γ reduced by one
    product, as ``PhoneLoop.accumulate``'s gradient route takes it."""
    gamma, gamma0, xi = cuda_scan.estep_gamma_banded(*est)
    g = gamma.flatten(0, 1)
    return g.T @ est[0].flatten(0, 1), g.sum(0), gamma0, xi


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def bound(n_bytes, flops):
    """The least time the card could take: bytes over the memory rate or
    float32 operations over the peak rate, whichever is larger.  Every
    kernel here computes in float32 FFMA, K8 included (its 3×TF32 form
    failed the probe of ``stats_variants.py probe``), so the float32 peak
    is the one its work runs at."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_peak="float32 FFMA 67 TFLOP/s; 3.35 TB/s")


def forward_dense_bound(lens, t_len, s, p_dim=0):
    """K5's least time on these inputs (:func:`bound`): each valid frame's
    statistics (``p_dim`` > 0) or llh read once, α̂ and the norms written
    for every frame, A (and W) and init/last once; FMAs of the ELLH (2·S·P
    a frame), the propagate (2·S²) and the rest (4·S)."""
    b, nv = lens.shape[0], float(lens.sum())
    width = p_dim or s
    return bound(4 * (nv * width + b * t_len * (s + 1) + s * (s + p_dim) + 2 * b * s),
                 nv * (2 * s * p_dim + 2 * s * s + 4 * s))


def k1_bound(lens, t_len, s, p_dim):
    """K1's least time on these inputs (:func:`bound`): each valid frame's
    statistics read once, α̂ and the norms written for every frame, W once;
    FMAs of the ELLH (2·S·P a frame) and the propagate and sums (8·S)."""
    nv = float(lens.sum())
    return bound(4 * (nv * p_dim + lens.shape[0] * t_len * (s + 1) + s * p_dim), nv * (2 * s * p_dim + 8 * s))


def k7_bound(lens, t_len, s, n_xi=None):
    """K7's (K15's with ``n_xi`` = n_r·n_c) least time on these inputs
    (:func:`bound`): each valid frame's llh and α̂ and its norm read once, γ
    written for every frame, A (and ξ) once; FMAs of the propagate (2·S²),
    of ξ (2·S², K15 2·n_r·n_c) and the rest (10·S) a valid frame."""
    b, nv = lens.shape[0], float(lens.sum())
    xi = s * s if n_xi is None else n_xi
    return bound(4 * (nv * (2 * s + 1) + b * t_len * s + s * s + xi + b * s), nv * (2 * s * s + 2 * xi + 10 * s))


def plain_twin(model):
    """A copy of ``model`` whose every kernel call takes the plain version."""
    twin = copy.deepcopy(model)
    for module in twin.modules():
        if hasattr(module, "plain_scan"):
            module.plain_scan = True
    return twin


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    t0 = time.time()
    path = cuda_scan.build()
    cuda_scan._library()
    print(f"phase 2 build: {time.time() - t0:.1f} s -> {path.name}")
    entry = ""
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "Used" in line or "spill" in line:
            print(f"  ptxas {entry}: {line.strip().removeprefix('ptxas info    : ')}")


def launch_geometry(kernel, dev, s, p, b, u=0, rc=()):
    """The launch the wrapper of a chunked kernel takes on ``dev`` at these
    sizes, as it picks it, with the card's own SM count: K1, K2, K3, K11,
    K12 banded (``scaled_pass``) and K13 banded (placement, utterances a
    block, frames a chunk), K4 (instance, utterances a block, frames a
    chunk), the dense instances of K12 and K13 (``scaled_pass_dense``,
    ``smoothing_pass_dense``: placement, utterances a block, slices), K6, K7
    and K15 (instance, frames a chunk, utterances a block)."""
    n_sm = cuda_scan.sm_count(dev.index)
    if kernel == "forward_llh_banded":
        return list(cuda_scan.forward_banded_geometry(s, p, b, n_sm))
    if kernel == "estep_acc_banded":
        return list(cuda_scan.acc_banded_geometry(s, p, u, b, n_sm))
    if kernel == "estep_gamma_banded":
        return list(cuda_scan.gamma_banded_geometry(s, p, u, b, n_sm))
    if kernel == "viterbi_fwd_banded":
        return list(cuda_scan.viterbi_banded_geometry(s, b, n_sm))
    if kernel == "viterbi_backtrace_banded":
        return list(cuda_scan.backtrace_banded_geometry(s, b, n_sm))
    if kernel == "smoothing_pass":
        return list(cuda_scan.smoothing_banded_geometry(s, b, n_sm))
    if kernel == "scaled_pass":
        return list(cuda_scan.scaled_banded_geometry(s, b, n_sm))
    if kernel in ("scaled_pass_dense", "smoothing_pass_dense"):
        return list(cuda_scan.dense_grouped_geometry(kernel.removesuffix("_dense"), s, b, n_sm))
    if kernel == "estep_acc_dense":
        instance, chunk = cuda_scan.backward_instance(s, p)
        return [instance, chunk, cuda_scan.backward_utterances(s, p, b, n_sm) if instance == "warp" else 1]
    instance, chunk = cuda_scan.gamma_instance(s, *rc)
    return [instance, chunk, cuda_scan.gamma_utterances(s, b, n_sm, *rc) if instance == "warp" else 1]


def with_empty_rows(data, mask):
    """The bench's data with two zero-length rows appended."""
    t = data.shape[1]
    return (np.concatenate([data, np.zeros((2, t, data.shape[2]), np.float32)]),
            np.concatenate([mask, np.zeros((2, t), np.float32)]))


def banded_operands(dev):
    """Config 4's kernel operands (plus two zero-length rows): the loop,
    its statistics and scan operands, K1's arguments and the mask."""
    data, mask = with_empty_rows(*make_data(B, T, D))
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    loop = config4(dev)
    stats = loop.sufficient_statistics(x).contiguous()
    ops = loop.scan_operands(stats, m)
    fwd = (stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["init"])
    return loop, stats, ops, fwd, m


def banded_estep_args(stats, ops, alpha, norms):
    """K2's (and K11's) arguments after K1's ``alpha`` and ``norms``."""
    return (stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["final"], alpha, norms,
            ops["ends"], ops["starts"])


def k11_row(est, reps=REPS):
    """K11 against its plain version on ``est`` (γ and γ₀ abs 1e-5, ξ rel
    1e-4, γ and γ₀ 0 on empty rows, two calls bitwise), alone (profiler
    device time of its entry point's kernels) and wrapped, with its launch
    geometry and bound; returns (row, errors)."""
    stats, lens = est[0], est[1]
    b, t_len, p_dim = stats.shape
    s, n_u = est[2].shape[0], est[8].shape[0]
    got, want = cuda_scan.estep_gamma_banded(*est), cuda_scan.estep_gamma_banded_plain(*est)
    errs = dict(gamma=float((got[0] - want[0]).abs().max()), gamma0=float((got[1] - want[1]).abs().max()),
                xi=rel(got[2], want[2]))
    check(errs["gamma"] <= 1e-5 and errs["gamma0"] <= 1e-5 and errs["xi"] <= 1e-4,
          f"estep_gamma_banded at S={s}, U={n_u}: {errs}")
    empty = lens == 0
    check(not bool(got[0][empty].any()) and not bool(got[1][empty].any()),
          "estep_gamma_banded: empty rows must give gamma 0")
    check(all(torch.equal(x, y) for x, y in zip(got, cuda_scan.estep_gamma_banded(*est))),
          "estep_gamma_banded: two calls must agree bitwise")
    del got, want
    nv = float(lens.sum())
    row = dict(max_abs_err=errs["gamma"],
               geometry=launch_geometry("estep_gamma_banded", stats.device, s, p_dim, b, n_u),
               ms=entry_ms(lambda: cuda_scan.estep_gamma_banded(*est), ("estep_acc", "sum_rows")),
               wrapper_ms=cuda_ms(lambda: cuda_scan.estep_gamma_banded(*est)),
               plain_ms=cuda_ms(lambda: cuda_scan.estep_gamma_banded_plain(*est), reps=reps),
               **bound(4 * (nv * (p_dim + s + 1) + b * t_len * s + s * (p_dim + 6) + b * s + n_u * n_u),
                       nv * (2 * s * p_dim + 12 * s + 2 * n_u * n_u)))
    return row, errs


def decode_args(decode):
    """The arguments that ``decode()`` (a model's decode on the card) gives
    K3's and K4's wrappers, (K3's, K4's): the main path's own operands."""
    seen, wrappers = {}, (cuda_scan.viterbi_fwd_banded, cuda_scan.viterbi_backtrace_banded)

    def spy(name, wrapper):
        def call(*args):
            seen.setdefault(name, []).append(args)
            return wrapper(*args)
        return call

    cuda_scan.viterbi_fwd_banded = spy("k3", wrappers[0])
    cuda_scan.viterbi_backtrace_banded = spy("k4", wrappers[1])
    try:
        decode()
    finally:
        cuda_scan.viterbi_fwd_banded, cuda_scan.viterbi_backtrace_banded = wrappers
    counts = {k: len(v) for k, v in seen.items()}
    check(counts == {"k3": 1, "k4": 1}, f"the decode called K3 / K4 {counts} times")
    return seen["k3"][0], seen["k4"][0]


def viterbi_args(decode):
    """The arguments that ``decode()`` gives K3's wrapper."""
    return decode_args(decode)[0]


def k3_row(vit, log_final, reps=REPS):
    """K3 against its plain version on ``vit``: the mismatches of its
    choices, exit indices and α_last (0 expected: (max, +) rounds once, in
    the add, as the plain version does), the best scores (rel 1e-6) and
    the backtrace's paths on both outputs (>= 99.9 % of valid frames), two
    calls bitwise; alone (profiler device time) and wrapped, with its
    launch geometry and bound; returns (row, mismatches)."""
    llh, lens = vit[0], vit[1]
    b, t_len, s = llh.shape
    got, want = cuda_scan.viterbi_fwd_banded(*vit), cuda_scan.viterbi_fwd_banded_plain(*vit)
    full = lens > 0
    best = [(o[2] + log_final).max(-1).values[full] for o in (got, want)]
    e3 = rel(best[0], best[1])
    check(e3 <= 1e-6, f"viterbi best scores rel {e3} at S={s}")
    paths = [cuda_scan.viterbi_backtrace_banded_plain(*o, log_final)[0] for o in (got, want)]
    valid = torch.arange(t_len, device=llh.device)[None] < lens[:, None]
    agree = float((paths[0] == paths[1])[valid].float().mean()) if bool(valid.any()) else 1.0
    check(agree >= 0.999, f"viterbi paths agree on {agree} of valid frames at S={s}")
    check(all(torch.equal(x, y) for x, y in zip(got, cuda_scan.viterbi_fwd_banded(*vit))),
          "viterbi_fwd_banded: two calls must agree bitwise")
    mismatch = dict(choices=int((got[0] != want[0]).sum()), exarg=int((got[1] != want[1]).sum()),
                    alpha_last=int((got[2] != want[2]).sum()))
    del got, want, paths
    nv = float(lens.sum())
    row = dict(max_abs_err=float((best[0] - best[1]).abs().max()) if bool(full.any()) else 0.0,
               mismatches=mismatch, path_agree=agree, states=s,
               geometry=launch_geometry("viterbi_fwd_banded", llh.device, s, 0, b),
               ms=entry_ms(lambda: cuda_scan.viterbi_fwd_banded(*vit), ("viterbi_fwd",)),
               wrapper_ms=cuda_ms(lambda: cuda_scan.viterbi_fwd_banded(*vit)),
               plain_ms=cuda_ms(lambda: cuda_scan.viterbi_fwd_banded_plain(*vit), reps=reps),
               **bound(4 * nv * s + b * t_len * (s + 4) + 4 * b * s, nv * 6 * s))
    return row, mismatch


def k4_row(back, lens, reps=REPS):
    """K4 against its plain version on ``back`` (K3's outputs and
    log_final, ``lens`` the decode's lengths): the mismatches of its paths
    and scores (0 expected: the backtrace does the plain version's float
    adds and integer steps), two calls bitwise; alone (profiler device time)
    and wrapped, with its launch geometry and bound; returns (row,
    mismatches)."""
    choices = back[0]
    b, t_len, s = choices.shape
    got, want = cuda_scan.viterbi_backtrace_banded(*back), cuda_scan.viterbi_backtrace_banded_plain(*back)
    mismatch = dict(paths=int((got[0] != want[0]).sum()), scores=int((got[1] != want[1]).sum()))
    check(mismatch == {"paths": 0, "scores": 0}, f"viterbi_backtrace_banded at S={s}: mismatches {mismatch}")
    check(all(torch.equal(x, y) for x, y in zip(got, cuda_scan.viterbi_backtrace_banded(*back))),
          "viterbi_backtrace_banded: two calls must agree bitwise")
    del got, want
    nv = float(lens.sum())
    row = dict(max_abs_err=0.0, mismatches=mismatch, states=s,
               geometry=launch_geometry("viterbi_backtrace_banded", choices.device, s, 0, b),
               ms=entry_ms(lambda: cuda_scan.viterbi_backtrace_banded(*back), ("viterbi_backtrace",)),
               wrapper_ms=cuda_ms(lambda: cuda_scan.viterbi_backtrace_banded(*back)),
               plain_ms=cuda_ms(lambda: cuda_scan.viterbi_backtrace_banded_plain(*back), reps=reps),
               **bound(5 * nv + 4 * b * t_len + 4 * b * s, 2 * nv))
    return row, mismatch


def phase_kernels(dev):
    """Each kernel against its plain version at the main path's shapes."""
    loop, stats, ops, fwd, _ = banded_operands(dev)
    full = ops["lens"] > 0
    tiny = torch.finfo(torch.float32).tiny
    out = {}

    k1 = cuda_scan.forward_llh_banded(*fwd)
    p1 = cuda_scan.forward_llh_banded_plain(*fwd)
    logz = [o[3] + torch.log((o[2] * ops["final"]).sum(-1).clamp_min(tiny)) for o in (k1, p1)]
    e_logz = rel(logz[0][full], logz[1][full])
    check(e_logz <= 1e-5, f"forward log Z rel {e_logz}")
    check(not bool(k1[3][~full].any()), "forward: empty rows must give logz_base 0")
    e_alpha = max(float((k1[i] - p1[i]).abs().max()) for i in (0, 2))
    check(e_alpha <= 1e-5 and rel(k1[1], p1[1]) <= 1e-5, f"forward alpha / last abs {e_alpha}, norms")
    check(all(torch.equal(x, y) for x, y in zip(k1, cuda_scan.forward_llh_banded(*fwd))),
          "forward: two calls must agree bitwise")
    b, t_len, p_dim = stats.shape
    s = ops["w"].shape[0]
    n_u = ops["ends"].shape[0]
    nv = float(ops["lens"].sum())             # valid frames: the work the kernels do
    out["forward_llh_banded"] = dict(
        max_abs_err=float((logz[0][full] - logz[1][full]).abs().max()),
        geometry=launch_geometry("forward_llh_banded", dev, s, p_dim, b),
        ms=entry_ms(lambda: cuda_scan.forward_llh_banded(*fwd), ("forward_llh_chunked",)),
        wrapper_ms=cuda_ms(lambda: cuda_scan.forward_llh_banded(*fwd)),
        plain_ms=cuda_ms(lambda: cuda_scan.forward_llh_banded_plain(*fwd)),
        **k1_bound(ops["lens"], t_len, s, p_dim))

    est = banded_estep_args(stats, ops, k1[0], k1[1])
    k2 = cuda_scan.estep_acc_banded(*est)
    p2 = cuda_scan.estep_acc_banded_plain(*est)
    for name, i in (("acc2", 0), ("counts", 1), ("xi", 3)):
        e = rel(k2[i], p2[i])
        check(e <= 1e-4, f"estep {name} rel {e}")
    e_g0 = float((k2[2] - p2[2]).abs().max())
    check(e_g0 <= 1e-5, f"estep gamma0 abs {e_g0}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for the unfused route's product")
    u2 = unfused_estep(est)
    e_unfused = max(rel(u2[i], p2[i]) for i in (0, 1, 3))
    check(e_unfused <= 1e-4, f"unfused route rel {e_unfused}")
    out["estep_acc_banded"] = dict(
        max_abs_err=float((k2[0] - p2[0]).abs().max()),
        geometry=launch_geometry("estep_acc_banded", dev, s, p_dim, b, n_u),
        ms=entry_ms(lambda: cuda_scan.estep_acc_banded(*est), ("estep_acc", "sum_rows")),
        wrapper_ms=cuda_ms(lambda: cuda_scan.estep_acc_banded(*est)),
        unfused_ms=cuda_ms(lambda: unfused_estep(est)),
        plain_ms=cuda_ms(lambda: cuda_scan.estep_acc_banded_plain(*est)),
        **bound(4 * (nv * (p_dim + s + 1) + 2 * s * p_dim + b * s + n_u * n_u),
                nv * (4 * s * p_dim + 2 * n_u * n_u + 12 * s)))
    del k2, p2, u2
    k11_config4, e11 = k11_row(est)

    graph = ops["graph"]
    llh = loop.modelset.expected_log_likelihood(stats).contiguous()
    vit = (llh, ops["lens"], tss.log_bands(ops["bands"]).contiguous(),
           torch.clamp(graph.log_init, min=-1e30).contiguous())
    out["viterbi_fwd_banded"], m3 = k3_row(vit, graph.log_final)
    k3 = cuda_scan.viterbi_fwd_banded(*vit)

    back = (k3[0], k3[1], k3[2], graph.log_final.contiguous())
    out["viterbi_backtrace_banded"], m4 = k4_row(back, ops["lens"])
    torch.cuda.synchronize()
    k1r, k2r, k3r = out["forward_llh_banded"], out["estep_acc_banded"], out["viterbi_fwd_banded"]
    k4r = out["viterbi_backtrace_banded"]
    print("phase 3 kernels: " + "; ".join(
        f"{k} ok (max_abs_err {v['max_abs_err']:.3g})" for k, v in out.items())
        + f" | forward_llh_banded {tuple(k1r['geometry'])} alone {k1r['ms']:.3f} ms, wrapped "
          f"{k1r['wrapper_ms']:.3f} ms (bound {k1r['bound_ms']:.4f} by {k1r['bound_by']})"
        + f" | estep_acc_banded {tuple(k2r['geometry'])} alone {k2r['ms']:.3f} ms, wrapped "
          f"{k2r['wrapper_ms']:.3f} ms; unfused route (estep_gamma_banded + one product) "
          f"{k2r['unfused_ms']:.3f} ms, rel {e_unfused:.3g}"
        + f" | estep_gamma_banded {tuple(k11_config4['geometry'])} alone {k11_config4['ms']:.3f} ms, wrapped "
          f"{k11_config4['wrapper_ms']:.3f} ms (bound {k11_config4['bound_ms']:.4f}); "
          + json.dumps({k: float(f"{e:.3g}") for k, e in e11.items()})
        + f" | viterbi_fwd_banded {tuple(k3r['geometry'])} alone {k3r['ms']:.3f} ms, wrapped "
          f"{k3r['wrapper_ms']:.3f} ms (bound {k3r['bound_ms']:.4f}); mismatches {json.dumps(m3)}"
        + f" | viterbi_backtrace_banded {tuple(k4r['geometry'])} alone {k4r['ms']:.4f} ms, wrapped "
          f"{k4r['wrapper_ms']:.4f} ms (bound {k4r['bound_ms']:.4f}); mismatches {json.dumps(m4)}"
        + " | tol: log Z, norms rel 1e-5; alpha, last abs 1e-5; acc2/counts/xi rel 1e-4; gamma, gamma0 abs "
          "1e-5; K3's paths >= 99.9% of valid frames, scores rel 1e-6; K4's paths and scores equal; K1, K3, "
          "K4, K11 bitwise")
    return out, k11_config4


def run_steps(loop, x, m):
    elbos = []
    for _ in range(N_STEPS):
        elbo, loop = bt.vb_step(loop, x, mask=m)
        elbos.append(float(elbo))
    return np.array(elbos)


def reference_check(dev):
    """Kernel route (card, float32) against the general path (CPU, float64)."""
    data, mask = make_data(6, 40, 4, seed=3)
    mask[-1] = 0.0
    ref = config4("cpu", n_units=5, spu=3, dim=4, dtype=torch.float64)
    loop = copy.deepcopy(ref).to(device=dev, dtype=torch.float32)
    x64, m64 = torch.from_numpy(data).double(), torch.from_numpy(mask).double()
    stats64 = ref.sufficient_statistics(x64)
    lz_ref, cache = ref.smooth(stats64, m64)
    acc_ref = ref.accumulate(stats64, cache)
    x, m = x64.float().to(dev), m64.float().to(dev)
    stats = loop.sufficient_statistics(x)
    lz, cache = loop.infer(stats, m)
    acc = loop.accumulate(stats, cache)
    check(rel(lz.double().cpu(), lz_ref) <= 1e-5, "small problem: log Z vs float64")
    for key, sub in (("modelset", "means_precisions"), ("unit_prior", "sticks")):
        e = rel(acc[key][sub].double().cpu(), acc_ref[key][sub])
        check(e <= 1e-4, f"small problem: {key} statistics rel {e} vs float64")


def phase_slice(dev):
    data, mask = make_data(B, T, D)
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    frames = float(mask.sum())
    loop = config4(dev)
    plain = plain_twin(loop)

    cuda_scan.reset_launch_counts()
    elbos = run_steps(loop, x, m)
    units, scores = loop.decode_units(x, m)
    torch.cuda.synchronize()
    launches = {k: cuda_scan.KERNELS[k].launches for k in (
        "forward_llh_banded", "estep_acc_banded", "viterbi_fwd_banded", "viterbi_backtrace_banded")}
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    check(bool(np.isfinite(elbos).all()), f"ELBO not finite: {elbos}")
    drops = np.diff(elbos) / frames
    check(bool((drops >= -1e-6).all()), f"ELBO decreased: per-frame steps {drops}")
    elbos_plain = run_steps(plain, x, m)
    gap = float(np.abs(elbos - elbos_plain).max() / frames)
    check(gap <= 1e-4, f"kernel vs plain route ELBO gap {gap} per frame")

    check(units.shape == (B, T) and units.dtype == torch.int32, "decode shape")
    valid = m > 0
    check(bool(((units >= 0) & (units < N_UNITS))[valid].all()), "unit labels out of range")
    check(bool(torch.isfinite(scores).all()), "decode scores not finite")
    units_plain, _ = plain_twin(loop).decode_units(x, m)
    agree = float((units == units_plain)[valid].float().mean())
    check(agree >= 0.999, f"decode agrees with the plain route on {agree} of frames")
    reference_check(dev)
    print(f"phase 4 slice: B={B} T<={T} D={D} S={N_UNITS * STATES_PER_UNIT} frames={frames:.0f} "
          f"| ELBO/frame {', '.join(f'{e / frames:.6f}' for e in elbos)} "
          f"| plain-route gap {gap:.3g}/frame | decode agree {agree:.6f} "
          f"| launches {launches}")
    return launches, loop, x, m


def phase_times(loop, x, m):
    kern = copy.deepcopy(loop)
    plain = plain_twin(loop)
    times = {}
    for name, model in (("kernel", kern), ("plain", plain)):
        times[f"vb_step_{name}_ms"] = cuda_ms(lambda: bt.vb_step(model, x, mask=m))
        times[f"decode_{name}_ms"] = cuda_ms(lambda: model.decode_units(x, m))
    frames = float(m.sum())
    print("phase 5 times: " + json.dumps(
        {**{k: round(v, 3) for k, v in times.items()},
         "vb_step_kernel_frames_per_s": round(frames / times["vb_step_kernel_ms"] * 1e3),
         "decode_kernel_frames_per_s": round(frames / times["decode_kernel_ms"] * 1e3),
         "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2)}))


# ----------------------------------------------------------------------
# The Bayesian HMM: configs 2 and 3
# ----------------------------------------------------------------------
def config2(device, s=HMM_S, dim=D, dtype=torch.float32):
    """Ergodic HMM with Dirichlet-learned transitions (bench.py:307-312)."""
    gen = torch.Generator(device=device).manual_seed(3)
    nset = bt.NormalSet.create(torch.zeros(dim, dtype=dtype, device=device),
                               torch.ones(dim, dtype=dtype, device=device), size=s,
                               noise_std=0.5, generator=gen)
    return bt.HMM.create(bt.ergodic(s), nset, learn_transitions=True)


def config3_data(b=REC_B, t=REC_T, d=D, n_phones=REC_PHONES, seed=4):
    """The recognizer bench's data and 6-phone transcriptions (bench.py:361-364)."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(b, t, d)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    seqs = [list(rng.integers(n_phones, size=6)) for _ in range(b)]
    return data, mask, seqs


def config3(device, seqs, n_phones=REC_PHONES, spp=REC_SPP, dim=D, dtype=torch.float32,
            shared=True):
    """Supervised recognizer on transcription graphs (bench.py:365-370)."""
    gen = torch.Generator(device=device).manual_seed(4)
    graphs = bt.transcription_graphs(seqs, n_phones, spp, dtype=dtype, shared=shared,
                                     device=device)
    nset = bt.NormalSet.create(torch.zeros(dim, dtype=dtype, device=device),
                               torch.ones(dim, dtype=dtype, device=device),
                               size=n_phones * spp, noise_std=0.5, generator=gen)
    return bt.HMM.create(graphs, nset)


def hmm_operands(hmm, x, m):
    """The fused E-step's kernel operands of ``hmm`` on ``x``/``m``."""
    stats = hmm.sufficient_statistics(x)
    _, cache = hmm.infer(stats, m)
    return stats.contiguous(), cache


def dense_operands(dev):
    """Config 2's kernel operands (plus two zero-length rows, and per-row
    final vectors with padding states): the statistics, the HMM's cache,
    ``final`` and K5's arguments."""
    data, mask = with_empty_rows(*make_data(B, T, D))
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    hmm = config2(dev)
    stats, c = hmm_operands(hmm, x, m)
    final = c["final"].clone()
    final[: B // 4, -5:] = 0.0
    init = torch.exp(hmm.graph_log_init).expand_as(final).contiguous()
    return stats, c, final, (stats, c["lens"], c["trans"], init, c["w"], c["bias"])


def phase_hmm_kernels(dev):
    """K5–K7 against their plain versions at the config-2/3 shapes."""
    out = {}
    tiny = torch.finfo(torch.float32).tiny
    # config 2 (stats route): K5 with in-kernel ELLH, K6
    stats, c, final, fwd = dense_operands(dev)
    full = c["lens"] > 0
    k5 = cuda_scan.forward_llh_dense(*fwd)
    p5 = cuda_scan.forward_llh_dense_plain(*fwd)
    logz = [o[3] + torch.log((o[2] * final).sum(-1).clamp_min(tiny)) for o in (k5, p5)]
    e5 = rel(logz[0][full], logz[1][full])
    check(e5 <= 1e-5, f"dense forward log Z rel {e5}")
    check(float((k5[0] - p5[0]).abs().max()) <= 1e-5, "dense forward alpha")
    check(not bool(k5[3][~full].any()), "dense forward: empty rows must give logz_base 0")
    b, t_len, p_dim = stats.shape
    s = c["trans"].shape[0]
    nv = float(c["lens"].sum())
    out["forward_llh_dense"] = dict(
        max_abs_err=float((logz[0][full] - logz[1][full]).abs().max()),
        instance=cuda_scan.forward_instance(HMM_S, stats.shape[-1])[0],
        ms=device_ms(lambda: cuda_scan.forward_llh_dense(*fwd), "forward_llh"),
        wrapper_ms=cuda_ms(lambda: cuda_scan.forward_llh_dense(*fwd)),
        plain_ms=cuda_ms(lambda: cuda_scan.forward_llh_dense_plain(*fwd)),
        **forward_dense_bound(c["lens"], t_len, s, p_dim))
    est = (stats, c["lens"], c["w"], c["bias"], c["trans"], final, k5[0], k5[1])
    k6 = cuda_scan.estep_acc_dense(*est)
    p6 = cuda_scan.estep_acc_dense_plain(*est)
    for name, i in (("acc2", 0), ("counts", 1), ("xi", 3)):
        e = rel(k6[i], p6[i])
        check(e <= 1e-4, f"dense estep {name} rel {e}")
    check(float((k6[2] - p6[2]).abs().max()) <= 1e-5, "dense estep gamma0")
    out["estep_acc_dense"] = dict(
        max_abs_err=float((k6[0] - p6[0]).abs().max()),
        instance=launch_geometry("estep_acc_dense", dev, HMM_S, p_dim, est[0].shape[0]),
        ms=entry_ms(lambda: cuda_scan.estep_acc_dense(*est), ("estep_acc", "sum_rows")),
        wrapper_ms=cuda_ms(lambda: cuda_scan.estep_acc_dense(*est)),
        plain_ms=cuda_ms(lambda: cuda_scan.estep_acc_dense_plain(*est)),
        **bound(4 * (nv * (p_dim + s + 1) + s * (2 * s + 2 * p_dim + 1) + 2 * b * s),
                nv * (4 * s * p_dim + 4 * s * s + 10 * s)))
    # config 3 (llh route): K5 on the llh stream, K7; two extra utterances
    # with shorter transcriptions (padding states) and two zero-length rows
    data, mask, seqs = config3_data()
    rng = np.random.default_rng(5)
    seqs = seqs + [list(rng.integers(REC_PHONES, size=n)) for n in (4, 5, 6, 6)]
    data = np.concatenate([data, rng.normal(size=(4, REC_T, D)).astype(np.float32)])
    mask = np.concatenate([mask, (np.arange(REC_T)[None] < np.array([[200], [REC_T], [0], [0]]))
                           .astype(np.float32)])
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    rec = config3(dev, seqs)
    _, c = hmm_operands(rec, x, m)
    full = c["lens"] > 0
    check(bool((c["final"][-4:-2, -1] == 0).all()), "config 3: the short rows have no padding states")
    init = torch.exp(torch.clamp(rec.graph_log_init, min=-1e30)).expand_as(c["final"]).contiguous()
    fwd3 = (c["llh"], c["lens"], c["trans"], init)
    k5b = cuda_scan.forward_llh_dense(*fwd3)
    p5b = cuda_scan.forward_llh_dense_plain(*fwd3)
    logz = [o[3] + torch.log((o[2] * c["final"]).sum(-1).clamp_min(tiny)) for o in (k5b, p5b)]
    e5b = rel(logz[0][full], logz[1][full])
    check(e5b <= 1e-5, f"dense forward (llh stream) log Z rel {e5b}")
    gam = (c["llh"], c["lens"], c["trans"], c["final"], k5b[0], k5b[1])
    k7 = cuda_scan.estep_gamma_dense(*gam)
    p7 = cuda_scan.estep_gamma_dense_plain(*gam)
    e7 = float((k7[0] - p7[0]).abs().max())
    check(e7 <= 1e-5, f"dense gamma abs {e7}")
    check(rel(k7[1], p7[1]) <= 1e-4, "dense gamma xi")
    check(not bool(k7[0][~full].any()), "dense gamma: empty rows must give gamma 0")
    check(all(torch.equal(x, y) for x, y in zip(k7, cuda_scan.estep_gamma_dense(*gam))),
          "dense gamma: two calls must agree bitwise")
    b, t_len, s = c["llh"].shape
    out["estep_gamma_dense"] = dict(
        max_abs_err=e7,
        instance=launch_geometry("estep_gamma_dense", dev, s, 0, b),
        ms=entry_ms(lambda: cuda_scan.estep_gamma_dense(*gam), ("estep_acc", "sum_rows")),
        wrapper_ms=cuda_ms(lambda: cuda_scan.estep_gamma_dense(*gam)),
        plain_ms=cuda_ms(lambda: cuda_scan.estep_gamma_dense_plain(*gam)),
        **k7_bound(c["lens"], t_len, s))
    llh_fwd = dict(ms=device_ms(lambda: cuda_scan.forward_llh_dense(*fwd3), "forward_llh"),
                   wrapper_ms=cuda_ms(lambda: cuda_scan.forward_llh_dense(*fwd3)),
                   plain_ms=cuda_ms(lambda: cuda_scan.forward_llh_dense_plain(*fwd3)),
                   **forward_dense_bound(c["lens"], t_len, s))
    out["forward_llh_dense"]["config3"] = llh_fwd
    torch.cuda.synchronize()
    print("phase 6 hmm kernels: " + "; ".join(
        f"{k} ok (max_abs_err {v['max_abs_err']:.3g}, {v['ms']:.3f} ms vs plain "
        f"{v['plain_ms']:.3f} ms)" for k, v in out.items())
        + f" | forward_llh_dense ({out['forward_llh_dense']['instance']} instance) alone "
          f"{out['forward_llh_dense']['ms']:.3f} ms, wrapped {out['forward_llh_dense']['wrapper_ms']:.3f} ms"
        + f" | estep_acc_dense ({out['estep_acc_dense']['instance'][0]} instance) alone "
          f"{out['estep_acc_dense']['ms']:.3f} ms, wrapped {out['estep_acc_dense']['wrapper_ms']:.3f} ms"
        + f" | estep_gamma_dense (config 3, {tuple(out['estep_gamma_dense']['instance'])}) alone "
          f"{out['estep_gamma_dense']['ms']:.3f} ms, wrapped {out['estep_gamma_dense']['wrapper_ms']:.3f} ms"
        + f" | on the config-3 llh stream {llh_fwd['ms']:.3f} ms alone, "
          f"{llh_fwd['wrapper_ms']:.3f} ms wrapped vs plain {llh_fwd['plain_ms']:.3f} ms, log Z rel {e5b:.3g}"
        + " | tol: log Z rel 1e-5; alpha, gamma, gamma0 abs 1e-5; acc2/counts/xi rel 1e-4; K7 bitwise")
    return out


SMALL_SEQS = [[0, 1], [2], [1, 2, 0], [0], [2, 2], [1]]


def stat_leaves(tree):
    """The tensors of a nested statistics dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in stat_leaves(tree[key])]
    return [tree]


def hmm_reference_check(dev, cases=None):
    """Kernel routes (card, float32) against the general path (CPU,
    float64); ``cases`` (name, float64 CPU model, route) default to small
    problems of configs 2 and 3."""
    data, mask = make_data(6, 40, 4, seed=3)
    mask[-1] = 0.0
    x64, m64 = torch.from_numpy(data).double(), torch.from_numpy(mask).double()
    if cases is None:
        cases = (("config 2", config2("cpu", s=6, dim=4, dtype=torch.float64), "stats"),
                 ("config 3", config3("cpu", SMALL_SEQS, n_phones=3, spp=2, dim=4,
                                      dtype=torch.float64), "llh"))
    for name, ref, route in cases:
        stats64 = ref.sufficient_statistics(x64)
        log_trans = ref._effective_log_trans()
        fb = tss.forward_backward_probs(ref._state_llh(stats64), log_trans, ref.graph_log_init,
                                        ref.graph_log_final, m64)
        lz_ref = fb.log_z * (m64.sum(-1) > 0)
        acc_ref = ref.modelset.accumulate(stats64.reshape(-1, stats64.shape[-1]),
                                          ref._pdf_posteriors(fb.posteriors).reshape(-1, ref.n_pdfs))
        xi_ref = tss.expected_transition_counts_probs(fb, log_trans, m64)
        card = copy.deepcopy(ref).to(device=dev, dtype=torch.float32)
        x, m = x64.float().to(dev), m64.float().to(dev)
        stats = card.sufficient_statistics(x)
        lz, cache = card.infer(stats, m)
        acc = card.accumulate(stats, cache)
        check(cache["route"] == route, f"{name}: route")
        check(rel(lz.double().cpu(), lz_ref) <= 1e-5, f"small {name}: log Z vs float64")
        for got, want in zip(stat_leaves(acc["modelset"]), stat_leaves(acc_ref)):
            e = rel(got.double().cpu(), want)
            check(e <= 1e-4, f"small {name}: statistics rel {e} vs float64")
        e = rel(card.expected_transition_counts(cache).double().cpu(), xi_ref)
        check(e <= 1e-4, f"small {name}: transition counts rel {e} vs float64")


def hmm_run(model, x, m, frames, label):
    """5 VB-EM steps, a decode, ``HMM.posteriors`` and
    ``HMM.expected_transition_counts`` through the kernels (counters read
    around them), then the same on the plain route.  The posteriors sum
    to 1 on every valid frame, and the ξ counts to the number of
    frame-to-frame transitions, Σ_b (len_b − 1)."""
    plain = plain_twin(model)
    cuda_scan.reset_launch_counts()
    elbos = run_steps(model, x, m)
    paths, scores = model.decode(x, m)
    post = model.posteriors(x, m)
    xi = model.expected_transition_counts(model.infer(model.sufficient_statistics(x), m)[1])
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in cuda_scan.KERNELS.items() if v.launches}
    check(bool(np.isfinite(elbos).all()), f"{label}: ELBO not finite: {elbos}")
    drops = np.diff(elbos) / frames
    check(bool((drops >= -1e-6).all()), f"{label}: ELBO decreased: per-frame steps {drops}")
    elbos_plain = run_steps(plain, x, m)
    gap = float(np.abs(elbos - elbos_plain).max() / frames)
    check(gap <= 1e-4, f"{label}: kernel vs plain route ELBO gap {gap} per frame")
    valid = m > 0
    check(paths.shape == x.shape[:2] and paths.dtype == torch.int32, f"{label}: decode shape")
    check(bool(torch.isfinite(scores).all()), f"{label}: decode scores not finite")
    twin = plain_twin(model)
    paths_plain, _ = twin.decode(x, m)
    check(bool(torch.equal(paths[valid], paths_plain[valid])),
          f"{label}: decode paths differ from the plain route")
    e_post = float((post.sum(-1)[valid] - 1).abs().max())
    check(e_post <= 1e-4, f"{label}: posteriors sum to 1 within {e_post}")
    e_plain = float((post - twin.posteriors(x, m)).abs().max())
    check(e_plain <= 1e-4, f"{label}: posteriors differ from the plain route by {e_plain}")
    n_trans = float((m.sum(-1) - 1).clamp_min(0).sum())
    e_xi = abs(float(xi.sum(dtype=torch.float64)) - n_trans) / n_trans
    check(e_xi <= 1e-4, f"{label}: transition counts sum to {float(xi.sum())} of {n_trans}")
    return elbos, gap, launches, (e_post, e_plain, e_xi)


def phase_hmm_slice(dev):
    data, mask = make_data(B, T, D)
    x2, m2 = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    frames2 = float(mask.sum())
    hmm2 = config2(dev)
    elbos2, gap2, launches2, checks2 = hmm_run(hmm2, x2, m2, frames2, "config 2")
    need2 = ("forward_llh_dense", "estep_acc_dense", "estep_gamma_dense")
    check(all(launches2.get(k, 0) > 0 for k in need2),
          f"config 2: a kernel was not launched: {launches2}")
    data, mask, seqs = config3_data()
    x3, m3 = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    frames3 = float(mask.sum())
    hmm3 = config3(dev, seqs)
    elbos3, gap3, launches3, checks3 = hmm_run(hmm3, x3, m3, frames3, "config 3")
    need3 = ("forward_llh_dense", "estep_gamma_dense", "viterbi_fwd_banded",
             "viterbi_backtrace_banded")
    check(all(launches3.get(k, 0) > 0 for k in need3),
          f"config 3: a kernel was not launched: {launches3}")
    hmm_reference_check(dev)
    launches = {k: launches2.get(k, 0) + launches3.get(k, 0) for k in cuda_scan.KERNELS}
    print(f"phase 7 hmm slice: config 2 B={B} T<={T} D={D} S={HMM_S} frames={frames2:.0f} "
          f"| ELBO/frame {', '.join(f'{e / frames2:.6f}' for e in elbos2)} "
          f"| plain-route gap {gap2:.3g}/frame | launches {launches2} || config 3 B={REC_B} "
          f"T={REC_T} S={hmm3.n_states} frames={frames3:.0f} "
          f"| ELBO/frame {', '.join(f'{e / frames3:.6f}' for e in elbos3)} "
          f"| plain-route gap {gap3:.3g}/frame | launches {launches3} | decode paths equal "
          f"| posteriors sum-to-1 error {checks2[0]:.3g}, {checks3[0]:.3g}; posteriors vs "
          f"plain route abs {checks2[1]:.3g}, {checks3[1]:.3g}; xi-count sum rel error "
          f"{checks2[2]:.3g}, {checks3[2]:.3g}")
    return launches, ((hmm2, x2, m2), (hmm3, x3, m3))


def phase_hmm_times(runs):
    times = {}
    for cfg, (model, x, m) in zip(("config2", "config3"), runs):
        kern = copy.deepcopy(model)
        plain = plain_twin(model)
        for name, mdl in (("kernel", kern), ("plain", plain)):
            times[f"{cfg}_vb_step_{name}_ms"] = cuda_ms(lambda: bt.vb_step(mdl, x, mask=m))
            times[f"{cfg}_decode_{name}_ms"] = cuda_ms(lambda: mdl.decode(x, m))
            times[f"{cfg}_posteriors_{name}_ms"] = cuda_ms(lambda: mdl.posteriors(x, m))
        frames = float(m.sum())
        times[f"{cfg}_vb_step_kernel_frames_per_s"] = round(
            frames / times[f"{cfg}_vb_step_kernel_ms"] * 1e3)
    print("phase 8 hmm times: " + json.dumps(
        {**{k: round(v, 3) if isinstance(v, float) else v for k, v in times.items()},
         "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2)}))

# ----------------------------------------------------------------------
# The full-covariance GMM: config 1 and the full-covariance recognizer
# ----------------------------------------------------------------------
def config1(device, k=GMM_K, dim=D, dtype=torch.float32):
    """Full-covariance Bayesian GMM (bench.py:225-237)."""
    gen = torch.Generator(device=device).manual_seed(2)
    nset = bt.NormalSet.create(torch.zeros(dim, dtype=dtype, device=device),
                               torch.eye(dim, dtype=dtype, device=device), size=k,
                               cov_type="full", noise_std=0.5, generator=gen)
    return bt.Mixture.create(nset)


def config1_frames(dev):
    """All 256,000 frames of the bench data (bench_gmm ignores the mask)."""
    return torch.from_numpy(make_data(B, T, D)[0].reshape(-1, D)).to(dev)


def config3_full(device, seqs, n_phones=REC_PHONES, spp=REC_SPP, ncomp=REC_NCOMP, dim=D,
                 dtype=torch.float32):
    """The recognizer with full-covariance GMM emissions: one MixtureSet of
    ``ncomp`` components per state (examples/recognizer_demo.py:42-47)."""
    gen = torch.Generator(device=device).manual_seed(4)
    graphs = bt.transcription_graphs(seqs, n_phones, spp, dtype=dtype, device=device)
    nset = bt.NormalSet.create(torch.zeros(dim, dtype=dtype, device=device),
                               torch.eye(dim, dtype=dtype, device=device),
                               size=n_phones * spp * ncomp, cov_type="full", noise_std=0.5,
                               generator=gen)
    return bt.HMM.create(graphs, bt.MixtureSet.create(nset, nmix=n_phones * spp))


def gmm_operands(model):
    """E[T] and E[log w] of a Mixture, as the fused E-step takes them."""
    return (model.modelset.means_precisions.expected_sufficient_statistics(),
            model.categorical.expected_log_weights())


def full_cov_costs(t_len, d, k):
    """(bytes, FLOPs) of K9 and of K10 over t_len frames: one product of
    the packed (t_len, L) statistic with a (L, K) matrix, 2·t_len·K·L."""
    width = sk.packed_width(d)
    flops = 2.0 * t_len * k * width
    ellh = 4.0 * (t_len * d + width * k + t_len * k)
    acc = 4.0 * (t_len * d + t_len * k + k * (d * d + d + 2))
    return ellh, acc, flops


def phase_gmm_kernels(dev):
    """K8–K10 against their plain versions at the config-1 shape (ragged
    last tile, masked stretch) and K9/K10 at the recognizer's; times on
    the unmasked config-1 frames, beside a yardstick: torch.matmul (TF32
    off) on the materialised packed statistics S (T, L)."""
    x = config1_frames(dev)
    n_frames = x.shape[0]
    gmm = config1(dev)
    e, log_w = gmm_operands(gmm)
    # a ragged last tile (T not a multiple of 128) and a masked stretch
    xr = x[: n_frames - 37]
    mask = torch.ones(xr.shape[0], device=dev)
    mask[10_000:30_000] = 0.0
    mask[::17] = 0.0
    k8 = sk.gmm_estep_full(xr, e, log_w, mask)
    p8 = sk.gmm_estep_full_plain(xr, e, log_w, mask)
    errs = dict(llh=rel(k8[0], p8[0]), acc=rel(k8[1], p8[1]), counts=rel(k8[2], p8[2]))
    check(errs["llh"] <= 1e-5, f"gmm_estep_full llh rel {errs['llh']}")
    check(errs["acc"] <= 1e-4 and errs["counts"] <= 1e-4, f"gmm_estep_full stats {errs}")
    check(not bool(k8[0][mask == 0].any()), "gmm_estep_full: masked frames must give llh 0")
    k9 = sk.ellh_full(xr, e)
    p9 = sk.ellh_full_plain(xr, e)
    errs["ellh"] = rel(k9, p9)
    check(errs["ellh"] <= 1e-5, f"ellh_full rel {errs['ellh']}")
    resps = torch.softmax(p9 + log_w, -1) * mask[:, None]
    k10 = sk.accumulate_full(xr, resps)
    p10 = sk.accumulate_full_plain(xr, resps)
    errs["acc10"] = rel(k10, p10)
    check(errs["acc10"] <= 1e-4, f"accumulate_full rel {errs['acc10']}")

    # the recognizer's shape: (38,400, 39) frames, 60 components
    data3, _, seqs = config3_data()
    x3 = torch.from_numpy(data3.reshape(-1, D)).to(dev)
    e3 = config3_full(dev, seqs).modelset.modelset.means_precisions.expected_sufficient_statistics()
    r3 = torch.softmax(sk.ellh_full_plain(x3, e3), -1)
    errs["ellh_rec"] = rel(sk.ellh_full(x3, e3), sk.ellh_full_plain(x3, e3))
    errs["acc_rec"] = rel(sk.accumulate_full(x3, r3), sk.accumulate_full_plain(x3, r3))
    check(errs["ellh_rec"] <= 1e-5 and errs["acc_rec"] <= 1e-4, f"recognizer shape: {errs}")
    torch.cuda.synchronize()

    # times at the config-1 shape: the kernel alone (the bare foreign call on
    # operands packed and a geometry computed in advance) and the wrapper
    k = e.shape[0]
    r = torch.softmax(sk.ellh_full_plain(x, e) + log_w, -1)
    s_mat = sk.packed_stats(x)
    w_mat, w_joint = sk.pack_weights(e, D), sk.pack_weights(e, D, log_w)
    lib_joint = cuda_ms(lambda: torch.matmul(s_mat, w_joint), reps=KERNEL_REPS)
    lib_ellh = cuda_ms(lambda: torch.matmul(s_mat, w_mat), reps=KERNEL_REPS)
    lib_acc = cuda_ms(lambda: torch.matmul(r.T, s_mat), reps=KERNEL_REPS)
    del s_mat
    ellh_b, acc_b, flops = full_cov_costs(n_frames, D, k)
    out = {
        "gmm_estep_full": dict(
            max_abs_err=float((k8[1] - p8[1]).abs().max()),
            **stats_times(lambda: sk.prepare_gmm_estep_full(x, e, log_w)[-1],
                          lambda: sk.gmm_estep_full(x, e, log_w)),
            plain_ms=cuda_ms(lambda: sk.gmm_estep_full_plain(x, e, log_w)),
            library_ms=lib_joint + lib_acc,
            **bound(4.0 * (n_frames * (D + 1) + sk.packed_width(D) * k + k * (D * D + D + 3)),
                    2 * flops)),
        "ellh_full": dict(
            max_abs_err=float((k9 - p9).abs().max()),
            **stats_times(lambda: sk.prepare_ellh_full(x, e)[-1], lambda: sk.ellh_full(x, e)),
            plain_ms=cuda_ms(lambda: sk.ellh_full_plain(x, e)),
            library_ms=lib_ellh, **bound(ellh_b, flops)),
        "accumulate_full": dict(
            max_abs_err=float((k10 - p10).abs().max()),
            **stats_times(lambda: sk.prepare_accumulate_full(x, r)[-1],
                          lambda: sk.accumulate_full(x, r)),
            plain_ms=cuda_ms(lambda: sk.accumulate_full_plain(x, r)),
            library_ms=lib_acc, **bound(acc_b, flops)),
    }
    s3 = sk.packed_stats(x3)
    w3 = sk.pack_weights(e3, D)
    ellh_b3, acc_b3, flops3 = full_cov_costs(x3.shape[0], D, e3.shape[0])
    rec = {
        "ellh_full": dict(**stats_times(lambda: sk.prepare_ellh_full(x3, e3)[-1],
                                        lambda: sk.ellh_full(x3, e3)),
                          plain_ms=cuda_ms(lambda: sk.ellh_full_plain(x3, e3)),
                          library_ms=cuda_ms(lambda: torch.matmul(s3, w3), reps=KERNEL_REPS),
                          **bound(ellh_b3, flops3)),
        "accumulate_full": dict(**stats_times(lambda: sk.prepare_accumulate_full(x3, r3)[-1],
                                              lambda: sk.accumulate_full(x3, r3)),
                                plain_ms=cuda_ms(lambda: sk.accumulate_full_plain(x3, r3)),
                                library_ms=cuda_ms(lambda: torch.matmul(r3.T, s3), reps=KERNEL_REPS),
                                **bound(acc_b3, flops3)),
    }
    del s3
    torch.cuda.synchronize()
    fmt = lambda v: (f"{v['ms']:.3f} ms alone, {v['wrapper_ms']:.3f} ms wrapped (plain "  # noqa: E731
                     f"{v['plain_ms']:.3f}, matmul {v['library_ms']:.3f}, bound {v['bound_ms']:.3f} "
                     f"by {v['bound_by']}, {v['bound_ms'] / v['ms']:.0%} of it)")
    print(f"phase 9 gmm kernels: config 1 T={n_frames} D={D} K={k}: "
          + "; ".join(f"{name} {fmt(v)}" for name, v in out.items())
          + f" | recognizer T={x3.shape[0]} K={e3.shape[0]}: "
          + "; ".join(f"{name} {fmt(v)}" for name, v in rec.items())
          + " | rel errors " + json.dumps({k_: float(f"{v:.3g}") for k_, v in errs.items()})
          + " | tol: llh and ELLH rel 1e-5, statistics and counts rel 1e-4 of the largest"
            " magnitude (float32 sums in another order)")
    return out, rec


def stats_times(prepared, wrapped):
    """``ms``: CUDA-event median of the kernel alone, the bare foreign call
    of a prepared K8–K10 launch (its checks, packing and geometry done
    once beforehand); ``wrapper_ms``: the whole wrapper call."""
    launch = prepared()
    return dict(ms=cuda_ms(lambda: check(launch() == 0, "launch refused"), reps=KERNEL_REPS),
                wrapper_ms=cuda_ms(wrapped, reps=KERNEL_REPS))


def gmm_reference_check(dev):
    """Small problems on the card (float32 kernels) against the float64
    path on the CPU: a GMM's E-step through K8 and its posteriors through
    K9 against the logsumexp route, and the full-covariance recognizer
    through K9/K10 against the general path."""
    x64 = torch.from_numpy(make_data(6, 40, 4, seed=3)[0].reshape(-1, 4)).double()
    ref = config1("cpu", k=3, dim=4, dtype=torch.float64)
    card = copy.deepcopy(ref).to(device=dev, dtype=torch.float32)
    x = x64.float().to(dev)
    joint = ref.modelset.expected_log_likelihood(x64) + ref.categorical.expected_log_weights()
    llh_ref = torch.logsumexp(joint, -1)
    resps = torch.exp(joint - llh_ref[:, None])
    acc_ref = ref.modelset.accumulate(x64, resps)["means_precisions"]
    llh, cache = card.infer(card.sufficient_statistics(x))
    check(rel(llh.double().cpu(), llh_ref) <= 1e-5, "small GMM: llh vs float64")
    e = rel(cache["gmm_acc"].double().cpu(), acc_ref)
    check(e <= 1e-4, f"small GMM: statistics rel {e} vs float64")
    e = float((card.posteriors(x).double().cpu() - resps).abs().max())
    check(e <= 1e-5, f"small GMM: posteriors abs {e} vs float64")
    hmm_reference_check(dev, [("full-covariance recognizer",
                               config3_full("cpu", SMALL_SEQS, n_phones=3, spp=2, dim=4,
                                            dtype=torch.float64), "llh")])


def phase_gmm_slice(dev):
    # config 1: 5 VB-EM steps and the posteriors through K8 and K9
    x = config1_frames(dev)
    frames = float(x.shape[0])
    gmm = config1(dev)
    plain = plain_twin(gmm)
    cuda_scan.reset_launch_counts()
    elbos = np.array([float(bt.vb_step(gmm, x)[0]) for _ in range(N_STEPS)])
    post = gmm.posteriors(x)
    torch.cuda.synchronize()
    launches1 = {k: v.launches for k, v in cuda_scan.KERNELS.items() if v.launches}
    check(all(launches1.get(k, 0) > 0 for k in ("gmm_estep_full", "ellh_full")),
          f"config 1: a kernel was not launched: {launches1}")
    check(bool(np.isfinite(elbos).all()), f"config 1: ELBO not finite: {elbos}")
    drops = np.diff(elbos) / frames
    check(bool((drops >= -1e-6).all()), f"config 1: ELBO decreased: per-frame steps {drops}")
    elbos_plain = np.array([float(bt.vb_step(plain, x)[0]) for _ in range(N_STEPS)])
    gap1 = float(np.abs(elbos - elbos_plain).max() / frames)
    check(gap1 <= 1e-4, f"config 1: kernel vs plain route ELBO gap {gap1} per frame")
    e_post = float((post.sum(-1) - 1).abs().max())
    check(post.shape == (x.shape[0], GMM_K) and e_post <= 1e-5,
          f"config 1: posteriors sum to 1 within {e_post}")

    # the trajectory gate: clustered data at production magnitudes
    rng = np.random.default_rng(7)
    centres = rng.normal(size=(16, D)) * 3.0
    xc = torch.from_numpy((centres[rng.integers(0, 16, size=64_000)]
                           + rng.normal(size=(64_000, D))).astype(np.float32)).to(dev)
    trajs = []
    for model in (config1(dev), plain_twin(config1(dev))):
        trajs.append(np.array([float(bt.vb_step(model, xc)[0]) / 64_000 for _ in range(10)]))
    drift = float(np.abs(trajs[0] - trajs[1]).max())
    check(drift <= 1e-4, f"trajectory gate: kernel vs plain route drift {drift} per frame")
    check(bool((np.diff(trajs[0][2:]) >= -1e-5).all()),
          f"trajectory gate: not monotone after burn-in: {trajs[0]}")

    # the recognizer with full-covariance GMM emissions
    data, mask, seqs = config3_data()
    x3, m3 = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    frames3 = float(mask.sum())
    rec = config3_full(dev, seqs)
    check(rec.route() == "llh", "full-covariance recognizer: route")
    elbos3, gap3, launches3, checks3 = hmm_run(rec, x3, m3, frames3, "full-covariance recognizer")
    need3 = ("ellh_full", "accumulate_full", "forward_llh_dense", "estep_gamma_dense",
             "viterbi_fwd_banded", "viterbi_backtrace_banded")
    check(all(launches3.get(k, 0) > 0 for k in need3),
          f"full-covariance recognizer: a kernel was not launched: {launches3}")
    gmm_reference_check(dev)
    launches = {k: launches1.get(k, 0) + launches3.get(k, 0) for k in cuda_scan.KERNELS}
    print(f"phase 10 gmm slice: config 1 T={x.shape[0]} D={D} K={GMM_K} "
          f"| ELBO/frame {', '.join(f'{v / frames:.6f}' for v in elbos)} "
          f"| plain-route gap {gap1:.3g}/frame | posteriors sum-to-1 error {e_post:.3g} "
          f"| launches {launches1} || trajectory gate (64,000 clustered frames, 10 steps) "
          f"ELBO/frame {', '.join(f'{v:.6f}' for v in trajs[0])} | drift {drift:.3g}/frame "
          f"|| full-covariance recognizer B={REC_B} T={REC_T} S={rec.n_states} "
          f"components={REC_PHONES * REC_SPP * REC_NCOMP} "
          f"| ELBO/frame {', '.join(f'{v / frames3:.6f}' for v in elbos3)} "
          f"| plain-route gap {gap3:.3g}/frame | launches {launches3} | decode paths equal "
          f"| posteriors sum-to-1 error {checks3[0]:.3g}, vs plain route {checks3[1]:.3g}"
          f" | small problems agree with float64")
    return launches, ((gmm, x), (rec, x3, m3))


def phase_gmm_times(runs):
    (gmm, x), (rec, x3, m3) = runs
    times = {}
    for name, model in (("kernel", copy.deepcopy(gmm)), ("plain", plain_twin(gmm))):
        times[f"config1_vb_step_{name}_ms"] = cuda_ms(lambda: bt.vb_step(model, x))
        times[f"config1_posteriors_{name}_ms"] = cuda_ms(lambda: model.posteriors(x))
    for name, model in (("kernel", copy.deepcopy(rec)), ("plain", plain_twin(rec))):
        times[f"recognizer_full_vb_step_{name}_ms"] = cuda_ms(lambda: bt.vb_step(model, x3, mask=m3))
        times[f"recognizer_full_decode_{name}_ms"] = cuda_ms(lambda: model.decode(x3, m3))
    times["config1_vb_step_kernel_frames_per_s"] = round(
        x.shape[0] / times["config1_vb_step_kernel_ms"] * 1e3)
    times["recognizer_full_vb_step_kernel_frames_per_s"] = round(
        float(m3.sum()) / times["recognizer_full_vb_step_kernel_ms"] * 1e3)
    print("phase 11 gmm times: " + json.dumps(
        {**{k: round(v, 3) if isinstance(v, float) else v for k, v in times.items()},
         "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2)}))


# ----------------------------------------------------------------------
# The structured VAE: config 5 and its two smaller paths
# ----------------------------------------------------------------------
def config5(device, kind="phone_loop", dtype=torch.float32, obs=D, dz=SVAE_DZ,
            hidden=(SVAE_H, SVAE_H), units=SVAE_UNITS, spu=SVAE_SPU):
    """A SequenceVAE over a phone-loop prior (bench.py:430-438), or over an
    ergodic HMM of ``units·spu`` states with learned transitions."""
    gen = torch.Generator(device=device).manual_seed(7)
    nset = bt.NormalSet.create(torch.zeros(dz, dtype=dtype, device=device),
                               torch.ones(dz, dtype=dtype, device=device), size=units * spu,
                               noise_std=0.5, generator=gen)
    if kind == "phone_loop":
        prior = bt.PhoneLoop.create(units, spu, nset)
    else:
        prior = bt.HMM.create(bt.ergodic(units * spu), nset, learn_transitions=True)
    return bt.SequenceVAE.create(obs, dz, prior, hidden=hidden, nsamples=1,
                                 generator=torch.Generator().manual_seed(8))


def config5_data(dev):
    """``make_data()``'s frames cut to the first 256 utterances × 250
    frames (bench.py:446-447): every frame is valid."""
    data, mask = make_data(B, T, D)
    return (torch.from_numpy(np.ascontiguousarray(data[:SVAE_B, :SVAE_T])).to(dev),
            torch.from_numpy(np.ascontiguousarray(mask[:SVAE_B, :SVAE_T])).to(dev))


def gmm_vae(device, dtype=torch.float32, hidden=(GVAE_H, GVAE_H)):
    """The frame-level VAE over a full-covariance GMM (examples/svae_demo.py)."""
    gen = torch.Generator(device=device).manual_seed(3)
    nset = bt.NormalSet.create(torch.zeros(GVAE_DZ, dtype=dtype, device=device),
                               4.0 * torch.eye(GVAE_DZ, dtype=dtype, device=device), size=GVAE_K,
                               cov_type="full", noise_std=1.0, generator=gen)
    return bt.VAE.create(GVAE_D, GVAE_DZ, bt.Mixture.create(nset), hidden=hidden,
                         generator=torch.Generator().manual_seed(0))


def gmm_vae_data(dev, n=GVAE_N):
    rng = np.random.default_rng(0)
    z = np.concatenate([rng.normal(size=(n // 2, 2)) + [-3, 0], rng.normal(size=(n // 2, 2)) + [3, 0]])
    w = rng.normal(size=(2, GVAE_D))
    return torch.from_numpy((z @ w + 0.1 * rng.normal(size=(n, GVAE_D))).astype(np.float32)).to(dev)


def noise(shape, n, device, seed=99):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((1, *shape), generator=gen, device=device) for _ in range(n)]


def svae_operands(vae, x, m):
    """The phone-loop prior's kernel operands on the posterior means of ``x``."""
    with torch.no_grad():
        z = vae.posteriors(x)["mean"]
        stats = vae.latent_model.sufficient_statistics(z).contiguous()
        return stats, vae.latent_model.scan_operands(stats, m)


def phase_svae_kernels(dev):
    """K11 against its plain version at the config-5 shape + two empty rows."""
    x, m = config5_data(dev)
    x = torch.cat([x, torch.zeros(2, *x.shape[1:], device=dev)])
    m = torch.cat([m, torch.zeros(2, m.shape[1], device=dev)])
    vae = config5(dev)
    stats, ops = svae_operands(vae, x, m)
    fwd = (stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["init"])
    k1, p1 = cuda_scan.forward_llh_banded(*fwd), cuda_scan.forward_llh_banded_plain(*fwd)
    full = ops["lens"] > 0
    tiny = torch.finfo(torch.float32).tiny
    logz = [o[3] + torch.log((o[2] * ops["final"]).sum(-1).clamp_min(tiny)) for o in (k1, p1)]
    e_k1 = dict(log_z=rel(logz[0][full], logz[1][full]), alpha=float((k1[0] - p1[0]).abs().max()),
                norms=rel(k1[1], p1[1]))
    check(e_k1["log_z"] <= 1e-5 and e_k1["alpha"] <= 1e-5 and e_k1["norms"] <= 1e-5,
          f"forward_llh_banded at config 5: {e_k1}")
    alpha, norms = k1[0], k1[1]
    del p1
    est = (stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["final"], alpha, norms,
           ops["ends"], ops["starts"])
    b, t_len, p_dim = stats.shape
    s, n_u = ops["w"].shape[0], ops["ends"].shape[0]
    out = {}
    out["estep_gamma_banded"], e11 = k11_row(est)
    log_final = vae.latent_model._effective_graph().log_final
    out["viterbi_fwd_banded"], m3 = k3_row(viterbi_args(lambda: vae.latent_decode(x, m)), log_final)
    out["forward_llh_banded"] = dict(
        max_abs_err=float((logz[0][full] - logz[1][full]).abs().max()),
        geometry=launch_geometry("forward_llh_banded", dev, s, p_dim, b),
        ms=entry_ms(lambda: cuda_scan.forward_llh_banded(*fwd), ("forward_llh_chunked",)),
        wrapper_ms=cuda_ms(lambda: cuda_scan.forward_llh_banded(*fwd)),
        plain_ms=cuda_ms(lambda: cuda_scan.forward_llh_banded_plain(*fwd)),
        **k1_bound(ops["lens"], t_len, s, p_dim))
    v, v1, v3 = out["estep_gamma_banded"], out["forward_llh_banded"], out["viterbi_fwd_banded"]
    torch.cuda.synchronize()
    print(f"phase 12 svae kernels: config 5 B={b} (2 empty) T={t_len} S={s} P={p_dim} U={n_u}: "
          f"estep_gamma_banded {tuple(v['geometry'])} ok (alone {v['ms']:.3f} ms, wrapped {v['wrapper_ms']:.3f} "
          f"ms vs plain {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms by {v['bound_by']}; gamma abs "
          f"{e11['gamma']:.3g}, gamma0 abs {e11['gamma0']:.3g}, xi rel {e11['xi']:.3g}); viterbi_fwd_banded "
          f"(latent decode) {tuple(v3['geometry'])} ok (alone {v3['ms']:.3f} ms, wrapped {v3['wrapper_ms']:.3f} "
          f"ms vs plain {v3['plain_ms']:.3f} ms, bound {v3['bound_ms']:.4f} ms; mismatches {json.dumps(m3)}); "
          f"forward_llh_banded {tuple(v1['geometry'])} ok (alone "
          f"{v1['ms']:.3f} ms, wrapped {v1['wrapper_ms']:.3f} ms vs plain {v1['plain_ms']:.3f} ms, bound "
          f"{v1['bound_ms']:.4f} ms by {v1['bound_by']}; {json.dumps({k: float(f'{e:.3g}') for k, e in e_k1.items()})})"
          " | tol: gamma, gamma0, alpha abs 1e-5; log Z, norms rel 1e-5; xi rel 1e-4; decode scores rel 1e-6, "
          "paths >= 99.9% of valid frames; K3, K11 bitwise")
    return out


def grad_gap(model, twin):
    """The largest rel difference between two models' gradients of one
    nnet parameter."""
    return max(rel(p.grad, q.grad) for p, q in zip(model.parameters(), twin.parameters()))


def svae_run(model, x, m, frames, label, eps):
    """5 hybrid steps through the kernels with the launch counters read
    around them, each followed by the same step on the plain route (same
    noise; the plain versions launch nothing).  Checks the ELBO gap per
    frame (1e-4) and the gradients of the first step, taken at identical
    parameters (rel 1e-4); returns the ELBOs, the ELBO gap, the gradient
    gap of each step and the launches."""
    twin = plain_twin(model)
    steps = [bt.make_vae_train_step(torch.optim.Adam(v.parameters(), lr=1e-3))
             for v in (model, twin)]
    elbos, g_gaps = [], []
    cuda_scan.reset_launch_counts()
    for e in eps:
        elbo = float(steps[0](model, x, None, m, eps=e))
        elbos.append((elbo, float(steps[1](twin, x, None, m, eps=e))))
        g_gaps.append(grad_gap(model, twin))
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in cuda_scan.KERNELS.items() if v.launches}
    elbos = np.array(elbos)
    check(bool(np.isfinite(elbos).all()), f"{label}: ELBO not finite: {elbos}")
    gap = float(np.abs(elbos[:, 0] - elbos[:, 1]).max() / frames)
    check(gap <= 1e-4, f"{label}: kernel vs plain route ELBO gap {gap} per frame")
    check(g_gaps[0] <= 1e-4, f"{label}: kernel vs plain route gradient rel {g_gaps[0]}")
    return elbos[:, 0], gap, g_gaps, launches


def underflow_share(vae, x, m):
    """The share of valid frames whose γ sums below 0.5 (f32 α̂·v̂
    underflow) on the posterior means of ``x``, through the latent
    model's gradient route (K1 + K11, or K5 + K7)."""
    with torch.no_grad():
        z = vae.posteriors(x)["mean"]
    stats = vae.latent_model.sufficient_statistics(z.requires_grad_())
    _, cache = vae.latent_model.infer(stats, mask=m)
    return float(((cache["gamma"].sum(-1) < 0.5) & (m > 0)).sum() / m.sum())


def svae_reference_check(dev):
    """Small problems of the three VAE paths on the card (float32
    kernels) against the float64 plain route on the CPU, with the same
    noise: ELBO rel 1e-5, every nnet gradient and the latent statistics
    rel 1e-4."""
    data, mask = make_data(4, 20, 4, seed=3)
    mask[-1] = 0.0
    x64, m64 = torch.from_numpy(data).double(), torch.from_numpy(mask).double()
    cases = (("phone loop", config5("cpu", dtype=torch.float64, obs=4, dz=2, hidden=(8,),
                                    units=3, spu=2), x64, m64),
             ("hmm prior", config5("cpu", "hmm", dtype=torch.float64, obs=4, dz=2, hidden=(8,),
                                   units=4, spu=1), x64, m64),
             ("gmm prior", gmm_vae("cpu", dtype=torch.float64, hidden=(8,)),
              gmm_vae_data("cpu", 64).double(), None))
    for name, ref, x_ref, m_ref in cases:
        card = copy.deepcopy(ref).to(device=dev, dtype=torch.float32)
        eps = torch.randn(1, *x_ref.shape[:-1], ref.latent_dim, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(1))
        outs = []
        for model, xx, mm, ee in ((ref, x_ref, m_ref, eps),
                                  (card, x_ref.float().to(dev),
                                   None if m_ref is None else m_ref.float().to(dev),
                                   eps.float().to(dev))):
            elbo, acc = model.elbo_and_stats(xx, None, None, mm, eps=ee)
            (-elbo).backward()
            outs.append((elbo.detach().cpu(), acc))
        check(rel(outs[1][0], outs[0][0]) <= 1e-5, f"small {name}: ELBO vs float64")
        for p, q in zip(card.parameters(), ref.parameters()):
            check(rel(p.grad.double().cpu(), q.grad) <= 1e-4, f"small {name}: gradient vs float64")
        for got, want in zip(stat_leaves(outs[1][1]), stat_leaves(outs[0][1])):
            e = rel(got.double().cpu(), want)
            check(e <= 1e-4, f"small {name}: statistics rel {e} vs float64")


def phase_svae_slice(dev):
    # config 5: the phone-loop prior through K1 + K11, then the latent decode
    x, m = config5_data(dev)
    frames = float(m.sum())
    vae = config5(dev)
    under5 = [underflow_share(vae, x, m)]
    elbos5, gap5, g_gap5, launches5 = svae_run(vae, x, m, frames, "config 5",
                                               noise((SVAE_B, SVAE_T, SVAE_DZ), N_STEPS, dev))
    want = {"forward_llh_banded": N_STEPS, "estep_gamma_banded": N_STEPS}
    check({k: launches5.get(k, 0) for k in want} == want and "estep_acc_banded" not in launches5,
          f"config 5: launches {launches5}, expected K1 {N_STEPS}, K11 {N_STEPS}, K2 0")
    cuda_scan.reset_launch_counts()
    units, scores = vae.latent_decode(x, m)
    torch.cuda.synchronize()
    decode_launches = {k: v.launches for k, v in cuda_scan.KERNELS.items() if v.launches}
    check(decode_launches == {"viterbi_fwd_banded": 1, "viterbi_backtrace_banded": 1},
          f"config 5 decode: launches {decode_launches}")
    check(units.shape == (SVAE_B, SVAE_T) and bool(((units >= 0) & (units < SVAE_UNITS)).all())
          and bool(torch.isfinite(scores).all()), "config 5: latent decode")
    units_plain, _ = plain_twin(vae).latent_decode(x, m)
    agree = float((units == units_plain).float().mean())
    check(agree >= 0.999, f"config 5: decode agrees with the plain route on {agree} of frames")
    under5.append(underflow_share(vae, x, m))

    # the HMM prior (K5 + K7) and the frame-level GMM prior (K9, K10)
    hmm = config5(dev, "hmm")
    under_h = [underflow_share(hmm, x, m)]
    elbos_h, gap_h, g_gap_h, launches_h = svae_run(hmm, x, m, frames, "hmm prior",
                                                   noise((SVAE_B, SVAE_T, SVAE_DZ), N_STEPS, dev, 98))
    under_h.append(underflow_share(hmm, x, m))
    check(all(launches_h.get(k, 0) == N_STEPS for k in ("forward_llh_dense", "estep_gamma_dense"))
          and "estep_acc_dense" not in launches_h, f"hmm prior: launches {launches_h}")
    xg = gmm_vae_data(dev)
    gvae = gmm_vae(dev)
    elbos_g, gap_g, g_gap_g, launches_g = svae_run(gvae, xg, None, float(GVAE_N), "gmm prior",
                                                   noise((GVAE_N, GVAE_DZ), N_STEPS, dev, 97))
    check(launches_g.get("ellh_full", 0) >= N_STEPS and launches_g.get("accumulate_full", 0) >= N_STEPS
          and "gmm_estep_full" not in launches_g, f"gmm prior: launches {launches_g}")
    svae_reference_check(dev)
    launches = {k: launches5.get(k, 0) + launches_h.get(k, 0) + launches_g.get(k, 0)
                + decode_launches.get(k, 0) for k in cuda_scan.KERNELS}
    def gaps(values):
        return "[" + ", ".join(f"{v:.3g}" for v in values) + "]"

    print(f"phase 13 svae slice: config 5 B={SVAE_B} T={SVAE_T} D={D} dz={SVAE_DZ} H={SVAE_H} "
          f"S={SVAE_UNITS * SVAE_SPU} frames={frames:.0f} | ELBO/frame "
          f"{', '.join(f'{e / frames:.6f}' for e in elbos5)} | plain-route gap {gap5:.3g}/frame, "
          f"gradient rel by step {gaps(g_gap5)} | launches {launches5} | decode launches "
          f"{decode_launches}, agree {agree:.6f} | frames with sum(gamma) < 0.5 before/after "
          f"{gaps(under5)} || hmm prior S={SVAE_UNITS * SVAE_SPU} | ELBO/frame "
          f"{', '.join(f'{e / frames:.6f}' for e in elbos_h)} | gap {gap_h:.3g}/frame, gradient rel "
          f"by step {gaps(g_gap_h)} | launches {launches_h} | frames with sum(gamma) < 0.5 "
          f"before/after {gaps(under_h)} || gmm prior N={GVAE_N} D={GVAE_D} dz={GVAE_DZ} "
          f"K={GVAE_K} | ELBO/frame {', '.join(f'{e / GVAE_N:.4f}' for e in elbos_g)} | gap "
          f"{gap_g:.3g}/frame, gradient rel by step {gaps(g_gap_g)} | launches {launches_g} "
          f"| small problems agree with float64")
    return launches, (("config5", vae, x, m), ("hmm_prior", hmm, x, m), ("gmm_prior", gvae, xg, None))


def profile_step(fn):
    """One call of ``fn`` under ``torch.profiler``: wall ms (host clock to
    a synchronise), device ms summed over kernels (annotated ranges such
    as the optimizer's are not kernels), their count, the busy share of
    that wall time and the six kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
               and e.self_device_time_total > 0 and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=round(wall, 3), device_ms=round(busy, 3),
                kernel_launches=sum(e.count for e in kernels), busy_share=round(busy / wall, 3),
                top_ms={e.key[:60]: round(e.self_device_time_total / 1e3, 3) for e in top})


def phase_svae_times(runs):
    times = {}
    for name, model, x, m in runs:
        for route, mdl in (("kernel", copy.deepcopy(model)), ("plain", plain_twin(model))):
            step = bt.make_vae_train_step(torch.optim.Adam(mdl.parameters(), lr=1e-3))
            gen = torch.Generator(device=x.device).manual_seed(5)
            times[f"{name}_step_{route}_ms"] = cuda_ms(lambda: step(mdl, x, gen, m))
            if name == "config5":
                times[f"config5_latent_decode_{route}_ms"] = cuda_ms(lambda: mdl.latent_decode(x, m))
                if route == "kernel":
                    prof = profile_step(lambda: step(mdl, x, gen, m))
    frames = float(runs[0][3].sum())
    times["config5_step_kernel_frames_per_s"] = round(frames / times["config5_step_kernel_ms"] * 1e3)
    prof["busy_share_of_step"] = round(prof["device_ms"] / times["config5_step_kernel_ms"], 3)
    print("phase 14 svae times: " + json.dumps(
        {**{k: round(v, 3) if isinstance(v, float) else v for k, v in times.items()},
         "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
         "config5_step_profile": prof}))


# ----------------------------------------------------------------------
# The subspace-HMM: the general path (K12–K15), GSM and H-SHMM
# ----------------------------------------------------------------------
def general_operands(loop, x, m):
    """The general path's kernel operands of a phone loop on ``x``/``m``:
    llh, e_llh, lens, the dense matrix, the bands, per-row init/final."""
    stats = loop.sufficient_statistics(x)
    llh = loop.modelset.expected_log_likelihood(stats).contiguous()
    graph = loop._effective_graph()
    e_llh, _ = tss._scaled_likelihoods(llh, m)
    b, _, s = llh.shape
    vec = lambda lv: torch.exp(torch.clamp(lv, min=-1e30)).expand(b, s).contiguous()  # noqa: E731
    return dict(llh=llh, e_llh=e_llh.contiguous(), lens=m.sum(-1).to(torch.int32), mask=m,
                trans=torch.exp(graph.log_trans).contiguous(),
                bands=loop._structured_trans(llh.dtype).contiguous(), init=vec(graph.log_init),
                final=vec(graph.log_final), graph=graph, ends=loop._ends().to(torch.int32),
                starts=loop._starts().to(torch.int32))


def valid_err(got, want, mask, relative=False):
    """Largest difference over the valid frames, abs or relative to the
    largest valid magnitude."""
    m = mask[..., None] if got.ndim == 3 else mask
    err = float(((got - want) * m).abs().max())
    return err / float((want * m).abs().max().clamp_min(1e-30)) if relative else err


def general_instance(o, banded):
    """K12 forward + K13 of one instance against the plain versions;
    returns the kernel outputs, the errors and the two timing rows (each
    kernel alone, by profiler device time, and wrapped, with its launch
    geometry)."""
    mat = o["bands"] if banded else o["trans"]
    fwd = (o["e_llh"], o["lens"], mat, o["init"])
    probs, logcs = cuda_scan.scaled_pass(*fwd, banded=banded)
    probs_p, logcs_p = cuda_scan.scaled_pass_plain(*fwd, banded=banded)
    errs = dict(alpha=float((probs - probs_p).abs().max()), logcs=rel(logcs, logcs_p))
    smo = (o["e_llh"], probs, o["lens"], mat, o["final"])
    got = cuda_scan.smoothing_pass(*smo, banded=banded)
    want = cuda_scan.smoothing_pass_plain(*smo, banded=banded)
    check(not bool(got[0][o["mask"] == 0].any()), "smoothing_pass: gamma must be 0 on t >= len")
    errs.update(gamma=valid_err(got[0], want[0], o["mask"]),
                w_probs=valid_err(got[1], want[1], o["mask"]),
                w_sums=valid_err(got[2], want[2], o["mask"], relative=True),
                post_norm=valid_err(got[3], want[3], o["mask"], relative=True))
    fbs = [tss.FBProbs(p, g[0], g[1], g[2], g[3], c, None)
           for p, c, g in ((probs, logcs, got), (probs_p, logcs_p, want))]
    xi = [tss.expected_transition_counts_probs(f, o["graph"].log_trans, o["mask"]) for f in fbs]
    errs["xi"] = rel(xi[0], xi[1])
    del want, fbs, probs_p, logcs_p
    b, t_len, s = o["e_llh"].shape
    nv = float(o["lens"].sum())
    n_mat = 4 * s if banded else s * s
    dev = o["e_llh"].device
    suffix = "" if banded else "_dense"
    rows = {
        "scaled_pass": dict(
            max_abs_err=errs["alpha"],
            geometry=launch_geometry("scaled_pass" + suffix, dev, s, 0, b),
            ms=entry_ms(lambda: cuda_scan.scaled_pass(*fwd, banded=banded),
                        ("scaled_banded",) if banded else ("dense_grouped",)),
            wrapper_ms=cuda_ms(lambda: cuda_scan.scaled_pass(*fwd, banded=banded)),
            plain_ms=cuda_ms(lambda: cuda_scan.scaled_pass_plain(*fwd, banded=banded)),
            **bound(4 * (nv * s + b * t_len * (s + 1) + n_mat + b * s),
                    nv * (10 * s if banded else 2 * s * s + 4 * s))),
        "smoothing_pass": dict(
            max_abs_err=errs["gamma"],
            geometry=launch_geometry("smoothing_pass" + suffix, dev, s, 0, b),
            ms=entry_ms(lambda: cuda_scan.smoothing_pass(*smo, banded=banded),
                        ("smoothing_banded",) if banded else ("dense_grouped",)),
            wrapper_ms=cuda_ms(lambda: cuda_scan.smoothing_pass(*smo, banded=banded)),
            plain_ms=cuda_ms(lambda: cuda_scan.smoothing_pass_plain(*smo, banded=banded)),
            **bound(4 * (2 * nv * s + 2 * b * t_len * (s + 1) + n_mat + b * s),
                    nv * (16 * s if banded else 2 * s * s + 10 * s))),
    }
    return (probs, logcs, got), errs, rows


def check_general(errs, label):
    for key in ("alpha", "gamma", "w_probs"):
        check(errs[key] <= 1e-5, f"{label}: {key} abs {errs[key]}")
    for key in ("logcs", "w_sums", "post_norm"):
        check(errs[key] <= 1e-5, f"{label}: {key} rel {errs[key]}")
    check(errs["xi"] <= 1e-4, f"{label}: xi rel {errs['xi']}")


def reverse_instance(o, plain_reps=REPS):
    """K12's dense reverse (the β̂ pass) against its plain version (β̂ abs
    1e-5, logcs rel 1e-5); returns the errors and its timing row (alone, by
    profiler device time, and wrapped, with its launch geometry)."""
    rev = (o["e_llh"], o["lens"], o["trans"], o["final"])
    beta, blog = cuda_scan.scaled_pass(*rev, reverse=True)
    beta_p, blog_p = cuda_scan.scaled_pass_plain(*rev, reverse=True)
    errs = dict(beta=float((beta - beta_p).abs().max()), logcs=rel(blog, blog_p))
    del beta, blog, beta_p, blog_p
    b, t_len, s = o["e_llh"].shape
    check(errs["beta"] <= 1e-5 and errs["logcs"] <= 1e-5, f"scaled_pass reverse at S={s}: {errs}")
    nv = float(o["lens"].sum())
    return errs, dict(
        max_abs_err=errs["beta"],
        geometry=launch_geometry("scaled_pass_dense", o["e_llh"].device, s, 0, b),
        ms=entry_ms(lambda: cuda_scan.scaled_pass(*rev, reverse=True), ("dense_grouped",)),
        wrapper_ms=cuda_ms(lambda: cuda_scan.scaled_pass(*rev, reverse=True)),
        plain_ms=cuda_ms(lambda: cuda_scan.scaled_pass_plain(*rev, reverse=True), reps=plain_reps),
        **bound(4 * (nv * s + b * t_len * (s + 1) + s * s + b * s), nv * (2 * s * s + 5 * s)))


def llh_pair(llh, lens, trans, init, final, rows, cols):
    """K14 and K15 on these operands against their plain versions;
    returns the errors and the two timing rows."""
    fwd = (llh, lens, trans, init)
    got = cuda_scan.forward_llh_dense(*fwd, return_shifts=True)
    want = cuda_scan.forward_llh_dense_plain(*fwd, return_shifts=True)
    errs = dict(alpha=float((got[0] - want[0]).abs().max()), norms=rel(got[1], want[1]),
                logz_base=rel(got[3], want[3]), shifts=float((got[4] - want[4]).abs().max()))
    est = (llh, lens, trans, final, got[0], got[1])
    gamma, xi = cuda_scan.estep_gamma_dense(*est, rows=rows, cols=cols)
    gamma_p, xi_p = cuda_scan.estep_gamma_dense_plain(*est, rows=rows, cols=cols)
    errs.update(gamma=float((gamma - gamma_p).abs().max()), xi=rel(xi, xi_p))
    del want, gamma_p
    check(errs["alpha"] <= 1e-5 and errs["gamma"] <= 1e-5 and errs["shifts"] == 0.0
          and errs["norms"] <= 1e-5 and errs["logz_base"] <= 1e-5 and errs["xi"] <= 1e-4,
          f"forward_llh_shifts_dense / estep_gamma_dense_restricted: {errs}")
    b, t_len, s = llh.shape
    nv, n_xi = float(lens.sum()), rows.numel() * cols.numel()
    rows_out = {
        "forward_llh_shifts_dense": dict(
            max_abs_err=errs["alpha"],
            ms=cuda_ms(lambda: cuda_scan.forward_llh_dense(*fwd, return_shifts=True)),
            plain_ms=cuda_ms(lambda: cuda_scan.forward_llh_dense_plain(*fwd, return_shifts=True)),
            **bound(4 * (nv * s + b * t_len * (s + 2) + s * s + 3 * b * s + b),
                    nv * (2 * s * s + 4 * s))),
        "estep_gamma_dense_restricted": dict(
            max_abs_err=errs["gamma"],
            instance=launch_geometry("estep_gamma_dense_restricted", llh.device, s, 0, b,
                                     rc=(rows.numel(), cols.numel())),
            ms=entry_ms(lambda: cuda_scan.estep_gamma_dense(*est, rows=rows, cols=cols), ("estep_acc", "sum_rows")),
            wrapper_ms=cuda_ms(lambda: cuda_scan.estep_gamma_dense(*est, rows=rows, cols=cols)),
            plain_ms=cuda_ms(lambda: cuda_scan.estep_gamma_dense_plain(*est, rows=rows,
                                                                        cols=cols)),
            **k7_bound(lens, t_len, s, n_xi)),
    }
    return errs, rows_out


def phase_general_kernels(dev):
    """K12–K15 against their plain versions at the main path's shapes."""
    data, mask = make_data(B, T, D)
    data = np.concatenate([data, np.zeros((2, T, D), np.float32)])  # two zero-length rows
    mask = np.concatenate([mask, np.zeros((2, T), np.float32)])
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    o = general_operands(config4(dev), x, m)
    instances, errors = {}, {}
    dense_out, errors["dense"], instances["dense"] = general_instance(o, banded=False)
    check_general(errors["dense"], "dense S=150")
    band_out, errors["banded"], instances["banded"] = general_instance(o, banded=True)
    check_general(errors["banded"], "banded S=150")
    # the bands_to_dense route equals the banded one
    e_bd = dict(alpha=float((band_out[0] - dense_out[0]).abs().max()),
                logcs=rel(band_out[1], dense_out[1]),
                gamma=valid_err(band_out[2][0], dense_out[2][0], o["mask"]))
    check(max(e_bd.values()) <= 1e-5, f"banded vs dense instances: {e_bd}")
    check(float((tss.bands_to_dense(o["bands"]) - o["trans"]).abs().max()) <= 1e-7,
          "bands_to_dense != exp(log_trans)")
    del dense_out, band_out
    # the β̂ pass
    errors["reverse"], row = reverse_instance(o)
    instances["reverse"] = {"scaled_pass": row}
    # K14 / K15 at config 4's shape (the dense matrix, ξ on unit ends × starts)
    errors["llh_pair_config4"], pair4 = llh_pair(o["llh"], o["lens"], o["trans"], o["init"],
                                                 o["final"], o["ends"], o["starts"])
    del o
    # ... and at config 2's (ergodic, S = 30; ξ on every third row, every second column)
    hmm = config2(dev)
    _, c = hmm_operands(hmm, x, m)
    llh2 = hmm._state_llh(hmm.sufficient_statistics(x)).contiguous()
    init2 = torch.exp(hmm.graph_log_init).expand_as(c["final"]).contiguous()
    ids = torch.arange(HMM_S, device=dev, dtype=torch.int32)
    errors["llh_pair_config2"], pair2 = llh_pair(llh2, c["lens"], c["trans"], init2, c["final"],
                                                 ids[::3].contiguous(), ids[::2].contiguous())
    del llh2, c
    # the banded instances at S = 450, where no dense matrix fits a block
    big = general_operands(config4(dev, n_units=BIG_UNITS), x, m)
    band_out, errors["banded_450"], instances["banded_450"] = general_instance(big, banded=True)
    check_general(errors["banded_450"], f"banded S={BIG_UNITS * STATES_PER_UNIT}")
    # ... and the dense ones, whose matrix no block holds there: the global placement
    check(cuda_scan.dense_placement("scaled_pass", BIG_UNITS * STATES_PER_UNIT) == "global",
          "S = 450 takes the global placement")
    dense_out, errors["dense_450"], instances["dense_450"] = general_instance(big, banded=False)
    check_general(errors["dense_450"], f"dense (global) S={BIG_UNITS * STATES_PER_UNIT}")
    e_bd["gamma_450"] = valid_err(band_out[2][0], dense_out[2][0], big["mask"])
    check(e_bd["gamma_450"] <= 1e-5, f"banded vs dense instances at S=450: {e_bd}")
    errors["reverse_450"], row = reverse_instance(big)
    instances["reverse_450"] = {"scaled_pass": row}
    del big, band_out, dense_out
    # every instance at phase 18's 100-unit loop (S = 300: the dense ones global, K12 and K13 banded on the
    # block chain) and at config 5's (10 units, S = 30)
    for units in (LOOP_UNITS, SVAE_UNITS):
        ops = general_operands(config4(dev, n_units=units), x, m)
        s_u = units * STATES_PER_UNIT
        for name, banded in ((f"dense_{s_u}", False), (f"banded_{s_u}", True)):
            _, errors[name], instances[name] = general_instance(ops, banded=banded)
            check_general(errors[name], f"{name} S={s_u}")
        errors[f"reverse_{s_u}"], row = reverse_instance(ops)
        instances[f"reverse_{s_u}"] = {"scaled_pass": row}
        del ops
    torch.cuda.synchronize()

    def fmt(v):
        wrapped = f", wrapped {v['wrapper_ms']:.3f}" if "wrapper_ms" in v else ""
        geometry = f" {tuple(v['geometry'])}" if "geometry" in v else ""
        return (f"{v['ms']:.3f} ms{wrapped}{geometry} (plain {v['plain_ms']:.3f}, bound {v['bound_ms']:.3f} by "
                f"{v['bound_by']})")

    print(f"phase 15 general kernels: B={B}+2 empty T<={T}: "
          + "; ".join(f"{name} {inst}: {fmt(v)}" for inst, rows in instances.items()
                      for name, v in rows.items())
          + " | config 4 S=150: " + "; ".join(f"{k} {fmt(v)}" for k, v in pair4.items())
          + f" | config 2 S={HMM_S}: " + "; ".join(f"{k} {fmt(v)}" for k, v in pair2.items())
          + " | errors " + json.dumps({k: {n: float(f"{e:.3g}") for n, e in v.items()}
                                       for k, v in errors.items()})
          + f" | banded vs dense {json.dumps({k: float(f'{v:.3g}') for k, v in e_bd.items()})}"
          + " | dense S=450 through the global placement"
          + " | tol: alpha, gamma, w_probs abs 1e-5; logcs, w_sums, post_norm, norms rel 1e-5;"
            " xi rel 1e-4; shifts equal")
    return instances, dict(config4=pair4, config2=pair2)


def gsm_config(device, hierarchical=False, dtype=torch.float32, n_units=N_UNITS, spu=STATES_PER_UNIT,
               dim=D, embed=GSM_EMBED):
    """The subspace of the slice: a GSM over config 4's loop, or bench
    config 6's HierarchicalGSM over 3 languages of ``n_units`` units
    (bench.py:704-709), both with learned transitions."""
    gen = torch.Generator().manual_seed(3)
    if not hierarchical:
        return bt.GSM.create(n_units, embed, dim, states_per_unit=spu, learn_transitions=True,
                             generator=gen, dtype=dtype, device=device)
    unit_lang = [lang for lang in range(GSM_LANGS) for _ in range(n_units)]
    return bt.HierarchicalGSM.create(n_units * GSM_LANGS, embed, dim, lang_dim=GSM_LANG_DIM,
                                     n_langs=GSM_LANGS, unit_lang=unit_lang, states_per_unit=spu,
                                     learn_transitions=True, generator=gen, dtype=dtype,
                                     device=device)


def synthetic_unit_stats(u, p, d, device, seed=5):
    """Per-unit-state statistics in ``accumulate_unit_stats``' dict layout,
    as the bench makes them (bench.py:682-695, 712-717)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(500.0, 2000.0, size=(u, p, 1)).astype(np.float32)
    mu = rng.normal(size=(u, p, 1, d)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=(u, p, 1, d)).astype(np.float32)
    cc = c[..., None]
    shape = mu.shape
    emission = np.concatenate([-0.5 * cc * (var + mu**2), cc * mu, np.broadcast_to(-0.5 * cc, shape),
                               np.broadcast_to(0.5 * cc, shape)], axis=-1)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {"emission": to(emission), "comp_counts": to(c), "self": to(0.9 * c[..., 0]),
            "adv": to(0.1 * c[..., 0])}


def gsm_reference_check(dev):
    """Small problems on the card (float32, kernels) against the float64
    general path on the CPU: the per-unit statistics with transitions
    (rel 1e-4), and the GSM ELBO and its gradients on the same noise."""
    data, mask = make_data(6, 40, 4, seed=3)
    mask[-1] = 0.0
    ref = config4("cpu", n_units=5, spu=3, dim=4, dtype=torch.float64)
    ref.plain_scan = True
    card = copy.deepcopy(ref).to(device=dev, dtype=torch.float32)
    card.plain_scan = False
    x64, m64 = torch.from_numpy(data).double(), torch.from_numpy(mask).double()
    want, want_counts = bt.accumulate_unit_stats(ref, x64, m64, transitions=True)
    got, got_counts = bt.accumulate_unit_stats(card, x64.float().to(dev), m64.float().to(dev),
                                               transitions=True)
    for key in want:
        e = rel(got[key].double().cpu(), want[key])
        check(e <= 1e-4, f"small problem: unit statistics {key} rel {e} vs float64")
    check(rel(got_counts.double().cpu(), want_counts) <= 1e-4, "small problem: unit counts")
    gsm64 = gsm_config("cpu", dtype=torch.float64, n_units=5, dim=4, embed=3)
    gsm32 = copy.deepcopy(gsm64).to(device=dev, dtype=torch.float32)
    eps = gsm64.sample_eps(torch.Generator().manual_seed(1), GSM_NSAMPLES)
    gsm64.elbo(want, eps=eps).backward()
    gsm32.elbo({k: v.float().to(dev) for k, v in want.items()},
               eps={k: v.float().to(dev) for k, v in eps.items()}).backward()
    for p, q in zip(gsm32.parameters(), gsm64.parameters()):
        check(rel(p.grad.double().cpu(), q.grad) <= 1e-4, "small problem: GSM gradient vs float64")


def capturable_adam(model):
    """The optimizer of a captured GSM step: Adam with its step count on the card."""
    return torch.optim.Adam(model.parameters(), lr=GSM_LR, capturable=True)


def eager_gsm(model, stats, eps, n):
    """``n`` eager steps (``make_gsm_train_step``, capturable Adam) from a
    copy of ``model`` on the noise stack: every step's ELBO and the model."""
    m = copy.deepcopy(model)
    step = bt.make_gsm_train_step(capturable_adam(m), GSM_NSAMPLES)
    return torch.stack([step(m, stats, eps={k: v[i] for k, v in eps.items()})
                        for i in range(n)]), m


def graph_gsm(model, stats, eps, n):
    """The same steps through ``make_gsm_train_scan`` from copies of
    ``model``: one call of ``n`` steps (its last ELBO and model), and ``n``
    one-step calls that replay one captured graph (every step's ELBO, the
    model)."""
    whole = copy.deepcopy(model)
    last = bt.make_gsm_train_scan(capturable_adam(whole), GSM_NSAMPLES)(whole, stats, nsteps=n,
                                                                          eps=eps)
    single = copy.deepcopy(model)
    run = bt.make_gsm_train_scan(capturable_adam(single), GSM_NSAMPLES)
    elbos = torch.stack([run(single, stats, nsteps=1, eps={k: v[i:i + 1] for k, v in eps.items()})
                         for i in range(n)])
    return last, whole, elbos, single


def model_gap(a, b):
    """The largest parameter difference, relative to each parameter's largest entry."""
    return max(rel(p.detach(), q.detach()) for p, q in zip(a.parameters(), b.parameters()))


def steps_rel(got, want):
    """The largest relative difference of two runs' ELBOs, step by step."""
    return float(((got - want).abs() / want.abs()).max())


def graph_vs_eager(model, stats, n, gen, label):
    """The CUDA graph against the eager loop on the same noise from the
    same start, and a second eager run against the first: bitwise where
    the eager runs are (no atomic adds in the step), otherwise every
    step's ELBO within 1e-5 and the parameters within 1e-4 relative, no
    farther from the eager run than the second eager run is, within ten
    times its gap (the graph is one more run of the same arithmetic)."""
    eps = {k: torch.randn((n, *shape), generator=gen, device=model.e_mean.device)
           for k, shape in model._eps_spec(GSM_NSAMPLES).items()}
    e1, m1 = eager_gsm(model, stats, eps, n)
    e2, m2 = eager_gsm(model, stats, eps, n)
    last, whole, eg, single = graph_gsm(model, stats, eps, n)
    torch.cuda.synchronize()
    gaps = dict(eager_elbo=steps_rel(e2, e1), eager_params=model_gap(m2, m1),
                graph_elbo=max(steps_rel(eg, e1), steps_rel(last, e1[-1])),
                graph_params=max(model_gap(whole, m1), model_gap(single, m1)))
    bitwise = dict(eager=gaps["eager_elbo"] == 0 and gaps["eager_params"] == 0,
                   graph=gaps["graph_elbo"] == 0 and gaps["graph_params"] == 0)
    if bitwise["eager"]:
        check(bitwise["graph"], f"{label}: the graph is not the eager loop to the bit: {gaps}")
    else:
        check(gaps["graph_elbo"] <= 1e-5 and gaps["graph_params"] <= 1e-4,
              f"{label}: the graph against the eager loop: {gaps}")
        check(gaps["graph_elbo"] <= 10 * gaps["eager_elbo"]
              and gaps["graph_params"] <= 10 * gaps["eager_params"],
              f"{label}: the graph is farther from the eager loop than a second eager run: {gaps}")
    check(bool(torch.isfinite(eg).all()), f"{label}: graph ELBO not finite")
    return eg, single, dict(bitwise=bitwise, **{k: float(f"{v:.3g}") for k, v in gaps.items()})


def generator_draws(model, stats, n, seed):
    """The scan drawing its noise from a registered generator against the
    eager loop from the same generator state (capturable Adam on both):
    whether the parameters agree, and whether both generators stand at
    the same state afterwards."""
    dev = model.e_mean.device
    a, b = copy.deepcopy(model), copy.deepcopy(model)
    ga, gb = bt.train_key(seed, dev), bt.train_key(seed, dev)
    bt.make_gsm_train_scan(capturable_adam(a), GSM_NSAMPLES)(a, stats, generator=ga, nsteps=n)
    bt.train_gsm(b, capturable_adam(b), stats, generator=gb, nsteps=n, nsamples=GSM_NSAMPLES)
    return dict(same_parameters=model_gap(a, b) == 0, params_rel=float(f"{model_gap(a, b):.3g}"),
                same_next_draw=bool(torch.equal(torch.randn(8, generator=ga, device=dev),
                                                torch.randn(8, generator=gb, device=dev))))


def rising(elbos, n):
    """Means of the first and the last ``n`` values; the latter must be larger."""
    first, last = float(elbos[:n].mean()), float(elbos[-n:].mean())
    return first, last


def phase_gsm_slice(dev):
    data, mask = make_data(B, T, D)
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    frames = float(mask.sum())
    loop = config4(dev)
    cuda_scan.reset_launch_counts()
    elbos = [float(bt.vb_step(loop, x, mask=m)[0]) for _ in range(2)]
    before = {k: v.launches for k, v in cuda_scan.KERNELS.items()}

    # the statistics bridge: PhoneLoop.smooth through K12 + K13
    stats, counts = bt.accumulate_unit_stats(loop, x, m, transitions=True)
    torch.cuda.synchronize()
    bridge = {k: v.launches - before[k] for k, v in cuda_scan.KERNELS.items()
              if v.launches != before[k]}
    check(bridge == {"scaled_pass": 1, "smoothing_pass": 1},
          f"accumulate_unit_stats: launches {bridge}, expected K12 1, K13 1 and no other")
    stats_plain, counts_plain = bt.accumulate_unit_stats(plain_twin(loop), x, m, transitions=True)
    e_stats = {k: rel(stats[k], stats_plain[k]) for k in stats}
    check(max(e_stats.values()) <= 1e-4, f"unit statistics vs the plain route: {e_stats}")
    e_counts = abs(float(counts.sum(dtype=torch.float64)) - frames) / frames
    check(e_counts <= 1e-5, f"unit counts sum to {float(counts.sum())} of {frames} frames")
    n_trans = float((m.sum(-1) - 1).clamp_min(0).sum()) + float((m.sum(-1) > 0).sum())
    e_trans = abs(float((stats["self"] + stats["adv"]).sum(dtype=torch.float64)) - n_trans) / n_trans
    check(e_trans <= 1e-4, f"self + adv counts sum to a share {1 + e_trans} of the transitions")

    # the subspace: 200 Adam steps on the GSM ELBO through the CUDA graph
    # of make_gsm_train_scan, against the eager loop on the same noise
    start = gsm_config(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    gsm_elbos, gsm, gsm_graph = graph_vs_eager(start, stats, GSM_STEPS, gen, "GSM")
    first, last = rising(gsm_elbos, 20)
    check(last > first, f"GSM ELBO did not rise: first 20 {first}, last 20 {last}")

    # the write-back: E[T] of the emissions equals the moments it was matched to
    eps = gsm.sample_eps(gen, GSM_WRITEBACK_SAMPLES)
    mom = bt.induced_posterior_moments(gsm, eps=eps)
    bt.apply_to_phoneloop(gsm, loop, eps=eps)
    e_t = loop.modelset.means_precisions.expected_sufficient_statistics()
    e_mom = {name: rel(e_t[:, i * D:(i + 1) * D], mom[name].reshape(-1, D))
             for i, name in enumerate(("e_lam", "e_lam_mu", "e_lam_mu2", "e_log_lam"))}
    check(max(e_mom.values()) <= 1e-3, f"written-back E[T] vs the matched moments: {e_mom}")
    check(loop.log_exit is not None and bool(torch.isfinite(loop.log_exit).all()),
          "write-back: log_exit")
    elbos.append(float(bt.vb_step(loop, x, mask=m)[0]))
    check(bool(np.isfinite(elbos).all()), f"phone-loop ELBO not finite: {elbos}")
    units, scores = loop.decode_units(x, m)
    check(units.shape == (B, T) and bool(torch.isfinite(scores).all()), "decode after write-back")

    # the main path ends here: its launches are read before any comparison
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in cuda_scan.KERNELS.items()}
    need = ("scaled_pass", "smoothing_pass", "forward_llh_banded", "estep_acc_banded")
    check(all(launches[k] > 0 for k in need), f"a kernel was not launched: {launches}")

    # the log-domain route: K12 forward + reverse
    o = general_operands(loop, x, m)
    g = o["graph"]
    fb = tss.forward_backward(o["llh"], g.log_trans, g.log_init, g.log_final, m)
    check(cuda_scan.KERNELS["scaled_pass"].launches - launches["scaled_pass"] == 2,
          "forward_backward: expected K12 twice (forward, reverse)")
    fbp = tss.forward_backward_probs(o["llh"], g.log_trans, g.log_init, g.log_final, m)
    e_logz = rel(fb.log_z, fbp.log_z)
    e_gamma = float((fb.posteriors - fbp.posteriors).abs().max())
    sel = fbp.posteriors > 1e-3
    e_gamma_rel = float(((fb.posteriors - fbp.posteriors).abs()[sel] / fbp.posteriors[sel]).max())
    # float32 log α + log β carry a rounding of about 1e-3 each at |1e4|,
    # which the softmax turns into a relative error of γ of that order
    check(e_logz <= 1e-5 and e_gamma <= 2e-3 and e_gamma_rel <= 1e-2,
          f"forward_backward vs probs: log Z rel {e_logz}, gamma abs {e_gamma}, "
          f"rel {e_gamma_rel} where gamma > 1e-3")
    del fb, sel
    # K14 + K15 through their entry points, against the general path
    alpha, norms, shifts = tss.forward_llh(o["llh"], o["trans"], o["init"], o["lens"])
    gamma, xi_raw = tss.phone_loop_estep(o["llh"], alpha, norms, o["trans"], o["final"], o["lens"],
                                         o["ends"], o["starts"])
    tiny = torch.finfo(torch.float32).tiny
    log_z = torch.log(norms).sum(1) + shifts.sum(1) + torch.log(
        (alpha[:, -1] * o["final"]).sum(-1).clamp_min(tiny))
    xi = tss.expected_transition_counts_probs(fbp, g.log_trans, m, rows=o["ends"].long(),
                                              cols=o["starts"].long())
    e_pair = dict(log_z=rel(log_z, fbp.log_z), gamma=float((gamma - fbp.posteriors).abs().max()),
                  xi=rel(xi_raw * o["trans"][o["ends"].long()][:, o["starts"].long()], xi))
    check(e_pair["log_z"] <= 1e-5 and e_pair["gamma"] <= 1e-4 and e_pair["xi"] <= 1e-3,
          f"forward_llh + phone_loop_estep vs the general path: {e_pair}")
    del alpha, gamma, fbp, o
    gsm_reference_check(dev)

    # the noise drawn inside the graph from a registered generator
    draws = generator_draws(start, stats, 20, 13)

    # the H-SHMM gradient step at bench config 6's shape, graph against eager
    hstats = synthetic_unit_stats(N_UNITS * GSM_LANGS, STATES_PER_UNIT, D, dev)
    h_elbos, hgsm, hshmm_graph = graph_vs_eager(gsm_config(dev, hierarchical=True), hstats, 50,
                                                gen, "H-SHMM")
    h_first, h_last = rising(h_elbos, 10)
    check(bool(torch.isfinite(h_elbos).all()) and h_last > h_first,
          f"H-SHMM ELBO: first 10 {h_first}, last 10 {h_last}")
    sub = bt.slice_gsm(hgsm, 1, N_UNITS)
    check(sub.e_mean.shape == (N_UNITS, GSM_EMBED + GSM_LANG_DIM), "slice_gsm shape")
    bt.apply_to_phoneloop(sub, config4(dev), generator=gen, nsamples=GSM_WRITEBACK_SAMPLES)
    fmt = lambda d_: json.dumps({k: float(f"{v:.3g}") for k, v in d_.items()})  # noqa: E731
    print(f"phase 16 gsm slice: B={B} T<={T} D={D} S={N_UNITS * STATES_PER_UNIT} frames={frames:.0f} "
          f"| loop ELBO/frame (2 VB steps, then after the write-back) "
          f"{', '.join(f'{e / frames:.6f}' for e in elbos)} | accumulate_unit_stats launches "
          f"{bridge}, vs plain route rel {fmt(e_stats)}, counts-sum rel error {e_counts:.3g}, "
          f"self+adv rel error {e_trans:.3g} | GSM U={N_UNITS} E={GSM_EMBED} {GSM_STEPS} Adam steps "
          f"lr {GSM_LR} x{GSM_NSAMPLES} samples through the CUDA graph: ELBO first 20 {first:.6g} "
          f"-> last 20 {last:.6g}; graph vs eager on the same noise {json.dumps(gsm_graph)}; "
          f"noise from a registered generator vs the eager loop {json.dumps(draws)} "
          f"| write-back ({GSM_WRITEBACK_SAMPLES} samples) E[T] vs moments rel {fmt(e_mom)} "
          f"| forward_backward vs probs: log Z rel {e_logz:.3g}, gamma abs {e_gamma:.3g}, rel "
          f"{e_gamma_rel:.3g} where gamma > 1e-3 "
          f"| forward_llh + phone_loop_estep vs general path {fmt(e_pair)} "
          f"| H-SHMM {GSM_LANGS}x{N_UNITS} units, 50 steps through the graph: ELBO first 10 "
          f"{h_first:.6g} -> last 10 {h_last:.6g}; graph vs eager {json.dumps(hshmm_graph)} "
          f"| tol: graph vs eager bitwise where two eager runs are, else ELBO 1e-5 and parameters "
          f"1e-4 relative | launches of the outer iteration {({k: v for k, v in launches.items() if v})} "
          f"| small problems agree with float64")
    return launches, (x, m, stats, hstats)


def outer_iteration(loop, gsm, run, gen, x, m):
    """One subspace-HMM outer iteration, its gradient steps through the
    scan ``run`` (as ``shmm train`` runs them); returns the loop's last ELBO."""
    for _ in range(2):
        bt.vb_step(loop, x, mask=m)
    stats, _ = bt.accumulate_unit_stats(loop, x, m, transitions=True)
    run(gsm, stats, generator=gen, nsteps=GSM_STEPS)
    bt.apply_to_phoneloop(gsm, loop, generator=gen, nsamples=GSM_WRITEBACK_SAMPLES)
    return bt.vb_step(loop, x, mask=m)[0]


def phase_gsm_times(dev, runs, kernel_rows):
    x, m, stats, hstats = runs
    frames = float(m.sum())
    times = {}
    loop = config4(dev)
    bt.vb_step(loop, x, mask=m)
    suff = loop.sufficient_statistics(x)
    graph = loop._effective_graph()
    # smooth takes the banded instances; the same work through the dense ones
    times["smooth_dense_ms"] = cuda_ms(lambda: tss.forward_backward_probs(
        loop.modelset.expected_log_likelihood(suff), graph.log_trans, graph.log_init,
        graph.log_final, m))
    times["smooth_banded_ms"] = cuda_ms(lambda: loop.smooth(suff, m))
    plain = plain_twin(loop)
    times["smooth_plain_ms"] = cuda_ms(lambda: plain.smooth(suff, m), reps=3)
    big = config4(dev, n_units=BIG_UNITS)
    big_suff = big.sufficient_statistics(x)
    times["smooth_banded_s450_ms"] = cuda_ms(lambda: big.smooth(big_suff, m), reps=3)
    del big, big_suff
    times["accumulate_unit_stats_kernel_ms"] = cuda_ms(
        lambda: bt.accumulate_unit_stats(loop, x, m, transitions=True))
    times["accumulate_unit_stats_plain_ms"] = cuda_ms(
        lambda: bt.accumulate_unit_stats(plain, x, m, transitions=True), reps=3)
    times["accumulate_unit_stats_frames_per_s"] = round(
        frames / times["accumulate_unit_stats_kernel_ms"] * 1e3)
    profiles = {"accumulate_unit_stats": profile_step(
        lambda: bt.accumulate_unit_stats(loop, x, m, transitions=True))}
    gen = torch.Generator(device=dev).manual_seed(12)
    n = 50
    # eager (train_gsm, the default Adam) and the CUDA graph of
    # make_gsm_train_scan (capturable Adam) in turns, each its median over
    # REPS runs of n steps
    for name, model, st in (("gsm", gsm_config(dev), stats),
                            ("hshmm", gsm_config(dev, hierarchical=True), hstats)):
        opt = torch.optim.Adam(model.parameters(), lr=GSM_LR)
        twin = copy.deepcopy(model)
        scan = bt.make_gsm_train_scan(capturable_adam(twin), GSM_NSAMPLES)
        eager = lambda: bt.train_gsm(model, opt, st, generator=gen, nsteps=n,  # noqa: E731
                                     nsamples=GSM_NSAMPLES)
        graph = lambda: scan(twin, st, generator=gen, nsteps=n)  # noqa: E731
        for tag in ("eager", "graph", "graph", "eager"):
            times.setdefault(f"{name}_{tag}_step_ms", []).append(
                cuda_ms(eager if tag == "eager" else graph) / n)
        for tag in ("eager", "graph"):
            ms = float(np.min(times[f"{name}_{tag}_step_ms"]))
            times[f"{name}_{tag}_steps_per_s"] = round(1e3 / ms)
        times[f"{name}_graph_speedup"] = round(
            min(times[f"{name}_eager_step_ms"]) / min(times[f"{name}_graph_step_ms"]), 2)
        profiles[f"{name}_step"] = profile_step(lambda: bt.train_gsm(
            model, opt, st, generator=gen, nsteps=1, nsamples=GSM_NSAMPLES))
        profiles[f"{name}_graph_{n}_steps"] = profile_step(graph)
        if name == "gsm":
            times["writeback_ms"] = cuda_ms(lambda: bt.apply_to_phoneloop(
                model, loop, generator=gen, nsamples=GSM_WRITEBACK_SAMPLES))
    # two outer iterations of one model: the first captures the graph
    gsm, outer_loop = gsm_config(dev), config4(dev)
    run = bt.make_gsm_train_scan(capturable_adam(gsm), GSM_NSAMPLES)
    times["outer_iteration_s"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        elbo = float(outer_iteration(outer_loop, gsm, run, gen, x, m))
        torch.cuda.synchronize()
        times["outer_iteration_s"].append(round(time.perf_counter() - t0, 4))
        check(np.isfinite(elbo), "outer iteration: ELBO not finite")
    print("phase 17 gsm times: " + json.dumps(
        {**{k: round(v, 4) if isinstance(v, float) else [round(u, 4) for u in v]
            if isinstance(v, list) else v for k, v in times.items()},
         "kernels_ms": {f"{name}_{inst}": round(v["ms"], 3) for inst, rows in kernel_rows.items()
                        for name, v in rows.items()},
         "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
         "profiles": profiles}))


# ----------------------------------------------------------------------
# Every S the reference takes: the dense kernels' global placement
# ----------------------------------------------------------------------
LARGE_S, LARGE_B, LARGE_T = 300, 64, 200   # an ergodic HMM above every dense kernel's limit
SHARED_S = 150                             # the same at a size whose operands mostly fit a block
CHAIN_PHONES, CHAIN_T = 60, 240            # a shared chain of 60 phones × 3 states (S = 180)
LOOP_UNITS = 100                           # a phone loop above K2's first limit (95 units): S = 300
BIG_LOOP_UNITS = 250                       # S = 750: K1 and K11 in their global placement too
VIT_UNITS, VIT_B = 3200, 8                 # K3 near the per-frame kernel's limit (S = 9,674): S = 9,600


def dense_rows(hmm, x, m):
    """Every dense kernel on an ergodic HMM's operands against its plain
    version: K5 on the statistics and on the llh stream, K6, K7, K14, K15,
    K12 (dense forward and reverse) and K13 (dense).  Returns the timing
    rows, each with the placement its wrapper took, and the errors."""
    stats, c = hmm_operands(hmm, x, m)
    lens, trans, final = c["lens"], c["trans"], c["final"]
    init = torch.exp(hmm.graph_log_init).expand_as(final).contiguous()
    tiny = torch.finfo(torch.float32).tiny
    full = lens > 0
    b, t_len, p_dim = stats.shape
    s = trans.shape[0]
    nv = float(lens.sum())
    rows, errs = {}, {}
    fwd = (stats, lens, trans, init, c["w"], c["bias"])
    k5, p5 = cuda_scan.forward_llh_dense(*fwd), cuda_scan.forward_llh_dense_plain(*fwd)
    logz = [o[3] + torch.log((o[2] * final).sum(-1).clamp_min(tiny)) for o in (k5, p5)]
    errs["forward_llh_dense"] = dict(log_z=rel(logz[0][full], logz[1][full]),
                                     alpha=float((k5[0] - p5[0]).abs().max()))
    rows["forward_llh_dense"] = dict(
        max_abs_err=float((logz[0][full] - logz[1][full]).abs().max()),
        ms=cuda_ms(lambda: cuda_scan.forward_llh_dense(*fwd)),
        plain_ms=cuda_ms(lambda: cuda_scan.forward_llh_dense_plain(*fwd), reps=3),
        **forward_dense_bound(lens, t_len, s, p_dim))
    est = (stats, lens, c["w"], c["bias"], trans, final, k5[0], k5[1])
    k6, p6 = cuda_scan.estep_acc_dense(*est), cuda_scan.estep_acc_dense_plain(*est)
    errs["estep_acc_dense"] = dict(acc2=rel(k6[0], p6[0]), counts=rel(k6[1], p6[1]),
                                   xi=rel(k6[3], p6[3]), gamma0=float((k6[2] - p6[2]).abs().max()))
    rows["estep_acc_dense"] = dict(
        max_abs_err=float((k6[0] - p6[0]).abs().max()),
        ms=cuda_ms(lambda: cuda_scan.estep_acc_dense(*est)),
        plain_ms=cuda_ms(lambda: cuda_scan.estep_acc_dense_plain(*est), reps=3),
        **bound(4 * (nv * (p_dim + s + 1) + s * (2 * s + 2 * p_dim + 1) + 2 * b * s),
                nv * (4 * s * p_dim + 4 * s * s + 10 * s)))
    del k5, p5, k6, p6
    llh = hmm._state_llh(stats).contiguous()
    f7 = cuda_scan.forward_llh_dense(llh, lens, trans, init)
    gam = (llh, lens, trans, final, f7[0], f7[1])
    k7, p7 = cuda_scan.estep_gamma_dense(*gam), cuda_scan.estep_gamma_dense_plain(*gam)
    errs["estep_gamma_dense"] = dict(gamma=float((k7[0] - p7[0]).abs().max()), xi=rel(k7[1], p7[1]))
    rows["estep_gamma_dense"] = dict(
        max_abs_err=errs["estep_gamma_dense"]["gamma"],
        ms=entry_ms(lambda: cuda_scan.estep_gamma_dense(*gam), ("estep_acc", "sum_rows")),
        wrapper_ms=cuda_ms(lambda: cuda_scan.estep_gamma_dense(*gam)),
        plain_ms=cuda_ms(lambda: cuda_scan.estep_gamma_dense_plain(*gam), reps=3),
        **k7_bound(lens, t_len, s))
    del f7, k7, p7
    for name in ("forward_llh_dense", "estep_acc_dense", "estep_gamma_dense"):
        e = errs[name]
        check(all(v <= (1e-4 if k in ("acc2", "counts", "xi") else 1e-5) for k, v in e.items()),
              f"{name} at S={s}: {e}")
    ids = torch.arange(s, device=x.device, dtype=torch.int32)
    errs["llh_pair"], pair = llh_pair(llh, lens, trans, init, final, ids[::3].contiguous(),
                                      ids[::2].contiguous())
    rows.update(pair)
    # the general path's dense instances, on one shared matrix
    log_trans = hmm._effective_log_trans()
    e_llh, _ = tss._scaled_likelihoods(llh, m)
    o = dict(e_llh=e_llh.contiguous(), lens=lens, trans=trans, init=init, final=final, mask=m,
             graph=types.SimpleNamespace(log_trans=log_trans))
    _, errs["general"], general = general_instance(o, banded=False)
    check_general(errs["general"], f"dense general path S={s}")
    rows.update(general)
    errs["reverse"], rows["scaled_pass_reverse"] = reverse_instance(o, plain_reps=3)
    for name, row in rows.items():
        p = p_dim if name in ("forward_llh_dense", "estep_acc_dense") else 0
        n_rc = (ids[::3].numel(), ids[::2].numel()) if name == "estep_gamma_dense_restricted" else (0, 0)
        kernel = "scaled_pass" if name == "scaled_pass_reverse" else name
        row["placement"] = cuda_scan.dense_placement(kernel, s, p, *n_rc)
    return rows, errs


def banded_rows(loop, x, m):
    """K1, K2 and K11 on a phone loop's operands against their plain
    versions, each row with the placement (K1, K2: the geometry) its wrapper
    took; returns the rows and the errors."""
    stats = loop.sufficient_statistics(x).contiguous()
    ops = loop.scan_operands(stats, m)
    fwd = (stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["init"])
    full = ops["lens"] > 0
    tiny = torch.finfo(torch.float32).tiny
    b, t_len, p_dim = stats.shape
    s, n_u = ops["w"].shape[0], ops["ends"].shape[0]
    nv = float(ops["lens"].sum())
    k1, p1 = cuda_scan.forward_llh_banded(*fwd), cuda_scan.forward_llh_banded_plain(*fwd)
    logz = [o[3] + torch.log((o[2] * ops["final"]).sum(-1).clamp_min(tiny)) for o in (k1, p1)]
    errs = {"forward_llh_banded": dict(log_z=rel(logz[0][full], logz[1][full]),
                                       alpha=float((k1[0] - p1[0]).abs().max()))}
    est = banded_estep_args(stats, ops, k1[0], k1[1])
    k2, p2 = cuda_scan.estep_acc_banded(*est), cuda_scan.estep_acc_banded_plain(*est)
    errs["estep_acc_banded"] = dict(acc2=rel(k2[0], p2[0]), counts=rel(k2[1], p2[1]), xi=rel(k2[3], p2[3]),
                                    gamma0=float((k2[2] - p2[2]).abs().max()))
    k11, errs["estep_gamma_banded"] = k11_row(est, reps=3)
    for name, e in errs.items():
        check(all(v <= (1e-4 if k in ("acc2", "counts", "xi") else 1e-5) for k, v in e.items()),
              f"{name} at {n_u} units (S={s}): {e}")
    rows = {
        "forward_llh_banded": dict(
            max_abs_err=float((logz[0][full] - logz[1][full]).abs().max()),
            ms=entry_ms(lambda: cuda_scan.forward_llh_banded(*fwd), ("forward_llh_chunked",)),
            wrapper_ms=cuda_ms(lambda: cuda_scan.forward_llh_banded(*fwd)),
            plain_ms=cuda_ms(lambda: cuda_scan.forward_llh_banded_plain(*fwd), reps=3),
            **k1_bound(ops["lens"], t_len, s, p_dim)),
        "estep_acc_banded": dict(
            max_abs_err=float((k2[0] - p2[0]).abs().max()),
            ms=cuda_ms(lambda: cuda_scan.estep_acc_banded(*est)),
            plain_ms=cuda_ms(lambda: cuda_scan.estep_acc_banded_plain(*est), reps=3),
            **bound(4 * (nv * (p_dim + s + 1) + 2 * s * p_dim + b * s + n_u * n_u),
                    nv * (4 * s * p_dim + 2 * n_u * n_u + 12 * s))),
        "estep_gamma_banded": k11}
    dev = stats.device
    for name, row in rows.items():
        row["placement"] = "_".join(map(str, launch_geometry(name, dev, s, p_dim, b, n_u)))
    return rows, errs


def viterbi_rows(dev, x, m):
    """K3 and K4 on the operands each model's decode gives them: config 3
    (the recognizer's decode, S = 18, B = 128, per-row log_final), the
    unit decodes of the phone loops of LOOP_UNITS and BIG_LOOP_UNITS units
    over ``x`` (S = 300 and 750) and of VIT_UNITS units (S = 9,600, near
    the largest S the per-frame K3 took) over VIT_B of its rows; returns
    the K3 rows, the K4 rows and the mismatches of both."""
    data, mask, seqs = config3_data()
    x3, m3 = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    rec = config3(dev, seqs)
    decodes = {"config3": lambda: rec.decode(x3, m3)}
    for units, rows in ((LOOP_UNITS, None), (BIG_LOOP_UNITS, None), (VIT_UNITS, VIT_B)):
        loop = config4(dev, n_units=units)
        decodes[f"u{units}"] = lambda loop=loop, rows=rows: loop.decode_units(x[:rows], m[:rows])
    k3_rows, k4_rows, mismatches = {}, {}, {}
    for tag, decode in decodes.items():
        vit, back = decode_args(decode)
        if tag == "config3" or tag == f"u{VIT_UNITS}":
            k3_rows[tag], mismatches[f"k3_{tag}"] = k3_row(vit, back[3], reps=3)
            k3_rows[tag]["placement"] = "_".join(map(str, k3_rows[tag]["geometry"]))
        k4_rows[tag], mismatches[f"k4_{tag}"] = k4_row(back, vit[1], reps=3)
        k4_rows[tag]["placement"] = "_".join(map(str, k4_rows[tag]["geometry"]))
        del vit, back
    return k3_rows, k4_rows, mismatches


def large_estep(model, x, m):
    """log Z, posteriors and ξ counts of one E-step, then the ELBO of one
    VB step (the model is updated)."""
    stats = model.sufficient_statistics(x)
    log_z, cache = model.infer(stats, m)
    xi = model.expected_transition_counts(cache)
    post = model.posteriors(x, m)
    return log_z, post, xi, float(bt.vb_step(model, x, mask=m)[0])


def phase_large_dense(dev):
    """The dense kernels at sizes whose operands no block's shared memory
    holds (ROADMAP C.1): every dense kernel against its plain version on
    an ergodic HMM at S = 300 (global placement) and at S = 150 (shared,
    but K6's at P = 78), then the paths: a VB step, the posteriors and the
    ξ counts of the ergodic HMM at S = 300 and of a 60-phone × 3-state
    shared transcription chain (S = 180, llh route), with the launch
    counters read around them, against the plain route; last, phone loops
    above the banded kernels' shared limits: K1, K2 and K11 against their
    plain versions at 100 units (S = 300: K2 global) and 250 (S = 750: all
    three global), then two VB steps of the 100-unit loop through K1 + K2
    against the plain route (the second step's ELBO reads the statistics
    K2 gave the first update), its launches read around them."""
    data, mask = make_data(LARGE_B, LARGE_T, D, seed=8)
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    rows, errs = {}, {}
    for s in (SHARED_S, LARGE_S):
        rows[s], errs[s] = dense_rows(config2(dev, s=s), x, m)
    check(all(r["placement"] == "global" for r in rows[LARGE_S].values()),
          f"S={LARGE_S}: every dense kernel takes the global placement")
    rng = np.random.default_rng(9)
    seqs = [list(rng.integers(REC_PHONES, size=CHAIN_PHONES - (i % 3) * 5)) for i in range(LARGE_B)]
    xc = torch.from_numpy(rng.normal(size=(LARGE_B, CHAIN_T, D)).astype(np.float32)).to(dev)
    mc = torch.from_numpy((np.arange(CHAIN_T)[None] < rng.integers(200, CHAIN_T + 1, size=(LARGE_B, 1)))
                          .astype(np.float32)).to(dev)
    paths = {"ergodic": (config2(dev, s=LARGE_S), x, m), "chain": (config3(dev, seqs), xc, mc)}
    check(paths["chain"][0].n_states == CHAIN_PHONES * REC_SPP and paths["chain"][0].route() == "llh",
          "the chain: S = 180 on the llh route")
    twins = {name: plain_twin(model) for name, (model, _, _) in paths.items()}
    cuda_scan.reset_launch_counts()
    got = {name: large_estep(model, xx, mm) for name, (model, xx, mm) in paths.items()}
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in cuda_scan.KERNELS.items()}
    need = ("forward_llh_dense", "estep_acc_dense", "estep_gamma_dense")
    check(all(launches[k] > 0 for k in need), f"a kernel was not launched: {launches}")
    gaps = {}
    for name, (_, xx, mm) in paths.items():
        want = large_estep(twins[name], xx, mm)
        full = mm.sum(-1) > 0
        gaps[name] = dict(log_z=rel(got[name][0][full], want[0][full]),
                          gamma=float((got[name][1] - want[1]).abs().max()),
                          xi=rel(got[name][2], want[2]), elbo=abs(got[name][3] - want[3]) / abs(want[3]))
        g = gaps[name]
        check(g["log_z"] <= 1e-5 and g["gamma"] <= 1e-5 and g["xi"] <= 1e-4 and g["elbo"] <= 1e-5,
              f"{name}: kernel vs plain route {g}")
    # phone loops above the banded kernels' shared limits (P = 78): each kernel
    # against its plain version, then two VB steps through K1 + K2
    loop_rows = {}
    for units in (LOOP_UNITS, BIG_LOOP_UNITS):
        loop_rows[units], errs[f"loop{units}"] = banded_rows(config4(dev, n_units=units), x, m)
    check(launch_geometry("forward_llh_banded", dev, 3 * BIG_LOOP_UNITS, 2 * D, x.shape[0])[0] == "global"
          and loop_rows[BIG_LOOP_UNITS]["estep_gamma_banded"]["placement"].startswith("global"),
          f"{BIG_LOOP_UNITS} units: K1 and K11 take the global placement")
    loop = config4(dev, n_units=LOOP_UNITS)
    twin = plain_twin(loop)
    geometry = launch_geometry("estep_acc_banded", dev, 3 * LOOP_UNITS, 2 * D, x.shape[0], LOOP_UNITS)
    cuda_scan.reset_launch_counts()
    elbos = []
    for _ in range(2):
        elbo, loop = bt.vb_step(loop, x, mask=m)
        elbos.append(float(elbo))
    torch.cuda.synchronize()
    loop_launches = {k: v.launches for k, v in cuda_scan.KERNELS.items() if v.launches}
    check(loop_launches == {"forward_llh_banded": 2, "estep_acc_banded": 2},
          f"the 100-unit loop's VB steps: launches {loop_launches}")
    for k, n in loop_launches.items():
        launches[k] += n
    frames = float(m.sum())
    want = []
    for _ in range(2):
        elbo, twin = bt.vb_step(twin, x, mask=m)
        want.append(float(elbo))
    gaps["loop100"] = dict(elbo_per_frame=max(abs(a - b) for a, b in zip(elbos, want)) / frames)
    check(gaps["loop100"]["elbo_per_frame"] <= 1e-4, f"the 100-unit loop: kernel vs plain route {gaps['loop100']}")
    vit_rows, back_rows, vit_mismatches = viterbi_rows(dev, x, m)
    torch.cuda.synchronize()

    def fmt(v):
        wrapped = f", wrapped {v['wrapper_ms']:.3f}" if "wrapper_ms" in v else ""
        return (f"{v['ms']:.3f} ms{wrapped} {v['placement']} (plain {v['plain_ms']:.3f}, bound "
                f"{v['bound_ms']:.4f} by {v['bound_by']})")

    print(f"phase 18 large dense: ergodic B={LARGE_B} T={LARGE_T} D={D} "
          + " || ".join(f"S={s}: " + "; ".join(f"{k} {fmt(v)}" for k, v in r.items())
                        for s, r in rows.items())
          + f" | paths (ergodic S={LARGE_S}, chain S={CHAIN_PHONES * REC_SPP} T<={CHAIN_T}) launches "
          + json.dumps({k: v for k, v in launches.items() if v})
          + " || phone loops: " + " || ".join(
              f"{u} units (S={3 * u}): " + "; ".join(f"{k} {fmt(v)}" for k, v in r.items())
              + " errors " + json.dumps({k: {n: float(f"{e:.3g}") for n, e in v.items()}
                                         for k, v in errs[f"loop{u}"].items()})
              for u, r in loop_rows.items())
          + f" | {LOOP_UNITS}-unit phone loop (S={3 * LOOP_UNITS}, K2 {geometry}) 2 VB steps launches "
          + json.dumps(loop_launches)
          + " vs plain route " + json.dumps({k: {n: float(f"{e:.3g}") for n, e in v.items()}
                                             for k, v in gaps.items()})
          + " || viterbi_fwd_banded: " + "; ".join(
              f"{k} (S={v['states']}) {fmt(v)} mismatches {json.dumps(vit_mismatches[f'k3_{k}'])}"
              for k, v in vit_rows.items())
          + " || viterbi_backtrace_banded: " + "; ".join(
              f"{k} (S={v['states']}) {fmt(v)} mismatches {json.dumps(vit_mismatches[f'k4_{k}'])}"
              for k, v in back_rows.items())
          + " | tol: log Z, ELBO rel 1e-5; alpha, gamma, gamma0 abs 1e-5; statistics, xi rel 1e-4; "
            "the loop's ELBOs 1e-4/frame; K3's decode scores rel 1e-6, paths >= 99.9% of valid frames; K4's "
            "paths and scores equal")
    return rows, launches, loop_rows, vit_rows, back_rows


# ----------------------------------------------------------------------
# Phase 19: the AUD recipe through the port's CLI
# ----------------------------------------------------------------------
RECIPE = Path(__file__).resolve().parent / "recipes" / "aud"
CLI_UTTS, CLI_UTTS_EVAL = 512, 64           # config 4's B; a held-out split
CLI_EPOCHS, CLI_RESUME_AT, CLI_STREAM_EPOCHS = 5, 3, 2
PATH_KERNELS = ("forward_llh_banded", "estep_acc_banded", "viterbi_fwd_banded",
                "viterbi_backtrace_banded")


def verb(argv):
    """One verb through ``beer_tpu_torch.cli.main.main`` in this process:
    (host-clock seconds, the card synchronised at both ends; its printed
    lines).  The printed lines go to standard error if it fails."""
    from beer_tpu_torch.cli.main import main as cli

    argv = [str(a) for a in argv]
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli(argv)
    except BaseException:
        print(f"$ beer-torch {' '.join(argv)}\n{out.getvalue()}", file=sys.stderr)
        raise
    torch.cuda.synchronize()
    check(rc == 0, f"beer-torch {' '.join(argv[:2])} returned {rc}")
    return time.time() - t0, out.getvalue()


def run_verb(argv):
    """:func:`verb`'s seconds."""
    return verb(argv)[0]


def path_launches(names=PATH_KERNELS):
    return {k: cuda_scan.KERNELS[k].launches for k in names}


def train_log(run_dir):
    lines = (run_dir / "log" / "metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


def padded(bio, feats, dev):
    _, data, mask = bio.load_padded(feats)
    return torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)


def phase_cli(dev, card, tmp):
    """``recipes/aud/run.sh``'s five verbs through the port's CLI on the
    card in the directory ``tmp``, with no ``--device`` flag: the recipe's synthetic data (512
    training utterances, 64 held out), its feature and model
    configurations (fbank, 26 filters with deltas: D = 78; 40 units × 3
    states: S = 120), 3 epochs then 5 (resumed), the same training
    streamed through ``.bar`` minibatches, and a per-frame decode of the
    held-out split.  Launch counters are read around the training and
    the decode."""
    from beer_tpu_torch import io as bio
    from beer_tpu_torch.utils import load_model

    secs, launches = {}, {}
    w = Path(tmp)
    t0 = time.time()
    subprocess.run([sys.executable, str(RECIPE / "local" / "make_synthetic_data.py"), tmp,
                    "--n-utts", str(CLI_UTTS), "--n-utts-eval", str(CLI_UTTS_EVAL)],
                   check=True, capture_output=True, timeout=600)
    secs["data"] = time.time() - t0
    for split in ("aud", "aud_eval"):
        secs[f"dataset_create_{split}"] = run_verb(
            ["dataset", "create", f"{tmp}/wav_{split}.scp", f"{tmp}/manifest_{split}.json"])
        secs[f"features_extract_{split}"] = run_verb(
            ["features", "extract", str(RECIPE / "conf" / "features.yml"),
             f"{tmp}/manifest_{split}.json", f"{tmp}/feats_{split}.npz"])
    feats, feats_eval, init = f"{tmp}/feats_aud.npz", f"{tmp}/feats_aud_eval.npz", f"{tmp}/init.mdl"
    secs["mkphoneloop"] = run_verb(
        ["hmm", "mkphoneloop", str(RECIPE / "conf" / "hmm.yml"), feats, init])

    cuda_scan.reset_launch_counts()
    secs[f"train_{CLI_RESUME_AT}"] = run_verb(
        ["hmm", "train", init, feats, f"{tmp}/train", "--epochs", str(CLI_RESUME_AT)])
    secs[f"train_resume_{CLI_EPOCHS}"] = run_verb(
        ["hmm", "train", init, feats, f"{tmp}/train", "--epochs", str(CLI_EPOCHS)])
    launches["train"] = path_launches()
    cuda_scan.reset_launch_counts()
    secs[f"train_streamed_{CLI_STREAM_EPOCHS}"] = run_verb(
        ["hmm", "train", init, feats, f"{tmp}/streamed", "--epochs", str(CLI_STREAM_EPOCHS),
         "--batch-size", "128", "--buckets", "4", "--accumulate-batches"])
    launches["streamed"] = path_launches()
    cuda_scan.reset_launch_counts()
    secs["decode_eval"] = run_verb(
        ["hmm", "decode", f"{tmp}/train/final.mdl", feats_eval, f"{tmp}/trans.txt",
         "--per-frame"])
    launches["decode"] = path_launches()

    # the launches: K1, K2 in both trainings; K3, K4 in the decode
    for k in PATH_KERNELS[:2]:
        check(launches["train"][k] > 0 and launches["streamed"][k] > 0,
              f"{k} not launched by hmm train: {launches}")
    for k in PATH_KERNELS[2:]:
        check(launches["decode"][k] > 0, f"{k} not launched by hmm decode: {launches}")

    # the features: D = 78, finite; the card's spectra against the CPU's
    from beer_tpu_torch import features
    from beer_tpu_torch.utils import load_yaml

    conf = features.FeatureConfig.from_dict(load_yaml(RECIPE / "conf" / "features.yml"))
    archive = np.load(feats_eval)
    manifest = json.loads((w / "manifest_aud_eval.json").read_text())["utterances"]
    feat_err = 0.0
    for key in archive.files[:8]:
        got = archive[key]
        check(got.shape[1] == 78 and bool(np.isfinite(got).all()), f"features of {key}")
        sig = torch.from_numpy(np.load(manifest[key]))
        raw = features.extract(sig, dataclasses.replace(conf, deltas=False,
                                                        mean_norm=False)).numpy()
        ref = features.add_deltas_np(raw)
        ref = ref - ref.mean(0, keepdims=True)
        feat_err = max(feat_err, float(np.abs(got - ref).max()))
    check(feat_err <= 1e-3, f"features on the card vs the CPU: {feat_err}")

    # the ELBO: finite, non-decreasing, within 1e-4/frame of the plain route
    x, m = padded(bio, feats, dev)
    frames = float(m.sum())
    records = train_log(w / "train")
    elbos = np.array([r["elbo_per_frame"] for r in records])
    check([r["step"] for r in records] == list(range(1, CLI_EPOCHS + 1)),
          f"train log epochs {[r['step'] for r in records]}")
    check(bool(np.isfinite(elbos).all()), f"ELBO not finite: {elbos}")
    check(bool((np.diff(elbos) >= -1e-6).all()), f"ELBO decreased: {elbos}")
    twin = plain_twin(load_model(init))
    plain = []
    for _ in range(CLI_EPOCHS):
        elbo, twin = bt.vb_step(twin, x, mask=m)
        plain.append(float(elbo) / frames)
    gap = float(np.abs(elbos - np.array(plain)).max())
    check(gap <= 1e-4, f"CLI vs plain route ELBO gap {gap} per frame")

    # streamed full-batch VB = full batch at epoch 2, to 2e-4 of each
    # array's largest entry (the two sum ~10^4 frames' float32
    # statistics in different orders, which entries near 0 show)
    full = load_model(w / "train" / f"epoch{CLI_STREAM_EPOCHS:04d}.mdl")
    streamed = load_model(w / "streamed" / "final.mdl")
    stream_rel = 0.0
    for (name, a), (_, b) in zip(full.state_dict().items(), streamed.state_dict().items()):
        err = rel(b, a)
        check(err <= 2e-4, f"streamed vs full batch: {name} rel {err}")
        stream_rel = max(stream_rel, err)
    s_elbos = [r["elbo_per_frame"] for r in train_log(w / "streamed")]
    stream_gap = float(np.abs(np.array(s_elbos) - elbos[:CLI_STREAM_EPOCHS]).max())
    check(stream_gap <= 1e-4, f"streamed vs full batch ELBO gap {stream_gap} per frame")
    bar = bio.Archive(feats + ".bar")
    check(bar.native, "the native archive reader did not run")

    # the decode: the plain route's labels, frame for frame
    xe, me = padded(bio, feats_eval, dev)
    with torch.no_grad():
        units, _ = plain_twin(load_model(w / "train" / "final.mdl")).decode_units(xe, me)
    units = units.cpu().numpy()
    lens = me.sum(-1).long().cpu().numpy()
    keys = list(np.load(feats_eval).files)
    lines = (w / "trans.txt").read_text().splitlines()
    check(len(lines) == len(keys), "one transcription a held-out utterance")
    mismatch = 0
    for i, line in enumerate(lines):
        key, *labels = line.split()
        check(key == keys[i] and len(labels) == lens[i], f"transcription of {keys[i]}")
        mismatch += int((np.array([int(u[2:]) for u in labels]) != units[i, :lens[i]]).sum())
    check(mismatch == 0, f"decode differs from the plain route on {mismatch} frames")
    used = len(np.unique(np.concatenate([units[i, :n] for i, n in enumerate(lens)])))
    t_max, dim, n_states = x.shape[1], x.shape[2], twin.n_states

    fps = {r["step"]: round(r["frames_per_sec"]) for r in records}
    print(f"phase 19 cli: {card} | utts {CLI_UTTS} + {CLI_UTTS_EVAL} held out, frames {frames:.0f}, "
          f"T_max {t_max}, D {dim}, S {n_states} | seconds "
          + json.dumps({k: round(v, 3) for k, v in secs.items()})
          + f" | train frames/s by epoch {json.dumps(fps)} | ELBO/frame "
          + ", ".join(f"{e:.6f}" for e in elbos)
          + f" | plain-route gap {gap:.3g}/frame | streamed vs full batch rel {stream_rel:.3g}, "
          f"ELBO gap {stream_gap:.3g} | features vs CPU {feat_err:.3g} | decode mismatches "
          f"{mismatch} (units used {used}) | native reader {bar.native} | launches "
          + json.dumps(launches)
          + " | tol: ELBO 1e-4/frame; streamed 2e-4 of each array's max; features 1e-3; decode equal")
    return {k: sum(v[k] for v in launches.values()) for k in PATH_KERNELS}


# ----------------------------------------------------------------------
# Phase 20: the supervised recipe through the port's CLI
# ----------------------------------------------------------------------
ROOT = Path(__file__).resolve().parent
SUPERVISED = ROOT / "recipes" / "supervised"
SUP_UTTS, SUP_UTTS_EVAL = 512, 64           # config 4's B, as phase 19; a held-out split
SUP_EPOCHS, SUP_RESUME_AT = 5, 3            # the recipe trains 20 epochs
SUP_KERNELS = ("forward_llh_dense", "estep_gamma_dense", "viterbi_fwd_banded",
               "viterbi_backtrace_banded")


@contextlib.contextmanager
def timed_calls(module, name):
    """Replace ``module.name`` by a wrapper that records each call's
    (start, end) on the host clock, the card synchronised at both ends."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((t0, time.time()))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def timed_scan_runs(module):
    """Make ``module.make_gsm_train_scan`` return runs that record each
    call's (start, end) on the host clock, the card synchronised at both ends."""
    make = module.make_gsm_train_scan
    calls = []

    def timed_make(*args, **kwargs):
        run = make(*args, **kwargs)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = run(*a, **kw)
            torch.cuda.synchronize()
            calls.append((t0, time.time()))
            return out

        return timed

    module.make_gsm_train_scan = timed_make
    try:
        yield calls
    finally:
        module.make_gsm_train_scan = make


def printed_elbos(printed, pattern=r"epoch (\d+): elbo/frame = (\S+)"):
    import re

    return {int(k): float(v) for k, v in re.findall(pattern, printed)}


def read_trans(path):
    return {line.split()[0]: line.split()[1:] for line in Path(path).read_text().splitlines()
            if line.split()}


def hmm_underflow_share(hmm, x, m):
    """ROADMAP §C.1: the share of valid frames whose γ sums below 0.5,
    through ``HMM.posteriors``."""
    with torch.no_grad():
        gamma = hmm.posteriors(x, m)
    valid = m > 0
    return float(((gamma.sum(-1) < 0.5) & valid).sum() / valid.sum())


def run_script(*argv):
    """A recipe's helper script: its standard output."""
    return subprocess.run([sys.executable, *map(str, argv)], check=True, capture_output=True,
                          text=True, timeout=600).stdout


def host_profile(argv, top=6):
    """``verb(argv)`` under ``cProfile``: its seconds and the functions
    with the most host time of their own (seconds)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    secs, _ = verb(argv)
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:top]
    return round(secs, 3), {f"{Path(f).name}:{line}({fn})": round(st[2], 3)
                            for (f, line, fn), st in rows}


def phase_supervised(dev, card, tmp):
    """``recipes/supervised/run.sh``'s verbs through the port's CLI on
    the card, with no ``--device`` flag, in the directory ``tmp``: the
    recipe's labelled synthetic data (512 training utterances, 64 held
    out), ``conf/features.yml`` (D = 78) and ``conf/phones.yml`` (8 phones
    × 3 states × 2 diagonal components), 3 epochs then 5 (resumed) of
    supervised training on shared transcription graphs, the bigram
    phone-LM decode of both splits, the forced alignment of the training
    split.  Launch counters are read around the training and the
    alignment."""
    from beer_tpu_torch import io as bio
    from beer_tpu_torch.utils import load_model

    w = Path(tmp) / "supervised"
    w.mkdir()
    secs, launches = {}, {}
    t0 = time.time()
    run_script(RECIPE / "local" / "make_synthetic_data.py", w, "--name", "sup", "--n-utts",
               SUP_UTTS, "--n-utts-eval", SUP_UTTS_EVAL, "--write-trans")
    secs["data"] = time.time() - t0
    for split in ("sup", "sup_eval"):
        secs[f"dataset_create_{split}"] = run_verb(
            ["dataset", "create", w / f"wav_{split}.scp", w / f"manifest_{split}.json"])
        secs[f"features_extract_{split}"] = run_verb(
            ["features", "extract", RECIPE / "conf" / "features.yml",
             w / f"manifest_{split}.json", w / f"feats_{split}.bar"])
    feats, feats_eval = w / "feats_sup.bar", w / "feats_sup_eval.bar"   # run.sh's native archives
    trans, em = w / "sup.trans", w / "emissions.mdl"
    secs["mkphones"] = run_verb(["hmm", "mkphones", SUPERVISED / "conf" / "phones.yml", feats,
                                 trans, em])

    cuda_scan.reset_launch_counts()
    printed = ""
    for epochs in (SUP_RESUME_AT, SUP_EPOCHS):
        secs[f"train_{epochs}"], out = verb(["hmm", "train", em, feats, w / "train", "--epochs",
                                             epochs, "--transcriptions", trans])
        printed += out
    launches["train"] = path_launches(SUP_KERNELS)

    # the recipe's decode (collapsed) of both splits; per frame on the card
    # and with --device cpu for the comparison; the dense Viterbi timed
    final = w / "train" / "final.mdl"
    lm = ["--phone-lm", "--lm-transcriptions", trans]
    cuda_scan.reset_launch_counts()
    with timed_calls(tss, "viterbi") as vit:
        for split, f in (("train", feats), ("eval", feats_eval)):
            secs[f"decode_{split}"] = run_verb(["hmm", "decode", final, f, w / f"hyp_{split}.trans"]
                                               + lm)
    launches["decode"] = path_launches(SUP_KERNELS)
    vit_secs = sum(b - a for a, b in vit)
    vit_share = vit_secs / (secs["decode_train"] + secs["decode_eval"])
    frame_labels = {}
    for split, f in (("train", feats), ("eval", feats_eval)):
        for device in ("cuda", "cpu"):
            out = w / f"hyp_{split}_frames_{device}.trans"
            secs[f"decode_{split}_per_frame_{device}"] = run_verb(
                ["hmm", "decode", final, f, out, "--per-frame", "--device", device] + lm)
            frame_labels[split, device] = read_trans(out)
    cuda_scan.reset_launch_counts()
    secs["align"] = run_verb(["hmm", "align", final, feats, trans, w / "ali.txt"])
    launches["align"] = path_launches(SUP_KERNELS)
    per = {split: run_script(SUPERVISED / "local" / "score_per.py", ref,
                             w / f"hyp_{split}.trans").strip()
           for split, ref in (("train", trans), ("eval", w / "sup_eval.trans"))}

    # the launches: K5, K7 in the training; K3, K4 in the alignment
    for k in SUP_KERNELS[:2]:
        check(launches["train"][k] > 0, f"{k} not launched by hmm train --transcriptions: {launches}")
    for k in SUP_KERNELS[2:]:
        check(launches["align"][k] > 0, f"{k} not launched by hmm align: {launches}")

    # the ELBO: finite, non-decreasing, within 1e-4/frame of the plain route
    keys, data, mask = bio.load_padded(feats)
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    frames = float(mask.sum())
    meta = json.loads((w / "emissions.mdl.phones.json").read_text())
    phones, spp = meta["phones"], meta["states_per_phone"]
    labels = read_trans(trans)
    graphs = bt.transcription_graphs([[phones.index(p) for p in labels[k]] for k in keys],
                                     len(phones), spp)
    elbos = printed_elbos(printed)
    check(sorted(elbos) == list(range(1, SUP_EPOCHS + 1)), f"train epochs {sorted(elbos)}")
    elbos = np.array([elbos[e] for e in range(1, SUP_EPOCHS + 1)])
    check(bool(np.isfinite(elbos).all()), f"ELBO not finite: {elbos}")
    check(bool((np.diff(elbos) >= -1e-6).all()), f"ELBO decreased: {elbos}")
    twin = plain_twin(bt.HMM.create(graphs, load_model(em)))
    plain = []
    for _ in range(SUP_EPOCHS):
        elbo, twin = bt.vb_step(twin, x, mask=m)
        plain.append(elbo.item() / frames)
    gap = float(np.abs(elbos - np.array(plain)).max())
    check(gap <= 1e-4, f"CLI vs plain route ELBO gap {gap} per frame")

    # where a training epoch's and a decode's time goes: one VB step on
    # each route (CUDA events), the step under torch.profiler, reading the
    # archive, and the two verbs under cProfile
    hmm = bt.HMM.create(graphs, load_model(final))
    twin = plain_twin(hmm)
    step = {"kernels_ms": cuda_ms(lambda: bt.vb_step(hmm, x, mask=m)),
            "plain_ms": cuda_ms(lambda: bt.vb_step(twin, x, mask=m)),
            "profile": profile_step(lambda: bt.vb_step(hmm, x, mask=m))}
    t0 = time.time()
    bio.load_padded(feats)
    step["load_padded_s"] = round(time.time() - t0, 3)
    profiles = {
        "train_1_epoch": host_profile(["hmm", "train", em, feats, w / "train_profiled", "--epochs",
                                       1, "--transcriptions", trans]),
        "decode_train": host_profile(["hmm", "decode", final, feats, w / "hyp_profiled.trans"]
                                     + lm),
    }

    # ROADMAP §C.1: γ that sums below 0.5, under the initial emissions and
    # after the last epoch, on the kernel route (K5 + K7) and the plain one
    underflow = {}
    for tag, path in (("emissions", em), (f"epoch{SUP_EPOCHS}", final)):
        hmm = bt.HMM.create(graphs, load_model(path))
        underflow[tag] = {"kernels": hmm_underflow_share(hmm, x, m),
                          "plain": hmm_underflow_share(plain_twin(hmm), x, m)}

    # the alignment: the plain route's, frame for frame
    with torch.no_grad():
        paths, _ = plain_twin(bt.HMM.create(graphs, load_model(final))).decode(x, m)
    want = (torch.gather(graphs.pdf_ids, 1, paths.long()) // spp).cpu().numpy()
    lens = mask.sum(-1).astype(int)
    got = read_trans(w / "ali.txt")
    check(list(got) == list(keys), "one alignment a training utterance")
    ali_mismatch = sum(int((np.array([phones.index(p) for p in got[k]]) != want[i, :lens[i]]).sum())
                       for i, k in enumerate(keys))
    check(all(len(got[k]) == lens[i] for i, k in enumerate(keys)), "alignment lengths")
    check(ali_mismatch == 0, f"alignment differs from the plain route on {ali_mismatch} frames")

    # the phone-LM decode: the card's per-frame labels are the CPU's
    decode_frames, ties = 0, {}
    for split in ("train", "eval"):
        card_labels, cpu_labels = frame_labels[split, "cuda"], frame_labels[split, "cpu"]
        check(list(card_labels) == list(cpu_labels), f"decode keys ({split})")
        ties[split] = sum(int(np.sum(np.array(card_labels[k]) != np.array(cpu_labels[k])))
                          for k in card_labels)
        decode_frames += sum(len(v) for v in card_labels.values())
    check(sum(ties.values()) == 0, f"the card's phone-LM decode differs from the CPU's: {ties}")

    train_secs = secs[f"train_{SUP_RESUME_AT}"] + secs[f"train_{SUP_EPOCHS}"]
    epochs_run = {SUP_RESUME_AT: SUP_RESUME_AT, SUP_EPOCHS: SUP_EPOCHS - SUP_RESUME_AT}
    fps = {f"train_{e}": round(frames * n / secs[f"train_{e}"]) for e, n in epochs_run.items()}
    print(f"phase 20 supervised: {card} | utts {SUP_UTTS} + {SUP_UTTS_EVAL} held out, frames "
          f"{frames:.0f}, T_max {x.shape[1]}, D {x.shape[2]}, {len(phones)} phones x {spp} states "
          f"x {meta['ncomp_per_state']} components (S_max {graphs.n_states}) | seconds "
          + json.dumps({k: round(v, 3) for k, v in secs.items()})
          + f" | train frames/s, the verb's wall clock {json.dumps(fps)} (all {SUP_EPOCHS} epochs "
          f"{frames * SUP_EPOCHS / train_secs:.0f}) | ELBO/frame "
          + ", ".join(f"{e:.6f}" for e in elbos)
          + f" | plain-route gap {gap:.3g}/frame | dense viterbi {vit_secs:.3f} s of the two "
          f"phone-LM decodes' {secs['decode_train'] + secs['decode_eval']:.3f} s "
          f"({100 * vit_share:.1f} %, {len(vit)} calls) | card vs CPU decode: {decode_frames} "
          f"frames, mismatches {json.dumps(ties)} | alignment mismatches {ali_mismatch} | "
          f"underflow (share of frames with sum gamma < 0.5) {json.dumps(underflow)} | "
          f"PER train {per['train']} eval {per['eval']} | one vb_step {json.dumps(step)} | "
          f"host profiles (s, own seconds) {json.dumps(profiles)} | launches "
          + json.dumps(launches) + " | tol: ELBO 1e-4/frame; alignment and decode equal")
    return {k: sum(v[k] for v in launches.values()) for k in SUP_KERNELS}


# ----------------------------------------------------------------------
# Phase 21: map-reduce and the subspace-HMM through the port's CLI
# ----------------------------------------------------------------------
SHMM = ROOT / "recipes" / "shmm"
SHMM_LOOP_EPOCHS = 5                        # the recipe trains 20 (A, B) and 30 (C) epochs
SHMM_OUTER, SHMM_INNER = 2, 200             # the recipe runs 6 x 600
MR_KERNELS = ("forward_llh_banded", "estep_acc_banded")
SHMM_KERNELS = MR_KERNELS + ("scaled_pass", "smoothing_pass")


def mapreduce_check(reduced_model, printed, full, full_per_frame, label):
    """The reduced model against the full-batch step: every array within
    2e-4 of its largest entry, the reduced ELBO within 1e-5 a frame."""
    from beer_tpu_torch.utils import load_model

    worst = 0.0
    for (name, a), (_, b) in zip(load_model(reduced_model).state_dict().items(),
                                 full.state_dict().items()):
        err = rel(a, b)
        check(err <= 2e-4, f"{label} vs vb_step: {name} rel {err}")
        worst = max(worst, err)
    gap = abs(float(printed.rsplit("elbo/frame = ", 1)[1].split()[0]) - full_per_frame)
    check(gap <= 1e-5, f"{label} reduced ELBO gap {gap} per frame")
    return worst, gap


def phase_mapreduce_shmm(dev, card, tmp):
    """Map-reduce VB on phase 19's AUD ``init.mdl`` and features (4
    shards in this process, then 2 concurrent ``python -m
    beer_tpu_torch.cli hmm accumulate`` processes sharing the card, each
    reduced by ``hmm update`` and held against one full-batch
    ``vb_step``); then ``recipes/shmm/run.sh``'s verbs: the multilingual
    synthetic data (A, B: 60 utterances, C: 4, C's held-out 40),
    features, a phone loop per language (20 units × 3 states) trained
    5 epochs, ``shmm train`` on C with A and B (H-SHMM, learned
    transitions), a per-frame decode of C's held-out split and its NMI."""
    import os

    from beer_tpu_torch import io as bio
    from beer_tpu_torch.models import gsm as tgsm
    from beer_tpu_torch.utils import load_model

    aud = Path(tmp)
    w = aud / "mapreduce"
    w.mkdir()
    init, feats = aud / "init.mdl", aud / "feats_aud.npz"
    secs, launches = {}, {}

    cuda_scan.reset_launch_counts()
    accs = [w / f"s{i}of4.acc" for i in range(1, 5)]
    for i, acc in enumerate(accs, 1):
        secs[f"accumulate_{i}of4"] = run_verb(["hmm", "accumulate", init, feats, acc,
                                               "--shard", f"{i}/4"])
    launches["accumulate"] = path_launches(MR_KERNELS)
    for k in MR_KERNELS:
        check(launches["accumulate"][k] > 0, f"{k} not launched by hmm accumulate: {launches}")
    secs["update_4"], printed4 = verb(["hmm", "update", init, w / "mr4.mdl", *accs])

    # the fan-out of recipes/lib/parallel_vbem.sh: processes sharing the
    # card (one alone first, for its start-up time)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    for tag, shards in (("accumulate_1_process", ["1/1"]),
                        ("accumulate_2_concurrent", ["1/2", "2/2"])):
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, "-m", "beer_tpu_torch.cli", "hmm", "accumulate",
                                   str(init), str(feats),
                                   str(w / f"s{shard.replace('/', 'of')}.acc"), "--shard", shard],
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for shard in shards]
        try:
            outs = [proc.communicate(timeout=600) for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        secs[tag] = time.time() - t0
        for proc, (out, err) in zip(procs, outs):
            check(proc.returncode == 0, f"hmm accumulate in a process failed:\n{out}\n{err}")
    secs["update_2"], printed2 = verb(["hmm", "update", init, w / "mr2.mdl",
                                       w / "s1of2.acc", w / "s2of2.acc"])

    x, m = padded(bio, feats, dev)
    frames = float(m.sum())
    elbo, full = bt.vb_step(load_model(init), x, mask=m)
    full_per_frame = elbo.item() / frames
    mr = {"4 shards": mapreduce_check(w / "mr4.mdl", printed4, full, full_per_frame, "4 shards"),
          "2 concurrent": mapreduce_check(w / "mr2.mdl", printed2, full, full_per_frame,
                                          "2 concurrent processes")}

    # the subspace-HMM recipe
    sh = aud / "shmm"
    t0 = time.time()
    run_script(SHMM / "local" / "make_multilingual_data.py", sh)
    secs["shmm_data"] = time.time() - t0
    for name in ("A", "B", "C", "C_eval"):
        secs[f"dataset_create_{name}"] = run_verb(
            ["dataset", "create", sh / f"wav_{name}.scp", sh / f"manifest_{name}.json"])
        secs[f"features_extract_{name}"] = run_verb(
            ["features", "extract", SHMM / "conf" / "features.yml", sh / f"manifest_{name}.json",
             sh / f"feats_{name}.npz"])
    for lang in ("A", "B", "C"):
        secs[f"mkphoneloop_{lang}"] = run_verb(
            ["hmm", "mkphoneloop", SHMM / "conf" / "hmm.yml", sh / f"feats_{lang}.npz",
             sh / f"init_{lang}.mdl"])
        secs[f"train_{lang}"] = run_verb(
            ["hmm", "train", sh / f"init_{lang}.mdl", sh / f"feats_{lang}.npz",
             sh / f"train_{lang}", "--epochs", SHMM_LOOP_EPOCHS])
    cuda_scan.reset_launch_counts()
    with timed_scan_runs(tgsm) as gsm_calls, timed_calls(tgsm, "train_gsm") as eager_calls:
        secs["shmm_train"], printed = verb(
            ["shmm", "train", sh / "train_C" / "final.mdl", sh / "feats_C.npz", sh / "shmm",
             "--extra-lang", f"A:{sh / 'train_A' / 'final.mdl'}:{sh / 'feats_A.npz'}",
             "--extra-lang", f"B:{sh / 'train_B' / 'final.mdl'}:{sh / 'feats_B.npz'}",
             "--embed-dim", "8", "--lang-dim", "2", "--learn-transitions",
             "--outer-iters", SHMM_OUTER, "--inner-iters", SHMM_INNER, "--loop-epochs", "3"])
    launches["shmm_train"] = path_launches(SHMM_KERNELS)
    check(len(gsm_calls) == SHMM_OUTER and not eager_calls,
          f"shmm train's inner loops: {len(gsm_calls)} scan runs, {len(eager_calls)} eager loops")
    for k in SHMM_KERNELS:
        check(launches["shmm_train"][k] > 0, f"{k} not launched by shmm train: {launches}")
    secs["decode_C_eval"] = run_verb(["hmm", "decode", sh / "shmm" / "final.mdl",
                                      sh / "feats_C_eval.npz", sh / "trans_shmm_C.txt",
                                      "--per-frame"])
    score = run_script(SHMM / "local" / "score.py", sh / "ref_C_eval.ali",
                       sh / "trans_shmm_C.txt").strip().replace("\n", "; ")

    gsm_elbos = printed_elbos(printed, r"outer (\d+): gsm elbo = (\S+)")
    check(sorted(gsm_elbos) == list(range(SHMM_OUTER)), f"outer iterations {sorted(gsm_elbos)}")
    values = [gsm_elbos[k] for k in range(SHMM_OUTER)]
    check(bool(np.isfinite(values).all()), f"GSM ELBO not finite: {values}")
    check(values[-1] > values[0], f"GSM ELBO did not rise: {values}")
    out = sh / "shmm"
    check(all((out / n).exists() for n in ("final_A.mdl", "final_B.mdl", "gsm.mdl")),
          "shmm train's outputs")
    gsm = load_model(out / "gsm.mdl")
    check(type(gsm).__name__ == "HierarchicalGSM" and gsm.n_units == 60 and gsm.n_langs == 3,
          f"gsm.mdl: {type(gsm).__name__}, {gsm.n_units} units, {gsm.n_langs} languages")
    check(load_model(out / "final.mdl").log_exit is not None, "no transition write-back")

    gsm_secs = [b - a for a, b in gsm_calls]
    ends = [b for _, b in gsm_calls]
    outer_secs = [b - a for a, b in zip(ends, ends[1:])]
    print(f"phase 21 map-reduce and shmm: {card} | map-reduce on phase 19's init.mdl, frames "
          f"{frames:.0f}: 4 shards in this process and 2 concurrent processes vs one vb_step: "
          + json.dumps({k: {"rel": float(f"{v[0]:.3g}"), "elbo_gap": float(f"{v[1]:.3g}")}
                       for k, v in mr.items()})
          + f" | gsm elbo by outer iteration {values} | gsm steps {SHMM_INNER} an outer iteration "
          f"through the scan's CUDA graph (the first call captures it), "
          f"{', '.join(f'{s:.3f}' for s in gsm_secs)} s ({SHMM_INNER / np.mean(gsm_secs):.0f} "
          f"steps/s) | outer iteration (write-back, 3 x 3 loop VB steps, statistics, GSM steps) "
          f"{', '.join(f'{s:.3f}' for s in outer_secs)} s | C eval: {score} | seconds "
          + json.dumps({k: round(v, 3) for k, v in secs.items()})
          + " | launches " + json.dumps(launches)
          + " | tol: map-reduce 2e-4 of each array's max, ELBO 1e-5/frame; GSM ELBO finite, rising")
    total = {k: 0 for k in SHMM_KERNELS}
    for v in launches.values():
        for k, n in v.items():
            total[k] += n
    return total


# ----------------------------------------------------------------------
# Phase 22: PPCA and PLDA (configs 7 and 8), coordinate VB, the other
# covariance types
# ----------------------------------------------------------------------
PPCA_N, PPCA_D, PPCA_Q = 262144, 256, 64            # config 7 (bench.py:833)
PLDA_C, PLDA_PER, PLDA_D, PLDA_Q = 512, 64, 256, 64  # config 8 (bench.py:834)
SUBSPACE_STEPS = 10                                 # joint steps, then as many coordinate steps
N_TRIALS = 1000
COORD_STEPS = 3
NEW_COV_TYPES = ("isotropic", "shared_diagonal", "shared_full", "shared_isotropic")


def ppca_data():
    """Config 7's data, bench.py's ``_ppca_data`` (seed 11): x = z Wᵀ + 0.1 ε
    with W ~ N(0, 1/Q), z, ε ~ N(0, 1)."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(PPCA_D, PPCA_Q)) / np.sqrt(PPCA_Q)
    z = rng.normal(size=(PPCA_N, PPCA_Q))
    return (z @ w.T + 0.1 * rng.normal(size=(PPCA_N, PPCA_D))).astype(np.float32)


def plda_data():
    """Config 8's data and labels, bench.py's ``_plda_data`` (seed 12): 512
    classes of 64 embeddings, x = F h_class + 0.3 ε."""
    rng = np.random.default_rng(12)
    f = rng.normal(size=(PLDA_D, PLDA_Q)) / np.sqrt(PLDA_Q)
    h = rng.normal(size=(PLDA_C, PLDA_Q))
    x = np.repeat(h, PLDA_PER, 0) @ f.T + 0.3 * rng.normal(size=(PLDA_C * PLDA_PER, PLDA_D))
    return x.astype(np.float32), np.repeat(np.arange(PLDA_C), PLDA_PER).astype(np.int32)


def subspace_run(model, convert, x, kw, label):
    """``SUBSPACE_STEPS`` joint ``vb_step``s then as many
    ``vb_step_coordinate`` steps of the float32 ``model``, beside a
    float64 copy carried across at the start and run on its own (the free
    twin), and each beside the same step of a float64 copy of the model
    as it stands before the step (the synced twin: what one E-step's
    float32 arithmetic costs).  A last E-step after the last update is
    compared too, so every update shows in a gated ELBO.  Every ELBO
    finite, non-decreasing to 1e-5 a frame, within 1e-4 a frame of the
    free twin's and of the synced twin's.  Returns the per-frame ELBOs and
    both gaps."""
    frames = float(x.shape[0])
    x64 = x.double()
    free = convert(model.to_numpy(), device=x.device, dtype=torch.float64)
    rows = []
    for step in ([bt.vb_step] * SUBSPACE_STEPS + [bt.vb_step_coordinate] * SUBSPACE_STEPS
                 + [bt.elbo_and_stats]):
        synced = convert(model.to_numpy(), device=x.device, dtype=torch.float64)
        e32 = float(step(model, x, **kw)[0])
        e_sync = float(step(synced, x64, **kw)[0])
        e_free = float(step(free, x64, **kw)[0])
        rows.append((e32 / frames, (e32 - e_sync) / frames, (e32 - e_free) / frames))
    elbos, sync, free_gap = (np.array(c) for c in zip(*rows))
    check(bool(np.isfinite(elbos).all()), f"{label}: ELBO not finite: {elbos}")
    check(float(np.diff(elbos).min()) >= -1e-5, f"{label}: ELBO fell: per-frame {elbos}")
    check(float(np.abs(free_gap).max()) <= 1e-4,
          f"{label}: float32 trajectory vs float64 twin from the same start {free_gap} per frame")
    check(float(np.abs(sync).max()) <= 1e-4,
          f"{label}: float32 step vs float64 copy of the model as it stood {sync} per frame")
    return elbos, sync, free_gap


def subspace_times(model, x, kw, card):
    """CUDA-event medians of one joint and one coordinate step (on copies),
    frames/s, and a ``torch.profiler`` trace of one joint step."""
    frames = x.shape[0]
    out = {}
    for name, step in (("joint", bt.vb_step), ("coordinate", bt.vb_step_coordinate)):
        mdl = copy.deepcopy(model)
        out[f"{name}_step_ms"] = round(cuda_ms(lambda: step(mdl, x, **kw)), 3)
        out[f"{name}_step_frames_per_s"] = round(frames / out[f"{name}_step_ms"] * 1e3)
    mdl = copy.deepcopy(model)
    out["joint_step_profile"] = profile_step(lambda: bt.vb_step(mdl, x, **kw))
    out["card"] = card
    return out


def subspace_bound(n, d, q, c=0):
    """The least time of one joint step (:func:`bound`): x read once; the
    float32 products 2·N·D·Q each — PPCA's x·W̄, m·W̄ᵀ and xcᵀ·m, PLDA's
    the same three — plus PPCA's three (N, Q)·(Q, Q) and PLDA's one-hot
    (C, N)·(N, Q)."""
    flops = 6.0 * n * d * q + (2.0 * c * n * q if c else 6.0 * n * q * q)
    return bound(4.0 * n * d, flops)


def trials(labels, rng):
    """``N_TRIALS`` same-class and as many different-class index pairs."""
    n_cls = int(labels.max()) + 1
    same, diff = [], []
    for _ in range(N_TRIALS):
        c = rng.integers(n_cls)
        idx = np.flatnonzero(labels == c)
        i, j = rng.choice(idx, 2, replace=False)
        same.append((i, j))
        c2 = (c + 1 + rng.integers(n_cls - 1)) % n_cls
        diff.append((i, rng.choice(np.flatnonzero(labels == c2))))
    return np.array(same), np.array(diff)


def coordinate_run(model, x, m, label, need):
    """``COORD_STEPS`` ``vb_step_coordinate`` steps through the kernels
    (launch counters read around them: each kernel of ``need`` launched
    once an E-step, two E-steps a step) beside the plain route's: ELBOs
    finite, non-decreasing and within 1e-4 a frame of the plain route."""
    frames = float(m.sum())
    plain = plain_twin(model)
    cuda_scan.reset_launch_counts()
    elbos = np.array([float(bt.vb_step_coordinate(model, x, mask=m)[0])
                      for _ in range(COORD_STEPS)])
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in cuda_scan.KERNELS.items() if v.launches}
    groups = len(model.mean_field_factorization())
    check(all(launches.get(k, 0) == groups * COORD_STEPS for k in need),
          f"{label}: launches {launches}, want {groups * COORD_STEPS} of each of {need}")
    check(bool(np.isfinite(elbos).all()), f"{label}: ELBO not finite: {elbos}")
    check(bool((np.diff(elbos) / frames >= -1e-6).all()), f"{label}: ELBO fell: {elbos}")
    plain_elbos = np.array([float(bt.vb_step_coordinate(plain, x, mask=m)[0])
                            for _ in range(COORD_STEPS)])
    gap = float(np.abs(elbos - plain_elbos).max() / frames)
    check(gap <= 1e-4, f"{label}: kernel vs plain route ELBO gap {gap} per frame")
    timed = copy.deepcopy(model)
    step_ms = cuda_ms(lambda: bt.vb_step_coordinate(timed, x, mask=m))
    return dict(elbo_per_frame=[round(e / frames, 6) for e in elbos], plain_gap=gap,
                launches=launches, coordinate_step_ms=round(step_ms, 3),
                frames_per_s=round(frames / step_ms * 1e3))


def phase_subspace(dev, card):
    """Configs 7 and 8 at bench.py's shapes (float32 runs beside float64
    twins, PLDA's trials and repeatability), the coordinate step through
    the kernels on configs 4 and 2, and a Mixture over each covariance
    type the port gained with them."""
    out = {}
    # config 7: PPCA
    x = torch.from_numpy(ppca_data()).to(dev)
    ppca = bt.PPCA.create(PPCA_D, PPCA_Q, device=dev, generator=torch.Generator().manual_seed(5))
    elbos, sync, free = subspace_run(ppca, bt.ppca_from_numpy, x, {}, "config 7")
    out["config7"] = dict(elbo_per_frame=[round(float(e), 6) for e in elbos],
                          f32_vs_f64_synced_per_frame=[float(f"{g:.3g}") for g in sync],
                          f32_vs_f64_free_per_frame=[float(f"{g:.3g}") for g in free],
                          **subspace_times(ppca, x, {}, card),
                          **subspace_bound(PPCA_N, PPCA_D, PPCA_Q))
    del x
    # config 8: PLDA
    data, labels = plda_data()
    x, y = torch.from_numpy(data).to(dev), torch.from_numpy(labels).to(dev)
    kw = dict(labels=y, n_classes=PLDA_C)
    plda = bt.PLDA.create(PLDA_D, PLDA_Q, device=dev, generator=torch.Generator().manual_seed(6))
    elbos, sync, free = subspace_run(plda, bt.plda_from_numpy, x, kw, "config 8")
    llh_a, cache_a = plda.infer(x, **kw)
    llh_b, cache_b = plda.infer(x, **kw)
    check(torch.equal(llh_a, llh_b) and torch.equal(cache_a["m_h"], cache_b["m_h"]),
          "config 8: two calls of infer differ")
    same, diff = trials(labels, np.random.default_rng(1))
    s_same = plda.llr_score(x[same[:, 0]], x[same[:, 1]]).cpu().numpy()
    s_diff = plda.llr_score(x[diff[:, 0]], x[diff[:, 1]]).cpu().numpy()
    thresh = np.median(np.concatenate([s_same, s_diff]))
    acc = 0.5 * ((s_same > thresh).mean() + (s_diff <= thresh).mean())
    check(bool(np.isfinite(s_same).all() and np.isfinite(s_diff).all()), "config 8: scores")
    check(float(s_same.mean()) > float(s_diff.mean()) and acc > 0.9,
          f"config 8: same-class trials {s_same.mean()} vs different {s_diff.mean()}, "
          f"accuracy {acc}")
    out["config8"] = dict(elbo_per_frame=[round(float(e), 6) for e in elbos],
                          f32_vs_f64_synced_per_frame=[float(f"{g:.3g}") for g in sync],
                          f32_vs_f64_free_per_frame=[float(f"{g:.3g}") for g in free],
                          llr_same_mean=round(float(s_same.mean()), 3),
                          llr_diff_mean=round(float(s_diff.mean()), 3),
                          trial_accuracy=float(acc), infer_bitwise_repeatable=True,
                          **subspace_times(plda, x, kw, card),
                          **subspace_bound(PLDA_C * PLDA_PER, PLDA_D, PLDA_Q, PLDA_C))
    del x
    print(f"phase 22 subspace: {card} | " + json.dumps(out))

    # coordinate VB through the kernels: config 4's loop, config 2's HMM
    data, mask = make_data(B, T, D)
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    coord = {"config4": coordinate_run(config4(dev), x, m, "config 4 coordinate",
                                       ("forward_llh_banded", "estep_acc_banded")),
             "config2": coordinate_run(config2(dev), x, m, "config 2 coordinate",
                                       ("forward_llh_dense", "estep_acc_dense"))}
    launches = {}
    for row in coord.values():
        for k, n in row["launches"].items():
            launches[k] = launches.get(k, 0) + n

    # a Mixture over each new covariance type at config 1's size
    x = config1_frames(dev)
    frames = float(x.shape[0])
    for cov_type in NEW_COV_TYPES:
        gen = torch.Generator(device=dev).manual_seed(2)
        nset = bt.NormalSet.create(torch.zeros(D, device=dev), torch.eye(D, device=dev),
                                   size=GMM_K, cov_type=cov_type, noise_std=0.5, generator=gen)
        gmm = bt.Mixture.create(nset)
        elbos = np.array([float(bt.vb_step(gmm, x)[0]) for _ in range(N_STEPS)]) / frames
        check(bool(np.isfinite(elbos).all()) and float(np.diff(elbos).min()) >= -1e-6,
              f"{cov_type} mixture: ELBO/frame {elbos}")
        timed = copy.deepcopy(gmm)
        step_ms = cuda_ms(lambda: bt.vb_step(timed, x))
        coord[cov_type] = dict(elbo_per_frame=[round(float(e), 6) for e in elbos],
                               vb_step_ms=round(step_ms, 3),
                               frames_per_s=round(frames / step_ms * 1e3))
    print(f"phase 22 coordinate and covariance types: {card} | " + json.dumps(coord))
    return launches


# ----------------------------------------------------------------------
# Phase 23: data-parallel VB-EM, hmm train across ranks, sequence-parallel
# inference and learned transitions on per-utterance graphs
# ----------------------------------------------------------------------
DP_KERNELS = ("forward_llh_banded", "estep_acc_banded", "forward_llh_dense", "estep_acc_dense",
              "estep_gamma_dense")
DP_MINIBATCHES, DP_LRATE, SUP_STEPS = 4, 0.5, 3
SEQ_UNITS, SEQ_B, SEQ_T = 50, 8, 200                    # tests/test_seq_parallel.py:110
SEQ_LENGTHS = (200, 151, 150, 149, 101, 100, 51, 26)


def counted(fn):
    """``fn()`` and the launches of ``DP_KERNELS`` it made."""
    cuda_scan.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: cuda_scan.KERNELS[k].launches for k in DP_KERNELS}


def model_rel(a, b):
    """The largest of each state entry's |a − b| over b's largest entry."""
    return max(rel(x, y) for (_, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()))


def stats_rel(a, b):
    if isinstance(a, dict):
        return max(stats_rel(a[k], b[k]) for k in a)
    return rel(a, b)


def elbo_gap(got, want, frames):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / frames)


def dp_config4(dev, mesh, x, m, frames):
    """(i) 5 data-parallel steps of config 4 against ``vb_step`` from the
    same start, and both steps' times; (ii) the stochastic minibatch step
    and the streamed E-step (one update) over 4 minibatches against their
    single-device twins."""
    from beer_tpu_torch import parallel
    from beer_tpu_torch.vbi import tree_add

    out = {}
    loop, single = config4(dev), config4(dev)
    step = parallel.make_vb_train_step(mesh)
    dp, launches = counted(lambda: [float(step(loop, x, m)[0]) for _ in range(N_STEPS)])
    ref = [float(bt.vb_step(single, x, mask=m)[0]) for _ in range(N_STEPS)]
    check(all(launches[k] == N_STEPS for k in DP_KERNELS[:2]),
          f"data-parallel config 4: launches {launches}, want {N_STEPS} of K1 and K2")
    check(bool(np.isfinite(dp).all()) and bool((np.diff(dp) / frames >= -1e-6).all()),
          f"data-parallel config 4: ELBO {dp}")
    out["full_batch"] = dict(elbo_per_frame=[round(e / frames, 6) for e in dp],
                             elbo_gap_per_frame=elbo_gap(dp, ref, frames),
                             model_rel=model_rel(loop, single), launches=launches)
    check(out["full_batch"]["elbo_gap_per_frame"] <= 1e-6,
          f"data-parallel vs vb_step: {out['full_batch']}")
    check(out["full_batch"]["model_rel"] <= 2e-4, f"data-parallel vs vb_step: {out['full_batch']}")
    out["dp_step_ms"] = round(cuda_ms(lambda: step(loop, x, m)), 3)
    out["single_step_ms"] = round(cuda_ms(lambda: bt.vb_step(single, x, mask=m)), 3)

    nb = x.shape[0] // DP_MINIBATCHES
    batches = [(x[i * nb:(i + 1) * nb], m[i * nb:(i + 1) * nb]) for i in range(DP_MINIBATCHES)]
    loop, single = config4(dev), config4(dev)
    mb_step = parallel.make_vb_minibatch_step(mesh, lrate=DP_LRATE)
    dp, launches = counted(lambda: [float(mb_step(loop, xb, mb, DP_MINIBATCHES)[0])
                                    for xb, mb in batches])
    ref = [float(bt.vb_step(single, xb, datasize=x.shape[0], lrate=DP_LRATE, mask=mb)[0])
           for xb, mb in batches]
    out["minibatch"] = dict(elbo_gap_per_frame=elbo_gap(dp, ref, frames),
                            model_rel=model_rel(loop, single), launches=launches)
    check(out["minibatch"]["elbo_gap_per_frame"] <= 1e-6 and out["minibatch"]["model_rel"] <= 2e-4
          and launches["estep_acc_banded"] == DP_MINIBATCHES,
          f"data-parallel minibatch step vs vb_step: {out['minibatch']}")

    loop, single = config4(dev), config4(dev)
    estep = parallel.make_vb_estep(mesh)
    sums = {}
    for name, model, fn in (("dp", loop, lambda mo, xb, mb: estep(mo, xb, mb)),
                            ("single", single, lambda mo, xb, mb: bt.elbo_and_stats(mo, xb,
                                                                                    mask=mb))):
        elbo, acc = 0.0, None
        for xb, mb in batches:
            e, a = fn(model, xb, mb)
            elbo, acc = elbo + float(e), a if acc is None else tree_add(acc, a)
        kl = float(model.kl_div_posterior_prior())
        model.vb_update(acc)
        sums[name] = (elbo + kl * (DP_MINIBATCHES - 1), acc)
    out["streamed"] = dict(elbo_gap_per_frame=abs(sums["dp"][0] - sums["single"][0]) / frames,
                           vs_full_batch_per_frame=abs(sums["dp"][0] - out["full_batch"][
                               "elbo_per_frame"][0] * frames) / frames,
                           stats_rel=stats_rel(sums["dp"][1], sums["single"][1]),
                           model_rel=model_rel(loop, single))
    check(out["streamed"]["elbo_gap_per_frame"] <= 1e-6 and out["streamed"]["stats_rel"] <= 2e-4
          and out["streamed"]["model_rel"] <= 2e-4 and out["streamed"]["vs_full_batch_per_frame"]
          <= 1e-5, f"data-parallel streamed E-step vs elbo_and_stats: {out['streamed']}")
    return out


def dp_hmms(dev, mesh, x, m, frames):
    """The E-step of config 2 (K5 + K6) and 3 supervised steps of config 3
    on both graph forms (shared: K5 + K7), data-parallel against
    single-device."""
    from beer_tpu_torch import parallel

    out = {}
    hmm = config2(dev)
    (elbo, acc), launches = counted(lambda: parallel.make_vb_estep(mesh)(hmm, x, m))
    ref, ref_acc = bt.elbo_and_stats(hmm, x, mask=m)
    out["config2_estep"] = dict(elbo_gap_per_frame=abs(float(elbo) - float(ref)) / frames,
                                stats_rel=stats_rel(acc, ref_acc), launches=launches)
    check(out["config2_estep"]["elbo_gap_per_frame"] <= 1e-6
          and out["config2_estep"]["stats_rel"] <= 2e-4
          and launches["forward_llh_dense"] == 1 and launches["estep_acc_dense"] == 1,
          f"data-parallel E-step of config 2: {out['config2_estep']}")
    data, mask, seqs = config3_data()
    x3, m3 = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    frames3 = float(m3.sum())
    sup = parallel.make_supervised_vb_train_step(mesh)
    for shared in (True, False):
        dp_model, single = config3(dev, seqs, shared=shared), config3(dev, seqs, shared=shared)
        graphs = dp_model.graph
        emissions = dp_model.modelset
        dp, launches = counted(lambda: [float(sup(emissions, graphs, x3, m3)[0])
                                        for _ in range(SUP_STEPS)])
        ref = [float(bt.vb_step(single, x3, mask=m3)[0]) for _ in range(SUP_STEPS)]
        row = dict(elbo_gap_per_frame=elbo_gap(dp, ref, frames3),
                   model_rel=model_rel(emissions, single.modelset), launches=launches)
        out["config3_" + ("shared" if shared else "per_utterance")] = row
        need = ("forward_llh_dense", "estep_gamma_dense") if shared else ()
        check(row["elbo_gap_per_frame"] <= 1e-6 and row["model_rel"] <= 2e-4
              and all(launches[k] == SUP_STEPS for k in need)
              and bool((np.diff(dp) / frames3 >= -1e-6).all()),
              f"data-parallel supervised steps (shared={shared}): {row}, ELBO {dp}")
    return out


def dp_cli(tmp):
    """(iv) ``hmm train`` through its data-parallel branch on phase 19's
    data, against ``--single-device``."""
    from beer_tpu_torch.utils import load_model

    feats, init = f"{tmp}/feats_aud.npz", f"{tmp}/init.mdl"
    cuda_scan.reset_launch_counts()
    secs, printed = verb(["hmm", "train", init, feats, f"{tmp}/dp_train", "--epochs", "3"])
    launches = path_launches(DP_KERNELS[:2])
    single_secs, _ = verb(["hmm", "train", init, feats, f"{tmp}/single_train", "--epochs", "3",
                           "--single-device"])
    check(printed.startswith("data-parallel over 1 devices"), f"hmm train printed {printed!r}")
    check(all(n > 0 for n in launches.values()), f"hmm train data-parallel: launches {launches}")
    dp_log = [r["elbo_per_frame"] for r in train_log(Path(tmp) / "dp_train")]
    single_log = [r["elbo_per_frame"] for r in train_log(Path(tmp) / "single_train")]
    row = dict(elbo_gap_per_frame=float(np.abs(np.array(dp_log) - np.array(single_log)).max()),
               model_rel=model_rel(load_model(f"{tmp}/dp_train/final.mdl"),
                                   load_model(f"{tmp}/single_train/final.mdl")),
               seconds=round(secs, 3), single_device_seconds=round(single_secs, 3),
               launches=launches)
    check(len(dp_log) == 3 and row["elbo_gap_per_frame"] <= 1e-5 and row["model_rel"] <= 2e-4,
          f"hmm train data-parallel vs --single-device: {row}")
    return row


def dp_seq_parallel(dev):
    """(v) ``make_sharded_forward_backward`` in float64 at the bench shape
    of ``tests/test_seq_parallel.py`` against the unsharded general path."""
    from beer_tpu_torch import parallel
    from beer_tpu_torch.ops import seq_parallel

    graph = bt.phone_loop_graph(SEQ_UNITS, STATES_PER_UNIT).compile(torch.float64, dev)
    rng = np.random.default_rng(SEED)
    llh = torch.from_numpy(rng.normal(size=(SEQ_B, SEQ_T, graph.n_states))).to(dev)
    lengths = np.array(SEQ_LENGTHS)
    mask = torch.from_numpy((np.arange(SEQ_T)[None] < lengths[:, None]).astype(np.float64)).to(dev)
    args = (llh, graph.log_trans, graph.log_init, graph.log_final, mask)
    fn = seq_parallel.make_sharded_forward_backward(parallel.make_mesh(axis_name="seq"))
    _, _, log_z, post = fn(*args)
    fb = tss.forward_backward(*args, plain=True)
    z_rel = float(((log_z - fb.log_z).abs() / fb.log_z.abs()).max())
    post_excess = max(float(((post[i, :n] - fb.posteriors[i, :n]).abs()
                             - 1e-9 - 1e-6 * fb.posteriors[i, :n].abs()).max())
                      for i, n in enumerate(lengths))
    row = dict(shape=[SEQ_B, SEQ_T, graph.n_states], log_z_rel=z_rel,
               posteriors_over_tolerance=post_excess, ms=round(cuda_ms(lambda: fn(*args)), 3))
    check(z_rel <= 1e-8 and post_excess <= 0.0,
          f"sequence-parallel forward-backward vs the unsharded path: {row}")
    return row


def per_utterance_learned(dev):
    """3 VB steps of config 3's recognizer on per-utterance graphs with
    learned transitions (the general path) in float32 and float64, on the
    card and on the CPU from the same start: the card's float64 ELBOs and
    (B, S, S) Dirichlet within rtol 1e-9 of the CPU's, its float32 ELBOs
    within 1e-4 a frame of the CPU's, rising.  The float32 run against its
    float64 twin is printed beside ROADMAP §C.1's share of frames whose γ
    underflows: that float32 fault of the scaled recursions under an
    untrained model, in both packages, moves it by more than 1e-4 a frame
    at this shape."""
    data, mask, seqs = config3_data()
    frames = float(mask.sum())
    base = config3(dev, seqs, shared=False)
    start = bt.HMM.create(base.graph, base.modelset, learn_transitions=True).to_numpy()
    runs, share = {}, None
    for where in (dev, torch.device("cpu")):
        for dtype in (torch.float32, torch.float64):
            hmm = bt.hmm_from_numpy(start, device=where, dtype=dtype)
            x = torch.from_numpy(data).to(where, dtype)
            m = torch.from_numpy(mask).to(where, dtype)
            if where == dev and dtype == torch.float32:
                check(hmm.route() == "general" and hmm.trans_alpha_post.ndim == 3,
                      f"per-utterance learned transitions: route {hmm.route()}")
                share = hmm_underflow_share(hmm, x, m)
            elbos = np.array([float(bt.vb_step(hmm, x, mask=m)[0]) for _ in range(SUP_STEPS)])
            runs[where.type, dtype] = (elbos, hmm.trans_alpha_post.cpu())
    (e32, _), (e64, a64) = runs[dev.type, torch.float32], runs[dev.type, torch.float64]
    (c32, _), (c64, ca64) = runs["cpu", torch.float32], runs["cpu", torch.float64]
    row = dict(trans_shape=list(a64.shape), elbo_per_frame=[round(e / frames, 6) for e in e32],
               f32_card_vs_cpu_per_frame=elbo_gap(e32, c32, frames),
               f64_card_vs_cpu_rel=float(np.abs(e64 - c64).max() / np.abs(c64).max()),
               f64_dirichlet_card_vs_cpu_rel=rel(a64, ca64),
               f32_vs_f64_per_frame_not_gated=elbo_gap(e32, e64, frames),
               gamma_underflow_share=share)
    check(bool(np.isfinite(e32).all()) and bool((np.diff(e32) / frames >= -1e-6).all())
          and row["f32_card_vs_cpu_per_frame"] <= 1e-4 and row["f64_card_vs_cpu_rel"] <= 1e-9
          and row["f64_dirichlet_card_vs_cpu_rel"] <= 1e-9,
          f"learned transitions on per-utterance graphs: {row}")
    return row


def phase_parallel(dev, card, tmp):
    """The data-parallel steps, ``hmm train``'s data-parallel branch and
    sequence-parallel inference over a world-size-1 NCCL process group
    (every reduction still goes through ``all_reduce``), each against its
    single-device run, and learned transitions on per-utterance graphs.
    A failed NCCL set-up fails the phase: there is no fallback."""
    import torch.distributed as dist

    from beer_tpu_torch import parallel

    t0 = time.time()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/nccl_store", 1), rank=0,
                            world_size=1)
    try:
        group = f"world size {dist.get_world_size()}, {dist.get_backend()}"
        check(dist.get_backend() == "nccl", f"process group backend {group}")
        mesh = parallel.make_mesh()
        data, mask = make_data(B, T, D)
        x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
        frames = float(m.sum())
        out = {"config4": dp_config4(dev, mesh, x, m, frames)}
        out.update(dp_hmms(dev, mesh, x, m, frames))
        out["cli"] = dp_cli(tmp)
        out["seq_parallel"] = dp_seq_parallel(dev)
    finally:
        dist.destroy_process_group()
    out["per_utterance_learned"] = per_utterance_learned(dev)
    times = out["config4"]
    print(f"phase 23 parallel: {card} | data-parallel step {times.pop('dp_step_ms')} ms, "
          f"single-device step {times.pop('single_step_ms')} ms (config 4, B={B}, CUDA-event "
          f"medians of {REPS}) | {group} | {time.time() - t0:.1f} s | "
          + json.dumps(out)
          + " | tol: data-parallel vs single-device ELBO 1e-6/frame and 2e-4 of each array's max "
          "(hmm train: ELBO 1e-5/frame); sequence-parallel log Z rtol 1e-8, posteriors rtol 1e-6 "
          "atol 1e-9; per-utterance learned transitions card vs CPU: f32 1e-4/frame, f64 rtol 1e-9")
    launches = {}
    for row in (out["config4"]["full_batch"], out["config4"]["minibatch"], out["config2_estep"],
                out["config3_shared"], out["config3_per_utterance"], out["cli"]):
        for k, n in row["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.manual_seed(SEED)
    dev = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    kernels, k11_config4 = phase_kernels(dev)
    launches, loop, x, m = phase_slice(dev)
    phase_times(loop, x, m)
    kernels.update(phase_hmm_kernels(dev))
    hmm_launches, runs = phase_hmm_slice(dev)
    launches = {k: launches.get(k, 0) + n for k, n in hmm_launches.items()}
    phase_hmm_times(runs)
    gmm_kernels, _ = phase_gmm_kernels(dev)
    kernels.update(gmm_kernels)
    gmm_launches, gmm_runs = phase_gmm_slice(dev)
    launches = {k: launches.get(k, 0) + n for k, n in gmm_launches.items()}
    phase_gmm_times(gmm_runs)
    svae_rows = phase_svae_kernels(dev)
    kernels["forward_llh_banded"]["config5"] = svae_rows.pop("forward_llh_banded")
    kernels["viterbi_fwd_banded"]["config5"] = svae_rows.pop("viterbi_fwd_banded")
    kernels.update(svae_rows)
    kernels["estep_gamma_banded"]["config4"] = k11_config4
    svae_launches, svae_runs = phase_svae_slice(dev)
    launches = {k: launches.get(k, 0) + n for k, n in svae_launches.items()}
    phase_svae_times(svae_runs)
    instances, pairs = phase_general_kernels(dev)
    gsm_launches, gsm_runs = phase_gsm_slice(dev)
    launches = {k: launches.get(k, 0) + n for k, n in gsm_launches.items()}
    phase_gsm_times(dev, gsm_runs, instances)
    large, large_launches, loop_rows, vit_rows, back_rows = phase_large_dense(dev)
    launches = {k: launches.get(k, 0) + n for k, n in large_launches.items()}
    # K12/K13's rows: the banded instance, which PhoneLoop.smooth takes, with
    # every instance's numbers beside it; K14/K15's: config 4's shape
    main_instance = "banded"
    for name in ("scaled_pass", "smoothing_pass"):
        kernels[name] = dict(instances[main_instance][name], instance=main_instance, instances={
            inst: rows[name] for inst, rows in instances.items() if name in rows})
    for name, row in pairs["config4"].items():
        kernels[name] = dict(row, config2=pairs["config2"][name])
    # the dense kernels at S = 150 and 300 (phase 18), each instance named
    # by its placement
    for s, rows in large.items():
        for name, row in rows.items():
            kernel = "scaled_pass" if name == "scaled_pass_reverse" else name
            inst = ("dense_reverse_" if name == "scaled_pass_reverse"
                    else "dense_" if kernel in ("scaled_pass", "smoothing_pass") else "")
            kernels[kernel].setdefault("instances", {})[f"{inst}{row['placement']}_s{s}"] = row
    # the banded kernels on the large phone loops (phase 18), named by placement
    for units, rows in loop_rows.items():
        for name, row in rows.items():
            kernels[name].setdefault("instances", {})[f"{row['placement']}_u{units}"] = row
    for tag, row in vit_rows.items():
        kernels["viterbi_fwd_banded"].setdefault("instances", {})[f"{row['placement']}_{tag}"] = row
    for tag, row in back_rows.items():
        kernels["viterbi_backtrace_banded"].setdefault("instances", {})[f"{row['placement']}_{tag}"] = row
    with tempfile.TemporaryDirectory(prefix="beer_cli_") as tmp:
        for phase in (phase_cli, phase_supervised, phase_mapreduce_shmm):
            for k, n in phase(dev, card, tmp).items():
                launches[k] = launches.get(k, 0) + n
        for k, n in phase_subspace(dev, card).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in phase_parallel(dev, card, tmp).items():   # phase 19's data
            launches[k] = launches.get(k, 0) + n
    rows = [dict(name=k, route="cuda", source=cuda_scan.KERNELS[k].source,
                 replaces=REPLACES[k], launches=launches[k], **{"library_ms": None, **v})
            for k, v in kernels.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
