#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU.

    python3 chip_smoke.py

Runs BASELINE config 4 (phone-loop acoustic-unit discovery: 50 units ×
3 states, diagonal NormalSet over 39-dim frames, stick-breaking unit
prior) at the bench shape (B=512 utterances, T ≤ 500 frames, lengths
uniform in [250, 500]), then the Bayesian HMM of configs 2 (ergodic
30-state HMM with learned transitions, the same data shape) and 3
(10-phone × 3-state recognizer on shared transcription graphs, B=128,
T=300), with random data and weights from fixed seeds, in eight phases,
each printing one line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the hand-written CUDA kernels from the sources in
   ``beer_tpu_torch/csrc`` and loads them;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it (plus two zero-length rows);
4. slice: 5 VB-EM steps and a unit decode through the kernels, with the
   launch counters read around that run; the ELBO must be finite and
   non-decreasing and match the plain route's; a small problem is held
   against the float64 general path on the CPU;
5. times: CUDA-event medians of each kernel, one vb_step and one decode,
   kernel route beside plain route;
6. hmm kernels: K5–K7 (dense transitions) against their plain versions
   at the config-2 and config-3 shapes (plus two zero-length rows, and
   per-row final vectors with padding states), with CUDA-event medians;
7. hmm slice: per config, 5 VB-EM steps, a decode, the posteriors and
   the ξ counts through the kernels with the launch counters read
   around that run, the same on the plain route; the ELBO must be
   finite and non-decreasing and within 1e-4 per frame of the plain
   route, decode paths equal, posteriors within 1e-4 of the plain
   route's and summing to 1, ξ counts summing to the number of
   transitions; small problems are held against the float64 general
   path on the CPU;
8. hmm times: one vb_step, one decode and one posteriors call per
   config, kernel route beside plain route.

Then one JSON line describing the kernels, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; without a CUDA device it exits non-zero before
printing a result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

import beer_tpu_torch as bt
from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.ops import semiring_scan as tss

B, T, D = 512, 500, 39
N_UNITS, STATES_PER_UNIT = 50, 3
HMM_S = 30                                  # config 2 (bench.py:295)
REC_B, REC_T, REC_PHONES, REC_SPP = 128, 300, 10, 3   # config 3 (bench.py:348-349)
SEED = 0
N_STEPS = 5
REPS = 5

# kernel → the Pallas TPU kernel body it replaces
REPLACES = {
    "forward_llh_banded": "beer_tpu/ops/pallas_scan.py:1640",
    "estep_acc_banded": "beer_tpu/ops/pallas_scan.py:2083",
    "viterbi_fwd_banded": "beer_tpu/ops/pallas_scan.py:2596",
    "viterbi_backtrace_banded": "beer_tpu/ops/pallas_scan.py:2707",
    "forward_llh_dense": "beer_tpu/ops/pallas_scan.py:1640",
    "estep_acc_dense": "beer_tpu/ops/pallas_scan.py:2083",
    "estep_gamma_dense": "beer_tpu/ops/pallas_scan.py:1844",
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


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_build():
    t0 = time.time()
    path = cuda_scan.build()
    cuda_scan._library()
    print(f"phase 2 build: {time.time() - t0:.1f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas", line.strip())


def phase_kernels(dev):
    """Each kernel against its plain version at the main path's shapes."""
    data, mask = make_data(B, T, D)
    data = np.concatenate([data, np.zeros((2, T, D), np.float32)])  # two zero-length rows
    mask = np.concatenate([mask, np.zeros((2, T), np.float32)])
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    loop = config4(dev)
    stats = loop.sufficient_statistics(x).contiguous()
    ops = loop.scan_operands(stats, m)
    full = ops["lens"] > 0
    tiny = torch.finfo(torch.float32).tiny
    out = {}

    fwd = (stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["init"])
    k1 = cuda_scan.forward_llh_banded(*fwd)
    p1 = cuda_scan.forward_llh_banded_plain(*fwd)
    logz = [o[3] + torch.log((o[2] * ops["final"]).sum(-1).clamp_min(tiny)) for o in (k1, p1)]
    e_logz = rel(logz[0][full], logz[1][full])
    check(e_logz <= 1e-5, f"forward log Z rel {e_logz}")
    check(not bool(k1[3][~full].any()), "forward: empty rows must give logz_base 0")
    out["forward_llh_banded"] = dict(
        max_abs_err=float((logz[0][full] - logz[1][full]).abs().max()),
        ms=cuda_ms(lambda: cuda_scan.forward_llh_banded(*fwd)),
        plain_ms=cuda_ms(lambda: cuda_scan.forward_llh_banded_plain(*fwd)))

    est = (stats, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["final"], k1[0], k1[1],
           ops["ends"], ops["starts"])
    k2 = cuda_scan.estep_acc_banded(*est)
    p2 = cuda_scan.estep_acc_banded_plain(*est)
    for name, i in (("acc2", 0), ("counts", 1), ("xi", 3)):
        e = rel(k2[i], p2[i])
        check(e <= 1e-4, f"estep {name} rel {e}")
    e_g0 = float((k2[2] - p2[2]).abs().max())
    check(e_g0 <= 1e-5, f"estep gamma0 abs {e_g0}")
    out["estep_acc_banded"] = dict(
        max_abs_err=float((k2[0] - p2[0]).abs().max()),
        ms=cuda_ms(lambda: cuda_scan.estep_acc_banded(*est)),
        plain_ms=cuda_ms(lambda: cuda_scan.estep_acc_banded_plain(*est)))

    graph = ops["graph"]
    llh = loop.modelset.expected_log_likelihood(stats).contiguous()
    vit = (llh, ops["lens"], tss.log_bands(ops["bands"]).contiguous(),
           torch.clamp(graph.log_init, min=-1e30).contiguous())
    k3 = cuda_scan.viterbi_fwd_banded(*vit)
    p3 = cuda_scan.viterbi_fwd_banded_plain(*vit)
    best = [(o[2] + graph.log_final).max(-1).values[full] for o in (k3, p3)]
    e3 = rel(best[0], best[1])
    check(e3 <= 1e-6, f"viterbi best scores rel {e3}")
    agree = float((k3[0] == p3[0]).float().mean())
    check(agree >= 0.999, f"viterbi choices agree on {agree}")
    out["viterbi_fwd_banded"] = dict(
        max_abs_err=float((best[0] - best[1]).abs().max()),
        ms=cuda_ms(lambda: cuda_scan.viterbi_fwd_banded(*vit)),
        plain_ms=cuda_ms(lambda: cuda_scan.viterbi_fwd_banded_plain(*vit)))

    back = (k3[0], k3[1], k3[2], graph.log_final.contiguous())
    k4 = cuda_scan.viterbi_backtrace_banded(*back)
    p4 = cuda_scan.viterbi_backtrace_banded_plain(*back)
    valid = m > 0
    agree = float((k4[0] == p4[0])[valid].float().mean())
    check(agree >= 0.999, f"backtrace paths agree on {agree} of valid frames")
    check(rel(k4[1][full], p4[1][full]) <= 1e-6, "backtrace scores")
    out["viterbi_backtrace_banded"] = dict(
        max_abs_err=float((k4[0] - p4[0])[valid].abs().max()),
        ms=cuda_ms(lambda: cuda_scan.viterbi_backtrace_banded(*back)),
        plain_ms=cuda_ms(lambda: cuda_scan.viterbi_backtrace_banded_plain(*back)))
    torch.cuda.synchronize()
    print("phase 3 kernels: " + "; ".join(
        f"{k} ok (max_abs_err {v['max_abs_err']:.3g})" for k, v in out.items())
        + " | tol: log Z rel 1e-5; acc2/counts/xi rel 1e-4; gamma0 abs 1e-5; "
          "paths >= 99.9% of valid frames; scores rel 1e-6")
    return out


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
    plain = copy.deepcopy(loop)
    plain.plain_scan = True

    cuda_scan.reset_launch_counts()
    elbos = run_steps(loop, x, m)
    units, scores = loop.decode_units(x, m)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in cuda_scan.KERNELS.items() if k.endswith("_banded")}
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
    twin = copy.deepcopy(loop)
    twin.plain_scan = True
    units_plain, _ = twin.decode_units(x, m)
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
    plain = copy.deepcopy(loop)
    plain.plain_scan = True
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


def phase_hmm_kernels(dev):
    """K5–K7 against their plain versions at the config-2/3 shapes."""
    out = {}
    tiny = torch.finfo(torch.float32).tiny
    # config 2 (stats route): K5 with in-kernel ELLH, K6
    data, mask = make_data(B, T, D)
    data = np.concatenate([data, np.zeros((2, T, D), np.float32)])  # two zero-length rows
    mask = np.concatenate([mask, np.zeros((2, T), np.float32)])
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    hmm = config2(dev)
    stats, c = hmm_operands(hmm, x, m)
    full = c["lens"] > 0
    final = c["final"].clone()
    final[: B // 4, -5:] = 0.0                # per-row final vectors with padding states
    init = torch.exp(hmm.graph_log_init).expand_as(final).contiguous()
    fwd = (stats, c["lens"], c["trans"], init, c["w"], c["bias"])
    k5 = cuda_scan.forward_llh_dense(*fwd)
    p5 = cuda_scan.forward_llh_dense_plain(*fwd)
    logz = [o[3] + torch.log((o[2] * final).sum(-1).clamp_min(tiny)) for o in (k5, p5)]
    e5 = rel(logz[0][full], logz[1][full])
    check(e5 <= 1e-5, f"dense forward log Z rel {e5}")
    check(float((k5[0] - p5[0]).abs().max()) <= 1e-5, "dense forward alpha")
    check(not bool(k5[3][~full].any()), "dense forward: empty rows must give logz_base 0")
    out["forward_llh_dense"] = dict(
        max_abs_err=float((logz[0][full] - logz[1][full]).abs().max()),
        ms=cuda_ms(lambda: cuda_scan.forward_llh_dense(*fwd)),
        plain_ms=cuda_ms(lambda: cuda_scan.forward_llh_dense_plain(*fwd)))
    est = (stats, c["lens"], c["w"], c["bias"], c["trans"], final, k5[0], k5[1])
    k6 = cuda_scan.estep_acc_dense(*est)
    p6 = cuda_scan.estep_acc_dense_plain(*est)
    for name, i in (("acc2", 0), ("counts", 1), ("xi", 3)):
        e = rel(k6[i], p6[i])
        check(e <= 1e-4, f"dense estep {name} rel {e}")
    check(float((k6[2] - p6[2]).abs().max()) <= 1e-5, "dense estep gamma0")
    out["estep_acc_dense"] = dict(
        max_abs_err=float((k6[0] - p6[0]).abs().max()),
        ms=cuda_ms(lambda: cuda_scan.estep_acc_dense(*est)),
        plain_ms=cuda_ms(lambda: cuda_scan.estep_acc_dense_plain(*est)))
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
    out["estep_gamma_dense"] = dict(
        max_abs_err=e7,
        ms=cuda_ms(lambda: cuda_scan.estep_gamma_dense(*gam)),
        plain_ms=cuda_ms(lambda: cuda_scan.estep_gamma_dense_plain(*gam)))
    llh_fwd = dict(ms=cuda_ms(lambda: cuda_scan.forward_llh_dense(*fwd3)),
                   plain_ms=cuda_ms(lambda: cuda_scan.forward_llh_dense_plain(*fwd3)))
    torch.cuda.synchronize()
    print("phase 6 hmm kernels: " + "; ".join(
        f"{k} ok (max_abs_err {v['max_abs_err']:.3g}, {v['ms']:.3f} ms vs plain "
        f"{v['plain_ms']:.3f} ms)" for k, v in out.items())
        + f" | forward_llh_dense on the config-3 llh stream {llh_fwd['ms']:.3f} ms vs plain "
          f"{llh_fwd['plain_ms']:.3f} ms, log Z rel {e5b:.3g}"
        + " | tol: log Z rel 1e-5; alpha, gamma, gamma0 abs 1e-5; acc2/counts/xi rel 1e-4")
    return out


def hmm_reference_check(dev):
    """Kernel routes (card, float32) against the general path (CPU, float64)."""
    data, mask = make_data(6, 40, 4, seed=3)
    mask[-1] = 0.0
    x64, m64 = torch.from_numpy(data).double(), torch.from_numpy(mask).double()
    seqs = [[0, 1], [2], [1, 2, 0], [0], [2, 2], [1]]
    for name, ref in (("config 2", config2("cpu", s=6, dim=4, dtype=torch.float64)),
                      ("config 3", config3("cpu", seqs, n_phones=3, spp=2, dim=4,
                                           dtype=torch.float64))):
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
        check(cache["route"] == ("stats" if name == "config 2" else "llh"), f"{name}: route")
        check(rel(lz.double().cpu(), lz_ref) <= 1e-5, f"small {name}: log Z vs float64")
        e = rel(acc["modelset"]["means_precisions"].double().cpu(), acc_ref["means_precisions"])
        check(e <= 1e-4, f"small {name}: statistics rel {e} vs float64")
        e = rel(card.expected_transition_counts(cache).double().cpu(), xi_ref)
        check(e <= 1e-4, f"small {name}: transition counts rel {e} vs float64")


def hmm_run(model, x, m, frames, label):
    """5 VB-EM steps, a decode, ``HMM.posteriors`` and
    ``HMM.expected_transition_counts`` through the kernels (counters read
    around them), then the same on the plain route.  The posteriors sum
    to 1 on every valid frame, and the ξ counts to the number of
    frame-to-frame transitions, Σ_b (len_b − 1)."""
    plain = copy.deepcopy(model)
    plain.plain_scan = True
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
    twin = copy.deepcopy(model)
    twin.plain_scan = True
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
        plain = copy.deepcopy(model)
        plain.plain_scan = True
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.manual_seed(SEED)
    dev = torch.device("cuda", 0)
    phase_device()
    phase_build()
    kernels = phase_kernels(dev)
    launches, loop, x, m = phase_slice(dev)
    phase_times(loop, x, m)
    kernels.update(phase_hmm_kernels(dev))
    hmm_launches, runs = phase_hmm_slice(dev)
    launches = {k: launches.get(k, 0) + n for k, n in hmm_launches.items()}
    phase_hmm_times(runs)
    rows = [dict(name=k, route="cuda", source=cuda_scan.KERNELS[k].source,
                 replaces=REPLACES[k], launches=launches[k], **v) for k, v in kernels.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
