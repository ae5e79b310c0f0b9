#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's phone-loop main path once on one GPU.

    python3 chip_smoke.py

Runs BASELINE config 4 (phone-loop acoustic-unit discovery: 50 units ×
3 states, diagonal NormalSet over 39-dim frames, stick-breaking unit
prior) at the bench shape (B=512 utterances, T ≤ 500 frames, lengths
uniform in [250, 500]) with random data and weights from fixed seeds, in
five phases, each printing one line:

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
   kernel route beside plain route.

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
SEED = 0
N_STEPS = 5
REPS = 5

# kernel → the Pallas TPU kernel body it replaces
REPLACES = {
    "forward_llh_banded": "beer_tpu/ops/pallas_scan.py:1640",
    "estep_acc_banded": "beer_tpu/ops/pallas_scan.py:2083",
    "viterbi_fwd_banded": "beer_tpu/ops/pallas_scan.py:2596",
    "viterbi_backtrace_banded": "beer_tpu/ops/pallas_scan.py:2707",
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
    launches = {k: v.launches for k, v in cuda_scan.KERNELS.items()}
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
    rows = [dict(name=k, route="cuda", source=cuda_scan.KERNELS[k].source,
                 replaces=REPLACES[k], launches=launches[k], **v) for k, v in kernels.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
