#!/usr/bin/env python3
"""Time variants of the full-covariance kernels K9 and K10 alone on one GPU.

    python3 stats_variants.py [variant ...]

Each variant is ``beer_tpu_torch/csrc/stats_full.cu`` with a few text
substitutions (a design knob changed or one stage removed), built with
``nvcc -shared`` into its own library (all variants in parallel) and
loaded with ``ctypes``; the entry points need no other source.  Each
variant's K9 and K10 are timed with CUDA events around the bare foreign
call (median of 20 after a warm-up) at the two shapes that ``chip_smoke.py``
phase 9 times, config 1 (T = 256,000, D = 39, K = 64) and the recognizer
(T = 38,400, K = 60), on the same random data, and held against the plain
versions where the variant computes the same function.  One line per
variant, beside the card's name and power limit.  The variants answer
where the kernels' time goes; the shipped kernels are the "base" variant.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as c
from beer_tpu_torch.ops import cuda_scan
from beer_tpu_torch.ops import stats_kernels as sk

CAP9 = "__launch_bounds__(EllhTile<BM, BN, TN>::kThreads, 512 / EllhTile<BM, BN, TN>::kThreads)"
K9_88 = [("f(ellh_full_kernel<128, 64, 4>, EllhTile<128, 64, 4>())",
          "f(ellh_full_kernel<128, 64, 8>, EllhTile<128, 64, 8>())"),
         ("f(ellh_full_kernel<64, 64, 4>, EllhTile<64, 64, 4>())",
          "f(ellh_full_kernel<64, 64, 8>, EllhTile<64, 64, 8>())")]
# name -> (substitutions, computes the same function, K10's frames a tile)
VARIANTS = {
    "base": ([], True, 32),
    # the S operand not built: the pure GEMM on whatever the ring holds
    "no_s_build": ([("    build_s(c + 1, cur ^ 1);  // (past the last chunk: zeros, never read)\n", ""),
                    ("#pragma unroll 8\n    for (int t = 0; t < kTt10; ++t) ss[t * kLdS + tid] = "
                     "xt[oa + t * sa] * xt[ob + t * sb];", "")], False, 32),
    # K9 without the 128-register cap
    "uncapped": ([(CAP9, "__launch_bounds__(EllhTile<BM, BN, TN>::kThreads)")], True, 32),
    # K9 at 8 × 8 outputs a thread for the 64-component tile (128 threads
    # for 128 × 64), K10 at 16 frames a tile
    "tiles_8x8": (K9_88 + [("constexpr int kTt10 = 32;", "constexpr int kTt10 = 16;")], True, 16),
    # K9 with chunks of 32 lanes, K10 with tiles of 64 frames
    "long_chunks": ([("constexpr int kLc9 = 16;", "constexpr int kLc9 = 32;"),
                     ("constexpr int kTt10 = 32;", "constexpr int kTt10 = 64;")], True, 64),
}
REPS = 20
# registers reported for the instances the two shapes take
REPORTED = {"ellh_full_kernelILi128ELi64": "k9_128x64", "ellh_full_kernelILi64ELi64": "k9_64x64",
            "accumulate_full_kernelILi64": "k10_64"}


def build(names):
    """Compile the variants in parallel; returns {name: (library path, registers)}."""
    src = (cuda_scan.CSRC / "stats_full.cu").read_text()
    tmp = Path(tempfile.mkdtemp(dir=cuda_scan.BUILD_DIR))
    (tmp / "scan_common.cuh").write_text((cuda_scan.CSRC / "scan_common.cuh").read_text())
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in stats_full.cu")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_scan._nvcc(), *cuda_scan.NVCC_FLAGS, "-shared", "-o", str(tmp / f"{name}.so"),
             str(tmp / f"{name}.cu")], stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-3000:]}")
        regs, entry = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = next((k for k in REPORTED if k in line), None)
            elif "Used " in line and entry:
                regs[REPORTED[entry]] = int(line.split("Used ")[1].split()[0])
        out[name] = (tmp / f"{name}.so", regs)
    return out


def median_ms(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(names) -> int:
    if not torch.cuda.is_available():
        print("stats_variants: no CUDA device", file=sys.stderr)
        return 2
    c.phase_device()
    dev = torch.device("cuda", 0)
    built = build(names)
    x1 = c.config1_frames(dev)
    e1, log_w = c.gmm_operands(c.config1(dev))
    data3, _, seqs = c.config3_data()
    x3 = torch.from_numpy(data3.reshape(-1, c.D)).to(dev)
    e3 = c.config3_full(dev, seqs).modelset.modelset.means_precisions.expected_sufficient_statistics()
    shapes = {"config1": (x1, e1, torch.softmax(sk.ellh_full_plain(x1, e1) + log_w, -1)),
              "recognizer": (x3, e3, torch.softmax(sk.ellh_full_plain(x3, e3), -1))}
    want = {tag: (sk.ellh_full_plain(x, e), sk.accumulate_full_plain(x, r))
            for tag, (x, e, r) in shapes.items()}
    p, i = ctypes.c_void_p, ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    d, width = c.D, sk.packed_width(c.D)
    for name in names:
        path, regs = built[name]
        subs, same, frames = VARIANTS[name]
        lib = ctypes.CDLL(str(path))
        lib.beer_ellh_full.argtypes = [i, p, p, p] + [i] * 6 + [p]
        lib.beer_accumulate_full.argtypes = [i, p, p, p, p] + [i] * 6 + [p]
        lib.beer_stats_blocks.argtypes = [i] * 5
        lib.beer_stats_prepare.argtypes = [i]
        c.check(lib.beer_stats_prepare(0) == 0, f"{name}: prepare")
        chunk = 32 if name == "long_chunks" else sk.ELLH_LANE_CHUNK
        row = {}
        for tag, (x, e, r) in shapes.items():
            t_len, k = r.shape
            tile_t, tile_k = sk.ellh_tiles(t_len, k)
            k_pad = -(-k // tile_k) * tile_k
            w = torch.nn.functional.pad(sk.pack_weights(e, d), (
                0, k_pad - k, 0, (-(-width // chunk) + 1) * chunk - width))
            out = torch.empty(t_len, k, device=dev)
            ellh = lambda: lib.beer_ellh_full(0, ptr(x), ptr(w), ptr(out), t_len, d, k, k_pad,  # noqa: E731
                                              tile_t, tile_k, stream)
            c.check(ellh() == 0, f"{name}: K9 launch")
            row[f"k9_{tag}_ms"] = median_ms(ellh)
            acc_k = sk.accumulate_tile_k(k)
            resident = lib.beer_stats_blocks(0, 2, d, k, acc_k)
            n_tiles = -(-t_len // frames)
            per = -(-n_tiles // min(n_tiles, max(1, round(resident / (-(-width // 128) * -(-k // acc_k))))))
            n_slices, slice_len = -(-n_tiles // per), per * frames
            lanes = -(-width // 128) * 128
            part = torch.empty(n_slices, k * lanes, device=dev)
            total = torch.empty(k * lanes, device=dev)
            acc = lambda: lib.beer_accumulate_full(0, ptr(x), ptr(r), ptr(part), ptr(total),  # noqa: E731
                                                   n_slices, slice_len, t_len, d, k, acc_k, stream)
            c.check(acc() == 0, f"{name}: K10 launch")
            row[f"k10_{tag}_ms"] = median_ms(acc)
            if same:
                got = sk.unpack_acc(total.view(k, lanes)[:, :width], d)[0]
                c.check(c.rel(out, want[tag][0]) <= 1e-5 and c.rel(got, want[tag][1]) <= 1e-4,
                        f"{name}: {tag} differs from the plain versions")
        print(f"variant {name}: " + ", ".join(f"{k_} {v:.3f}" for k_, v in row.items())
              + f" | registers {regs} | {'same function' if same else 'not the same function'}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
