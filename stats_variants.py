#!/usr/bin/env python3
"""Time variants of the full-covariance kernels K9 and K10 alone on one GPU.

    python3 stats_variants.py [variant ...]
    python3 stats_variants.py probe | times | b2 | b7 | b11 | b13 | b12 | geometry | b11_geometry | b13_geometry
                              | b12_geometry | vb | diag
    python3 stats_variants.py --sources DIR k2_* | k6_* | k1_* | k7_* | k11_* | k3_* | k4_* | k13_* | k12_*

``probe`` is the 3×TF32 probe that decided K8's arithmetic (see
:func:`probe`); it builds no variant.  ``times`` times K8 alone at config
1 and K5 alone at configs 2 and 3 through the package's own entry
points, so that the same file, copied into a checkout of another
revision, times that revision's kernels.  The ``k8_*`` variants (of
``stats_full.cu``) time K8 alone at config 1, the ``k5_*`` variants (of
``hmm_scan.cu``) K5 alone at configs 2 and 3, at S = 300 and near the
shared placement's limit, in each instance and chunk length the launch
can be given.

B2, the accumulating backward (K2 banded at config 4, K6 dense at config
2): ``b2`` times K2, K6 (also at phase 18's S = 150 and 300), K11, K7,
K15 and K1 (configs 4 and 5) through this checkout's wrappers, split by
kernel in profiler device time (so that the batch sum,
``sum_rows_kernel``, shows apart), and the unfused route at config 4
(K11 + γᵀ·stats); like ``times`` it runs on any revision, and so does
``vb``, one ``vb_step`` of configs 4 and 2.  ``geometry`` times the
redesigned K2 in each launch geometry and K6 in each instance.  The
``k2n_*`` / ``k6n_*`` variants take stages out of the redesigned kernels
(their anatomy) or change a knob.  The ``k2_*`` / ``k6_*`` variants take
the same stages out of K2 and K6 as they stood before their redesign
(``PERF.md``'s anatomy of the parent): they edit that revision's
sources, so they take ``--sources DIR``, DIR holding its
``beer_tpu_torch/csrc`` (``git archive 53a1783 beer_tpu_torch/csrc``),
and stop with that hint on any other.

B1 and B7, the forward and the γ-emitting backward: ``b7`` times K1 at
configs 4 and 5 and on phone loops of 100 and 250 units, K7 at config 3
and at phase 18's S = 150 and 300, K15 at config 4, and beside them K2,
K6 (config 2, S = 150 and 300), K11 (configs 4 and 5) and K5 (configs 2
and 3), each split by kernel in profiler device time, through this
checkout's wrappers (any revision, as ``b2``).  ``geometry`` also times
K1 in each launch geometry, K7 / K15 in each instance, and K2 and K6's
warp instance at small batches with 4, 2 and 1 utterances a block.  The ``k1n_*`` /
``k7n_*`` variants take stages out of the chunked K1 and K7; the ``k1_*``
/ ``k7_*`` variants take them out of the per-frame K1 and K7 as they
stood before (6a3a03f; ``--sources DIR``, as ``k2_*``).

B7's banded mode and B3: ``b11`` times K11 (configs 4 and 5, 100 and 250
units) and K3 (configs 3, 4 and 5) with K1, K2, K6, K7, K15 and K5 beside
them, split by kernel, through this checkout's wrappers (any revision, as
``b7``); ``b11_geometry`` times the chunked K11 and K3 in each launch
geometry.  The ``k11n_*`` / ``k3n_*`` variants take stages out of the
chunked K11 and K3; the ``k11_*`` / ``k3_*`` variants out of the
per-frame ones as they stood before (0849d1a; ``--sources DIR``).

B4 and B9e, the backtrace and the banded smoothing: ``b13`` times K4 (the
decodes of configs 3, 4 and 5 and of phone loops of 100, 250, 700 and
3,200 units, S = 300 to 9,600, on the operands each decode gives it) and
K13's banded instance (config 4, S = 150, and S = 450), with K12 banded,
K13 dense, K3 and K11 beside them, split by kernel, through this
checkout's wrappers (any revision, as ``b11``).  The ``k4_*`` /
``k13_*`` variants take stages out of K4 and K13 as they stood before
their redesign (3d14238; ``--sources DIR``): K4's final arg-max, its exit
load and its path write; K13's in-chain loads of e and α̂, its post-norm
reduction and its γ / ŵ writes.  ``b13_geometry`` times the redesigned
K13 banded and K4 in several launch geometries; the ``k4n_*`` /
``k13n_*`` variants take stages out of the redesigned kernels.

B9a–d, K12 and K13's dense instance: ``b12`` times K12 (banded forward,
dense forward, dense reverse) and K13 (banded, dense) on phone loops of
50, 10, 100 and 150 units over config 4's data (S = 150, 30, 300, 450),
with K1, K2, K3, K4 and K11 beside them, split by kernel, through this
checkout's wrappers (any revision, as ``b13``); ``b12_geometry`` times the
grouped dense instances in several launch geometries, their rows grouped
by length and as they come, and K12 banded in several.  The ``k12_*``
variants take stages out of K12 and K13 dense as they stood before their
redesign (13e9c4a; ``--sources DIR``): the banded forward's q reduction,
its e loads, its probs writes, and the dense products cut to a quarter (A
read once for 4 utterances) or removed; the ``k12n_*`` / ``grpn_*``
variants take stages out of the redesigned ones.

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

``diag`` times ``diag_stats``, the diagonal statistics [−½x², x] in one
pass, alone at the benchmark's batch beside the plain expression it
replaced (square, scale, ``torch.cat``), a device-to-device copy of as
many bytes and its bound (any revision: without the kernel it times the
rest).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
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
# K8: name -> (substitutions, computes the same function, (component tile, frames) or None)
K8_ACC = ("    if (K <= 32)\n      estep_acc<32>", "    else\n      estep_acc<64>")
K8_VARIANTS = {
    "k8_base": ([], True, None),
    # supertiles of 256 frames: one block an SM, half the partial traffic
    "k8_f256": ([], True, (64, 256)),
    # S built neither for the joint nor for the accumulation
    "k8_no_s_build": ([("    build_s(c + 1, cur ^ 1);\n    const float* st = ring + cur * kStage;",
                        "    const float* st = ring + cur * kStage;"),
                       ("        ss[t * kLdS8 + gt] = xr[ia] * xr[ib];", "")], False, None),
    # no register cap (one block an SM where the registers say so)
    "k8_uncapped": ([("__launch_bounds__(kThr8, 2) gmm_estep_full_kernel", "__launch_bounds__(kThr8) gmm_estep_full_kernel")],
                    True, None),
    "k8_no_softmax": ([("    for (int t = warp; t < F; t += kThr8 / 32) {",
                        "    for (int t = warp; t < 0; t += kThr8 / 32) {")], False, None),
    "k8_joint_only": ([(K8_ACC[0], "    if (false)\n      estep_acc<32>"),
                       (K8_ACC[1], "    else if (false)\n      estep_acc<64>")], False, None),
    "k8_acc_only": ([("    for (int t0 = 0; t0 < rows; t0 += BM)", "    for (int t0 = 0; t0 < 0; t0 += BM)")],
                    False, None),
}
# K5: name -> (substitutions, computes the same function)
K5_NO_ELLH = [("      for (int p = 0; p < ldr; p += 4) {", "      for (int p = 0; p < 0; p += 4) {"),
              ("        for (int p = 0; p < P; ++p) {", "        for (int p = 0; p < 0; ++p) {"),
              ("          for (int p = 0; p < P; ++p) l = fmaf(", "          for (int p = 0; p < 0; ++p) l = fmaf(")]
K5_NO_STORES = [("      if (on) al_b[static_cast<size_t>(t) * S + j] = carry;\n", ""),
                ("        al_b[static_cast<size_t>(t) * S + j] = a;\n", "")]
K5_VARIANTS = {
    "k5_base": ([], True),
    "k5_no_ellh": (K5_NO_ELLH, False),
    # every chunk waits for its own copy: no overlap with the recursion
    "k5_no_prefetch": ([("cp_async_wait(more);", "cp_async_wait(false);")], True),
    # the chain floor: the bare recursion, no ELLH and no α̂ stores
    "k5_chain_floor": (K5_NO_ELLH + K5_NO_STORES, False),
    # the warp instance with the branch on S between its shuffles, as first written
    "k5_lane_branch": ([("        for (int i = 0; i < 32; ++i) q[i & 3] = fmaf(",
                         "        for (int i = 0; i < 32; ++i) if (i < S) q[i & 3] = fmaf(")], True),
    # the global block instance with A read in a plain loop, as the shared one reads it
    "k5_blk_plain_loop": ([("              if (i0 + u < S) base = fmaf(prev[i0 + u], av[u], base);",
                            "              if (i0 + u < S) base = fmaf(prev[i0 + u], a_m[(i0 + u) * ldt_a + j], base);")],
                          True),
    # the block instance without its propagate (α̂ from e alone)
    "k5_blk_no_prop": ([("          for (int i = 0; i < S; ++i) base = fmaf(prev[i], a_m[i * ldt_a + j], base);",
                         "          for (int i = 0; i < 0; ++i) base = fmaf(prev[i], a_m[i * ldt_a + j], base);"),
                        ("          for (int i0 = 0; i0 < S; i0 += 32) {", "          for (int i0 = 0; i0 < 0; i0 += 32) {")],
                       False),
    # the shared block instance reading A in batches of 32, as the global one does
    "k5_blk_batched_shared": ([("        } else if (!kGlobal) {\n", "        } else if (false) {\n")], True),
    # the division a step, as first written, in both instances
    "k5_div": ([("      carry = raw * (1.f / norm);", "      carry = raw / norm;"),
                ("        const float a = cur[j] * inv;", "        const float a = cur[j] / pn;")], True),
    # the block instance without its launch bound (ptxas then keeps it at 32 registers)
    "k5_blk_no_lb": ([("__global__ void __launch_bounds__(1024, 1) forward_llh_dense_kernel(",
                       "__global__ void forward_llh_dense_kernel(")], True),
    # the block instance's chunk length a runtime value at 16 frames too
    "k5_runtime_chunk": ([("  const bool full = chunk == kChunkBlock;", "  const bool full = false;")], True),
    # the warp instance without its recursion: the chunks' loads, ELLH and stores only
    "k5_no_chain": ([("    for (int f = 0; f < nf; ++f) {\n      const int t = f0 + f;\n      float base;",
                      "    for (int f = 0; f < 0; ++f) {\n      const int t = f0 + f;\n      float base;")], False),
}
# K2 and K6 (B2, the accumulating backward) as they stood before their
# redesign (53a1783): substitutions in that revision's sources, which
# build() reads from --sources DIR; name -> (substitutions, computes the
# same function)
K2_NO_ACC = [("        for (int p = 0; p < P; ++p) ar[p] = fmaf(g, x_sh[p], ar[p]);\n        ar[P] += g;\n",
              "        (void)ar;\n")]
K2_NO_XI = [("    if (!is_last) {\n      for (int k = tid; k < U * U; k += nt) {",
             "    if (false) {\n      for (int k = tid; k < U * U; k += nt) {")]
K2_NO_ELLH = [("      for (int p = 0; p < P; ++p) acc = fmaf(wr[p], x_sh[p], acc);\n      acc += bias_sh[s];\n"
               "      v_sh[s] = acc;\n      mx = fmaxf(mx, acc);\n      r +=",
               "      acc = bias_sh[s] + 0.f * wr[0];\n      v_sh[s] = acc;\n      mx = fmaxf(mx, acc);\n      r +=")]
K2_VARIANTS = {
    "k2_base": ([], True),
    "k2_no_acc": (K2_NO_ACC, False),
    "k2_no_xi": (K2_NO_XI, False),
    "k2_no_ellh": (K2_NO_ELLH, False),
    "k2_chain_floor": (K2_NO_ACC + K2_NO_XI + K2_NO_ELLH, False),
    # the one-line lever: K6's sixteen reads of the moments in flight before their writes
    "k2_reads_in_flight": ([(K2_NO_ACC[0][0],
                             "        for (int p0 = 0; p0 <= P; p0 += 16) {\n          float v[16];\n"
                             "#pragma unroll\n          for (int u = 0; u < 16; ++u)\n"
                             "            if (p0 + u <= P) v[u] = ar[p0 + u];\n#pragma unroll\n"
                             "          for (int u = 0; u < 16; ++u)\n            if (p0 + u <= P) ar[p0 + u] = "
                             "p0 + u < P ? fmaf(g, x_sh[p0 + u], v[u]) : v[u] + g;\n        }\n")], True),
}
K6_NO_ACC = [("        float* ar = acc_m + s * acc_rs;\n        for (int p0 = 0; p0 <= P; p0 += 16) {",
              "        float* ar = acc_m + s * acc_rs;\n        for (int p0 = 0; p0 < 0; p0 += 16) {")]
K6_NO_XI = [("    if (!is_last) {\n      for (int j = tid; j < n_c; j += nt) {",
             "    if (false) {\n      for (int j = tid; j < n_c; j += nt) {")]
K6_NO_ELLH = [("#pragma unroll 16\n        for (int p = 0; p < P; ++p) l = fmaf(wr[p * w_cs], x_sh[p], l);",
               "        for (int p = 0; p < 0; ++p) l = fmaf(wr[p * w_cs], x_sh[p], l);")]
K6_VARIANTS = {
    "k6_base": ([], True),
    "k6_no_acc": (K6_NO_ACC, False),
    "k6_no_xi": (K6_NO_XI, False),
    "k6_no_ellh": (K6_NO_ELLH, False),
    "k6_chain_floor": (K6_NO_ACC + K6_NO_XI + K6_NO_ELLH, False),
}
# K1 and K7 (B1, B7) as they stood before their redesign (6a3a03f): the
# per-frame block chains; substitutions in that revision's sources
# (--sources DIR); name -> (substitutions, computes the same function)
K1_NO_ELLH = [("    float mx = -FLT_MAX, q = 0.f;\n    for (int s = tid; s < S; s += nt) {\n"
               "      const float* wr = w_m + s * w_rs;\n      float acc = 0.f;\n#pragma unroll 8\n"
               "      for (int p = 0; p < P; ++p) acc", "    float mx = -FLT_MAX, q = 0.f;\n"
               "    for (int s = tid; s < S; s += nt) {\n      const float* wr = w_m + s * w_rs;\n"
               "      float acc = 0.f;\n#pragma unroll 8\n      for (int p = 0; p < 0; ++p) acc")]
K1_NO_STORES = [("      a_b[static_cast<size_t>(t) * S + s] = a;\n", ""),
                ("  for (int t = 0; t < len; ++t) {\n    for (int p = tid; p < P; p += nt) x_sh[p]",
                 "  for (int t = 0; t < len; ++t) {\n    for (int p = tid; p < 0; p += nt) x_sh[p]")]
K7_NO_XI = [("    if (!is_last) {\n      for (int j = tid; j < n_c; j += nt) {",
             "    if (false) {\n      for (int j = tid; j < n_c; j += nt) {")]
K7_NO_GAMMA = [("      g_b[static_cast<size_t>(t) * S + s] = ab_sh[s] / gnorm;\n", "")]
K1_VARIANTS = {
    "k1_base": ([], True),
    "k1_no_ellh": (K1_NO_ELLH, False),
    # the chain floor: no ELLH, no α̂ stores and no statistics loads
    "k1_chain_floor": (K1_NO_ELLH + K1_NO_STORES, False),
}
K7_VARIANTS = {
    "k7_base": ([], True),
    "k7_no_xi": (K7_NO_XI, False),
    "k7_no_gamma": (K7_NO_GAMMA, False),
    "k7_chain_floor": (K7_NO_XI + K7_NO_GAMMA, False),
}
# the chunked K1 and K7: name -> (substitutions, computes the same function)
K1N_NO_ELLH = [("    for (int it = tid; it < n_utt * groups * S; it += nt) {",
                "    for (int it = tid; it < 0 * groups * S; it += nt) {")]
K1N_NO_CHAIN = [("    if (warp < n_utt) {\n      const int u = warp;\n", "    if (false) {\n      const int u = warp;\n")]
NO_WRITE = [("  for (int e = tid; e < nf * S; e += nt) {\n    const int f = row_of(e, inv_s), s = e - f * S;",
             "  for (int e = tid; e < 0 * S; e += nt) {\n    const int f = row_of(e, inv_s), s = e - f * S;")]
K1N_VARIANTS = {
    "k1n_base": ([], True),
    "k1n_no_ellh": (K1N_NO_ELLH, False),
    "k1n_no_chain": (K1N_NO_CHAIN, False),
    "k1n_no_store": (NO_WRITE, False),
    "k1n_chain_only": (K1N_NO_ELLH + NO_WRITE, False),
    # one block an SM, no register cap
    "k1n_lb1": ([("__launch_bounds__(kAccThreads, 2) forward_llh_chunked_kernel",
                  "__launch_bounds__(kAccThreads) forward_llh_chunked_kernel")], True),
    # the ELLH with 16 frames a tile item (each W value read half as often)
    "k1n_group16": ([("constexpr int kFwdGroup = kAccGroup;", "constexpr int kFwdGroup = 16;")], True),
    # ... and 4 (twice the items, half the registers)
    "k1n_group4": ([("constexpr int kFwdGroup = kAccGroup;", "constexpr int kFwdGroup = 4;")], True),
}

# the redesigned K2 and K6: name -> (substitutions, computes the same function)
K2N_NO_CHAIN = [("    if (warp < n_utt) {\n      const int u = warp, len = len_of(u);",
                 "    if (false) {\n      const int u = warp, len = len_of(u);")]
K2N_NO_ELLH = [("    for (int it = tid; it < (kStream ? 0 : n_utt * groups * S); it += nt) {",
                "    for (int it = tid; it < 0 * groups * S; it += nt) {")]
K2N_NO_PRODUCTS = [("  const int np4 = (P + 1 + 3) / 4, ns4 = (S + 3) / 4, nr4 = (n_r + 3) / 4, nc4 = (n_c + 3) / 4;",
                    "  const int np4 = 0, ns4 = 0, nr4 = 0, nc4 = 0;")]
K2N_NO_FACTORS = [("    for (int i = tid; i < n_utt * C; i += nt) {\n      const int u = i / C, f = i - u * C;",
                   "    for (int i = tid; i < 0 * C; i += nt) {\n      const int u = i / C, f = i - u * C;"),
                  ("      for (int i = tid; i < nf * n_c; i += nt) {", "      for (int i = tid; i < 0 * n_c; i += nt) {")]
K6N_NO_CHAIN = K2N_NO_CHAIN + [
    ("    for (int f = nf - 1; f >= 0; --f) {\n      const bool last = lo + f == len - 1;\n      const float* vn = e_sh",
     "    for (int f = nf - 1; f >= nf; --f) {\n      const bool last = lo + f == len - 1;\n      const float* vn = e_sh")]
K6N_NO_ELLH = K2N_NO_ELLH + [
    ("l[f] = 0.f;\n        for (int p = 0; p < P; ++p) {\n          const float wv = wr[p * w_cs];\n#pragma unroll\n"
     "          for (int f = 0; f < kAccChunkBlock;",
     "l[f] = 0.f;\n        for (int p = 0; p < 0; ++p) {\n          const float wv = wr[p * w_cs];\n#pragma unroll\n"
     "          for (int f = 0; f < kAccChunkBlock;")]
K6N_NO_PRODUCTS = K2N_NO_PRODUCTS  # acc_products, shared by both K6 instances
K2N_VARIANTS = {
    "k2n_base": ([], True),
    # one block an SM (no register cap), and blocks of 256 threads
    "k2n_lb1": ([("__launch_bounds__(kAccThreads, kDense ? 1 : 2) estep_acc_chunked_kernel",
                  "__launch_bounds__(kAccThreads) estep_acc_chunked_kernel")], True),
    "k2n_t256": ([("constexpr int kAccThreads = 512;", "constexpr int kAccThreads = 256;")], True),
    # the ELLH with 16 frames a thread item (each W value read half as often)
    "k2n_group16": ([("constexpr int kAccGroup = 8;", "constexpr int kAccGroup = 16;")], True),
    "k2n_no_chain": (K2N_NO_CHAIN, False),
    "k2n_no_ellh": (K2N_NO_ELLH, False),
    "k2n_no_products": (K2N_NO_PRODUCTS, False),
    "k2n_no_factors": (K2N_NO_FACTORS, False),
    "k2n_chain_only": (K2N_NO_ELLH + K2N_NO_PRODUCTS + K2N_NO_FACTORS, False),
    # what else the chain-only variant spends: its chunk loads, the row max / e
    # pass, the division a step, the chain's work on the states
    "k2n_chain_only_no_fetch": (K2N_NO_ELLH + K2N_NO_PRODUCTS + K2N_NO_FACTORS + [
        ("  for (int e = tid; e < C * ld; e += nt) {", "  for (int e = tid; e < 0 * ld; e += nt) {")], False),
    "k2n_chain_only_no_rowmax": (K2N_NO_ELLH + K2N_NO_PRODUCTS + K2N_NO_FACTORS + [
        ("    for (int uf = warp; uf < n_utt * C; uf += n_warps) {", "    for (int uf = warp; uf < 0 * C; uf += n_warps) {")], False),
    "k2n_chain_only_rcp": (K2N_NO_ELLH + K2N_NO_PRODUCTS + K2N_NO_FACTORS + [
        ("        ip = 1.f / fmaxf(sv, FLT_MIN);\n        r = sw * ip;", "        ip = __frcp_rn(fmaxf(sv, FLT_MIN));\n        r = sw * ip;")], False),
    "k2n_chain_only_no_states": (K2N_NO_ELLH + K2N_NO_PRODUCTS + K2N_NO_FACTORS + [
        ("        for (int s = lane; s < S; s += 32) {\n          const float4 bd = band_sh[s];  // a_self, a_adv, exit, w",
         "        for (int s = lane; s < 0; s += 32) {\n          const float4 bd = band_sh[s];  // a_self, a_adv, exit, w")],
        False),
}
K6N_VARIANTS = {
    "k6n_base": ([], True),
    "k6n_no_chain": (K6N_NO_CHAIN, False),
    "k6n_no_ellh": (K6N_NO_ELLH, False),
    "k6n_no_products": (K6N_NO_PRODUCTS, False),
    "k6n_chain_only": (K6N_NO_ELLH + K6N_NO_PRODUCTS, False),
    # what the γ mode's edits to the shared helpers cost K6's block instance
    # (each takes one back; K7 is not timed): γ₀'s null test, the exp's
    # separate source, ξ's second dimension; and a 512-thread launch bound
    # the fetch's two reciprocals up front, as before acc_fetch_rows
    "k6n_v_fetch": ([("  acc_fetch_rows(xs, stats, row, nf, C, ldx, P, tid, nt);\n  acc_fetch_rows(as, alpha, row, nf, C, ldg, S, tid, nt);",
                      "  const float inv_ldx = 1.f / ldx, inv_ldg = 1.f / ldg;\n"
                      "  for (int e = tid; e < C * ldx; e += nt) {\n    const int f = row_of(e, inv_ldx), q = e - f * ldx;\n"
                      "    const bool ok = f < nf && q < P;\n    cp_async4(xs + e, ok ? stats + (row + f) * P + q : stats, ok);\n  }\n"
                      "  for (int e = tid; e < C * ldg; e += nt) {\n    const int f = row_of(e, inv_ldg), q = e - f * ldg;\n"
                      "    const bool ok = f < nf && q < S;\n    cp_async4(as + e, ok ? alpha + (row + f) * S + q : alpha, ok);\n  }")],
                    True),
    # the block kernel's parameters in the parent's order, the γ mode's after them
    "k6n_v_params": ([("    const int* __restrict__ rows,      // kGamma: (n_r,) ξ rows (K15); null: every state (K7)\n"
                       "    const int* __restrict__ cols,      // kGamma: (n_c,) ξ columns (K15); null: every state (K7)\n"
                       "    float* __restrict__ part,          // (B, (P+1)*S + S*S); kGamma: (B, n_r*n_c)\n"
                       "    float* __restrict__ gamma0,        // (B, S) (not kGamma)\n"
                       "    float* __restrict__ gamma,         // (B, T, S) (kGamma)\n"
                       "    int T, int S, int P, int n_r, int n_c, int chunk) {",
                       "    float* __restrict__ part, float* __restrict__ gamma0, int T, int S, int P, int chunk,\n"
                       "    const int* __restrict__ rows, const int* __restrict__ cols, float* __restrict__ gamma, int n_r, int n_c) {"),
                      ("                                                                       rows, cols, part, gamma0, gamma, T, S, P, n_r,\n"
                       "                                                                       n_c, chunk);",
                       "                                                                       part, gamma0, T, S, P, chunk, rows, cols, gamma,\n"
                       "                                                                       n_r, n_c);")], True),
    # the block instance's launch bound at 512 and 768 threads (128 and 80 registers)
    "k6n_v_lb512": ([("__global__ void __launch_bounds__(1024, 1) estep_acc_dense_block_kernel(",
                      "__global__ void __launch_bounds__(512, 1) estep_acc_dense_block_kernel(")], True),
    "k6n_v_lb768": ([("__global__ void __launch_bounds__(1024, 1) estep_acc_dense_block_kernel(",
                      "__global__ void __launch_bounds__(768, 1) estep_acc_dense_block_kernel(")], True),
}
# K7 and K15 share K6's kernels (the γ-emitting mode): their chain, ξ
# product and γ write out
K7N_VARIANTS = {
    "k7n_base": ([], True),
    "k7n_no_chain": (K6N_NO_CHAIN, False),
    "k7n_no_xi": (K6N_NO_PRODUCTS, False),
    "k7n_no_gamma": (NO_WRITE, False),
    "k7n_chain_only": (K6N_NO_PRODUCTS + NO_WRITE, False),
    # the block instance's launch bound at 512 threads (128 registers)
    "k7n_lb512": ([("__global__ void __launch_bounds__(1024, 1) estep_acc_dense_block_kernel(",
                    "__global__ void __launch_bounds__(512, 1) estep_acc_dense_block_kernel(")], True),
}
# K11 and K3 (B7's banded mode, B3) as they stood before their redesign
# (0849d1a): per-frame block chains; substitutions in that revision's
# sources (--sources DIR); name -> (substitutions, computes the same function)
K11_NO_XI = [("    if (!is_last) {\n      for (int k = tid; k < U * U; k += nt) {",
              "    if (false) {\n      for (int k = tid; k < U * U; k += nt) {")]
K11_NO_GAMMA = [("      g_b[static_cast<size_t>(t) * S + s] = g;\n", "")]
K11_NO_ELLH = [("      for (int p = 0; p < P; ++p) acc = fmaf(wr[p * w_cs], x_sh[p], acc);",
                "      for (int p = 0; p < 0; ++p) acc = fmaf(wr[p * w_cs], x_sh[p], acc);")]
K3_NO_LLH = [("      a_next[s] = fmaxf(l_b[static_cast<size_t>(t) * S + s] + best, kNeg);",
              "      a_next[s] = fmaxf(best, kNeg);")]
K3_NO_CHOICES = [("      c_b[static_cast<size_t>(t) * S + s] = ch;\n", "")]
K11_VARIANTS = {
    "k11_base": ([], True),
    "k11_no_xi": (K11_NO_XI, False),
    "k11_no_gamma": (K11_NO_GAMMA, False),
    "k11_no_ellh": (K11_NO_ELLH, False),
    # the chain floor: no ξ, no γ write, no ELLH in the chain
    "k11_chain_floor": (K11_NO_XI + K11_NO_GAMMA + K11_NO_ELLH, False),
}
K3_VARIANTS = {
    "k3_base": ([], True),
    "k3_no_llh": (K3_NO_LLH, False),
    "k3_no_choices": (K3_NO_CHOICES, False),
    # the chain floor: no in-chain llh load, no choice write
    "k3_chain_floor": (K3_NO_LLH + K3_NO_CHOICES, False),
}
# the chunked K11 (K2's kernel emitting γ) and K3 (K1's skeleton)
K3N_NO_CHAIN = [("    if (c < n_chunks) walk(kBlock ? 0 : warp, c);\n", "")]
K3N_NO_STORE = [("      for (int e = ptid; e < nf * S; e += pnt) {", "      for (int e = ptid; e < 0 * S; e += pnt) {")]
K3N_NO_FETCH = [("      acc_fetch_rows(ring(u, c & 1), llh, static_cast<size_t>(b0 + u) * T + lo, nf, C, ldg, S, ptid, pnt);\n",
                 "")]
K3N_MAX = "        exb = __int_as_float(vkey(__int_as_float(top)));\n        cand = mb == exb ? mi : S;\n"
# the warp chain's exit max and index by the five-round shuffle tree (value
# and index a round), as first written, in place of the redux.sync
K3N_TREE = [(K3N_MAX,
             "        for (int o = 16; o > 0; o >>= 1) {\n"
             "          const float ov = __shfl_xor_sync(0xffffffffu, mb, o);\n"
             "          const int oi = __shfl_xor_sync(0xffffffffu, mi, o);\n"
             "          if (ov > mb || (ov == mb && oi < mi)) {\n            mb = ov;\n            mi = oi;\n          }\n"
             "        }\n        exb = mb;\n        cand = mi;\n")]
K11N_VARIANTS = {
    "k11n_base": ([], True),
    "k11n_no_chain": (K2N_NO_CHAIN, False),
    "k11n_no_ellh": (K2N_NO_ELLH, False),
    "k11n_no_xi": (K2N_NO_PRODUCTS, False),
    "k11n_no_gamma": (NO_WRITE, False),
    "k11n_chain_only": (K2N_NO_ELLH + K2N_NO_PRODUCTS + NO_WRITE + K2N_NO_FACTORS, False),
}
K3N_VARIANTS = {
    "k3n_base": ([], True),
    "k3n_no_chain": (K3N_NO_CHAIN, False),
    "k3n_no_store": (K3N_NO_STORE, False),
    # the chain alone: no chunk loads, no write-out
    "k3n_chain_only": (K3N_NO_STORE + K3N_NO_FETCH, False),
    # the chain without its exit max (each lane's own max carried)
    "k3n_no_argmax": ([(K3N_MAX, "        exb = mb;\n        cand = mi;\n")], False),
    # one block an SM (the warp chain's instances), no register cap below 128
    "k3n_lb1": ([(", kRegs > 0 ? 2 : 1)\n    viterbi_fwd_chunked_kernel(", ", 1)\n    viterbi_fwd_chunked_kernel(")], True),
    "k3n_tree": (K3N_TREE, True),
    # the block chain on 512 threads in place of 1,024, and with 2, 4 or 16 copying warps in place of 8
    "k3n_block512": ([("constexpr int kVitBlockThreads = 1024;", "constexpr int kVitBlockThreads = 512;")], True),
    "k3n_copy2": ([("constexpr int kVitCopyWarps = 8;", "constexpr int kVitCopyWarps = 2;")], True),
    "k3n_copy4": ([("constexpr int kVitCopyWarps = 8;", "constexpr int kVitCopyWarps = 4;")], True),
    "k3n_copy16": ([("constexpr int kVitCopyWarps = 8;", "constexpr int kVitCopyWarps = 16;")], True),
}
# K4 and K13 (B4, B9e) as they stood before their redesign (3d14238):
# one thread an utterance; one block an utterance with three block
# reductions a step; substitutions in that revision's sources (--sources
# DIR); name -> (substitutions, computes the same function)
K4_NO_ARGMAX = [("  for (int s = 1; s < S; ++s) {", "  for (int s = 1; s < 0; ++s) {")]
K4_NO_EXARG = [("    st = c == 0 ? st : (c == 1 ? st - 1 : e_b[t]);", "    st = c == 0 ? st : (c == 1 ? st - 1 : st);")]
# the path written once, at the end, so that the chase stays live
K4_NO_PATH = [("    p_b[t - 1] = st;\n  }\n}", "  }\n  p_b[0] = st;\n}")]
K13_NO_LOADS = [("      const float v = e_t[i] * u1;", "      const float v = u1;"),
                ("      const float ab = al_t[i] * (u_sh[i] / nu);", "      const float ab = u_sh[i] / nu;")]
K13_NO_POSTNORM = [("    block_sum_sum(pn, unused, red);\n", "")]
K13_NO_WRITES = [("      g_b[static_cast<size_t>(t) * S + i] = ab_sh[i] / gnorm;\n", ""),
                 ("      w_b[static_cast<size_t>(t) * S + i] = w;\n", "")]
K4_VARIANTS = {
    "k4_base": ([], True),
    "k4_no_argmax": (K4_NO_ARGMAX, False),
    "k4_no_exarg": (K4_NO_EXARG, False),
    "k4_no_path": (K4_NO_PATH, False),
    # the chase alone: no arg-max, no exit load, one path write
    "k4_chase_floor": (K4_NO_ARGMAX + K4_NO_EXARG + K4_NO_PATH, False),
}
K13_VARIANTS = {
    "k13_base": ([], True),
    "k13_no_loads": (K13_NO_LOADS, False),
    "k13_no_postnorm": (K13_NO_POSTNORM, False),
    "k13_no_writes": (K13_NO_WRITES, False),
    # the chain floor: two block reductions a step, no stream
    "k13_chain_floor": (K13_NO_LOADS + K13_NO_POSTNORM + K13_NO_WRITES, False),
}
# the redesigned K4 (a warp an utterance over staged choices) and K13 banded
# (chunks, the chain on a warp or a block, the side warps finishing frames)
K4N_NO_ARGMAX = [("  for (int s = lane + 32; s < S; s += 32) {\n    const float v = a[s] + lf[s];",
                  "  for (int s = lane + 32; s < 0; s += 32) {\n    const float v = a[s] + lf[s];")]
K4N_NO_FETCH = [("      fetch(k + kBtStages - 1);  // into the stage chunk k − 1 left\n", ""),
                ("  for (int k = 0; k < kBtStages - 1; ++k) fetch(k);\n", "")]
K4N_NO_CHASE = [("    for (int f = nf - 1; f >= 0; --f, ch -= S) {", "    for (int f = nf - 1; f >= 0 && S < 0; --f, ch -= S) {")]
K13N_NO_CHAIN = [("    if (c < n_chunks) walk(kBlock ? 0 : warp, c);\n", "")]
K13N_NO_OUTPUT = [("        if (f < span(u, c - 1, lo)) finish(u, c - 1, f, lo);", "        if (f < 0) finish(u, c - 1, f, lo);")]
K13N_NO_FETCH = [("      if (c + 1 < n_chunks) fetch(c + 1);  // into the stages of chunk c − 2\n", ""),
                 ("  if (sid >= 0 && n_chunks > 0) fetch(0);\n", "")]
K13N_NO_TAIL = [("  for (int u = 0; u < n_utt; ++u) {\n    if (b0 + u >= B) continue;\n    const size_t row",
                  "  for (int u = 0; u < 0; ++u) {\n    if (b0 + u >= B) continue;\n    const size_t row")]
K4N_VARIANTS = {
    "k4n_base": ([], True),
    "k4n_no_argmax": (K4N_NO_ARGMAX, False),
    "k4n_no_fetch": (K4N_NO_FETCH, False),
    "k4n_no_chase": (K4N_NO_CHASE, False),
}
K13N_VARIANTS = {
    "k13n_base": ([], True),
    "k13n_no_chain": (K13N_NO_CHAIN, False),
    "k13n_no_output": (K13N_NO_OUTPUT, False),
    "k13n_no_fetch": (K13N_NO_FETCH, False),
    "k13n_no_tail": (K13N_NO_TAIL, False),
    # the chain alone: no fetch, no output, no tail
    "k13n_chain_only": (K13N_NO_OUTPUT + K13N_NO_FETCH + K13N_NO_TAIL, False),
}
# K12 and K13's dense instance (B9a–d) as they stood before their redesign
# (13e9c4a): a block an utterance, two block reductions a frame (the
# banded forward's q, then Σraw), the dense product S FMAs a state from
# shared memory or L2; substitutions in that revision's sources (--sources
# DIR); name -> (substitutions, computes the same function)
K12_NO_Q = [("      block_sum_sum(q, unused, st.red);\n", "")]
K12_NO_LOADS = [("      const float raw = base * e_t[j];", "      const float raw = base;")]
K12_NO_WRITES = [("      st.p_b[static_cast<size_t>(t) * S + s] = a;\n", ""),
                 ("      st.p_b[static_cast<size_t>(t) * S + i] = a;\n", "")]
# the dense products at a quarter of their rows: A read once for 4 utterances
K12_QUARTER = [("        for (int i = 0; i < S; ++i) base = fmaf(p_sh[i], mat_sh[i * a_rs + j], base);",
                "        for (int i = 0; i < S; i += 4) base = fmaf(p_sh[i], mat_sh[i * a_rs + j], base);"),
               ("      for (int j = 0; j < S; ++j) raw = fmaf(ar[j * a_cs], v_sh[j], raw);",
                "      for (int j = 0; j < S; j += 4) raw = fmaf(ar[j * a_cs], v_sh[j], raw);"),
               ("        for (int j = 0; j < S; ++j) u1 = fmaf(ar[j * a_cs], vh_sh[j], u1);",
                "        for (int j = 0; j < S; j += 4) u1 = fmaf(ar[j * a_cs], vh_sh[j], u1);")]
K12_NO_PRODUCT = [(old, new.replace("i += 4", "i < 0").replace("j += 4", "j < 0")
                   .replace("i < S; i < 0", "i < 0; ++i").replace("j < S; j < 0", "j < 0; ++j"))
                  for old, new in K12_QUARTER]
K12_VARIANTS = {
    "k12_base": ([], True),
    "k12_no_q": (K12_NO_Q, False),
    "k12_no_loads": (K12_NO_LOADS, False),
    "k12_no_writes": (K12_NO_WRITES, False),
    # the banded forward's chain floor: one block reduction a step, no stream
    "k12_chain_floor": (K12_NO_Q + K12_NO_LOADS + K12_NO_WRITES, False),
    "k12_quarter_product": (K12_QUARTER, False),
    "k12_no_product": (K12_NO_PRODUCT, False),
}
# the redesigned K12 banded (chunks, the chain on a warp or a block) and the
# grouped dense step (K12's dense forward and reverse, K13's dense instance)
K12N_NO_OUTPUT = [("        if (f >= span(u, c - 1, lo)) continue;\n        const float ipn",
                   "        if (f >= 0) continue;\n        const float ipn")]
K12N_NO_FETCH = [("      if (c + 1 < n_chunks) fetch(c + 1);  // into the stage of chunk c − 2\n", ""),
                 ("  if (sid >= 0 && n_chunks > 0) fetch(0);\n  for (int s = tid; s < (kGlobal ? 0 : L.ldg); s += nt)",
                  "  for (int s = tid; s < (kGlobal ? 0 : L.ldg); s += nt)")]
K12N_NO_TAIL = [("  for (int u = 0; u < n_utt; ++u) {\n    if (b0 + u >= B) continue;\n    const size_t row = static_cast<size_t>(b0 + u) * T;\n    const int nf",
                 "  for (int u = 0; u < 0; ++u) {\n    if (b0 + u >= B) continue;\n    const size_t row = static_cast<size_t>(b0 + u) * T;\n    const int nf")]
K12N_NO_LOGCS = [("      if (sid < n_utt) {  // the log-scales of chunk c − 1, frame by frame",
                  "      if (sid < 0) {  // the log-scales of chunk c − 1, frame by frame")]
# the product on one step only (the forward's and the smoothing's second, the reverse's first): every
# other step reuses its partial sums, so the step's other work runs on finite values
GRPN_NO_PRODUCT = [("    if (kRev || k > 0) grp_product<kU>(smem + L.mat, mat, x, part, L, S, ks);",
                    "    if (k == (kRev ? 0 : 1)) grp_product<kU>(smem + L.mat, mat, x, part, L, S, ks);")]
GRPN_NO_LOADS = [("        pe[i] = __ldg(e + off + j);", "        pe[i] = 1.f;"),
                 ("        if (kSmo) pa[i] = __ldg(alpha + off + j);", "        pa[i] = 1.f;"),
                 ("f(j, e[off + j], kSmo ? alpha[off + j] : 0.f);", "f(j, 1.f, 1.f);")]
GRPN_NO_OUTPUTS = [("        out[off + j] = p;\n", ""), ("        w_out[off + j] = w;\n", ""),
                   ("      items([&](int j, float, float) { out[off + j] = abv[j * kU + my] * ig; });\n", "")]
GRPN_THREADS512 = [("constexpr int kGrpThreads = 256;", "constexpr int kGrpThreads = 512;"),
                   ("__launch_bounds__(kGrpThreads, 2) dense_grouped_kernel(", "__launch_bounds__(kGrpThreads, 1) dense_grouped_kernel(")]
GRPN_UNROLL16 = [("#pragma unroll 8\n    for (int i = max(r0, L.rows); i < r1; ++i)",
                  "#pragma unroll 16\n    for (int i = max(r0, L.rows); i < r1; ++i)")]
K12N_VARIANTS = {
    "k12n_base": ([], True),
    "k12n_no_output": (K12N_NO_OUTPUT, False),
    "k12n_no_fetch": (K12N_NO_FETCH, False),
    # the chain alone: no fetch, no output, no log-scales, no tail
    "k12n_chain_only": (K12N_NO_OUTPUT + K12N_NO_FETCH + K12N_NO_TAIL + K12N_NO_LOGCS, False),
    # the grouped dense step without its product (one step's reused): barriers, reductions and streams
    "grpn_no_product": (GRPN_NO_PRODUCT, False),
    # the e and α̂ streams not loaded
    "grpn_no_loads": (GRPN_NO_LOADS, False),
    "grpn_no_outputs": (GRPN_NO_OUTPUTS, False),
    # no product and no output: the step's barriers, reductions and stream loads
    "grpn_floor": (GRPN_NO_PRODUCT + GRPN_NO_OUTPUTS, False),
    # twice the loads of M in flight from device memory
    "grpn_unroll16": (GRPN_UNROLL16, True),
    # blocks of 512 threads, one an SM, at the same geometry
    "grpn_threads512": (GRPN_THREADS512, True),
}
# the source each variant compiles (its substitutions may fall in a header)
SOURCES = {**{n: "stats_full.cu" for n in (*VARIANTS, *K8_VARIANTS)},
           **{n: "hmm_scan.cu" for n in (*K6N_VARIANTS, *K7N_VARIANTS)},
           **{n: "phone_loop_scan.cu" for n in (*K2N_VARIANTS, *K1N_VARIANTS)},
           **{n: "hmm_scan.cu" for n in (*K5_VARIANTS, *K6_VARIANTS, *K7_VARIANTS)},
           **{n: "phone_loop_scan.cu" for n in (*K2_VARIANTS, *K1_VARIANTS)},
           **{n: "phone_loop_scan.cu" for n in (*K11_VARIANTS, *K3_VARIANTS, *K11N_VARIANTS, *K3N_VARIANTS)},
           **{n: "phone_loop_scan.cu" for n in (*K4_VARIANTS, *K4N_VARIANTS)},
           **{n: "general_scan.cu" for n in (*K13_VARIANTS, *K13N_VARIANTS, *K12_VARIANTS, *K12N_VARIANTS)}}
PARENT_VARIANTS = {**K2_VARIANTS, **K6_VARIANTS}
PARENT_B7_VARIANTS = {**K1_VARIANTS, **K7_VARIANTS}   # of 6a3a03f's sources
NEW_B7_VARIANTS = {**K1N_VARIANTS, **K7N_VARIANTS}
PARENT_B11_VARIANTS = {**K11_VARIANTS, **K3_VARIANTS}   # of 0849d1a's sources
NEW_B11_VARIANTS = {**K11N_VARIANTS, **K3N_VARIANTS}
PARENT_B13_VARIANTS = {**K4_VARIANTS, **K13_VARIANTS}   # of 3d14238's sources
NEW_B13_VARIANTS = {**K4N_VARIANTS, **K13N_VARIANTS}
PARENT_B12_VARIANTS = K12_VARIANTS   # of 13e9c4a's sources
NEW_B12_VARIANTS = K12N_VARIANTS
REPS = 20
CARD = ""   # the card's name and power limit (nvidia-smi), printed beside every number
SOURCES_DIR = cuda_scan.CSRC   # the sources the variants edit (--sources DIR)
# registers reported for the instances the two shapes take
REPORTED = {"ellh_full_kernelILi128ELi64": "k9_128x64", "ellh_full_kernelILi64ELi64": "k9_64x64",
            "accumulate_full_kernelILi64": "k10_64", "gmm_estep_full_kernelILi64": "k8_64",
            "forward_llh_warp_kernelILb1": "k5_warp_stats", "forward_llh_warp_kernelILb0": "k5_warp_llh",
            "forward_llh_dense_kernelILb0ELb0ELb1ELb1": "k5_block_llh_global",
            "forward_llh_dense_kernelILb1ELb0ELb1ELb1": "k5_block_stats_global",
            "forward_llh_dense_kernelILb0ELb0ELb1ELb0": "k5_block_llh_global_short",
            "forward_llh_dense_kernelILb1ELb0ELb1ELb0": "k5_block_stats_global_short",
            "estep_acc_chunked_kernelILb0ELb0ELb1ELb0": "k2_shared", "estep_acc_chunked_kernelILb0ELb1ELb1ELb0": "k2_global",
            "estep_acc_chunked_kernelILb0ELb0ELb1ELb1": "k11_shared", "estep_acc_chunked_kernelILb0ELb1ELb1ELb1": "k11_global",
            "estep_acc_chunked_kernelILb1ELb0ELb1ELb0": "k6_warp", "estep_acc_chunked_kernelILb1ELb0ELb1ELb1": "k7_warp",
            "viterbi_fwd_chunked_kernelILb0ELb1ELi0": "k3_shared", "viterbi_fwd_chunked_kernelILb1ELb1ELi0": "k3_global",
            **{f"viterbi_fwd_chunked_kernelILb0ELb1ELi{k}": f"k3_regs{k}" for k in range(1, 7)},
            "estep_gamma_banded_kernelILb0": "k11_parent_shared", "estep_gamma_banded_kernelILb1": "k11_parent_global",
            "viterbi_fwd_banded_kernel": "k3_parent",
            "estep_acc_dense_block_kernelILb1ELb1ELb0": "k6_block_global",
            "estep_acc_dense_block_kernelILb0ELb1ELb0": "k6_block_shared",
            "estep_acc_dense_block_kernelILb1ELb1ELb1": "k7_block_global",
            "estep_acc_dense_block_kernelILb0ELb1ELb1": "k7_block_shared",
            "forward_llh_chunked_kernelILb0ELb1": "k1_shared", "forward_llh_chunked_kernelILb1ELb1": "k1_global",
            "forward_llh_banded_kernelILb0": "k1_parent_shared", "forward_llh_banded_kernelILb1": "k1_parent_global",
            "estep_gamma_dense_kernelILb0ELb0": "k7_parent_shared", "estep_gamma_dense_kernelILb0ELb1": "k7_parent_global",
            "viterbi_backtrace_kernel": "k4_parent", "smoothing_pass_kernelILb1ELb0": "k13_parent_banded",
            "viterbi_backtrace_chunked_kernelILb1": "k4_staged", "viterbi_backtrace_chunked_kernelILb0": "k4_direct",
            **{f"smoothing_banded_chunked_kernelILb0ELi{k}": f"k13_regs{k}" for k in range(1, 7)},
            "smoothing_banded_chunked_kernelILb0ELi0": "k13_block", "smoothing_banded_chunked_kernelILb1ELi0": "k13_block_global",
            "scaled_pass_kernelILi0ELb0": "k12_parent_dense", "scaled_pass_kernelILi1ELb0": "k12_parent_banded",
            "scaled_pass_kernelILi2ELb0": "k12_parent_reverse", "smoothing_pass_kernelILb0": "k13_parent_dense",
            **{f"scaled_banded_chunked_kernelILb0ELi{k}": f"k12_regs{k}" for k in range(0, 7)},
            **{f"dense_grouped_kernelILi{m}ELb{g}ELi{u}": f"grp_{m}_{'global' if g else 'shared'}_u{u}"
               for m in (0, 2, 3) for g in (0, 1) for u in (1, 2, 4, 8)}}


def build(names):
    """Compile the variants in parallel; returns {name: (library path, registers)}."""
    tmp = Path(tempfile.mkdtemp(dir=cuda_scan.BUILD_DIR))
    procs = {}
    for name in names:
        # the compiled source and every header; a substitution is made in
        # the compiled source if it holds the text, else in the one header that does
        texts = {f.name: f.read_text() for f in [SOURCES_DIR / SOURCES[name], *SOURCES_DIR.glob("*.cuh")]}
        subs = {**VARIANTS, **K8_VARIANTS, **K5_VARIANTS, **PARENT_VARIANTS, **K2N_VARIANTS, **K6N_VARIANTS,
                **PARENT_B7_VARIANTS, **NEW_B7_VARIANTS, **PARENT_B11_VARIANTS, **NEW_B11_VARIANTS,
                **PARENT_B13_VARIANTS, **NEW_B13_VARIANTS, **PARENT_B12_VARIANTS, **NEW_B12_VARIANTS}[name][0]
        for old, new in subs:
            holders = [f for f, text in texts.items() if old in text]
            holders = [SOURCES[name]] if SOURCES[name] in holders else holders
            if len(holders) != 1:
                rev = ("53a1783" if name in PARENT_VARIANTS else "6a3a03f" if name in PARENT_B7_VARIANTS
                       else "0849d1a" if name in PARENT_B11_VARIANTS
                       else "3d14238" if name in PARENT_B13_VARIANTS
                       else "13e9c4a" if name in PARENT_B12_VARIANTS else "")
                hint = (f" (it edits the sources of {rev}: pass that revision's beer_tpu_torch/csrc as --sources DIR)"
                        if rev else "")
                raise RuntimeError(f"variant {name}: {old!r} is in {holders or 'no file'} of {SOURCES[name]}{hint}")
            texts[holders[0]] = texts[holders[0]].replace(old, new)
        (tmp / name).mkdir()
        for f, text in texts.items():
            (tmp / name / f).write_text(text)
        while sum(proc.poll() is None for proc in procs.values()) >= (os.cpu_count() or 4):
            time.sleep(0.5)
        procs[name] = subprocess.Popen(
            [cuda_scan._nvcc(), *cuda_scan.NVCC_FLAGS, "-shared", "-o", str(tmp / f"{name}.so"),
             str(tmp / name / SOURCES[name])], stderr=subprocess.PIPE, text=True)
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


PROBE_STEPS = 15


def split_tf32(x: torch.Tensor):
    """(hi, lo) of a float32 tensor: hi = x rounded to TF32 (10 mantissa
    bits, to nearest, ties away from zero: PTX ``cvt.rna.tf32.f32``), lo
    = (x − hi) rounded the same way.  Both are exact TF32 values, and
    hi + lo equals x to about 2⁻²¹ of |x|."""

    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b as three TF32 products in one float32 sum, hi·hi + hi·lo +
    lo·hi (lo·lo dropped): one matmul over operands concatenated along
    the contraction, so that on the card it runs as one tensor-core
    accumulator.  Its TF32 tensor cores are enabled for the call only."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    lhs = torch.cat([a_hi, a_hi, a_lo], dim=-1)
    rhs = torch.cat([b_hi, b_lo, b_hi], dim=0)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return lhs @ rhs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def gmm_estep_3xtf32(x, e_stats, log_w, mask=None):
    """:func:`gmm_estep_full_plain` with both of its products, S·W and
    rᵀ·S, taken by :func:`matmul_3xtf32` (float32 only): the arithmetic
    of a 3×TF32 tensor-core K8, materialised."""
    d = x.shape[-1]
    s_mat = sk.packed_stats(x)
    joint = matmul_3xtf32(s_mat, sk.pack_weights(e_stats, d, log_w))
    llh = torch.logsumexp(joint, dim=-1)
    r = torch.exp(joint - llh[:, None])
    if mask is not None:
        m = mask.reshape(-1).to(llh.dtype)
        llh = llh * m
        r = r * m[:, None]
    acc, counts = sk.unpack_acc(matmul_3xtf32(r.T.contiguous(), s_mat), d)
    return llh, acc, counts


def clustered_frames(dev, n=64_000):
    """Phase 10's trajectory data: 16 centres at 3σ, unit noise, D = 39."""
    rng = np.random.default_rng(7)
    centres = rng.normal(size=(16, c.D)) * 3.0
    return torch.from_numpy((centres[rng.integers(0, 16, size=n)]
                             + rng.normal(size=(n, c.D))).astype(np.float32)).to(dev)


def trajectory(dev, x, estep, dtype=torch.float32):
    """ELBO/frame of PROBE_STEPS VB steps of config 1's GMM on ``x`` with
    the fused E-step taken by ``estep``; the model after them."""
    model = c.config1(dev)
    if dtype != torch.float32:
        model = model.to(dtype=dtype)
        x = x.to(dtype)
    saved = sk.gmm_estep_full
    sk.gmm_estep_full = estep
    try:
        traj = np.array([float(c.bt.vb_step(model, x)[0]) / x.shape[0] for _ in range(PROBE_STEPS)])
    finally:
        sk.gmm_estep_full = saved
    return traj, model


def probe(dev) -> None:
    """The 3×TF32 probe: config 1's E-step with both products (S·W and
    rᵀ·S) taken as three TF32 tensor-core products in one float32 sum
    (``stats_kernels.gmm_estep_3xtf32``, emulated with cuBLAS on operands
    split in advance), against the float32 FFMA kernel K8.

    * 15 VB steps on phase 10's clustered data from the same initial
      model: the worst |ΔELBO|/frame against the float32 kernel route and
      whether each trajectory rises (every step ≥ 0, and phase 10's rule:
      no step below −1e-5/frame after two steps of burn-in);
    * the relative error of ``acc`` and ``counts`` (and llh) against
      float64 on the card, for the FFMA kernel, the 3×TF32 emulation and
      the float32 plain version, at the initial model on the clustered
      and on config 1's frames and at the trained model (the float32
      route's after its 15 steps) on the clustered frames.

    The gate that let 3×TF32 ship: |ΔELBO|/frame ≤ 1e-4, monotone, and
    statistics within 8× of the FFMA kernel's float64 error."""
    xc = clustered_frames(dev)
    routes = {"ffma_kernel": sk.gmm_estep_full, "3xtf32": gmm_estep_3xtf32,
              "plain_f32": sk.gmm_estep_full_plain}
    trajs = {name: trajectory(dev, xc, fn) for name, fn in routes.items()}
    trajs["plain_f64"] = trajectory(dev, xc, sk.gmm_estep_full_plain, torch.float64)
    base = trajs["ffma_kernel"][0]
    for name, (traj, _) in trajs.items():
        steps = np.diff(traj)
        print(f"{CARD} | probe trajectory {name}: ELBO/frame {', '.join(f'{v:.7f}' for v in traj)} "
              f"| worst |dELBO|/frame vs ffma_kernel {float(np.abs(traj - base).max()):.3g} "
              f"| smallest step {float(steps.min()):.3g} | rises every step {bool((steps >= 0).all())} "
              f"| phase-10 rule {bool((steps[2:] >= -1e-5).all())}", flush=True)
    trained = trajs["ffma_kernel"][1]
    cases = {"clustered_initial": (xc, c.config1(dev)),
             "config1_initial": (c.config1_frames(dev), c.config1(dev)),
             "clustered_trained": (xc, trained)}
    for tag, (x, model) in cases.items():
        e, log_w = c.gmm_operands(model)
        want = sk.gmm_estep_full_plain(x.double(), e.double(), log_w.double())
        errs = {}
        for name, fn in routes.items():
            got = fn(x, e, log_w)
            errs[name] = {out: float(f"{c.rel(g.double(), w):.3g}")
                          for out, g, w in zip(("llh", "acc", "counts"), got, want)}
        print(f"{CARD} | probe vs float64 {tag} (T={x.shape[0]}): " + json.dumps(errs), flush=True)


def run_stats(dev, built, names):
    """K9 and K10 alone at config 1 and the recognizer, one line a variant."""
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
        lib.beer_stats_blocks.argtypes = [i] * 6
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
            resident = lib.beer_stats_blocks(0, 2, d, k, 0, acc_k)
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
        print(f"variant {name}: {CARD} | " + ", ".join(f"{k_} {v:.3f}" for k_, v in row.items())
              + f" | registers {regs} | {'same function' if same else 'not the same function'}",
              flush=True)


def k8_operands(dev):
    x = c.config1_frames(dev)
    e, log_w = c.gmm_operands(c.config1(dev))
    return x, e, log_w


def run_k8(dev, built, names):
    """K8 alone at config 1 (the bare foreign call of each variant's
    library, K8's own packing and geometry), one line a variant."""
    x, e, log_w = k8_operands(dev)
    want = sk.gmm_estep_full_plain(x, e, log_w)
    p, i = ctypes.c_void_p, ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    d, k, t_len = c.D, e.shape[0], x.shape[0]
    width = sk.packed_width(d)
    lanes = -(-width // sk.ACC_LANES) * sk.ACC_LANES
    for name in names:
        path, regs = built[name]
        _, same, tiles = K8_VARIANTS[name]
        tile_k, frames = tiles or sk.estep_tiles(d, k)
        lib = ctypes.CDLL(str(path))
        lib.beer_gmm_estep_full.argtypes = [i] + [p] * 6 + [i] * 6 + [p]
        lib.beer_stats_blocks.argtypes = [i] * 6
        lib.beer_stats_prepare.argtypes = [i]
        c.check(lib.beer_stats_prepare(0) == 0, f"{name}: prepare")
        k_pad = sk.estep_k_pad(k, tile_k)
        chunks = -(-width // sk.ESTEP_LANE_CHUNK) + 1
        w = torch.nn.functional.pad(sk.pack_weights(e, d, log_w),
                                    (0, k_pad - k, 0, chunks * sk.ESTEP_LANE_CHUNK - width))
        n_blk = min(lib.beer_stats_blocks(0, 0, d, k, frames, tile_k), -(-t_len // frames))
        c.check(n_blk > 0, f"{name}: occupancy")
        part = torch.empty(n_blk, k * lanes, device=dev)
        out = torch.empty(k * lanes, device=dev)
        llh = torch.empty(t_len, device=dev)
        run = lambda: lib.beer_gmm_estep_full(0, ptr(x), None, ptr(w), ptr(llh), ptr(part), ptr(out),  # noqa: E731
                                              n_blk, t_len, d, k, frames, tile_k, stream)
        c.check(run() == 0, f"{name}: K8 launch")
        ms = median_ms(run)
        if same:
            acc, counts = sk.unpack_acc(out.view(k, lanes)[:, :width], d)
            c.check(c.rel(llh, want[0]) <= 1e-5 and c.rel(acc, want[1]) <= 1e-4,
                    f"{name}: differs from the plain version")
        print(f"variant {name}: {CARD} | k8_config1_ms {ms:.3f} (tiles {tile_k} x {frames}, {n_blk} blocks) "
              f"| registers {regs} | {'same function' if same else 'not the same function'}", flush=True)


def k5_cases(dev):
    """K5's operands: config 2 (stats, S = 30), config 3 (llh, S = 18),
    config 4's dense matrix on its llh stream (S = 150, B = 512), random
    llh streams (N(0, 9), a dense random A, B = 64, T = 200) at S = 300
    and 230, and phase 18's ergodic HMM (B = 64, T <= 200) at S = 300 on
    both streams and at S = 200 on the statistics; the S = 300 ones take
    the global placement, S = 230 (llh) and 200 (P = 78) the shared one
    in chunks of 8 and 4 frames, near its limit."""
    data, mask = c.make_data(c.B, c.T, c.D)
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    hmm = c.config2(dev)
    stats, c2 = c.hmm_operands(hmm, x, m)
    init2 = torch.exp(hmm.graph_log_init).expand(c.B, -1).contiguous()
    data3, mask3, seqs = c.config3_data()
    rec = c.config3(dev, seqs)
    _, c3 = c.hmm_operands(rec, torch.from_numpy(data3).to(dev), torch.from_numpy(mask3).to(dev))
    init3 = torch.exp(torch.clamp(rec.graph_log_init, min=-1e30)).expand_as(c3["final"]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(11)

    def random_llh(s, b=64, t_len=200):
        trans = torch.softmax(torch.randn(s, s, device=dev, generator=gen), -1)
        llh = torch.randn(b, t_len, s, device=dev, generator=gen) * 3.0
        lens = torch.full((b,), t_len, dtype=torch.int32, device=dev)
        return llh, lens, trans, torch.full((b, s), 1.0 / s, device=dev)

    data, mask = c.make_data(c.LARGE_B, c.LARGE_T, c.D, seed=8)     # phase 18's ergodic HMM
    xb, mb = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)

    def ergodic(s):
        big = c.config2(dev, s=s)
        stats_b, cb = c.hmm_operands(big, xb, mb)
        init_b = torch.exp(big.graph_log_init).expand_as(cb["final"]).contiguous()
        return big, stats_b, cb, init_b

    big, stats_b, cb, init_b = ergodic(c.LARGE_S)
    _, stats_m, cm, init_m = ergodic(200)
    o = c.general_operands(c.config4(dev), x, m)                        # config 4's dense matrix
    return {"config2": (stats, c2["lens"], c2["trans"], init2, c2["w"], c2["bias"]),
            "config4": (o["llh"], o["lens"], o["trans"], o["init"]),
            "config3": (c3["llh"], c3["lens"], c3["trans"], init3),
            "s300": random_llh(300),
            "ergodic300_stats": (stats_b, cb["lens"], cb["trans"], init_b, cb["w"], cb["bias"]),
            "ergodic300_llh": (big._state_llh(stats_b).contiguous(), cb["lens"], cb["trans"], init_b),
            "s230": random_llh(230),
            "ergodic200_stats": (stats_m, cm["lens"], cm["trans"], init_m, cm["w"], cm["bias"])}


def run_k5(dev, built, names):
    """K5 alone (ten bare foreign calls between two events, the median of
    20 such runs divided by ten) in each instance a shape can take: the
    warp and the block instance at configs 2 and 3, the global block
    instance at S = 300, and near the shared placement's limit (S = 230
    on llh, 200 at P = 78) the shared block instance in the chunks that
    fit against the global one in chunks of 16."""
    cases = k5_cases(dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr()) if t is not None else None  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    # (case, instance, frames a chunk of the block instance)
    runs = [("config2", "warp", 32), ("config2", "shared", 16), ("config3", "warp", 32),
            ("config3", "shared", 16), ("config4", "shared", 16), ("config4", "shared", 8),
            ("config4", "shared", 4), ("s300", "global", 16),
            ("ergodic300_stats", "global", 16), ("ergodic300_llh", "global", 16),
            ("s230", "shared", 8), ("s230", "shared", 4), ("s230", "global", 16),
            ("ergodic200_stats", "shared", 4), ("ergodic200_stats", "shared", 2),
            ("ergodic200_stats", "global", 16)]
    for name in names:
        path, regs = built[name]
        same = K5_VARIANTS[name][1]
        lib = ctypes.CDLL(str(path))
        lib.beer_forward_llh_dense.argtypes = [i, i, i] + [p] * 10 + [i] * 4 + [p]
        row = {}
        for tag, instance, chunk in runs:
            args = cases[tag]
            x, lens, trans, init = args[:4]
            w, bias = args[4:] if len(args) > 4 else (None, None)
            b, t_len, s = x.shape[0], x.shape[1], trans.shape[0]
            p_dim = x.shape[2] if w is not None else 0
            if instance == "global" and w is not None:
                w = w.T.contiguous()
            outs = (torch.empty(b, t_len, s, device=dev), torch.empty(b, t_len, device=dev),
                    torch.empty(b, s, device=dev), torch.empty(b, device=dev))
            code = cuda_scan._INSTANCES.index(instance)
            call = lambda: lib.beer_forward_llh_dense(  # noqa: E731
                0, code, chunk, ptr(x), ptr(lens), ptr(w), ptr(bias), ptr(trans), ptr(init),
                *map(ptr, outs), b, t_len, s, p_dim, stream)
            key = f"{tag}_{instance}" + (f"_c{chunk}" if instance != "warp" else "")
            c.check(call() == 0, f"{name}: K5 launch ({key})")
            row[f"{key}_ms"] = median_ms(lambda: [call() for _ in range(10)]) / 10
            if same:
                want = cuda_scan.forward_llh_dense_plain(*args)
                err = float((outs[0] - want[0]).abs().max())
                if err > 1e-5 or c.rel(outs[3], want[3]) > 1e-5:
                    row[f"{key}_DIFFERS_alpha_abs"] = err
        print(f"variant {name}: {CARD} | " + ", ".join(f"{k_} {v:.4f}" for k_, v in row.items())
              + f" | registers {regs} | {'same function' if same else 'not the same function'}", flush=True)


def k2k6_cases(dev):
    """K2's operands at config 4 and K6's at config 2, as ``chip_smoke.py``
    phases 3 and 6 build them (two zero-length rows each)."""
    _, stats, ops, fwd, _ = c.banded_operands(dev)
    alpha, norms, _, _ = cuda_scan.forward_llh_banded(*fwd)
    k2 = c.banded_estep_args(stats, ops, alpha, norms)
    stats6, c6, final, fwd6 = c.dense_operands(dev)
    alpha6, norms6, _, _ = cuda_scan.forward_llh_dense(*fwd6)
    k6 = (stats6, c6["lens"], c6["w"], c6["bias"], c6["trans"], final, alpha6, norms6)
    return k2, k6


def run_k2k6(dev, built, names):
    """K2 at config 4 and K6 at config 2 alone, one line a variant: ten
    bare foreign calls of the parent's entry points (the scan kernel and
    the batch sum) between two events, the median of 20 such runs
    divided by ten."""
    k2, k6 = k2k6_cases(dev)
    want2 = cuda_scan.estep_acc_banded_plain(*k2)
    want6 = cuda_scan.estep_acc_dense_plain(*k6)
    p, i = ctypes.c_void_p, ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for name in names:
        path, regs = built[name]
        lib = ctypes.CDLL(str(path))
        if name in K2_VARIANTS:
            same = K2_VARIANTS[name][1]
            lib.beer_estep_acc_banded.argtypes = [i] + [p] * 13 + [i] * 5 + [p]
            stats, w = k2[0], k2[2]
            b, t_len, p_dim = stats.shape
            s, n_u = w.shape[0], k2[8].shape[0]
            width = s * (p_dim + 1) + n_u * n_u
            part, out = torch.empty(b, width, device=dev), torch.empty(width, device=dev)
            gamma0 = torch.empty(b, s, device=dev)
            call = lambda: lib.beer_estep_acc_banded(  # noqa: E731
                0, *map(ptr, (*k2, part, out, gamma0)), b, t_len, s, p_dim, n_u, stream)
            key, want = "k2_config4", want2
            got = lambda: (out[: s * (p_dim + 1)].view(s, p_dim + 1)[:, :p_dim],  # noqa: E731
                           out[s * (p_dim + 1):].view(n_u, n_u))
        else:
            same = K6_VARIANTS[name][1]
            lib.beer_estep_acc_dense.argtypes = [i, i] + [p] * 11 + [i] * 4 + [p]
            stats = k6[0]
            b, t_len, p_dim = stats.shape
            s = k6[4].shape[0]
            width = s * (p_dim + 1) + s * s
            part, out = torch.empty(b, width, device=dev), torch.empty(width, device=dev)
            gamma0 = torch.empty(b, s, device=dev)
            call = lambda: lib.beer_estep_acc_dense(  # noqa: E731
                0, 0, *map(ptr, (*k6, part, out, gamma0)), b, t_len, s, p_dim, stream)
            key, want = "k6_config2", want6
            got = lambda: (out[: s * (p_dim + 1)].view(p_dim + 1, s).T[:, :p_dim],  # noqa: E731
                           out[s * (p_dim + 1):].view(s, s))
        c.check(call() == 0, f"{name}: launch")
        ms = median_ms(lambda: [call() for _ in range(10)]) / 10
        note = ""
        if same:
            acc, xi = got()
            e_acc, e_xi = c.rel(acc, want[0]), c.rel(xi, want[3])
            note = f" | acc2 rel {e_acc:.3g}, xi rel {e_xi:.3g}"
            c.check(e_acc <= 1e-4 and e_xi <= 1e-4, f"{name}: differs from the plain version{note}")
        print(f"variant {name}: {CARD} | {key}_ms {ms:.4f}{note} | registers {regs} "
              f"| {'same function' if same else 'not the same function'}", flush=True)


def kernel_split(fn, reps=20):
    """Device ms a call of ``fn`` by kernel (``torch.profiler`` over
    ``reps`` calls after a warm-up): {kernel name: ms}."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / reps / 1e3
    return out


def ours(split):
    """The device ms of the repository's own kernels in a ``kernel_split``."""
    return sum(v for k, v in split.items() if "at::" not in k and "_kernel" in k)


def b2_times(dev):
    """K2 at config 4, K6 at config 2 and at phase 18's S = 150 (shared)
    and 300 (global), the γ-emitting K11 (config 4 and config 5), K7
    (config 3, S = 300) and K15 (config 4) through this checkout's
    wrappers: each kernel's device ms, split by kernel, so that the batch
    sum (``sum_rows_kernel``) shows apart; and the unfused route at config
    4, K11 + γᵀ·stats (TF32 off), as ``PhoneLoop.accumulate``'s gradient
    route takes it; and K1, whose body the banded kernels' global
    placement touched, at config 4 and config 5 (the shared placement)."""
    k2, k6 = k2k6_cases(dev)
    fwd4 = c.banded_operands(dev)[3]
    row = {}

    def put(tag, fn):
        split = kernel_split(fn)
        row[f"{tag}_ms"] = round(ours(split), 4)
        row[f"{tag}_split"] = {k: round(v, 4) for k, v in split.items()}

    put("k1_config4", lambda: cuda_scan.forward_llh_banded(*fwd4))
    put("k2_config4", lambda: cuda_scan.estep_acc_banded(*k2))
    put("k6_config2", lambda: cuda_scan.estep_acc_dense(*k6))
    put("k11_config4", lambda: cuda_scan.estep_gamma_banded(*k2))
    assert not torch.backends.cuda.matmul.allow_tf32
    stats = k2[0]
    gamma = cuda_scan.estep_gamma_banded(*k2)[0].flatten(0, 1)
    row["unfused_product_ms"] = round(median_ms(lambda: gamma.T @ stats.flatten(0, 1)), 4)
    row["unfused_route_ms"] = round(median_ms(lambda: c.unfused_estep(k2)), 4)
    row["k2_config4_wrapper_ms"] = round(median_ms(lambda: cuda_scan.estep_acc_banded(*k2)), 4)
    row["k6_config2_wrapper_ms"] = round(median_ms(lambda: cuda_scan.estep_acc_dense(*k6)), 4)
    del gamma
    x5, m5 = c.config5_data(dev)
    x5 = torch.cat([x5, torch.zeros(2, *x5.shape[1:], device=dev)])
    m5 = torch.cat([m5, torch.zeros(2, m5.shape[1], device=dev)])
    stats5, ops5 = c.svae_operands(c.config5(dev), x5, m5)
    fwd5 = (stats5, ops5["lens"], ops5["w"], ops5["bias"], ops5["bands"], ops5["init"])
    alpha5, norms5, _, _ = cuda_scan.forward_llh_banded(*fwd5)
    k11 = c.banded_estep_args(stats5, ops5, alpha5, norms5)
    put("k1_config5", lambda: cuda_scan.forward_llh_banded(*fwd5))
    put("k11_config5", lambda: cuda_scan.estep_gamma_banded(*k11))
    data, mask = c.make_data(c.LARGE_B, c.LARGE_T, c.D, seed=8)
    xb, mb = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    for s in (c.SHARED_S, c.LARGE_S):
        hmm = c.config2(dev, s=s)
        st, cb = c.hmm_operands(hmm, xb, mb)
        init = torch.exp(hmm.graph_log_init).expand_as(cb["final"]).contiguous()
        f5 = cuda_scan.forward_llh_dense(st, cb["lens"], cb["trans"], init, cb["w"], cb["bias"])
        est = (st, cb["lens"], cb["w"], cb["bias"], cb["trans"], cb["final"], f5[0], f5[1])
        put(f"k6_s{s}", lambda: cuda_scan.estep_acc_dense(*est))
        if s == c.LARGE_S:
            llh = hmm._state_llh(st).contiguous()
            f7 = cuda_scan.forward_llh_dense(llh, cb["lens"], cb["trans"], init)
            gam = (llh, cb["lens"], cb["trans"], cb["final"], f7[0], f7[1])
            put(f"k7_s{s}", lambda: cuda_scan.estep_gamma_dense(*gam))
    data3, mask3, seqs = c.config3_data()
    rec = c.config3(dev, seqs)
    _, c3 = c.hmm_operands(rec, torch.from_numpy(data3).to(dev), torch.from_numpy(mask3).to(dev))
    init3 = torch.exp(torch.clamp(rec.graph_log_init, min=-1e30)).expand_as(c3["final"]).contiguous()
    f3 = cuda_scan.forward_llh_dense(c3["llh"], c3["lens"], c3["trans"], init3)
    gam3 = (c3["llh"], c3["lens"], c3["trans"], c3["final"], f3[0], f3[1])
    put("k7_config3", lambda: cuda_scan.estep_gamma_dense(*gam3))
    data, mask = c.with_empty_rows(*c.make_data(c.B, c.T, c.D))
    o = c.general_operands(c.config4(dev), torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev))
    fwd = (o["llh"], o["lens"], o["trans"], o["init"])
    shifted = cuda_scan.forward_llh_dense(*fwd, return_shifts=True)
    pair = (o["llh"], o["lens"], o["trans"], o["final"], shifted[0], shifted[1])
    put("k15_config4", lambda: cuda_scan.estep_gamma_dense(*pair, rows=o["ends"], cols=o["starts"]))
    print(f"b2 times: {CARD} | " + json.dumps(row), flush=True)


K2_GEOMETRIES = [("shared", 2, 16), ("shared", 1, 16), ("global", 4, 16), ("global", 2, 16), ("global", 1, 16),
                 ("shared", 2, 8), ("shared", 4, 4)]


def set_new_argtypes(lib):
    """The redesigned K2's and K6's entry points on a variant's library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("beer_estep_acc_banded", [i, i, i, i] + [p] * 13 + [i] * 5 + [p]),
                       ("beer_estep_acc_dense", [i, i, i, i] + [p] * 11 + [i] * 4 + [p])):
        if hasattr(lib, name):  # a variant's library holds one source
            getattr(lib, name).argtypes = args
    return lib


def time_k2(lib, dev, k2, want, geometries):
    """The redesigned K2 (bare foreign call, ten between two events, median
    of 20, divided by ten) in each launch geometry that fits; held against
    the plain version ``want`` (acc2, ξ rel 1e-4, γ₀ abs 1e-5) unless None."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    stats, w = k2[0], k2[2]
    b, t_len, p_dim = stats.shape
    s, n_u = w.shape[0], k2[8].shape[0]
    width = s * (p_dim + 1) + n_u * n_u
    row = {}
    for placement, n_utt, chunk in geometries:
        glob = placement == "global"
        if cuda_scan.acc_banded_smem_bytes(s, p_dim, n_u, placement, n_utt, chunk) > cuda_scan.SMEM_LIMIT:
            continue
        args = list(k2)
        if glob:
            args[2] = torch.nn.functional.pad(w, (0, -p_dim % 4)).T.contiguous()
        part, out = torch.empty(-(-b // n_utt), width, device=dev), torch.empty(width, device=dev)
        gamma0 = torch.empty(b, s, device=dev)
        call = lambda: lib.beer_estep_acc_banded(  # noqa: E731
            0, int(glob), n_utt, chunk, *map(ptr, (*args, part, out, gamma0)), b, t_len, s, p_dim, n_u, stream)
        key = f"k2_{placement}_u{n_utt}_c{chunk}"
        c.check(call() == 0, f"{key}: launch")
        if want is not None:
            acc = out[: s * (p_dim + 1)].view(s, p_dim + 1)[:, :p_dim]
            xi = out[s * (p_dim + 1):].view(n_u, n_u)
            errs = (c.rel(acc, want[0]), c.rel(xi, want[3]), float((gamma0 - want[2]).abs().max()))
            c.check(errs[0] <= 1e-4 and errs[1] <= 1e-4 and errs[2] <= 1e-5, f"{key}: differs from plain {errs}")
        row[key] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
    return row


def k6_cases(dev):
    """K6's operands at config 2 and on phase 18's ergodic HMMs at S = 150 and 300."""
    cases = {"config2": k2k6_cases(dev)[1]}
    data, mask = c.make_data(c.LARGE_B, c.LARGE_T, c.D, seed=8)
    xb, mb = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    for n in (c.SHARED_S, c.LARGE_S):
        hmm = c.config2(dev, s=n)
        st, cb = c.hmm_operands(hmm, xb, mb)
        init = torch.exp(hmm.graph_log_init).expand_as(cb["final"]).contiguous()
        f5 = cuda_scan.forward_llh_dense(st, cb["lens"], cb["trans"], init, cb["w"], cb["bias"])
        cases[f"s{n}"] = (st, cb["lens"], cb["w"], cb["bias"], cb["trans"], cb["final"], f5[0], f5[1])
    return cases


def time_k6(lib, dev, cases, check=True, instances=("warp", "shared", "global")):
    """The redesigned K6 (bare foreign call, as :func:`time_k2`) in each
    instance that fits each case, held against its plain version."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    row = {}
    for tag, args in cases.items():
        stats, lens, w, bias, trans, final, alpha, norms = args
        b, t_len, p_dim = stats.shape
        s = trans.shape[0]
        want = cuda_scan.estep_acc_dense_plain(*args) if check else None
        width = s * (p_dim + 1) + s * s
        for instance in instances:
            chunk = cuda_scan.BACKWARD_CHUNK if instance == "warp" else cuda_scan.backward_chunk(s, p_dim, instance)
            if (instance == "warp" and s > 32) or \
                    cuda_scan.backward_smem_bytes(s, p_dim, instance, chunk) > cuda_scan.SMEM_LIMIT:
                continue
            wk, tk = (w.T.contiguous(), trans.T.contiguous()) if instance == "global" else (w, trans)
            for n_utt in ((4, 2, 1) if instance == "warp" else (1,)):
                part, out = torch.empty(-(-b // n_utt), width, device=dev), torch.empty(width, device=dev)
                gamma0 = torch.empty(b, s, device=dev)
                call = lambda: lib.beer_estep_acc_dense(  # noqa: E731
                    0, cuda_scan._INSTANCES.index(instance), chunk, n_utt,
                    *map(ptr, (stats, lens, wk, bias, tk, final, alpha, norms, part, out, gamma0)),
                    b, t_len, s, p_dim, stream)
                key = f"k6_{tag}_{instance}_c{chunk}" + (f"_u{n_utt}" if instance == "warp" else "")
                c.check(call() == 0, f"{key}: launch")
                if want is not None:
                    acc = out[: s * (p_dim + 1)].view(p_dim + 1, s).T[:, :p_dim]
                    xi = out[s * (p_dim + 1):].view(s, s)
                    errs = (c.rel(acc, want[0]), c.rel(xi, want[3]), float((gamma0 - want[2]).abs().max()))
                    c.check(errs[0] <= 1e-4 and errs[1] <= 1e-4 and errs[2] <= 1e-5,
                            f"{key}: differs from plain {errs}")
                row[key] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
    return row


def geometry(dev):
    """The redesigned K2 at config 4 in each launch geometry of
    :data:`K2_GEOMETRIES` (placement, utterances a block, frames a chunk)
    and K6 in each instance (config 2: warp, shared and global block;
    phase 18's S = 150 and 300), each held against its plain version."""
    k2, _ = k2k6_cases(dev)
    lib = cuda_scan._library()
    row = time_k2(lib, dev, k2, cuda_scan.estep_acc_banded_plain(*k2), K2_GEOMETRIES)
    row.update(time_k6(lib, dev, k6_cases(dev)))
    print(f"geometry: {CARD} | " + json.dumps(row), flush=True)
    cases = b7_cases(dev)
    for tag, geometries in K1_GEOMETRIES.items():
        print(f"geometry: {CARD} | " + json.dumps(time_k1(lib, dev, tag, cases[tag], geometries)), flush=True)
    for tag, instances in K7_INSTANCES.items():
        print(f"geometry: {CARD} | " + json.dumps(time_k7(lib, dev, tag, cases[tag], instances)), flush=True)
    del cases
    print(f"geometry: {CARD} | " + json.dumps(small_batches(lib, dev)), flush=True)


def small_batches(lib, dev):
    """K2 and K6's warp instance at batches that fill the card with fewer
    utterances a block than fit (``cuda_scan._utterance_cap``): K2 on
    config 5's loop (B = 258) and on config 4's first 128 rows, K6 on
    config 2's first 128 rows, each in the geometry the batch-size rule
    picks and in the ones the rule by fit alone picked, held against the
    plain versions."""
    x5, m5 = c.config5_data(dev)
    x5 = torch.cat([x5, torch.zeros(2, *x5.shape[1:], device=dev)])
    m5 = torch.cat([m5, torch.zeros(2, m5.shape[1], device=dev)])
    stats5, ops5 = c.svae_operands(c.config5(dev), x5, m5)
    fwd5 = (stats5, ops5["lens"], ops5["w"], ops5["bias"], ops5["bands"], ops5["init"])
    k2_5 = c.banded_estep_args(stats5, ops5, *cuda_scan.forward_llh_banded_plain(*fwd5)[:2])
    row = {f"config5_{k}": v for k, v in time_k2(lib, dev, k2_5, cuda_scan.estep_acc_banded_plain(*k2_5), [
        ("shared", 4, 16), ("shared", 2, 16), ("shared", 1, 16)]).items()}
    k2, k6 = k2k6_cases(dev)
    n = 128
    k2 = tuple(x[:n] if i in (0, 1, 6, 7) else x for i, x in enumerate(k2))   # stats, lens, alpha, norms
    row.update({f"config4_b{n}_{k}": v for k, v in time_k2(lib, dev, k2, cuda_scan.estep_acc_banded_plain(*k2), [
        ("global", 2, 16), ("shared", 1, 16), ("global", 1, 16)]).items()})
    k6 = tuple(x[:n] if i in (0, 1, 5, 6, 7) else x for i, x in enumerate(k6))   # stats, lens, final, alpha, norms
    row.update(time_k6(lib, dev, {f"config2_b{n}": k6}, instances=("warp",)))
    return row


def run_new(dev, built, names):
    """The ``k2n_*`` / ``k6n_*`` variants of the redesigned kernels: K2 at
    config 4 in four geometries (global with 4, 2 and 1 utterances a block,
    shared with 2), K6 at config 2 (warp) and S = 150 and 300 (global), one
    line a variant."""
    k2, _ = k2k6_cases(dev)
    cases = k6_cases(dev)
    want2 = cuda_scan.estep_acc_banded_plain(*k2)
    s, p_dim, n_u = k2[2].shape[0], k2[0].shape[2], k2[8].shape[0]
    geoms = [("global", 4, 16), ("global", 2, 16), ("global", 1, 16), ("shared", 2, 16)]
    for name in names:
        path, regs = built[name]
        lib = set_new_argtypes(ctypes.CDLL(str(path)))
        if name in K2N_VARIANTS:
            same = K2N_VARIANTS[name][1]
            row = time_k2(lib, dev, k2, want2 if same else None, geoms)
        else:
            same = K6N_VARIANTS[name][1]
            row = time_k6(lib, dev, cases, check=same, instances=("warp", "global"))
        print(f"variant {name}: {CARD} | " + json.dumps(row) + f" | registers {regs} "
              f"| {'same function' if same else 'not the same function'}", flush=True)


def b7_cases(dev):
    """The operands of K1 (configs 4 and 5, phone loops of 100 and 250
    units on phase 18's data), K7 (config 3, the config-2 llh stream,
    phase 18's ergodic HMMs at S = 150 and 300) and K15 (config 4's
    dense matrix, ξ on the units' ends × starts), as ``chip_smoke.py``
    builds them (configs 4 and 5 with two zero-length rows)."""
    cases = {"k1_config4": c.banded_operands(dev)[3]}
    x5, m5 = c.config5_data(dev)
    x5 = torch.cat([x5, torch.zeros(2, *x5.shape[1:], device=dev)])
    m5 = torch.cat([m5, torch.zeros(2, m5.shape[1], device=dev)])
    stats5, ops5 = c.svae_operands(c.config5(dev), x5, m5)
    cases["k1_config5"] = (stats5, ops5["lens"], ops5["w"], ops5["bias"], ops5["bands"], ops5["init"])
    data, mask = c.make_data(c.LARGE_B, c.LARGE_T, c.D, seed=8)
    xb, mb = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    for units in (c.LOOP_UNITS, c.BIG_LOOP_UNITS):
        loop = c.config4(dev, n_units=units)
        st = loop.sufficient_statistics(xb).contiguous()
        ops = loop.scan_operands(st, mb)
        cases[f"k1_u{units}"] = (st, ops["lens"], ops["w"], ops["bias"], ops["bands"], ops["init"])
    data3, mask3, seqs = c.config3_data()
    rec = c.config3(dev, seqs)
    _, c3 = c.hmm_operands(rec, torch.from_numpy(data3).to(dev), torch.from_numpy(mask3).to(dev))
    init3 = torch.exp(torch.clamp(rec.graph_log_init, min=-1e30)).expand_as(c3["final"]).contiguous()
    f3 = cuda_scan.forward_llh_dense_plain(c3["llh"], c3["lens"], c3["trans"], init3)
    cases["k7_config3"] = (c3["llh"], c3["lens"], c3["trans"], c3["final"], f3[0], f3[1])
    data, mask = c.make_data(c.B, c.T, c.D)
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    hmm = c.config2(dev)
    st2, c2 = c.hmm_operands(hmm, x, m)
    llh2 = hmm._state_llh(st2).contiguous()
    init2 = torch.exp(hmm.graph_log_init).expand_as(c2["final"]).contiguous()
    f2 = cuda_scan.forward_llh_dense_plain(llh2, c2["lens"], c2["trans"], init2)
    cases["k7_config2"] = (llh2, c2["lens"], c2["trans"], c2["final"], f2[0], f2[1])
    for s in (c.SHARED_S, c.LARGE_S):
        big = c.config2(dev, s=s)
        sb, cb = c.hmm_operands(big, xb, mb)
        llh = big._state_llh(sb).contiguous()
        init = torch.exp(big.graph_log_init).expand_as(cb["final"]).contiguous()
        f = cuda_scan.forward_llh_dense_plain(llh, cb["lens"], cb["trans"], init)
        cases[f"k7_s{s}"] = (llh, cb["lens"], cb["trans"], cb["final"], f[0], f[1])
    data, mask = c.with_empty_rows(*c.make_data(c.B, c.T, c.D))
    o = c.general_operands(c.config4(dev), torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev))
    f = cuda_scan.forward_llh_dense_plain(o["llh"], o["lens"], o["trans"], o["init"], return_shifts=True)
    cases["k15_config4"] = (o["llh"], o["lens"], o["trans"], o["final"], f[0], f[1], o["ends"], o["starts"])
    return cases


def b7_times(dev):
    """K1 (configs 4 and 5, 100 and 250 units), K7 (config 3, S = 150 and
    300), K15 (config 4), and beside them K2 (config 4), K6 (config 2, S =
    150 and 300), K11 (configs 4 and 5) and K5 (configs 2 and 3), through
    this checkout's wrappers: each call's device ms split by kernel
    (``kernel_split``), so that the batch sum shows apart.  The operands
    are made once, with the plain versions, so that every revision times
    the same inputs."""
    cases = b7_cases(dev)
    row = {}

    def put(tag, fn):
        split = kernel_split(fn)
        row[f"{tag}_ms"] = round(ours(split), 4)
        row[f"{tag}_split"] = {k: round(v, 4) for k, v in split.items()}

    for tag in ("k1_config4", "k1_config5", f"k1_u{c.LOOP_UNITS}", f"k1_u{c.BIG_LOOP_UNITS}"):
        put(tag, lambda: cuda_scan.forward_llh_banded(*cases[tag]))
    for tag in ("k7_config3", "k7_config2", f"k7_s{c.SHARED_S}", f"k7_s{c.LARGE_S}"):
        put(tag, lambda: cuda_scan.estep_gamma_dense(*cases[tag]))
    k15 = cases["k15_config4"]
    put("k15_config4", lambda: cuda_scan.estep_gamma_dense(*k15[:6], rows=k15[6], cols=k15[7]))
    del cases
    k2, k6 = k2k6_cases(dev)
    put("k2_config4", lambda: cuda_scan.estep_acc_banded(*k2))
    put("k11_config4", lambda: cuda_scan.estep_gamma_banded(*k2))
    put("k6_config2", lambda: cuda_scan.estep_acc_dense(*k6))
    for tag, args in k6_cases(dev).items():
        if tag != "config2":
            put(f"k6_{tag}", lambda: cuda_scan.estep_acc_dense(*args))
    x5, m5 = c.config5_data(dev)
    x5 = torch.cat([x5, torch.zeros(2, *x5.shape[1:], device=dev)])
    m5 = torch.cat([m5, torch.zeros(2, m5.shape[1], device=dev)])
    stats5, ops5 = c.svae_operands(c.config5(dev), x5, m5)
    fwd5 = (stats5, ops5["lens"], ops5["w"], ops5["bias"], ops5["bands"], ops5["init"])
    alpha5, norms5, _, _ = cuda_scan.forward_llh_banded_plain(*fwd5)
    k11 = c.banded_estep_args(stats5, ops5, alpha5, norms5)
    put("k11_config5", lambda: cuda_scan.estep_gamma_banded(*k11))
    k5 = k5_cases(dev)
    for tag in ("config2", "config3"):
        put(f"k5_{tag}", lambda: cuda_scan.forward_llh_dense(*k5[tag]))
    print(f"b7 times: {CARD} | " + json.dumps(row), flush=True)


# K1: case -> launch geometries (placement, utterances a block, frames a chunk)
K1_GEOMETRIES = {
    "k1_config4": [("global", 4, 16), ("global", 2, 16), ("shared", 2, 16), ("shared", 1, 16), ("global", 1, 16),
                   ("shared", 4, 16), ("global", 4, 8)],
    "k1_config5": [("shared", 4, 16), ("shared", 2, 16), ("shared", 1, 16), ("global", 4, 16)],
    f"k1_u{c.LOOP_UNITS}": [("global", 2, 16), ("global", 1, 16), ("shared", 1, 16), ("global", 4, 16)],
    f"k1_u{c.BIG_LOOP_UNITS}": [("global", 1, 16), ("global", 2, 16), ("global", 1, 8)],
}
# K7 / K15: case -> instances (instance, frames a chunk, utterances a block)
K7_INSTANCES = {
    "k7_config3": [("warp", 16, 4), ("warp", 16, 2), ("warp", 16, 1), ("shared", 16, 1)],
    "k7_config2": [("warp", 16, 4), ("warp", 16, 2), ("warp", 16, 1)],
    f"k7_s{c.SHARED_S}": [("shared", 16, 1), ("shared", 8, 1), ("global", 16, 1)],
    f"k7_s{c.LARGE_S}": [("global", 16, 1), ("global", 8, 1)],
    "k15_config4": [("shared", 16, 1), ("shared", 8, 1), ("shared", 2, 1), ("global", 16, 1), ("global", 8, 1)],
}


def time_k1(lib, dev, tag, fwd, geometries, check=True):
    """The chunked K1 (bare foreign call, ten between two events, median of
    20, divided by ten) in each launch geometry that fits; held against
    the plain version (log Z rel 1e-5, α̂ abs 1e-5) when ``check``."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.beer_forward_llh_banded.argtypes = [i, i, i, i] + [p] * 10 + [i] * 4 + [p]
    stats, lens, w, bias, bands, init = fwd
    b, t_len, p_dim = stats.shape
    s = w.shape[0]
    want = cuda_scan.forward_llh_banded_plain(*fwd) if check else None
    full = lens > 0
    row = {}
    for placement, n_utt, chunk in geometries:
        glob = placement == "global"
        if cuda_scan.forward_banded_smem_bytes(s, p_dim, placement, n_utt, chunk) > cuda_scan.SMEM_LIMIT:
            continue
        wk = torch.nn.functional.pad(w, (0, -p_dim % 4)).T.contiguous() if glob else w
        outs = (torch.empty(b, t_len, s, device=dev), torch.empty(b, t_len, device=dev),
                torch.empty(b, s, device=dev), torch.empty(b, device=dev))
        call = lambda: lib.beer_forward_llh_banded(  # noqa: E731
            0, int(glob), n_utt, chunk, *map(ptr, (stats, lens, wk, bias, bands, init, *outs)), b, t_len, s, p_dim,
            stream)
        key = f"{tag}_{placement}_u{n_utt}_c{chunk}"
        c.check(call() == 0, f"{key}: launch")
        if want is not None:
            errs = (c.rel(outs[3][full], want[3][full]), float((outs[0] - want[0]).abs().max()))
            c.check(errs[0] <= 1e-5 and errs[1] <= 1e-5, f"{key}: differs from plain {errs}")
        row[key] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
    return row


def time_k7(lib, dev, tag, gam, instances, check=True):
    """The chunked K7 (K15 when ``gam`` carries rows and columns) in each
    instance that fits, as :func:`time_k1`; held against the plain version
    (γ abs 1e-5, ξ rel 1e-4) when ``check``."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr()) if t is not None else None  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.beer_estep_gamma_dense.argtypes = [i, i, i, i] + [p] * 11 + [i] * 5 + [p]
    llh, lens, trans, final, alpha, norms = gam[:6]
    rows, cols = gam[6:] if len(gam) > 6 else (None, None)
    b, t_len, s = llh.shape
    rc = (rows.numel(), cols.numel()) if rows is not None else ()
    n_r, n_c = rc or (s, s)
    kw = dict(rows=rows, cols=cols) if rc else {}
    want = cuda_scan.estep_gamma_dense_plain(*gam[:6], **kw) if check else None
    row = {}
    for instance, chunk, n_utt in instances:
        if (instance == "warp" and s > 32) or \
                cuda_scan.gamma_smem_bytes(s, instance, chunk, n_utt, *rc) > cuda_scan.SMEM_LIMIT:
            continue
        tk = trans.T.contiguous() if instance == "global" else trans
        part = torch.empty(-(-b // n_utt), n_r * n_c, device=dev)
        out, gamma = torch.empty(n_r * n_c, device=dev), torch.empty(b, t_len, s, device=dev)
        call = lambda: lib.beer_estep_gamma_dense(  # noqa: E731
            0, cuda_scan._INSTANCES.index(instance), chunk, n_utt,
            *map(ptr, (llh, lens, tk, final, alpha, norms, rows, cols, part, out, gamma)), b, t_len, s, n_r, n_c,
            stream)
        key = f"{tag}_{instance}_c{chunk}_u{n_utt}"
        c.check(call() == 0, f"{key}: launch")
        if want is not None:
            errs = (float((gamma - want[0]).abs().max()), c.rel(out.view(n_r, n_c), want[1]))
            c.check(errs[0] <= 1e-5 and errs[1] <= 1e-4, f"{key}: differs from plain {errs}")
        row[key] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
    return row


def run_b7_parent(dev, built, names):
    """The ``k1_*`` / ``k7_*`` variants of the per-frame K1 and K7 (6a3a03f's
    entry points, ten bare foreign calls between two events, median of 20,
    divided by ten): K1 at config 4 and on the 100- and 250-unit loops, K7
    at config 3 and at S = 150 and 300 (its shared and global placements
    as that revision picked them), one line a variant."""
    cases = b7_cases(dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in names:
        path, regs = built[name]
        lib = ctypes.CDLL(str(path))
        same = PARENT_B7_VARIANTS[name][1]
        row = {}
        if name in K1_VARIANTS:
            lib.beer_forward_llh_banded.argtypes = [i, i] + [p] * 10 + [i] * 4 + [p]
            for tag in ("k1_config4", f"k1_u{c.LOOP_UNITS}", f"k1_u{c.BIG_LOOP_UNITS}"):
                stats, lens, w, bias, bands, init = cases[tag]
                b, t_len, p_dim = stats.shape
                s = w.shape[0]
                glob = 4 * (s * (p_dim | 1) + 7 * s + p_dim + 64) > cuda_scan.SMEM_LIMIT   # that revision's rule
                wk = w.T.contiguous() if glob else w
                outs = (torch.empty(b, t_len, s, device=dev), torch.empty(b, t_len, device=dev),
                        torch.empty(b, s, device=dev), torch.empty(b, device=dev))
                call = lambda: lib.beer_forward_llh_banded(  # noqa: E731
                    0, int(glob), *map(ptr, (stats, lens, wk, bias, bands, init, *outs)), b, t_len, s, p_dim, stream)
                c.check(call() == 0, f"{name}: launch ({tag})")
                if same:
                    want = cuda_scan.forward_llh_banded_plain(*cases[tag])
                    c.check(float((outs[0] - want[0]).abs().max()) <= 1e-5, f"{name}: differs from plain ({tag})")
                row[f"{tag}_ms"] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
        else:
            lib.beer_estep_gamma_dense.argtypes = [i, i] + [p] * 9 + [i] * 3 + [p]
            for tag in ("k7_config3", f"k7_s{c.SHARED_S}", f"k7_s{c.LARGE_S}"):
                llh, lens, trans, final, alpha, norms = cases[tag]
                b, t_len, s = llh.shape
                glob = 4 * (6 * s + 64 + s * (s | 1) + s * s) > cuda_scan.SMEM_LIMIT   # that revision's rule
                tk = trans.T.contiguous() if glob else trans
                part, out = torch.empty(b, s * s, device=dev), torch.empty(s * s, device=dev)
                gamma = torch.empty(b, t_len, s, device=dev)
                call = lambda: lib.beer_estep_gamma_dense(  # noqa: E731
                    0, int(glob), *map(ptr, (llh, lens, tk, final, alpha, norms, part, out, gamma)), b, t_len, s,
                    stream)
                c.check(call() == 0, f"{name}: launch ({tag})")
                if same:
                    want = cuda_scan.estep_gamma_dense_plain(*cases[tag])
                    c.check(float((gamma - want[0]).abs().max()) <= 1e-5 and c.rel(out.view(s, s), want[1]) <= 1e-4,
                            f"{name}: differs from plain ({tag})")
                row[f"{tag}_ms"] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
        print(f"variant {name}: {CARD} | " + json.dumps(row) + f" | registers {regs} "
              f"| {'same function' if same else 'not the same function'}", flush=True)


def run_b7_new(dev, built, names):
    """The ``k1n_*`` / ``k7n_*`` variants of the chunked K1 and K7 / K15 in
    the geometry each shape takes (:func:`time_k1`, :func:`time_k7`): K1 at
    configs 4 and 5 and 250 units, K7 at config 3 and S = 150 and 300,
    K15 at config 4, one line a variant."""
    cases = b7_cases(dev)
    n_sm = cuda_scan.sm_count(dev.index)
    for name in names:
        path, regs = built[name]
        lib = ctypes.CDLL(str(path))
        same = NEW_B7_VARIANTS[name][1]
        row = {}
        if name in K1N_VARIANTS:
            for tag in ("k1_config4", "k1_config5", f"k1_u{c.BIG_LOOP_UNITS}"):
                st, w = cases[tag][0], cases[tag][2]
                geom = cuda_scan.forward_banded_geometry(w.shape[0], st.shape[2], st.shape[0], n_sm)
                row.update(time_k1(lib, dev, tag, cases[tag], [geom], check=same))
        else:
            for tag in ("k7_config3", f"k7_s{c.SHARED_S}", f"k7_s{c.LARGE_S}", "k15_config4"):
                gam = cases[tag]
                rc = (gam[6].numel(), gam[7].numel()) if len(gam) > 6 else ()
                s, b = gam[0].shape[2], gam[0].shape[0]
                instance, chunk = cuda_scan.gamma_instance(s, *rc)
                n_utt = cuda_scan.gamma_utterances(s, b, n_sm, *rc) if instance == "warp" else 1
                row.update(time_k7(lib, dev, tag, gam, [(instance, chunk, n_utt)], check=same))
        print(f"variant {name}: {CARD} | " + json.dumps(row) + f" | registers {regs} "
              f"| {'same function' if same else 'not the same function'}", flush=True)


def b11_cases(dev):
    """The operands of K11 (configs 4 and 5, with two zero-length rows, and
    phone loops of 100 and 250 units on phase 18's data; α̂ and the norms
    from K1's plain version) and K3 (config 3's recognizer decode, config
    4's unit decode, config 5's latent decode, each as the model's decode
    gives them, and the unit decodes of loops of 100, 250 and 700 units on
    phase 18's data and of a 3,200-unit loop on 8 of its rows), as
    ``chip_smoke.py`` builds them."""
    cases = {}
    _, stats, ops, fwd, m4 = c.banded_operands(dev)
    alpha, norms, _, _ = cuda_scan.forward_llh_banded_plain(*fwd)
    cases["k11_config4"] = c.banded_estep_args(stats, ops, alpha, norms)
    x5, m5 = c.config5_data(dev)
    x5 = torch.cat([x5, torch.zeros(2, *x5.shape[1:], device=dev)])
    m5 = torch.cat([m5, torch.zeros(2, m5.shape[1], device=dev)])
    vae = c.config5(dev)
    stats5, ops5 = c.svae_operands(vae, x5, m5)
    fwd5 = (stats5, ops5["lens"], ops5["w"], ops5["bias"], ops5["bands"], ops5["init"])
    cases["k11_config5"] = c.banded_estep_args(stats5, ops5, *cuda_scan.forward_llh_banded_plain(*fwd5)[:2])
    data, mask = c.make_data(c.LARGE_B, c.LARGE_T, c.D, seed=8)
    xb, mb = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    for units in (c.LOOP_UNITS, c.BIG_LOOP_UNITS):
        loop = c.config4(dev, n_units=units)
        st = loop.sufficient_statistics(xb).contiguous()
        o = loop.scan_operands(st, mb)
        f = (st, o["lens"], o["w"], o["bias"], o["bands"], o["init"])
        cases[f"k11_u{units}"] = c.banded_estep_args(st, o, *cuda_scan.forward_llh_banded_plain(*f)[:2])
    data3, mask3, seqs = c.config3_data()
    rec = c.config3(dev, seqs)
    x3, m3 = torch.from_numpy(data3).to(dev), torch.from_numpy(mask3).to(dev)
    cases["k3_config3"] = c.viterbi_args(lambda: rec.decode(x3, m3))
    data, mask = c.with_empty_rows(*c.make_data(c.B, c.T, c.D))
    x4, m4 = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    cases["k3_config4"] = c.viterbi_args(lambda: c.config4(dev).decode_units(x4, m4))
    cases["k3_config5"] = c.viterbi_args(lambda: vae.latent_decode(x5, m5))
    for units, rows in ((c.LOOP_UNITS, None), (c.BIG_LOOP_UNITS, None), (700, None), (3200, 8)):
        loop = c.config4(dev, n_units=units)   # 3,200 units: S = 9,600, near the per-frame kernel's limit
        cases[f"k3_u{units}"] = c.viterbi_args(lambda: loop.decode_units(xb[:rows], mb[:rows]))
    return cases


K3_TAGS = ("k3_config3", "k3_config4", "k3_config5", f"k3_u{c.LOOP_UNITS}", f"k3_u{c.BIG_LOOP_UNITS}", "k3_u700",
           "k3_u3200")


def b11_times(dev):
    """K11 (configs 4 and 5, 100 and 250 units) and K3 (configs 3, 4 and 5,
    loops of 100, 250, 700 and 3,200 units), and beside them K1 (configs 4 and
    5), K2 (config 4), K6 (config 2's warp instance, S = 150 and 300 in the
    block instance), K7 (config 3's warp instance, S = 150 shared and 300
    global block), K15 (config 4) and K5 (configs 2 and 3), through this
    checkout's wrappers: each call's device ms split by kernel
    (``kernel_split``), so that the batch sum shows apart.  K11's and K1's
    operands come from the plain versions, so that every revision times
    the same inputs."""
    row = {}

    def put(tag, fn):
        split = kernel_split(fn)
        row[f"{tag}_ms"] = round(ours(split), 4)
        row[f"{tag}_split"] = {k: round(v, 4) for k, v in split.items()}

    cases = b11_cases(dev)
    for tag in ("k11_config4", "k11_config5", f"k11_u{c.LOOP_UNITS}", f"k11_u{c.BIG_LOOP_UNITS}"):
        put(tag, lambda: cuda_scan.estep_gamma_banded(*cases[tag]))
    for tag in K3_TAGS:
        put(tag, lambda: cuda_scan.viterbi_fwd_banded(*cases[tag]))
    del cases
    cases = b7_cases(dev)
    for tag in ("k1_config4", "k1_config5"):
        put(tag, lambda: cuda_scan.forward_llh_banded(*cases[tag]))
    for tag in ("k7_config3", f"k7_s{c.SHARED_S}", f"k7_s{c.LARGE_S}"):
        put(tag, lambda: cuda_scan.estep_gamma_dense(*cases[tag]))
    k15 = cases["k15_config4"]
    put("k15_config4", lambda: cuda_scan.estep_gamma_dense(*k15[:6], rows=k15[6], cols=k15[7]))
    del cases
    k2, _ = k2k6_cases(dev)
    put("k2_config4", lambda: cuda_scan.estep_acc_banded(*k2))
    for tag, args in k6_cases(dev).items():
        put(f"k6_{tag}", lambda: cuda_scan.estep_acc_dense(*args))
    k5 = k5_cases(dev)
    for tag in ("config2", "config3"):
        put(f"k5_{tag}", lambda: cuda_scan.forward_llh_dense(*k5[tag]))
    print(f"b11 times: {CARD} | " + json.dumps(row), flush=True)


def run_b11_parent(dev, built, names):
    """The ``k11_*`` / ``k3_*`` variants of the per-frame K11 and K3
    (0849d1a's entry points, ten bare foreign calls between two events,
    median of 20, divided by ten): K11 at configs 4 and 5 and on the 100-
    and 250-unit loops (its shared and global placements as that revision
    picked them), K3 at configs 3, 4 and 5, one line a variant."""
    cases = b11_cases(dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in names:
        path, regs = built[name]
        lib = ctypes.CDLL(str(path))
        same = PARENT_B11_VARIANTS[name][1]
        row = {}
        if name in K11_VARIANTS:
            lib.beer_estep_gamma_banded.argtypes = [i, i] + [p] * 14 + [i] * 5 + [p]
            for tag in ("k11_config4", "k11_config5", f"k11_u{c.LOOP_UNITS}", f"k11_u{c.BIG_LOOP_UNITS}"):
                est = cases[tag]
                stats, w, ends = est[0], est[2], est[8]
                b, t_len, p_dim = stats.shape
                s, n_u = w.shape[0], ends.shape[0]
                glob = 4 * (s * (p_dim | 1) + n_u * n_u + 11 * s + p_dim + 2 * n_u + 64) > cuda_scan.SMEM_LIMIT
                args = list(est)
                if glob:   # that revision's rule and its Wᵀ
                    args[2] = w.T.contiguous()
                part, out = torch.empty(b, n_u * n_u, device=dev), torch.empty(n_u * n_u, device=dev)
                gamma0, gamma = torch.empty(b, s, device=dev), torch.empty(b, t_len, s, device=dev)
                call = lambda: lib.beer_estep_gamma_banded(  # noqa: E731
                    0, int(glob), *map(ptr, (*args, part, out, gamma0, gamma)), b, t_len, s, p_dim, n_u, stream)
                c.check(call() == 0, f"{name}: launch ({tag})")
                if same:
                    want = cuda_scan.estep_gamma_banded_plain(*est)
                    c.check(float((gamma - want[0]).abs().max()) <= 1e-5 and c.rel(out.view(n_u, n_u), want[2]) <= 1e-4,
                            f"{name}: differs from plain ({tag})")
                row[f"{tag}_ms"] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
        else:
            lib.beer_viterbi_fwd_banded.argtypes = [i] + [p] * 7 + [i] * 3 + [p]
            for tag in K3_TAGS:
                vit = cases[tag]
                b, t_len, s = vit[0].shape
                outs = (torch.empty(b, t_len, s, dtype=torch.int8, device=dev),
                        torch.empty(b, t_len, dtype=torch.int32, device=dev), torch.empty(b, s, device=dev))
                call = lambda: lib.beer_viterbi_fwd_banded(  # noqa: E731
                    0, *map(ptr, (*vit, *outs)), b, t_len, s, stream)
                c.check(call() == 0, f"{name}: launch ({tag})")
                if same:
                    want = cuda_scan.viterbi_fwd_banded_plain(*vit)
                    c.check(all(torch.equal(x, y) for x, y in zip(outs, want)), f"{name}: differs from plain ({tag})")
                row[f"{tag}_ms"] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
        print(f"variant {name}: {CARD} | " + json.dumps(row) + f" | registers {regs} "
              f"| {'same function' if same else 'not the same function'}", flush=True)


def time_k11(lib, dev, tag, est, geometries, check=True):
    """The chunked K11 (bare foreign call, ten between two events, median
    of 20, divided by ten) in each launch geometry that fits; held against
    the plain version (γ abs 1e-5, ξ rel 1e-4) when ``check``."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.beer_estep_gamma_banded.argtypes = [i, i, i, i] + [p] * 14 + [i] * 5 + [p]
    stats, w, ends = est[0], est[2], est[8]
    b, t_len, p_dim = stats.shape
    s, n_u = w.shape[0], ends.shape[0]
    want = cuda_scan.estep_gamma_banded_plain(*est) if check else None
    row = {}
    for placement, n_utt, chunk in geometries:
        glob = placement == "global"
        if cuda_scan.gamma_banded_smem_bytes(s, p_dim, n_u, placement, n_utt, chunk) > cuda_scan.SMEM_LIMIT:
            continue
        args = list(est)
        if glob:
            args[2] = torch.nn.functional.pad(w, (0, -p_dim % 4)).T.contiguous()
        part, out = torch.empty(-(-b // n_utt), n_u * n_u, device=dev), torch.empty(n_u * n_u, device=dev)
        gamma0, gamma = torch.empty(b, s, device=dev), torch.empty(b, t_len, s, device=dev)
        call = lambda: lib.beer_estep_gamma_banded(  # noqa: E731
            0, int(glob), n_utt, chunk, *map(ptr, (*args, part, out, gamma0, gamma)), b, t_len, s, p_dim, n_u, stream)
        key = f"{tag}_{placement}_u{n_utt}_c{chunk}"
        c.check(call() == 0, f"{key}: launch")
        if want is not None:
            errs = (float((gamma - want[0]).abs().max()), float((gamma0 - want[1]).abs().max()),
                    c.rel(out.view(n_u, n_u), want[2]))
            c.check(errs[0] <= 1e-5 and errs[1] <= 1e-5 and errs[2] <= 1e-4, f"{key}: differs from plain {errs}")
        row[key] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
    return row


def time_k3(lib, dev, tag, vit, geometries, check=True):
    """The chunked K3 in each launch geometry that fits, as
    :func:`time_k11`; equal to the plain version when ``check``."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.beer_viterbi_fwd_banded.argtypes = [i, i, i, i] + [p] * 7 + [i] * 3 + [p]
    b, t_len, s = vit[0].shape
    want = cuda_scan.viterbi_fwd_banded_plain(*vit) if check else None
    row = {}
    for placement, n_utt, chunk in geometries:
        glob = placement == "global"
        if cuda_scan.viterbi_banded_smem_bytes(s, placement, n_utt, chunk) > cuda_scan.SMEM_LIMIT:
            continue
        outs = (torch.empty(b, t_len, s, dtype=torch.int8, device=dev),
                torch.empty(b, t_len, dtype=torch.int32, device=dev), torch.empty(b, s, device=dev))
        call = lambda: lib.beer_viterbi_fwd_banded(  # noqa: E731
            0, int(glob), n_utt, chunk, *map(ptr, (*vit, *outs)), b, t_len, s, stream)
        key = f"{tag}_{placement}_u{n_utt}_c{chunk}"
        c.check(call() == 0, f"{key}: launch")
        if want is not None:
            c.check(all(torch.equal(x, y) for x, y in zip(outs, want)), f"{key}: differs from plain")
        row[key] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
    return row


# K11 / K3: case -> launch geometries (placement, utterances a block, frames a chunk)
K11_GEOMETRIES = {
    "k11_config4": [("global", 2, 16), ("global", 4, 16), ("global", 1, 16), ("shared", 1, 16), ("shared", 2, 8)],
    "k11_config5": [("shared", 1, 16), ("shared", 2, 16), ("shared", 4, 16), ("global", 1, 16)],
    f"k11_u{c.LOOP_UNITS}": [("shared", 1, 16), ("global", 1, 16), ("global", 2, 16)],
    f"k11_u{c.BIG_LOOP_UNITS}": [("global", 1, 16), ("global", 1, 8)],
}
K3_GEOMETRIES = {
    "k3_config3": [("shared", 1, 16), ("shared", 2, 16), ("shared", 4, 16), ("global", 1, 16)],
    "k3_config4": [("shared", 2, 16), ("shared", 4, 16), ("shared", 1, 16), ("global", 2, 16), ("shared", 2, 8)],
    "k3_config5": [("shared", 1, 16), ("shared", 2, 16), ("shared", 4, 16)],
}


def b11_geometry(dev):
    """The chunked K11 and K3 in each launch geometry of
    :data:`K11_GEOMETRIES` and :data:`K3_GEOMETRIES`, each held against its
    plain version."""
    lib = cuda_scan._library()
    cases = b11_cases(dev)
    for tag, geometries in K11_GEOMETRIES.items():
        print(f"b11 geometry: {CARD} | " + json.dumps(time_k11(lib, dev, tag, cases[tag], geometries)), flush=True)
    for tag, geometries in K3_GEOMETRIES.items():
        print(f"b11 geometry: {CARD} | " + json.dumps(time_k3(lib, dev, tag, cases[tag], geometries)), flush=True)


def run_b11_new(dev, built, names):
    """The ``k11n_*`` / ``k3n_*`` variants of the chunked K11 and K3 in the
    geometry each shape takes (:func:`time_k11`, :func:`time_k3`): K11 at
    configs 4 and 5 and 250 units, K3 at configs 3, 4 and 5, one line a
    variant."""
    cases = b11_cases(dev)
    n_sm = cuda_scan.sm_count(dev.index)
    for name in names:
        path, regs = built[name]
        lib = ctypes.CDLL(str(path))
        same = NEW_B11_VARIANTS[name][1]
        row = {}
        if name in K11N_VARIANTS:
            for tag in ("k11_config4", "k11_config5", f"k11_u{c.BIG_LOOP_UNITS}"):
                est = cases[tag]
                geom = cuda_scan.gamma_banded_geometry(est[2].shape[0], est[0].shape[2], est[8].shape[0],
                                                       est[0].shape[0], n_sm)
                row.update(time_k11(lib, dev, tag, est, [geom], check=same))
        else:
            for tag in K3_TAGS:
                vit = cases[tag]
                geom = cuda_scan.viterbi_banded_geometry(vit[0].shape[2], vit[0].shape[0], n_sm)
                row.update(time_k3(lib, dev, tag, vit, [geom], check=same))
        print(f"variant {name}: {CARD} | " + json.dumps(row) + f" | registers {regs} "
              f"| {'same function' if same else 'not the same function'}", flush=True)


K4_TAGS = ("config3", "config4", "config5", f"u{c.LOOP_UNITS}", f"u{c.BIG_LOOP_UNITS}", "u700", "u3200")


def b13_cases(dev):
    """The operands of K3 and K4 (the decodes of config 3's recognizer,
    config 4's loop with two zero-length rows, config 5's latent decode,
    and the unit decodes of loops of 100, 250 and 700 units on phase 18's
    data and of 3,200 units on 8 of its rows: S = 300, 750, 2,100 and
    9,600), of K13 banded (config 4 with two zero-length rows, S = 150,
    and S = 450, on K12's banded forward), K13 dense and K12 (banded, dense,
    reverse) at config 4, and K1 and K11 at configs 4 and 5, as
    ``chip_smoke.py`` builds them: ``{"k3": {tag: args}, "k4": {tag:
    args}, tag: args}``."""
    cases = {"k3": {}, "k4": {}}

    def put(tag, decode):
        cases["k3"][tag], cases["k4"][tag] = c.decode_args(decode)

    data3, mask3, seqs = c.config3_data()
    rec = c.config3(dev, seqs)
    x3, m3 = torch.from_numpy(data3).to(dev), torch.from_numpy(mask3).to(dev)
    put("config3", lambda: rec.decode(x3, m3))
    data, mask = c.with_empty_rows(*c.make_data(c.B, c.T, c.D))
    x4, m4 = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    put("config4", lambda: c.config4(dev).decode_units(x4, m4))
    x5, m5 = c.config5_data(dev)
    x5 = torch.cat([x5, torch.zeros(2, *x5.shape[1:], device=dev)])
    m5 = torch.cat([m5, torch.zeros(2, m5.shape[1], device=dev)])
    vae = c.config5(dev)
    put("config5", lambda: vae.latent_decode(x5, m5))
    data, mask = c.make_data(c.LARGE_B, c.LARGE_T, c.D, seed=8)
    xb, mb = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    for units, rows in ((c.LOOP_UNITS, None), (c.BIG_LOOP_UNITS, None), (700, None), (3200, 8)):
        loop = c.config4(dev, n_units=units)
        put(f"u{units}", lambda: loop.decode_units(xb[:rows], mb[:rows]))
    for tag, units in (("config4", c.N_UNITS), ("s450", c.BIG_UNITS)):
        o = c.general_operands(c.config4(dev, n_units=units), x4, m4)
        for banded in (True, False) if tag == "config4" else (True,):
            mat = o["bands"] if banded else o["trans"]
            probs, _ = cuda_scan.scaled_pass_plain(o["e_llh"], o["lens"], mat, o["init"], banded=banded)
            key = "k13" if banded else "k13d"
            cases[f"{key}_{tag}"] = (o["e_llh"], probs, o["lens"], mat, o["final"])
            if tag == "config4":
                cases[f"k12{'' if banded else 'd'}_config4"] = (o["e_llh"], o["lens"], mat, o["init"])
                if not banded:
                    cases["k12r_config4"] = (o["e_llh"], o["lens"], mat, o["final"])
    _, stats, ops, fwd, _ = c.banded_operands(dev)
    cases["k1_config4"] = fwd
    cases["k11_config4"] = c.banded_estep_args(stats, ops, *cuda_scan.forward_llh_banded_plain(*fwd)[:2])
    stats5, ops5 = c.svae_operands(vae, x5, m5)
    fwd5 = (stats5, ops5["lens"], ops5["w"], ops5["bias"], ops5["bands"], ops5["init"])
    cases["k1_config5"] = fwd5
    cases["k11_config5"] = c.banded_estep_args(stats5, ops5, *cuda_scan.forward_llh_banded_plain(*fwd5)[:2])
    return cases


def b13_times(dev):
    """K4 (every decode of :func:`b13_cases`) and K13 banded (config 4 and
    S = 450), and beside them K12 (banded, dense and reverse) and K13 dense
    at config 4, K3 (configs 3, 4 and 5), K11 and K1 (configs 4 and 5) and
    K2 (config 4), through this checkout's wrappers: each call's device ms
    split by kernel (``kernel_split``)."""
    row = {}

    def put(tag, fn):
        split = kernel_split(fn)
        row[f"{tag}_ms"] = round(ours(split), 4)
        row[f"{tag}_split"] = {k: round(v, 4) for k, v in split.items()}

    cases = b13_cases(dev)
    for tag in K4_TAGS:
        put(f"k4_{tag}", lambda: cuda_scan.viterbi_backtrace_banded(*cases["k4"][tag]))
    for tag in ("config4", "s450"):
        put(f"k13_{tag}", lambda: cuda_scan.smoothing_pass(*cases[f"k13_{tag}"], banded=True))
    put("k13_dense_config4", lambda: cuda_scan.smoothing_pass(*cases["k13d_config4"]))
    put("k12_banded_config4", lambda: cuda_scan.scaled_pass(*cases["k12_config4"], banded=True))
    put("k12_dense_config4", lambda: cuda_scan.scaled_pass(*cases["k12d_config4"]))
    put("k12_reverse_config4", lambda: cuda_scan.scaled_pass(*cases["k12r_config4"], reverse=True))
    for tag in ("config3", "config4", "config5"):
        put(f"k3_{tag}", lambda: cuda_scan.viterbi_fwd_banded(*cases["k3"][tag]))
    for tag in ("config4", "config5"):
        put(f"k11_{tag}", lambda: cuda_scan.estep_gamma_banded(*cases[f"k11_{tag}"]))
        put(f"k1_{tag}", lambda: cuda_scan.forward_llh_banded(*cases[f"k1_{tag}"]))
    put("k2_config4", lambda: cuda_scan.estep_acc_banded(*cases["k11_config4"]))  # K11's operands are K2's
    print(f"b13 times: {CARD} | " + json.dumps(row), flush=True)


def run_b13_parent(dev, built, names):
    """The ``k4_*`` / ``k13_*`` variants of K4 and K13 as they stood before
    their redesign (3d14238's entry points, ten bare foreign calls between
    two events, median of 20, divided by ten): K4 on every decode of
    :func:`b13_cases`, K13 banded at config 4 and S = 450, one line a
    variant."""
    cases = b13_cases(dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in names:
        path, regs = built[name]
        lib = ctypes.CDLL(str(path))
        same = PARENT_B13_VARIANTS[name][1]
        row = {}
        if name in K4_VARIANTS:
            lib.beer_viterbi_backtrace_banded.argtypes = [i] + [p] * 6 + [i] * 4 + [p]
            for tag in K4_TAGS:
                back = cases["k4"][tag]
                b, t_len, s = back[0].shape
                paths, scores = torch.empty(b, t_len, dtype=torch.int32, device=dev), torch.empty(b, device=dev)
                stride = s if back[3].ndim == 2 else 0
                call = lambda: lib.beer_viterbi_backtrace_banded(  # noqa: E731
                    0, *map(ptr, (*back, paths, scores)), b, t_len, s, stride, stream)
                c.check(call() == 0, f"{name}: launch ({tag})")
                if same:
                    want = cuda_scan.viterbi_backtrace_banded_plain(*back)
                    c.check(torch.equal(paths, want[0]) and torch.equal(scores, want[1]),
                            f"{name}: differs from plain ({tag})")
                row[f"k4_{tag}_ms"] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
        else:
            lib.beer_smoothing_pass.argtypes = [i, i, i] + [p] * 9 + [i] * 3 + [p]
            for tag in ("config4", "s450"):
                smo = cases[f"k13_{tag}"]
                b, t_len, s = smo[0].shape
                outs = (torch.empty(b, t_len, s, device=dev), torch.empty(b, t_len, s, device=dev),
                        torch.empty(b, t_len, device=dev), torch.empty(b, t_len, device=dev))
                e_llh, probs, lens, bands, final = smo
                call = lambda: lib.beer_smoothing_pass(  # noqa: E731
                    0, 1, 0, *map(ptr, (e_llh, probs, lens, bands, final, *outs)), b, t_len, s, stream)
                c.check(call() == 0, f"{name}: launch ({tag})")
                if same:
                    want = cuda_scan.smoothing_pass_plain(*smo, banded=True)
                    mask = (torch.arange(t_len, device=dev)[None] < lens[:, None]).float()
                    errs = [c.valid_err(x, y, mask) for x, y in zip(outs[:2], want[:2])]
                    c.check(max(errs) <= 1e-5, f"{name}: differs from plain ({tag}) {errs}")
                row[f"k13_{tag}_ms"] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
        print(f"variant {name}: {CARD} | " + json.dumps(row) + f" | registers {regs} "
              f"| {'same function' if same else 'not the same function'}", flush=True)


def time_k4(lib, dev, tag, back, geometries, check=True):
    """The redesigned K4 (bare foreign call, ten between two events, median
    of 20, divided by ten) in each launch geometry that fits; equal to the
    plain version when ``check``."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.beer_viterbi_backtrace_banded.argtypes = [i, i, i, i] + [p] * 6 + [i] * 4 + [p]
    b, t_len, s = back[0].shape
    stride = s if back[3].ndim == 2 else 0
    want = cuda_scan.viterbi_backtrace_banded_plain(*back) if check else None
    row = {}
    for instance, n_utt, chunk in geometries:
        staged = instance == "staged"
        if staged and cuda_scan.backtrace_smem_bytes(s, n_utt, chunk) > cuda_scan.SMEM_LIMIT:
            continue
        paths, scores = torch.empty(b, t_len, dtype=torch.int32, device=dev), torch.empty(b, device=dev)
        call = lambda: lib.beer_viterbi_backtrace_banded(  # noqa: E731
            0, int(staged), n_utt, chunk, *map(ptr, (*back, paths, scores)), b, t_len, s, stride, stream)
        key = f"{tag}_{instance}_u{n_utt}_c{chunk}"
        c.check(call() == 0, f"{key}: launch")
        if want is not None:
            c.check(torch.equal(paths, want[0]) and torch.equal(scores, want[1]), f"{key}: differs from plain")
        row[key] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
    return row


def time_k13(lib, dev, tag, smo, geometries, check=True):
    """The chunked K13 banded in each launch geometry that fits, as
    :func:`time_k4`; held against the plain version (γ and ŵ abs 1e-5 on
    the valid frames) when ``check``."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.beer_smoothing_banded.argtypes = [i, i, i, i] + [p] * 9 + [i] * 3 + [p]
    e_llh, probs, lens, bands, final = smo
    b, t_len, s = e_llh.shape
    want = cuda_scan.smoothing_pass_plain(*smo, banded=True) if check else None
    mask = (torch.arange(t_len, device=dev)[None] < lens[:, None]).float()
    row = {}
    for placement, n_utt, chunk in geometries:
        glob = placement == "global"
        if cuda_scan.smoothing_banded_smem_bytes(s, placement, n_utt, chunk) > cuda_scan.SMEM_LIMIT:
            continue
        outs = (torch.empty(b, t_len, s, device=dev), torch.empty(b, t_len, s, device=dev),
                torch.empty(b, t_len, device=dev), torch.empty(b, t_len, device=dev))
        call = lambda: lib.beer_smoothing_banded(  # noqa: E731
            0, int(glob), n_utt, chunk, *map(ptr, (*smo, *outs)), b, t_len, s, stream)
        key = f"{tag}_{placement}_u{n_utt}_c{chunk}"
        c.check(call() == 0, f"{key}: launch")
        if want is not None:
            errs = [c.valid_err(x, y, mask) for x, y in zip(outs[:2], want[:2])]
            c.check(max(errs) <= 1e-5, f"{key}: differs from plain {errs}")
        row[key] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
    return row


# K13 banded: case -> launch geometries (placement, utterances a block, frames a chunk)
K13_GEOMETRIES = {
    "config4": [("shared", 2, 8), ("shared", 2, 16), ("shared", 1, 16), ("shared", 2, 4), ("shared", 4, 4)],
    "s450": [("shared", 1, 4), ("shared", 1, 8), ("shared", 1, 16), ("shared", 1, 2)],
}


def b13_geometry(dev):
    """The chunked K13 banded in each launch geometry of
    :data:`K13_GEOMETRIES`, each held against its plain version, and K4 at
    config 4 and on the 3,200-unit loop in several."""
    lib = cuda_scan._library()
    cases = b13_cases(dev)
    for tag, geometries in K13_GEOMETRIES.items():
        row = time_k13(lib, dev, f"k13_{tag}", cases[f"k13_{tag}"], geometries)
        print(f"b13 geometry: {CARD} | " + json.dumps(row), flush=True)
    n_sm = cuda_scan.sm_count(dev.index)
    for tag in K4_TAGS:  # the staged instance in the wrapper's geometry, and the direct one
        back = cases["k4"][tag]
        staged = ("staged", *cuda_scan.backtrace_banded_geometry(back[0].shape[2], back[0].shape[0], n_sm)[1:])
        extra = [("staged", 2, 16), ("staged", 1, 8)] if tag == "config4" else []
        row = time_k4(lib, dev, f"k4_{tag}", back, [staged, *extra, ("direct", 1, 32)])
        print(f"b13 geometry: {CARD} | " + json.dumps(row), flush=True)


def run_b13_new(dev, built, names):
    """The ``k4n_*`` / ``k13n_*`` variants of the redesigned K4 and K13
    banded in the geometry each shape takes: K4 on every decode of
    :func:`b13_cases`, K13 at config 4 and S = 450, one line a variant."""
    cases = b13_cases(dev)
    n_sm = cuda_scan.sm_count(dev.index)
    for name in names:
        path, regs = built[name]
        lib = ctypes.CDLL(str(path))
        same = NEW_B13_VARIANTS[name][1]
        row = {}
        if name in K4N_VARIANTS:
            for tag in K4_TAGS:
                back = cases["k4"][tag]
                geom = cuda_scan.backtrace_banded_geometry(back[0].shape[2], back[0].shape[0], n_sm)
                row.update(time_k4(lib, dev, f"k4_{tag}", back, [geom], check=same))
        else:
            for tag in ("config4", "s450"):
                smo = cases[f"k13_{tag}"]
                geom = cuda_scan.smoothing_banded_geometry(smo[0].shape[2], smo[0].shape[0], n_sm)
                row.update(time_k13(lib, dev, f"k13_{tag}", smo, [geom], check=same))
        print(f"variant {name}: {CARD} | " + json.dumps(row) + f" | registers {regs} "
              f"| {'same function' if same else 'not the same function'}", flush=True)


B12_TAGS = {"config4": c.N_UNITS, "config5": c.SVAE_UNITS, "s300": c.LOOP_UNITS, "s450": c.BIG_UNITS}


def b12_cases(dev):
    """The operands of K12 (banded forward, dense forward, dense reverse)
    and K13 (banded, dense) on phone loops of 50, 10, 100 and 150 units (S
    = 150, 30, 300, 450) over config 4's data with two zero-length rows (B
    = 514, T = 500), as ``chip_smoke.py`` phase 15 builds them: ``{tag:
    {"k12b" | "k12d" | "k12r" | "k13b" | "k13d": args}}``, K13's α̂ from
    the plain forward."""
    data, mask = c.with_empty_rows(*c.make_data(c.B, c.T, c.D))
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    cases = {}
    for tag, units in B12_TAGS.items():
        o = c.general_operands(c.config4(dev, n_units=units), x, m)
        e, lens = o["e_llh"], o["lens"]
        probs_b, _ = cuda_scan.scaled_pass_plain(e, lens, o["bands"], o["init"], banded=True)
        probs_d, _ = cuda_scan.scaled_pass_plain(e, lens, o["trans"], o["init"])
        cases[tag] = dict(k12b=(e, lens, o["bands"], o["init"]), k12d=(e, lens, o["trans"], o["init"]),
                          k12r=(e, lens, o["trans"], o["final"]), k13b=(e, probs_b, lens, o["bands"], o["final"]),
                          k13d=(e, probs_d, lens, o["trans"], o["final"]))
    return cases


def b12_times(dev):
    """K12 (banded forward, dense forward, dense reverse) and K13 (banded,
    dense) at every shape of :func:`b12_cases`, and beside them K1 and K11
    (configs 4 and 5), K2 (config 4), K3 (configs 3, 4 and 5) and K4 (every
    decode of :func:`b13_cases`), through this checkout's wrappers: each
    call's device ms split by kernel (``kernel_split``)."""
    row = {}

    def put(tag, fn):
        split = kernel_split(fn)
        row[f"{tag}_ms"] = round(ours(split), 4)
        row[f"{tag}_split"] = {k: round(v, 4) for k, v in split.items()}

    for tag, case in b12_cases(dev).items():
        put(f"k12_banded_{tag}", lambda: cuda_scan.scaled_pass(*case["k12b"], banded=True))
        put(f"k12_dense_{tag}", lambda: cuda_scan.scaled_pass(*case["k12d"]))
        put(f"k12_reverse_{tag}", lambda: cuda_scan.scaled_pass(*case["k12r"], reverse=True))
        put(f"k13_banded_{tag}", lambda: cuda_scan.smoothing_pass(*case["k13b"], banded=True))
        put(f"k13_dense_{tag}", lambda: cuda_scan.smoothing_pass(*case["k13d"]))
        del case
    cases = b13_cases(dev)
    for tag in K4_TAGS:
        put(f"k4_{tag}", lambda: cuda_scan.viterbi_backtrace_banded(*cases["k4"][tag]))
    for tag in ("config3", "config4", "config5"):
        put(f"k3_{tag}", lambda: cuda_scan.viterbi_fwd_banded(*cases["k3"][tag]))
    for tag in ("config4", "config5"):
        put(f"k11_{tag}", lambda: cuda_scan.estep_gamma_banded(*cases[f"k11_{tag}"]))
        put(f"k1_{tag}", lambda: cuda_scan.forward_llh_banded(*cases[f"k1_{tag}"]))
    put("k2_config4", lambda: cuda_scan.estep_acc_banded(*cases["k11_config4"]))  # K11's operands are K2's
    print(f"b12 times: {CARD} | " + json.dumps(row), flush=True)


# the shapes the anatomy times a variant at: (tag, instance)
B12_ANATOMY = [("config4", "k12b"), ("s450", "k12b"), ("config4", "k12d"), ("config4", "k12r"), ("config4", "k13d"),
               ("s450", "k12d"), ("s450", "k13d")]


def run_b12_parent(dev, built, names):
    """The ``k12_*`` variants of K12 and K13's dense instance as they stood
    before their redesign (13e9c4a's entry points, ten bare foreign calls
    between two events, median of 20, divided by ten) at the shapes of
    :data:`B12_ANATOMY`, one line a variant."""
    cases = b12_cases(dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in names:
        path, regs = built[name]
        lib = ctypes.CDLL(str(path))
        lib.beer_scaled_pass.argtypes = [i, i, i] + [p] * 6 + [i] * 3 + [p]
        lib.beer_smoothing_pass.argtypes = [i, i] + [p] * 9 + [i] * 3 + [p]
        same = K12_VARIANTS[name][1]
        row = {}
        for tag, inst in B12_ANATOMY:
            args = cases[tag][inst]
            b, t_len, s = args[0].shape
            glob = int(inst != "k12b" and s > (237 if inst == "k13d" else 239))  # the parent's placements
            if inst == "k13d":
                e_llh, probs, lens, mat, final = args
                mat = mat.T.contiguous() if glob else mat
                outs = (torch.empty(b, t_len, s, device=dev), torch.empty(b, t_len, s, device=dev),
                        torch.empty(b, t_len, device=dev), torch.empty(b, t_len, device=dev))
                call = lambda: lib.beer_smoothing_pass(  # noqa: E731
                    0, glob, *map(ptr, (e_llh, probs, lens, mat, final, *outs)), b, t_len, s, stream)
                want = (lambda: cuda_scan.smoothing_pass_plain(*args)[:2]) if same else None
                mask = (torch.arange(t_len, device=dev)[None] < lens[:, None]).float()[..., None]
            else:
                mode = {"k12d": 0, "k12b": 1, "k12r": 2}[inst]
                e_llh, lens, mat, vec = args
                mat = mat.T.contiguous() if glob and mode == 2 else mat
                outs = (torch.empty(b, t_len, s, device=dev), torch.empty(b, t_len, device=dev))
                call = lambda: lib.beer_scaled_pass(  # noqa: E731
                    0, mode, glob, *map(ptr, (e_llh, lens, mat, vec, *outs)), b, t_len, s, stream)
                want = ((lambda: cuda_scan.scaled_pass_plain(*args, banded=mode == 1, reverse=mode == 2)[:1])
                        if same else None)
                mask = 1.0
            key = f"{inst}_{tag}"
            c.check(call() == 0, f"{name}: launch ({key})")
            if want is not None:
                errs = [float(((x - y) * mask).abs().max()) for x, y in zip(outs, want())]
                c.check(max(errs) <= 1e-5, f"{name}: differs from plain ({key}) {errs}")
            row[f"{key}_ms"] = round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)
        print(f"variant {name}: {CARD} | " + json.dumps(row) + f" | registers {regs} "
              f"| {'same function' if same else 'not the same function'}", flush=True)


def time_general(lib, dev, key, inst, args, geometry, grouped=True, check=True):
    """The redesigned K12 / K13 dense through ``lib``'s entry points (ten bare
    foreign calls between two events, median of 20, divided by ten) in one
    launch geometry, the dense instances' rows grouped by length or as they
    come (``grouped``); held against the plain version (α̂ / β̂ / γ, ŵ abs
    1e-5) when ``check``."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.beer_scaled_pass.argtypes = [i] * 5 + [p] * 7 + [i] * 3 + [p]
    lib.beer_smoothing_pass.argtypes = [i] * 4 + [p] * 10 + [i] * 3 + [p]
    lib.beer_smoothing_banded.argtypes = [i, i, i, i] + [p] * 9 + [i] * 3 + [p]
    placement, n_utt, param = geometry
    glob = int(placement == "global")
    b, t_len, s = args[0].shape
    lens = args[2] if inst.startswith("k13") else args[1]
    order = (cuda_scan.group_order(lens) if grouped
             else torch.arange(b, dtype=torch.int32, device=dev))
    if inst.startswith("k13"):
        e_llh, probs, lens, mat, final = args
        if inst == "k13d":
            mat = cuda_scan._grouped_matrix(mat.T)
        outs = (torch.empty(b, t_len, s, device=dev), torch.empty(b, t_len, s, device=dev),
                torch.empty(b, t_len, device=dev), torch.empty(b, t_len, device=dev))
        if inst == "k13d":
            call = lambda: lib.beer_smoothing_pass(  # noqa: E731
                0, glob, n_utt, param, ptr(e_llh), ptr(probs), ptr(lens), ptr(order),
                *map(ptr, (mat, final, *outs)), b, t_len, s, stream)
        else:
            call = lambda: lib.beer_smoothing_banded(  # noqa: E731
                0, glob, n_utt, param, *map(ptr, (e_llh, probs, lens, mat, final, *outs)), b, t_len, s, stream)
        want = lambda: cuda_scan.smoothing_pass_plain(*args, banded=inst == "k13b")[:2]  # noqa: E731
        mask = (torch.arange(t_len, device=dev)[None] < lens[:, None]).float()[..., None]
    else:
        mode = {"k12d": 0, "k12b": 1, "k12r": 2}[inst]
        e_llh, lens, mat, vec = args
        if mode != 1:
            mat = cuda_scan._grouped_matrix(mat.T if mode == 2 else mat)
        outs = (torch.empty(b, t_len, s, device=dev), torch.empty(b, t_len, device=dev))
        call = lambda: lib.beer_scaled_pass(  # noqa: E731
            0, mode, glob, n_utt, param, ptr(e_llh), ptr(lens), None if mode == 1 else ptr(order),
            *map(ptr, (mat, vec, *outs)), b, t_len, s, stream)
        want = lambda: cuda_scan.scaled_pass_plain(*args, banded=mode == 1, reverse=mode == 2)[:1]  # noqa: E731
        mask = 1.0
    c.check(call() == 0, f"{key}: launch")
    if check:
        errs = [float(((x - y) * mask).abs().max()) for x, y in zip(outs, want())]
        c.check(max(errs) <= 1e-5, f"{key}: differs from plain {errs}")
    return round(median_ms(lambda: [call() for _ in range(10)]) / 10, 4)


# the dense instances' geometries b12_geometry times: (placement, utterances a block, slices) at
# config 4 (S = 150) and S = 450, beside the wrapper's own
B12_GROUPED = {"config4": [("shared", 2, 6), ("shared", 2, 3), ("shared", 4, 4), ("shared", 4, 8), ("shared", 8, 8),
                           ("shared", 1, 8)],
               "s450": [("global", 4, 2), ("global", 4, 3), ("global", 4, 4), ("global", 8, 2), ("global", 2, 2)]}


def b12_geometry(dev):
    """The redesigned dense instances in each geometry of
    :data:`B12_GROUPED`, their rows grouped by length and as they come, and
    K12 banded in the wrapper's geometry and a few others (config 4, S =
    450), each held against its plain version."""
    lib = cuda_scan._library()
    cases = b12_cases(dev)
    for tag, geometries in B12_GROUPED.items():
        for inst in ("k12d", "k12r", "k13d"):
            row = {}
            for geometry in geometries:
                for grouped in (True, False):
                    key = f"{inst}_{tag}_{'_'.join(map(str, geometry))}_{'sorted' if grouped else 'consecutive'}"
                    row[key] = time_general(lib, dev, key, inst, cases[tag][inst], geometry, grouped)
            print(f"b12 geometry: {CARD} | " + json.dumps(row), flush=True)
    n_sm = cuda_scan.sm_count(dev.index)
    row = {}
    for tag, extra in (("config4", [("shared", 4, 16), ("shared", 2, 8), ("shared", 1, 16)]),
                       ("s450", [("shared", 1, 8), ("shared", 1, 4)])):
        args = cases[tag]["k12b"]
        for geometry in [cuda_scan.scaled_banded_geometry(args[0].shape[2], args[0].shape[0], n_sm), *extra]:
            key = f"k12b_{tag}_{'_'.join(map(str, geometry))}"
            row[key] = time_general(lib, dev, key, "k12b", args, geometry)
    print(f"b12 geometry: {CARD} | " + json.dumps(row), flush=True)


def run_b12_new(dev, built, names):
    """The ``k12n_*`` / ``grpn_*`` variants of the redesigned K12 banded and
    the grouped dense step in the geometry each shape takes, at the shapes
    of :data:`B12_ANATOMY`, one line a variant."""
    cases = b12_cases(dev)
    n_sm = cuda_scan.sm_count(dev.index)
    for name in names:
        path, regs = built[name]
        lib = ctypes.CDLL(str(path))
        same = K12N_VARIANTS[name][1]
        row = {}
        for tag, inst in B12_ANATOMY:
            if (inst == "k12b") == name.startswith("grpn"):
                continue
            args = cases[tag][inst]
            b, _, s = args[0].shape
            geometry = (cuda_scan.scaled_banded_geometry(s, b, n_sm) if inst == "k12b" else
                        cuda_scan.dense_grouped_geometry("smoothing_pass" if inst == "k13d" else "scaled_pass",
                                                         s, b, n_sm))
            row[f"{inst}_{tag}_ms"] = time_general(lib, dev, f"{name} {inst}_{tag}", inst, args, geometry, check=same)
        print(f"variant {name}: {CARD} | " + json.dumps(row) + f" | registers {regs} "
              f"| {'same function' if same else 'not the same function'}", flush=True)


def vb_times(dev):
    """One ``vb_step`` of config 4 (K1 + K2) and of config 2 (K5 + K6) on
    the bench's data through this checkout's package, as ``chip_smoke.py``
    phases 5 and 8 time it (CUDA-event median of 5 after a warm-up; the
    model is updated by every step), and the kernels' share of a step
    (``torch.profiler`` device time of the repository's kernels over one
    step, against its wall time)."""
    data, mask = c.make_data(c.B, c.T, c.D)
    x, m = torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)
    row = {}
    for tag, model in (("config4", c.config4(dev)), ("config2", c.config2(dev))):
        c.bt.vb_step(model, x, mask=m)
        row[f"{tag}_vb_step_ms"] = round(c.cuda_ms(lambda: c.bt.vb_step(model, x, mask=m)), 3)
        row[f"{tag}_vb_step_kernels_ms"] = round(ours(kernel_split(lambda: c.bt.vb_step(model, x, mask=m), reps=5)), 3)
    print(f"vb times: {CARD} | " + json.dumps(row), flush=True)


def times(dev):
    """K8 alone at config 1 beside one matmul pair on the materialised
    statistics, and K5 alone at every shape of :func:`k5_cases` and K14
    at config 4's and S = 230's (profiler device time of the wrapper's
    kernel), through this checkout's package."""
    x, e, log_w = k8_operands(dev)
    launch = sk.prepare_gmm_estep_full(x, e, log_w)[-1]
    k8 = median_ms(lambda: c.check(launch() == 0, "K8 launch"))
    r = torch.softmax(sk.ellh_full_plain(x, e) + log_w, -1)
    s_mat = sk.packed_stats(x)
    w_joint = sk.pack_weights(e, c.D, log_w)
    lib = median_ms(lambda: torch.matmul(s_mat, w_joint)) + median_ms(lambda: torch.matmul(r.T, s_mat))
    del s_mat
    cases = k5_cases(dev)
    k5 = {tag: c.device_ms(lambda: cuda_scan.forward_llh_dense(*args), "forward_llh", reps=20)
          for tag, args in cases.items()}
    for tag in ("config4", "s230"):
        k5[f"k14_{tag}"] = c.device_ms(lambda: cuda_scan.forward_llh_dense(*cases[tag], return_shifts=True),
                                       "forward_llh", reps=20)
    bounds = {}
    for tag, args in cases.items():   # K5's least time on each case's inputs
        x, lens, trans = args[:3]
        p_dim = x.shape[2] if len(args) > 4 else 0
        bounds[f"k5_{tag}_bound_ms"] = round(c.forward_dense_bound(lens, x.shape[1], trans.shape[0], p_dim)["bound_ms"], 5)
    print(f"times: {CARD} | " + json.dumps({"k8_config1_ms": round(k8, 4), "k8_library_ms": round(lib, 4),
                                  **{f"k5_{tag}_ms": round(v, 4) for tag, v in k5.items()}, **bounds}), flush=True)


def diag_times(dev):
    """``diag_stats`` alone at the benchmark's batch (16,384 × 500 frames of
    D = 39, N = 8,192,000) and at N = 512,000: the kernel in profiler device
    time, the wrapper by CUDA events; beside it the plain expression (the
    square, the scale and ``torch.cat``, by CUDA events and split by kernel
    in profiler device time), a device-to-device copy of as many bytes as
    the kernel moves, and the bound, 12·N·D bytes at 3.35 TB/s.  Through
    this checkout's package: a checkout without the kernel times the rest."""
    row = {}
    for tag, n in (("bench", 16_384 * 500), ("n512k", 512_000)):
        x = torch.randn(n, c.D, device=dev)
        plain = lambda: torch.cat([-0.5 * x**2, x], -1)  # noqa: E731
        moved = 12 * x.numel()
        row[f"{tag}_bound_ms"] = round(moved / 3.35e9, 4)
        if hasattr(sk, "diag_stats"):
            row[f"{tag}_kernel_ms"] = round(c.device_ms(lambda: sk.diag_stats(x), "diag_stats_kernel", reps=20), 4)
            row[f"{tag}_wrapper_ms"] = round(c.cuda_ms(lambda: sk.diag_stats(x), reps=20), 4)
            c.check(torch.equal(sk.diag_stats(x), plain()), "diag_stats bits")
        row[f"{tag}_plain_ms"] = round(c.cuda_ms(plain, reps=20), 4)
        row[f"{tag}_plain_split_ms"] = {k: round(v, 4) for k, v in kernel_split(plain, reps=5).items()}
        src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        row[f"{tag}_copy_ms"] = round(c.cuda_ms(lambda: dst.copy_(src), reps=20), 4)
        del x, src, dst
        torch.cuda.empty_cache()
    print(f"diag times: {CARD} | " + json.dumps(row), flush=True)


def main(names) -> int:
    if not torch.cuda.is_available():
        print("stats_variants: no CUDA device", file=sys.stderr)
        return 2
    global CARD
    c.phase_device()
    CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    if "probe" in names:
        probe(dev)
    if "times" in names:
        times(dev)
    if "b2" in names:
        b2_times(dev)
    if "geometry" in names:
        geometry(dev)
    if "vb" in names:
        vb_times(dev)
    if "b7" in names:
        b7_times(dev)
    if "b11" in names:
        b11_times(dev)
    if "b11_geometry" in names:
        b11_geometry(dev)
    if "b13" in names:
        b13_times(dev)
    if "b13_geometry" in names:
        b13_geometry(dev)
    if "b12" in names:
        b12_times(dev)
    if "b12_geometry" in names:
        b12_geometry(dev)
    if "diag" in names:
        diag_times(dev)
    names = [n for n in names if n not in ("probe", "times", "b2", "b7", "b11", "b11_geometry", "geometry", "vb",
                                           "b13", "b13_geometry", "b12", "b12_geometry", "diag")]
    if not names:
        return 0
    built = build(names)
    for group, run in ((VARIANTS, run_stats), (K8_VARIANTS, run_k8), (K5_VARIANTS, run_k5),
                       (PARENT_VARIANTS, run_k2k6), ({**K2N_VARIANTS, **K6N_VARIANTS}, run_new),
                       (PARENT_B7_VARIANTS, run_b7_parent), (NEW_B7_VARIANTS, run_b7_new),
                       (PARENT_B11_VARIANTS, run_b11_parent), (NEW_B11_VARIANTS, run_b11_new),
                       (PARENT_B13_VARIANTS, run_b13_parent), (NEW_B13_VARIANTS, run_b13_new),
                       (PARENT_B12_VARIANTS, run_b12_parent), (NEW_B12_VARIANTS, run_b12_new)):
        mine = [n for n in names if n in group]
        if mine:
            run(dev, built, mine)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--sources" in args:
        i = args.index("--sources")
        SOURCES_DIR = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    sys.exit(main(args or [*VARIANTS, *K8_VARIANTS, *K5_VARIANTS, *K2N_VARIANTS, *K6N_VARIANTS, *NEW_B7_VARIANTS,
                           *NEW_B11_VARIANTS, *NEW_B13_VARIANTS, *NEW_B12_VARIANTS]))
