// The chunked v-space backward of beer_tpu/ops/pallas_scan.py
// _make_estep_ckpt_acc_kernel_lm (B2: wrapper phone_loop_estep_ckpt_acc_lm,
// stored-α̂ route) and of _make_estep_ckpt_kernel_lm / _make_estep_kernel
// (B7 / B11: the γ-emitting backward), shared by the kernels of the port:
//   K2 estep_acc_banded (phone_loop_scan.cu): band + rank-1 transitions,
//      the loop-back ξ (U, U) gathered at the units' ends and starts;
//   K11 estep_gamma_banded (phone_loop_scan.cu): K2's banded mode emitting γ
//      (kGamma) — γ written per chunk in place of the moments, γ₀ and the
//      loop-back ξ as K2's, llh still W·stats + bias in the kernel;
//   K6 estep_acc_dense, its "warp" instance (hmm_scan.cu): a dense (S, S)
//      matrix with S <= 32, the full ξ (S, S), per-utterance final vectors,
//      the moments written state-minor;
//   K7 estep_gamma_dense / K15 estep_gamma_dense_restricted, their "warp"
//      instance (hmm_scan.cu): the dense mode emitting γ (kGamma), which
//      reads the llh stream in place of the statistics (kStream = kDense &&
//      kGamma), no γ₀, ξ over all states or the block [rows][:, cols].
// The recursion: walking t from len − 1 down to 0, u1 = final at the last
// frame, else A·v̂_{t+1} (banded: v̂·a_self + shift_up(v̂)·a_adv +
// (v̂·w)·exit); v = e·u1 with e = exp(llh − max) and llh = W·stats + bias
// (kStream: llh read); γ = α̂·u1 / Σ α̂·u1; wgt = 1 / (norm·Σ(α̂u1)/Σv) (0
// below the ξ floor).  It reduces γ to acc (S, P+1) = Σ γ ⊗ [stats, 1]
// (kGamma: writes γ (B, T, S) instead, 0 on frames t >= len), γ₀ (not under
// kStream), and ξ += (α̂_t[rows]·wgt_{t+1}) ⊗ v̂_{t+1}[cols] (int32 gathers;
// rows and cols the units' ends and starts, the identity when dense, K15's
// block when restricted).
//
// What bounds it on the H100 is the serial chain, so the chain keeps only
// what depends on the carry.  Frames go in chunks of C, from each
// utterance's end: chunk c + 1's statistics (kStream: llh) and α̂ arrive by
// cp.async into a two-stage ring while chunk c is worked on.  A chunk is
// five phases between barriers:
//   1. the ELLH of all its frames (register tiles of 8 frames a state,
//      acc_ellh_tile, which K1 calls too; none under kStream), then, a warp
//      a frame, the row max, e = exp(llh − max) and the gather α̂_t[rows];
//   2. the chain, on one warp an utterance: banded, states strided over
//      the lanes, Σv, Σα̂u1 and Σv·w in one shuffle tree; dense, lane i
//      holding row i of A in registers and v_{t+1}(j) coming by
//      __shfl_sync.  K2's and K6's carry stays unnormalised (v, with ip =
//      1/Σv beside it), so a step has no barrier and normalises nothing;
//      a γ-emitting chain (kGamma) propagates v̂ = v·ip instead (one
//      multiply a read: the dense chain shuffles v̂, the banded one scales
//      v_{t+1} as it reads it, as K1 scales its raw row): on config 3's long
//      forced alignments under an untrained model Σv falls to ~1e-40, and
//      A·v then runs on subnormals (γ 1.2e-3 from the plain version's,
//      which propagates v̂);
//   3. per frame 1/Σα̂u1, wgt_{t+1} and 1/Σv_{t+1}, and the gather
//      v_{t+1}[cols];
//   4. the moments and ξ as register-tiled FFMA products over the chunk's
//      frames, Γᵀ·[X, 1] and Lᵀ·R in 4 × 4 tiles (γ = α̂u1 / Σα̂u1, L =
//      α̂_t[rows]·wgt_{t+1} and R = v̂_{t+1}[cols] scaled as a tile reads
//      them), each accumulator element read and written once a chunk;
//      kGamma: γ of the chunk's frames written out by the whole block
//      (acc_write_gamma) and ξ alone (the moment product compiles out);
//   5. γ₀ (not under kStream), and the carry into the next chunk.
// Phases 1b, 3, 4 and 5, the chunk fetch and the write-out are __device__
// helpers (acc_fetch .. acc_write_gamma below), which K6's and K7's block
// instance (hmm_scan.cu, one block an utterance, a block chain) calls too;
// only the ELLH and the chain differ between the two kernels.
// A block runs n_utt utterances (their chains on warps 0 .. n_utt − 1 at
// once) and sums their moments and ξ into one partial row; the rows are
// summed over the blocks by sum_rows_kernel in a fixed order, so two calls
// agree bitwise.  Two placements (kGlobal): W, the moments and ξ in shared
// memory, or Wᵀ (P, S) from device memory and the moments and ξ in the
// block's row of `part` (every S); the wrappers pick the placement, n_utt
// and C by fit (cuda_scan.acc_banded_geometry, gamma_banded_geometry,
// backward_instance, gamma_instance).  kFull: C = kAccChunk, a constant.

#pragma once

#include "scan_common.cuh"

namespace {

constexpr int kAccThreads = 512;  // K2's block
constexpr int kAccChunk = 16;     // frames a chunk, at most
constexpr int kAccGroup = 8;      // the ELLH's frames a thread item

struct AccLayout {  // float offsets into one block's shared memory
  size_t w, acc, xi, bands, idx, utt, per_utt, total;
  int ldx, ldg, ldr, ldc, lda;
};

// ξ is (n_r, n_c) (K2, K6, K11: U = n_r = n_c).  P = 0: the llh stream
// (kStream): the ring holds llh (C, ldg) and there is no W.  `gamma` (K7,
// K11): no moment accumulator.
__host__ __device__ inline AccLayout acc_layout(int S, int P, int n_r, int n_c, int n_utt, int C, bool global,
                                                bool gamma = false) {
  AccLayout l;
  l.ldg = static_cast<int>(round4(S));
  l.ldx = P > 0 ? static_cast<int>(round4(P)) : l.ldg;
  l.ldr = static_cast<int>(round4(n_r));
  l.ldc = static_cast<int>(round4(n_c));
  l.lda = static_cast<int>(round4(P + 1));
  const bool w_sh = !global && P > 0, moments = w_sh && !gamma;
  size_t o = 0;
  l.w = o;  // W (S, ldx + 1), zero past P
  if (w_sh) o += round4(static_cast<size_t>(S) * (l.ldx + 1));
  l.acc = o;
  if (moments) o += static_cast<size_t>(S) * l.lda;
  l.xi = o;
  if (!global) o += static_cast<size_t>(n_r) * l.ldc;
  l.bands = o;  // (a_self, a_adv, exit, w) a float4 a state, then bias and final: (6, ldg)
  o += 6 * static_cast<size_t>(l.ldg);
  l.idx = o;  // rows, cols (int32)
  o += round4(static_cast<size_t>(n_r) + n_c);
  l.utt = o;
  l.per_utt = 2 * static_cast<size_t>(C) * (l.ldx + l.ldg)  // ring: 2 × (stats or llh (C, ldx), α̂ (C, ldg))
              + static_cast<size_t>(C + 1) * l.ldg         // e, then v; row C: v after the chunk
              + static_cast<size_t>(C) * (l.ldr + l.ldc)   // ξ factors L (C, ldr), R (C, ldc)
              + round4(5 * static_cast<size_t>(C) + 2);     // per frame: Σv, Σα̂u1, 1/Σα̂u1, wgt_{t+1},
                                                                // 1/Σv_{t+1}; carried 1/Σv, wgt
  o += static_cast<size_t>(n_utt) * l.per_utt;
  l.total = o;
  return l;
}

// Banded: two blocks an SM where their shared memory allows (64 registers a
// thread): at config 4 two blocks of two utterances beat one of four by 12 %
// (stats_variants.py k2n_lb1).  Dense: one block an SM, so that a chain
// lane's row of A stays in registers.
// e / ld for 0 <= e < C·ld without an integer division: (e + ½)/ld lies at
// least ½/ld from an integer, and for e < 2^21 the float product's error is
// below that, so the truncation is exact (C·ld stays far below 2^21 here).
__device__ __forceinline__ int row_of(int e, float inv_ld) {
  return static_cast<int>((static_cast<float>(e) + 0.5f) * inv_ld);
}

// ---------------------------------------------------------------------
// The phases both chunked kernels share.  Per utterance a chunk holds a
// ring stage of statistics X (C, ldx) and α̂ (C, ldg), then e (C + 1, ldg:
// llh, e, then v; row C: v of the frame after the chunk) and 5C + 2
// scalars sc: per frame f of the chunk Σv (sc[f]), Σα̂u1 (sc[C + f]),
// 1/Σα̂u1 (sc[2C + f]), wgt_{t+1} (sc[3C + f]) and 1/Σv_{t+1} (sc[4C + f]);
// carried from the chunk after, 1/Σv (sc[5C]) and wgt (sc[5C + 1]).
// ---------------------------------------------------------------------
// Issue the cp.async of nf rows of `width` floats from flat row `row` of
// src into dst (C, ld), zeros past nf and width; the caller commits.
__device__ __forceinline__ void acc_fetch_rows(float* dst, const float* src, size_t row, int nf, int C, int ld,
                                               int width, int tid, int nt) {
  const float inv_ld = 1.f / ld;
  for (int e = tid; e < C * ld; e += nt) {
    const int f = row_of(e, inv_ld), q = e - f * ld;
    const bool ok = f < nf && q < width;
    cp_async4(dst + e, ok ? src + (row + f) * width + q : src, ok);
  }
}

// One utterance's chunk, nf frames from flat frame `row` (b·T + lo): the
// statistics (width P; kStream: llh, width S) into xs (C, ldx) and α̂ into as
// (C, ldg).
__device__ __forceinline__ void acc_fetch(float* xs, float* as, const float* stats, const float* alpha, size_t row,
                                          int nf, int C, int ldx, int ldg, int P, int S, int tid, int nt) {
  acc_fetch_rows(xs, stats, row, nf, C, ldx, P, tid, nt);
  acc_fetch_rows(as, alpha, row, nf, C, ldg, S, tid, nt);
}

// llh = W·x + bias of up to kGroup frames for one state, into e[f·ldg]
// for f < nf: x (·, ldx) the frames' statistics, `room` of its rows
// readable; W's row through wr (W(s, p) = wr[p·w_cs]).  W and x are zero
// past P, so the dot runs to ldx in steps of four.  K2's and K1's phase 1.
template <int kGroup = kAccGroup>
__device__ __forceinline__ void acc_ellh_tile(float* e, const float* x, const float* wr, int w_cs, float bias, int ldx,
                                              int ldg, int nf, int room) {
  float l[kGroup];
#pragma unroll
  for (int f = 0; f < kGroup; ++f) l[f] = 0.f;
#pragma unroll 2
  for (int p = 0; p < ldx; p += 4) {
    const float w0 = wr[p * w_cs], w1 = wr[(p + 1) * w_cs], w2 = wr[(p + 2) * w_cs], w3 = wr[(p + 3) * w_cs];
#pragma unroll
    for (int f = 0; f < kGroup; ++f) {
      if (f < room) {
        const float4 xv = *reinterpret_cast<const float4*>(x + f * ldx + p);
        l[f] = fmaf(w3, xv.w, fmaf(w2, xv.z, fmaf(w1, xv.y, fmaf(w0, xv.x, l[f]))));
      }
    }
  }
#pragma unroll
  for (int f = 0; f < kGroup; ++f)
    if (f < nf) e[f * ldg] = l[f] + bias;
}

// One warp on one frame's row of llh (S entries): e = exp(llh − max) from
// src into dst (in place when they are one); returns the max.
__device__ __forceinline__ float acc_exp_row(float* dst, const float* src, int S, int lane) {
  float m = -FLT_MAX;
  for (int s = lane; s < S; s += 32) m = fmaxf(m, src[s]);
  m = warp_max(m);
  for (int s = lane; s < S; s += 32) dst[s] = expf(src[s] - m);
  return m;
}

// Frame f's factors (f < nf, after the chain): 1/Σα̂u1, wgt_{t+1} and
// 1/Σv_{t+1}, both 0 on the utterance's last frame (`last`); norm_next
// points at the forward's norm of frame t + 1, read inside the chunk only.
__device__ __forceinline__ void acc_frame_factors(float* sc, int C, int f, int nf, bool last, const float* norm_next) {
  float wn = 0.f, ipn = 0.f;
  if (!last) {
    if (f == nf - 1) {
      ipn = sc[5 * C];
      wn = sc[5 * C + 1];
    } else {
      const float svn = fmaxf(sc[f + 1], FLT_MIN);
      const float denom = *norm_next * sc[C + f + 1] / svn;
      wn = denom > kXiFloor ? 1.f / fmaxf(denom, kXiFloor) : 0.f;
      ipn = 1.f / svn;
    }
  }
  sc[2 * C + f] = 1.f / fmaxf(sc[C + f], FLT_MIN);
  sc[3 * C + f] = wn;
  sc[4 * C + f] = ipn;
}

// One utterance's chunk as the products read it: nf frames; g (·, ldg)
// α̂u1 with ig[f] = 1/Σα̂u1 (γ = α̂u1·ig), x (·, ldx) the statistics (zero
// past P; not read without the moments); l (·, ldl) α̂_t at the ξ rows with
// wn[f] = wgt_{t+1}; r (·, ldr) v_{t+1} at the ξ columns with ipn[f] =
// 1/Σv_{t+1}, row f at r + f·ldr but row nf − 1 at r_last.
struct AccChunkView {
  const float *g, *x, *ig, *l, *r, *r_last, *wn, *ipn;
  int ldl, ldr, nf;
};

// moments += Γᵀ·[X, 1] (kMoments) and ξ (n_r, n_c) += Lᵀ·R over the chunks
// of n_view utterances (view(u) → AccChunkView), in 4 × 4 tiles; each
// accumulator element is read and written by one thread, once.  acc(s, p)
// = acc_m[s·acc_rs + p·acc_cs], ξ(i, j) = xi_m[i·xi_rs + j].
template <bool kMoments, class View>
__device__ __forceinline__ void acc_products(float* acc_m, int acc_rs, int acc_cs, float* xi_m, int xi_rs, int S,
                                             int P, int n_r, int n_c, int ldg, int ldx, int n_view, View view,
                                             int tid, int nt) {
  const int np4 = (P + 1 + 3) / 4, ns4 = (S + 3) / 4, nr4 = (n_r + 3) / 4, nc4 = (n_c + 3) / 4;
  for (int it = tid; it < (kMoments ? ns4 * np4 : 0); it += nt) {
    const int s0 = (it / np4) * 4, p0 = (it % np4) * 4, one = P - p0;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[a][k] = s0 + a < S && p0 + k <= P ? acc_m[(s0 + a) * acc_rs + (p0 + k) * acc_cs] : 0.f;
    for (int u = 0; u < n_view; ++u) {
      const AccChunkView v = view(u);
      const float* g = v.g + s0;
      const float* x = v.x + p0;
      for (int f = 0; f < v.nf; ++f) {
        const float4 gv = *reinterpret_cast<const float4*>(g + f * ldg);  // α̂u1
        const float ig = v.ig[f];
        float4 xv = p0 < ldx ? *reinterpret_cast<const float4*>(x + f * ldx) : make_float4(0.f, 0.f, 0.f, 0.f);
        xv.x = one == 0 ? 1.f : xv.x;
        xv.y = one == 1 ? 1.f : xv.y;
        xv.z = one == 2 ? 1.f : xv.z;
        xv.w = one == 3 ? 1.f : xv.w;
        const float ga[4] = {gv.x * ig, gv.y * ig, gv.z * ig, gv.w * ig}, xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(ga[a], xk[k], acc[a][k]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (s0 + a < S && p0 + k <= P) acc_m[(s0 + a) * acc_rs + (p0 + k) * acc_cs] = acc[a][k];
  }
  for (int it = tid; it < nr4 * nc4; it += nt) {
    const int i0 = (it / nc4) * 4, j0 = (it % nc4) * 4;
    float xi[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) xi[a][k] = i0 + a < n_r && j0 + k < n_c ? xi_m[(i0 + a) * xi_rs + j0 + k] : 0.f;
    for (int u = 0; u < n_view; ++u) {
      const AccChunkView v = view(u);
      for (int f = 0; f < v.nf; ++f) {
        const float4 lv = *reinterpret_cast<const float4*>(v.l + f * v.ldl + i0);  // α̂_t[rows]
        const float* rr = f == v.nf - 1 ? v.r_last : v.r + f * v.ldr;
        const float4 rv = *reinterpret_cast<const float4*>(rr + j0);  // v_{t+1}[cols]
        const float wn = v.wn[f], ipn = v.ipn[f];
        const float la[4] = {lv.x * wn, lv.y * wn, lv.z * wn, lv.w * wn};
        const float rk[4] = {rv.x * ipn, rv.y * ipn, rv.z * ipn, rv.w * ipn};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) xi[a][k] = fmaf(la[a], rk[k], xi[a][k]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + a < n_r && j0 + k < n_c) xi_m[(i0 + a) * xi_rs + j0 + k] = xi[a][k];
  }
}

// After a chunk of frames lo .. (nf > 0): γ₀ = α̂u1·(1/Σα̂u1) of frame 0
// when the chunk holds it (g: its α̂u1 row; kGamma0 false: none), and the
// carry into the next chunk: frame lo's v to row C of e, its 1/Σv and wgt
// (norm_lo: the forward's norm of frame lo) to sc[5C], sc[5C + 1].
template <bool kGamma0>
__device__ __forceinline__ void acc_next_chunk(float* e, float* sc, const float* g, float* gamma0_row, int lo, int C,
                                               int ldg, int S, const float* norm_lo, int tid, int nt) {
  for (int s = tid; s < S; s += nt) {
    if (kGamma0 && lo == 0) gamma0_row[s] = g[s] * sc[2 * C];
    e[static_cast<size_t>(C) * ldg + s] = e[s];
  }
  if (tid == 0) {
    const float sv0 = fmaxf(sc[0], FLT_MIN);
    const float denom = *norm_lo * sc[C] / sv0;
    sc[5 * C] = 1.f / sv0;
    sc[5 * C + 1] = denom > kXiFloor ? 1.f / fmaxf(denom, kXiFloor) : 0.f;
  }
}

// The shared placement's accumulators to the block's partial row: the
// moments (S, P + 1) row-major, or state-minor (P + 1, S) when `dense`
// (none unless `moments`), then ξ (n_r, n_c).
__device__ __forceinline__ void acc_write_row(float* out, const float* acc_m, int acc_rs, const float* xi_m,
                                              int xi_rs, int S, int P, int n_r, int n_c, bool dense, bool moments,
                                              int tid, int nt) {
  const int n_acc = moments ? S * (P + 1) : 0;
  for (int i = tid; i < n_acc; i += nt) {
    if (dense) {
      const int p = i / S;
      out[i] = acc_m[(i - p * S) * acc_rs + p];
    } else {
      const int s = i / (P + 1);
      out[i] = acc_m[s * acc_rs + (i - s * (P + 1))];
    }
  }
  for (int k = tid; k < n_r * n_c; k += nt) {
    const int i = k / n_c;
    out[n_acc + k] = xi_m[i * xi_rs + (k - i * n_c)];
  }
}

// kGamma's phase 4: γ = α̂u1·(1/Σα̂u1) of a chunk's nf frames, g (·, ldg)
// α̂u1 and ig[f] = 1/Σα̂u1, into out (nf, S) in device memory (the chunk's
// first frame of γ), coalesced by the whole block.
__device__ __forceinline__ void acc_write_gamma(float* out, const float* g, const float* ig, int nf, int S, int ldg,
                                                int tid, int nt) {
  const float inv_s = 1.f / S;
  for (int e = tid; e < nf * S; e += nt) {
    const int f = row_of(e, inv_s), s = e - f * S;
    out[e] = g[f * ldg + s] * ig[f];
  }
}

// γ = 0 on one utterance's frames len .. T − 1 (out: its (T, S) rows).
__device__ __forceinline__ void acc_zero_tail(float* out, int len, int T, int S, int tid, int nt) {
  for (size_t i = static_cast<size_t>(len) * S + tid; i < static_cast<size_t>(T) * S; i += nt) out[i] = 0.f;
}

template <bool kDense, bool kGlobal, bool kFull, bool kGamma>
__global__ void __launch_bounds__(kAccThreads, kDense ? 1 : 2) estep_acc_chunked_kernel(
    const float* __restrict__ stats,   // (B, T, P); kStream: llh (B, T, S)
    const int* __restrict__ lens,      // (B,)
    const float* __restrict__ w,       // (S, P), kGlobal: Wᵀ padded with zero rows to (round4(P), S) (not kStream)
    const float* __restrict__ bias,    // (S,) (not kStream)
    const float* __restrict__ bands,   // (4, S) (banded)
    const float* __restrict__ trans,   // (S, S) (dense)
    const float* __restrict__ final_,  // (S,), dense: (B, S)
    const float* __restrict__ alpha,   // (B, T, S)
    const float* __restrict__ norms,   // (B, T)
    const int* __restrict__ rows,      // (n_r,) ξ rows (banded: the units' ends); null: the identity
    const int* __restrict__ cols,      // (n_c,) ξ columns (banded: the units' starts); null: the identity
    float* __restrict__ part,          // (n_blocks, S*(P+1) + n_r*n_c); kGamma: (n_blocks, n_r*n_c)
    float* __restrict__ gamma0,        // (B, S) (not kStream)
    float* __restrict__ gamma,         // (B, T, S) (kGamma)
    int B, int T, int S, int P, int n_r, int n_c, int n_utt, int chunk) {
  constexpr bool kStream = kDense && kGamma;  // K7/K15 read llh; K11 computes it as K2 does
  const int C = kFull ? kAccChunk : chunk;
  if (!kStream) n_c = n_r;  // K2, K6 and K11: ξ (U, U), one value (fewer live registers)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AccLayout L = acc_layout(S, kStream ? 0 : P, n_r, n_c, n_utt, C, kGlobal, kGamma);
  const int ldx = L.ldx, ldg = L.ldg, ldr = L.ldr, ldc = L.ldc, ldw = ldx + 1;
  const int width = kStream ? S : P;  // of a frame's row in the ring's first array
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31, n_warps = nt >> 5;
  const int b0 = blockIdx.x * n_utt;
  const int n_acc = kGamma ? 0 : S * (P + 1);
  float* out = part + static_cast<size_t>(blockIdx.x) * (n_acc + n_r * n_c);
  float* w_sh = smem + L.w;
  float4* band_sh = reinterpret_cast<float4*>(smem + L.bands);  // one 16-byte read a state in the chain
  float* bias_sh = smem + L.bands + 4 * static_cast<size_t>(ldg);
  float* fin_sh = bias_sh + ldg;
  int* rows_sh = reinterpret_cast<int*>(smem + L.idx);
  int* cols_sh = rows_sh + n_r;
  // W(s, p) = w_m[s·w_rs + p·w_cs]; acc(s, p) = acc_m[s·acc_rs + p·acc_cs]; ξ(i, j) = xi_m[i·xi_rs + j]
  const float* w_m = kGlobal ? w : w_sh;
  const int w_rs = kGlobal ? 1 : ldw, w_cs = kGlobal ? S : 1;
  float* acc_m = kGlobal ? out : smem + L.acc;
  float* xi_m = kGlobal ? out + n_acc : smem + L.xi;
  // the partial row: the moments row-major (banded) or state-minor (dense), then ξ
  const int acc_rs = kGlobal ? (kDense ? 1 : P + 1) : L.lda, acc_cs = kGlobal && kDense ? S : 1;
  const int xi_rs = kGlobal ? n_c : ldc;
  // utterance u's pieces: ring stage st (stats or llh, then α̂), e/v rows, L, R, scalars
  auto ring_x = [&](int u, int st) { return smem + L.utt + u * L.per_utt + static_cast<size_t>(st) * C * (ldx + ldg); };
  auto ring_a = [&](int u, int st) { return ring_x(u, st) + static_cast<size_t>(C) * ldx; };
  auto ebuf = [&](int u) { return smem + L.utt + u * L.per_utt + 2 * static_cast<size_t>(C) * (ldx + ldg); };
  auto lbuf = [&](int u) { return ebuf(u) + static_cast<size_t>(C + 1) * ldg; };
  auto rbuf = [&](int u) { return lbuf(u) + static_cast<size_t>(C) * ldr; };
  auto scal = [&](int u) { return rbuf(u) + static_cast<size_t>(C) * ldc; };
  auto len_of = [&](int u) { return b0 + u < B ? lens[b0 + u] : 0; };
  // chunk c of utterance u: frames lo .. lo + nf − 1, counted from its end
  auto span = [&](int u, int c, int& lo) {
    const int hi = len_of(u) - 1 - c * C;
    lo = max(hi - C + 1, 0);
    return hi >= 0 ? hi - lo + 1 : 0;
  };

  int n_chunks = 0;
  for (int u = 0; u < n_utt; ++u) n_chunks = max(n_chunks, (len_of(u) + C - 1) / C);
  auto fetch = [&](int c) {
    for (int u = 0; u < n_utt; ++u) {
      int lo;
      const int nf = span(u, c, lo);
      acc_fetch(ring_x(u, c & 1), ring_a(u, c & 1), stats, alpha, static_cast<size_t>(b0 + u) * T + lo, nf, C, ldx,
                ldg, width, S, tid, nt);
    }
    cp_async_commit();
  };
  if (n_chunks > 0) fetch(0);

  if (!kGlobal && !kStream) {
    for (int i = tid; i < S * ldw; i += nt) {
      const int s = i / ldw, p = i - s * ldw;
      w_sh[i] = p < P ? w[s * P + p] : 0.f;
    }
  }
  // the moments and ξ start at 0; each element is owned by one tile, so one thread
  for (int i = tid; i < (kGamma ? 0 : kGlobal ? n_acc : S * L.lda); i += nt) acc_m[i] = 0.f;
  for (int i = tid; i < n_r * xi_rs; i += nt) xi_m[i] = 0.f;
  for (int s = tid; s < ldg; s += nt) {
    const bool on = s < S;
    const bool band = on && !kDense;
    band_sh[s] = band ? make_float4(bands[s], bands[S + s], bands[2 * S + s], bands[3 * S + s])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    bias_sh[s] = on && !kStream ? bias[s] : 0.f;
    fin_sh[s] = band ? final_[s] : 0.f;
  }
  for (int i = tid; i < n_r; i += nt) rows_sh[i] = rows != nullptr ? rows[i] : i;
  for (int i = tid; i < n_c; i += nt) cols_sh[i] = cols != nullptr ? cols[i] : i;
  for (int u = 0; u < n_utt; ++u) {  // e/v (padding columns stay 0), L, R, the carried scalars
    float* e = ebuf(u);
    for (size_t i = tid; i < static_cast<size_t>(C + 1) * ldg + static_cast<size_t>(C) * (ldr + ldc) + 5 * C + 2;
         i += nt)
      e[i] = 0.f;
  }
  float ip = 0.f, r = 0.f;  // the chain warp's 1/Σv and (banded) Σv·w/Σv of the frame after the current one
  float vprev = 0.f;        // dense: the chain lane's v of the frame after the current one
  float a_row[32];          // dense: a chain lane's row of A
#pragma unroll
  for (int k = 0; k < 32; ++k) a_row[k] = kDense && warp < n_utt && lane < S && k < S ? trans[lane * S + k] : 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const bool more = c + 1 < n_chunks;
    __syncthreads();  // chunk c − 1 is done with stage (c + 1) & 1, e, L and R
    if (more) fetch(c + 1);
    cp_async_wait(more);
    __syncthreads();  // chunk c has landed

    // 1a. llh (nf, S) = X·Wᵀ + bias: an item is a state and up to kAccGroup frames (kStream: llh was read)
    const int groups = (C + kAccGroup - 1) / kAccGroup;
    for (int it = tid; it < (kStream ? 0 : n_utt * groups * S); it += nt) {
      const int s = it % S, ug = it / S, u = ug / groups, f0 = (ug - u * groups) * kAccGroup;
      int lo;
      const int nf = span(u, c, lo);
      if (f0 >= nf) continue;
      acc_ellh_tile(ebuf(u) + static_cast<size_t>(f0) * ldg + s, ring_x(u, c & 1) + static_cast<size_t>(f0) * ldx,
                    w_m + s * w_rs, w_cs, bias_sh[s], ldx, ldg, nf - f0, C - f0);
    }
    if (!kStream) __syncthreads();
    // 1b. a warp a frame: the row max, e = exp(llh − max), the gather α̂_t[rows]
    for (int uf = warp; uf < n_utt * C; uf += n_warps) {
      const int u = uf / C, f = uf - u * C;
      int lo;
      if (f >= span(u, c, lo)) continue;
      float* e = ebuf(u) + static_cast<size_t>(f) * ldg;
      acc_exp_row(e, kStream ? ring_x(u, c & 1) + static_cast<size_t>(f) * ldx : e, S, lane);
      const float* a = ring_a(u, c & 1) + static_cast<size_t>(f) * ldg;
      for (int i = lane; i < n_r; i += 32) lbuf(u)[f * ldr + i] = a[rows_sh[i]];
    }
    __syncthreads();

    // 2. the chain: warp u walks utterance u's frames of the chunk backward
    if (warp < n_utt) {
      const int u = warp, len = len_of(u);
      int lo;
      const int nf = span(u, c, lo);
      float* e = ebuf(u);
      float* ab = ring_a(u, c & 1);
      float* sc = scal(u);
      const float* fin_u = final_ + static_cast<size_t>(b0 + u) * S;  // dense: this utterance's final
      for (int f = nf - 1; f >= 0 && kDense; --f) {
        const bool on = lane < S;
        float u1;
        if (lo + f == len - 1) {
          u1 = on ? fin_u[lane] : 0.f;
        } else {
          // all 32 lanes (v and A are 0 past S): no branch between the shuffles
          float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < 32; ++k) q[k & 3] = fmaf(__shfl_sync(0xffffffffu, vprev, k), a_row[k], q[k & 3]);
          u1 = ((q[0] + q[1]) + (q[2] + q[3])) * (kGamma ? 1.f : ip);  // kGamma: vprev is v̂
        }
        float* er = e + static_cast<size_t>(f) * ldg;
        float* ar = ab + static_cast<size_t>(f) * ldg;
        const float v = on ? er[lane] * u1 : 0.f, a = on ? ar[lane] * u1 : 0.f;
        if (on) {
          er[lane] = v;
          ar[lane] = a;
        }
        float sv = v, sa = a;
        for (int o = 16; o > 0; o >>= 1) {
          sv += __shfl_xor_sync(0xffffffffu, sv, o);
          sa += __shfl_xor_sync(0xffffffffu, sa, o);
        }
        ip = 1.f / fmaxf(sv, FLT_MIN);
        vprev = kGamma ? v * ip : v;
        if (lane == 0) {
          sc[f] = sv;
          sc[C + f] = sa;
        }
      }
      for (int f = nf - 1; f >= 0 && !kDense; --f) {
        const bool last = lo + f == len - 1;
        const float* vn = e + static_cast<size_t>(f == nf - 1 ? C : f + 1) * ldg;  // v_{t+1}
        float* er = e + static_cast<size_t>(f) * ldg;
        float* ar = ab + static_cast<size_t>(f) * ldg;
        float sv = 0.f, sa = 0.f, sw = 0.f;
        for (int s = lane; s < S; s += 32) {
          const float4 bd = band_sh[s];  // a_self, a_adv, exit, w
          float u1;
          if (kGamma) {  // K11: v̂_{t+1} = v_{t+1}·ip as it is read (a normalised carry)
            const float up = s + 1 < S ? vn[s + 1] * ip : 0.f;
            u1 = last ? fin_sh[s] : fmaf(r, bd.z, fmaf(vn[s] * ip, bd.x, up * bd.y));
          } else {
            const float up = s + 1 < S ? vn[s + 1] : 0.f;
            u1 = last ? fin_sh[s] : fmaf(r, bd.z, fmaf(vn[s], bd.x, up * bd.y) * ip);
          }
          const float v = er[s] * u1, a = ar[s] * u1;
          er[s] = v;
          ar[s] = a;
          sv += v;
          sa += a;
          sw = fmaf(v, bd.w, sw);
        }
        for (int o = 16; o > 0; o >>= 1) {  // one tree for the three sums; every lane gets them
          sv += __shfl_xor_sync(0xffffffffu, sv, o);
          sa += __shfl_xor_sync(0xffffffffu, sa, o);
          sw += __shfl_xor_sync(0xffffffffu, sw, o);
        }
        ip = 1.f / fmaxf(sv, FLT_MIN);
        r = sw * ip;
        if (lane == 0) {
          sc[f] = sv;
          sc[C + f] = sa;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // 3. per frame 1/Σα̂u1 (γ = α̂u1 / Σα̂u1), wgt_{t+1} and 1/Σv_{t+1}; the
    //    gather R = v_{t+1}[cols] (v̂_{t+1} = R / Σv_{t+1})
    for (int i = tid; i < n_utt * C; i += nt) {
      const int u = i / C, f = i - u * C;
      int lo;
      const int nf = span(u, c, lo);
      if (f < nf)
        acc_frame_factors(scal(u), C, f, nf, lo + f == len_of(u) - 1,
                          norms + static_cast<size_t>(b0 + u) * T + lo + f + 1);
    }
    for (int u = 0; u < n_utt; ++u) {
      int lo;
      const int nf = span(u, c, lo);
      const float* e = ebuf(u);
      for (int i = tid; i < nf * n_c; i += nt) {
        const int f = i / n_c, k = i - f * n_c;
        rbuf(u)[f * ldc + k] = e[static_cast<size_t>(f == nf - 1 ? C : f + 1) * ldg + cols_sh[k]];
      }
    }
    __syncthreads();

    // 4. kGamma: γ of the chunk's frames; moments += Γᵀ·[X, 1] (not kGamma) and ξ += Lᵀ·R
    for (int u = 0; u < n_utt && kGamma; ++u) {
      int lo;
      const int nf = span(u, c, lo);
      acc_write_gamma(gamma + (static_cast<size_t>(b0 + u) * T + lo) * S, ring_a(u, c & 1), scal(u) + 2 * C, nf, S,
                      ldg, tid, nt);
    }
    acc_products<!kGamma>(acc_m, acc_rs, acc_cs, xi_m, xi_rs, S, P, n_r, n_c, ldg, ldx, n_utt, [&](int u) {
      int lo;
      const int nf = span(u, c, lo);
      const float* sc = scal(u);
      return AccChunkView{ring_a(u, c & 1), ring_x(u, c & 1), sc + 2 * C, lbuf(u), rbuf(u),
                          rbuf(u) + static_cast<size_t>(max(nf - 1, 0)) * ldc, sc + 3 * C, sc + 4 * C, ldr, ldc, nf};
    }, tid, nt);
    // 5. γ₀, and the carry into the next chunk (phase 4 reads R, not row C of e)
    for (int u = 0; u < n_utt; ++u) {
      int lo;
      if (span(u, c, lo) > 0)
        acc_next_chunk<!kStream>(ebuf(u), scal(u), ring_a(u, c & 1), gamma0 + static_cast<size_t>(b0 + u) * S, lo, C,
                                ldg, S, norms + static_cast<size_t>(b0 + u) * T + lo, tid, nt);
    }
  }
  __syncthreads();
  if (!kGlobal) acc_write_row(out, acc_m, acc_rs, xi_m, xi_rs, S, P, n_r, n_c, kDense, !kGamma, tid, nt);
  for (int u = 0; u < n_utt; ++u) {
    if (b0 + u >= B) continue;
    if (kGamma) acc_zero_tail(gamma + static_cast<size_t>(b0 + u) * T * S, len_of(u), T, S, tid, nt);
    if (!kStream && len_of(u) == 0)
      for (int s = tid; s < S; s += nt) gamma0[static_cast<size_t>(b0 + u) * S + s] = 0.f;
  }
}


// The kernel and its batch sum: part (ceil(B / n_utt), width), width =
// S·(P+1) + n_r·n_c (kGamma: n_r·n_c), out = Σ of its rows.
template <bool kDense, bool kGamma>
cudaError_t launch_acc_chunked(int global, int n_utt, int chunk, const float* stats, const int* lens, const float* w,
                               const float* bias, const float* bands, const float* trans, const float* final_,
                               const float* alpha, const float* norms, const int* rows, const int* cols,
                               float* part, float* out, float* gamma0, float* gamma, int B, int T, int S, int P,
                               int n_r, int n_c, cudaStream_t st) {
  if (n_utt < 1 || n_utt > kAccThreads / 32 || chunk < 1 || chunk > kAccChunk || (kDense && S > 32))
    return cudaErrorInvalidValue;
  constexpr bool kStream = kDense && kGamma;
  const size_t smem =
      acc_layout(S, kStream ? 0 : P, n_r, n_c, n_utt, chunk, global != 0, kGamma).total * sizeof(float);
  const bool full = chunk == kAccChunk;
  auto kernel = global ? (full ? estep_acc_chunked_kernel<kDense, true, true, kGamma>
                               : estep_acc_chunked_kernel<kDense, true, false, kGamma>)
                       : (full ? estep_acc_chunked_kernel<kDense, false, true, kGamma>
                               : estep_acc_chunked_kernel<kDense, false, false, kGamma>);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n = (kGamma ? 0 : S * (P + 1)) + n_r * n_c, n_blocks = (B + n_utt - 1) / n_utt;
  if (B > 0) {
    kernel<<<n_blocks, kAccThreads, smem, st>>>(stats, lens, w, bias, bands, trans, final_, alpha, norms, rows, cols,
                                               part, gamma0, gamma, B, T, S, P, n_r, n_c, n_utt, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n > 0) sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, n_blocks, n);
  return cudaGetLastError();
}

}  // namespace
