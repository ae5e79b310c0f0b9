// Dense-transition HMM scan kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by beer_tpu_torch/ops/cuda_scan.py.
//
// Three kernels carry the Bayesian HMM's VB-EM E-step over one shared
// (S, S) transition matrix (ergodic HMMs, shared transcription graphs):
//
//   K5 forward_llh_dense   scaled forward α̂_t = normalise(Aᵀα̂_{t−1} ⊙ e_t),
//                          from an llh stream or from reduced statistics
//                          with llh = W·stats + bias computed in the kernel;
//   K6 estep_acc_dense     v-space backward that reduces γ to the emission
//                          moments, γ₀ and the full (S, S) ξ;
//   K7 estep_gamma_dense   the same backward chain, emitting γ per frame
//                          and the full (S, S) ξ: K6's kernels in their
//                          γ-emitting mode (kGamma).
//
// Two more are template instances of K5 and K7, so that the modes cannot
// drift apart:
//
//   K14 forward_llh_shifts_dense      K5 on the llh stream, also writing the
//                                     masked per-frame row max, with the carry
//                                     copied through frames t >= len;
//   K15 estep_gamma_dense_restricted  K7 with ξ gathered to the block
//                                     [rows][:, cols] in the kernel (the
//                                     rows and columns in K7's index slots).
//
// Each replaces the dense mode of one Pallas TPU kernel of
// beer_tpu/ops/pallas_scan.py; the note above each kernel names it.
//
// The design is the phone-loop kernels' (phone_loop_scan.cu): one thread
// block per utterance, threads over states in strided loops, the time
// loop inside the block, per-utterance initial and final vectors, and
// the stored-α̂ contract (K5 writes α̂ and the per-step norms, K6/K7 run
// only the backward chain).  What changes is the propagate: a dense
// S×S product per step instead of band + rank-1, with A kept in shared
// memory for the whole recursion.  Row strides are odd so that the
// forward (thread j walks column j) and the backward (thread i walks row
// i) are both free of bank conflicts.  Per-utterance ξ and moment
// partials are written to a (B, ·) array and summed over the batch by
// sum_rows_kernel in a fixed order: deterministic, no atomics.  The JAX
// package's bf16×3 propagate is a TPU artifact; everything here is f32.
// K5 (with K14), K6 and K7 (with K15) have since been rebuilt around
// chunks of frames, with a one-warp instance for S <= 32 (their notes
// below).
//
// Two placements of the operands, one template flag (kGlobal) on each
// kernel.  "shared": A (and the ELLH matrix W, and K6's moment
// accumulator) in shared memory, as above; it fits up to S = 238 (K5 on
// the llh stream), 168 (K7) or ~133 (K6 at P = 78).  "global", for every
// larger S: A and W are read from device memory (an (S, S) matrix of a
// few hundred KB stays in the 50 MB L2), laid out so that each warp reads
// contiguous addresses: the forward walks columns of A as given, the
// backward rows of A, so it takes Aᵀ, and W comes as Wᵀ (P, S).  The ξ
// and moment accumulators become the utterance's own row of the partial
// array in device memory, each element read and written by one thread
// only, and are summed over the batch as before.  The sums run in the
// same order in both placements, so their outputs agree bitwise.  The
// wrapper picks the placement from the shared-memory size
// (cuda_scan.dense_placement, which asks forward_instance,
// backward_instance and gamma_instance).  Both placements write K6's
// moments as (P + 1, S), state-minor.

#include "acc_chunks.cuh"
#include "scan_common.cuh"

namespace {

// ---------------------------------------------------------------------
// K5 — scaled dense forward.
// Replaces beer_tpu/ops/pallas_scan.py _make_fwd_llh_ckpt_kernel_lm
// (wrapper forward_llh_ckpt_pass_lm with bands=None, trans=(S, S);
// store_alpha=True), in both of its input modes: kStats streams the
// reduced statistics and computes llh_t = W·stats_t + bias (the stats
// route of HMM.infer), otherwise the llh stream is read (the llh route).
// Per step: row max, e = exp(llh − max), raw_j = e_j · Σ_i α̂_{t−1}(i)
// A(i, j) (the first frame uses the row's init), norm = max(Σ raw,
// FLT_MIN), α̂ = raw / norm, logz_base += log norm + max.  Frames t >= len
// get α̂ = 0, norm = 1; an empty row keeps last = init and logz_base = 0.
//
// K14 (kShifts, llh stream only) replaces _make_fwd_llh_kernel (wrapper
// forward_llh_pass): it also writes shifts (B, T) = the row max on frames
// t < len and 0 after, frame 0 fires on every row (an empty row sees e = 1
// there, so it carries normalise(init) with norm_0 = Σ init), and frames
// t >= max(len, 1) copy the carry into α̂ (norm = 1, shift = 0).
//
// What bounds it: not bytes nor FMAs (the bound is tens of µs at config
// 2) but the serial chain of T steps per utterance, each a propagate, a
// sum over the states and a division.  So everything that does not depend
// on the carry leaves the chain.  Frames go in chunks: chunk c +
// 1's statistics (or llh) arrive by cp.async into a two-stage ring while
// chunk c recurses; at the start of a chunk llh, the row max and e =
// exp(llh − max) of all its frames are computed in parallel into shared
// memory; the serial loop only propagates, normalises and stores α̂; the
// norms, log Z's terms (log norm + max) and K14's shifts are written per
// chunk.  Two instances, chosen by fit in one place, the wrapper's
// cuda_scan.forward_instance:
//   "warp" (S <= 32 while its ring fits a block; chunks of kChunk): one
//       warp an utterance, kWarps utterances a block sharing W; lane j
//       holds column A(:, j) in registers, α̂_{t−1}(i) comes by
//       __shfl_sync and the step's sum by a shuffle tree: no barrier and
//       no shared memory in the chain;
//   "block" (any S, both placements; chunks of C frames, the most of 16,
//       8, 4, 2 or 1 whose block fits the placement: the ring moves the
//       shared placement's limit by one S at most, and the global
//       placement takes S to ~14,500 on the llh stream, above K7's
//       ~9,700; e computed in the ring's stage on the llh stream): one
//       block an utterance, threads over states; a step takes one block
//       reduction and one barrier (three barriers, against five with the ELLH and
//       the frame's load in the chain).  The carry stays normalised: an
//       unnormalised carry loses its digits to subnormal products when a
//       step's norm is tiny.
// ---------------------------------------------------------------------
constexpr int kChunk = 32;      // frames a chunk of the warp instance
constexpr int kChunkBlock = 16;  // frames a chunk of the block instance, at most
constexpr int kWarps = 4;       // utterances a block of the warp instance

// Floats of one instance's shared memory (instance: 0 block in the shared
// placement, 1 block in the global placement, 2 warp; chunk: the block
// instance's frames a chunk); p = 0: llh stream.
size_t dense_forward_smem_floats(int s, int p, int instance, int chunk) {
  const size_t S = s, P = p, C = instance == 2 ? kChunk : chunk;
  if (instance == 2) {
    const size_t ldr = p > 0 ? round4(P) : S;
    return (p > 0 ? round4(S * (round4(P) + 1)) : 0) + kWarps * (round4(2 * C * ldr) + C * 33 + C);
  }
  const bool global = instance == 1;
  size_t n = (global ? 0 : round4(S * odd_stride(s))) + 2 * S + 2 * kMaxWarps + round4(2 * C * (p > 0 ? P : S)) +
             2 * C;
  if (p > 0) n += C * S + S + (global ? 0 : S * odd_stride(p));  // e apart from the ring, the bias, W
  return n;
}

// The block instance: one block an utterance.
// 1024 threads at most, one block an SM: the bound lets ptxas hold the
// propagate's 32 reads of A in flight (uncapped it kept 32 registers and
// ran 1.7× slower at S = 300, stats_variants.py k5_blk_no_lb).
// kFull: chunks of kChunkBlock frames, a constant (a runtime chunk length
// cost the global instance 9 % at S = 300 on the llh stream,
// stats_variants.py k5_runtime_chunk); otherwise `chunk` frames.
template <bool kStats, bool kShifts, bool kGlobal, bool kFull>
__global__ void __launch_bounds__(1024, 1) forward_llh_dense_kernel(
    const float* __restrict__ x,      // (B, T, P) stats or (B, T, S) llh
    const int* __restrict__ lens,     // (B,)
    const float* __restrict__ w,      // (S, P), kGlobal: Wᵀ (P, S)  (kStats)
    const float* __restrict__ bias,   // (S,)    (kStats)
    const float* __restrict__ trans,  // (S, S), [i, j] = p(j | i)
    const float* __restrict__ init,   // (B, S)
    float* __restrict__ alpha,        // (B, T, S)
    float* __restrict__ norms,        // (B, T)
    float* __restrict__ last,         // (B, S)
    float* __restrict__ logz,         // (B,)
    float* __restrict__ shifts,       // (B, T)  (kShifts)
    int T, int S, int P, int chunk) {
  const int C = kFull ? kChunkBlock : chunk;  // frames a chunk, 1..kChunkBlock
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldt = odd_stride(S), ldw = odd_stride(P), row = kStats ? P : S;
  float* a_sh = smem;                                                           // A, (S, ldt)
  float* ring = a_sh + (kGlobal ? 0 : round4(static_cast<size_t>(S) * ldt));   // 2 × (C, row)
  float* e_st = ring + round4(2 * static_cast<size_t>(C) * row);               // kStats: (C, S)
  float* vbuf = e_st + (kStats ? static_cast<size_t>(C) * S : 0);               // α̂_{t−1}, then raw_t
  float* red = vbuf + 2 * S;
  float* mxs = red + 2 * kMaxWarps;                                             // (C,) row maxima
  float* nrm = mxs + C;                                                         // (C,) norms
  float* bias_sh = nrm + C;                                                     // kStats: (S,)
  float* w_sh = bias_sh + S;                                                    // kStats: W, (S, ldw)
  // A(i, j) = a_m[i·ldt_a + j]; W(s, p) = w_m[s·w_rs + p·w_cs]
  const float* a_m = kGlobal ? trans : a_sh;
  const float* w_m = kGlobal ? w : w_sh;
  const int ldt_a = kGlobal ? S : ldt, w_rs = kGlobal ? 1 : ldw, w_cs = kGlobal ? S : 1;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int len = lens[b];
  const int n_fire = kShifts ? min(max(len, 1), T) : len;
  const float* x_b = x + static_cast<size_t>(b) * T * row;
  float* al_b = alpha + static_cast<size_t>(b) * T * S;
  float* n_b = norms + static_cast<size_t>(b) * T;
  // chunk c → ring stage c & 1, zero-filled past the last frame
  auto fetch = [&](int c) {
    float* dst = ring + (c & 1) * C * row;
    const int f0 = c * C, n = min(C, T - f0) * row;
    const float* src = x_b + static_cast<size_t>(f0) * row;
    for (int e = tid; e < C * row; e += nt) cp_async4(dst + e, e < n ? src + e : x_b, e < n);
    cp_async_commit();
  };
  const int n_chunks = (n_fire + C - 1) / C;
  if (n_chunks > 0) fetch(0);
  if (!kGlobal) {
    for (int i = tid; i < S * S; i += nt) {
      const int r = i / S;
      a_sh[r * ldt + (i - r * S)] = trans[i];
    }
  }
  if (kStats) {
    if (!kGlobal) {
      for (int i = tid; i < S * P; i += nt) {
        const int s = i / P;
        w_sh[s * ldw + (i - s * P)] = w[i];
      }
    }
    for (int s = tid; s < S; s += nt) bias_sh[s] = bias[s];
  }
  float* abuf = vbuf + S;                                                        // raw_t, then α̂_t
  for (int s = tid; s < S; s += nt) vbuf[s] = init[static_cast<size_t>(b) * S + s];
  float pn = 1.f;
  float logz_acc = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int f0 = c * C, nf = min(C, n_fire - f0);
    const bool more = c + 1 < n_chunks;
    __syncthreads();  // every reader of stage (c + 1) & 1, e_sh, mxs and nrm is done
    if (more) fetch(c + 1);
    cp_async_wait(more);
    __syncthreads();  // chunk c has landed (and, at c = 0, A, W, bias and init)
    float* xc = ring + (c & 1) * C * row;
    float* e_sh = kStats ? e_st : xc;  // (C, S): llh, then e; on the llh stream the stage itself
    for (int s = tid; s < S; s += nt) {
      if (kStats && kFull) {
        float l[kChunkBlock];
#pragma unroll
        for (int f = 0; f < kChunkBlock; ++f) l[f] = 0.f;
        const float* wr = w_m + s * w_rs;
        for (int p = 0; p < P; ++p) {
          const float wv = wr[p * w_cs];
#pragma unroll
          for (int f = 0; f < kChunkBlock; ++f) l[f] = fmaf(wv, xc[f * P + p], l[f]);
        }
        const float bs = bias_sh[s];
#pragma unroll
        for (int f = 0; f < kChunkBlock; ++f)
          if (f < nf) e_sh[f * S + s] = l[f] + bs;
      } else if (kStats) {  // a shorter chunk (large S or P): a frame at a time, in the same order
        const float* wr = w_m + s * w_rs;
        for (int f = 0; f < nf; ++f) {
          float l = 0.f;
          for (int p = 0; p < P; ++p) l = fmaf(wr[p * w_cs], xc[f * P + p], l);
          e_sh[f * S + s] = l + bias_sh[s];
        }
      } else if (kShifts && f0 < 1 && len == 0) {
        e_sh[s] = 0.f;  // frame 0 of an empty row fires with e = 1
      }
    }
    __syncthreads();
    for (int f = warp; f < nf; f += nt >> 5) {
      float m = -FLT_MAX;
      for (int s = lane; s < S; s += 32) m = fmaxf(m, e_sh[f * S + s]);
      m = warp_max(m);
      if (lane == 0) {
        mxs[f] = m;
        if (kShifts) shifts[static_cast<size_t>(b) * T + f0 + f] = m;  // 0 on an empty row's frame 0
      }
    }
    __syncthreads();
    for (int e = tid; e < nf * S; e += nt) e_sh[e] = expf(e_sh[e] - mxs[e / S]);
    __syncthreads();
    for (int f = 0; f < nf; ++f) {
      const int t = f0 + f;
      // α̂_{t−1} in prev (init at t = 0); each thread's raw_t in cur[j]
      const float* prev = (t & 1) ? abuf : vbuf;
      float* cur = (t & 1) ? vbuf : abuf;
      float sum = 0.f, unused = 0.f;
      for (int j = tid; j < S; j += nt) {
        float base;
        if (t == 0) {
          base = prev[j];
        } else if (!kGlobal) {
          base = 0.f;
#pragma unroll 32
          for (int i = 0; i < S; ++i) base = fmaf(prev[i], a_m[i * ldt_a + j], base);
        } else {
          // 32 reads of A from L2 in flight, then their FMAs in order (the
          // plain loop above, fine for shared memory, left each L2 read's
          // latency in the chain here: stats_variants.py k5_blk_plain_loop)
          base = 0.f;
          for (int i0 = 0; i0 < S; i0 += 32) {
            float av[32];
#pragma unroll
            for (int u = 0; u < 32; ++u) av[u] = i0 + u < S ? a_m[(i0 + u) * ldt_a + j] : 0.f;
#pragma unroll
            for (int u = 0; u < 32; ++u)
              if (i0 + u < S) base = fmaf(prev[i0 + u], av[u], base);
          }
        }
        const float raw = base * e_sh[f * S + j];
        cur[j] = raw;
        sum += raw;
      }
      block_sum_sum(sum, unused, red);  // also: every reader of prev is done
      pn = fmaxf(sum, FLT_MIN);
      const float inv = 1.f / pn;
      for (int j = tid; j < S; j += nt) {
        const float a = cur[j] * inv;
        cur[j] = a;
        al_b[static_cast<size_t>(t) * S + j] = a;
      }
      if (tid == 0) nrm[f] = pn;
      __syncthreads();  // α̂_t is complete before the next propagate reads it
    }
    __syncthreads();
    if (warp == 0) {
      const float v = lane < nf ? logf(nrm[lane]) + mxs[lane] : 0.f;
      if (lane < nf) n_b[f0 + lane] = nrm[lane];
      logz_acc += warp_sum(v);
    }
  }
  __syncthreads();
  const float* fin = (n_fire & 1) ? abuf : vbuf;  // α̂ of frame n_fire − 1 (init if none)
  for (int s = tid; s < S; s += nt) last[static_cast<size_t>(b) * S + s] = fin[s];
  if (tid == 0) logz[b] = logz_acc;
  for (size_t i = static_cast<size_t>(n_fire) * S + tid; i < static_cast<size_t>(T) * S; i += nt)
    al_b[i] = kShifts ? fin[i % S] : 0.f;
  for (int t = n_fire + tid; t < T; t += nt) {
    n_b[t] = 1.f;
    if (kShifts) shifts[static_cast<size_t>(b) * T + t] = 0.f;
  }
}

// The warp instance (S <= 32): kWarps utterances a block, one warp each.
template <bool kStats, bool kShifts>
__global__ void __launch_bounds__(kWarps * 32) forward_llh_warp_kernel(
    const float* __restrict__ x, const int* __restrict__ lens, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ trans, const float* __restrict__ init,
    float* __restrict__ alpha, float* __restrict__ norms, float* __restrict__ last, float* __restrict__ logz,
    float* __restrict__ shifts, int B, int T, int S, int P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldr = kStats ? static_cast<int>(round4(P)) : S, ldw = kStats ? static_cast<int>(round4(P)) + 1 : 0;
  const int row = kStats ? P : S;
  const int tid = threadIdx.x, warp = tid >> 5, j = tid & 31;
  float* w_sh = smem;                                                  // kStats: W, (S, ldw), zero past P
  float* mine = smem + (kStats ? round4(static_cast<size_t>(S) * ldw) : 0) +
                warp * (round4(2 * static_cast<size_t>(kChunk) * ldr) + kChunk * 33 + kChunk);
  float* ring = mine;                                                  // 2 × (kChunk, ldr), zero past P
  float* e_sh = ring + round4(2 * static_cast<size_t>(kChunk) * ldr);  // (kChunk, 33)
  float* mxs = e_sh + kChunk * 33;                                     // (kChunk,)
  if (kStats) {
    for (int i = tid; i < S * ldw; i += blockDim.x) {
      const int s = i / ldw, p = i - s * ldw;
      w_sh[i] = p < P ? w[s * P + p] : 0.f;
    }
  }
  const int b = blockIdx.x * kWarps + warp;
  if (b < B) {
    for (int i = j; i < 2 * kChunk * ldr; i += 32) ring[i] = 0.f;  // the columns past P stay 0
  }
  __syncthreads();
  if (b >= B) return;
  const unsigned full = 0xffffffffu;
  const bool on = j < S;
  const int len = lens[b];
  const int n_fire = kShifts ? min(max(len, 1), T) : len;
  const float* x_b = x + static_cast<size_t>(b) * T * row;
  float* al_b = alpha + static_cast<size_t>(b) * T * S;
  float* n_b = norms + static_cast<size_t>(b) * T;
  float a_col[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a_col[i] = on && i < S ? trans[i * S + j] : 0.f;
  const float bs = kStats && on ? bias[j] : 0.f;
  float carry = on ? init[static_cast<size_t>(b) * S + j] : 0.f;
  auto fetch = [&](int c) {
    float* dst = ring + (c & 1) * kChunk * ldr;
    const int f0 = c * kChunk, n = min(kChunk, T - f0);
    const float* src = x_b + static_cast<size_t>(f0) * row;
    for (int e = j; e < kChunk * row; e += 32) {
      const int f = e / row, q = e - f * row;
      cp_async4(dst + f * ldr + q, f < n ? src + e : x_b, f < n);
    }
    cp_async_commit();
  };
  const int n_chunks = (n_fire + kChunk - 1) / kChunk;
  if (n_chunks > 0) fetch(0);
  float logz_acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int f0 = c * kChunk, nf = min(kChunk, n_fire - f0);
    const bool more = c + 1 < n_chunks;
    __syncwarp();  // every lane's reads of stage (c + 1) & 1, e_sh and mxs are done
    if (more) fetch(c + 1);
    cp_async_wait(more);
    __syncwarp();
    const float* xc = ring + (c & 1) * kChunk * ldr;
    if (kStats) {
      float l[kChunk];
#pragma unroll
      for (int f = 0; f < kChunk; ++f) l[f] = 0.f;
      const float* wr = w_sh + (on ? j : 0) * ldw;
      for (int p = 0; p < ldr; p += 4) {  // the block instance's order: p ascending, then the bias
        const float w0 = wr[p], w1 = wr[p + 1], w2 = wr[p + 2], w3 = wr[p + 3];
#pragma unroll
        for (int f = 0; f < kChunk; ++f) {
          const float4 xv = *reinterpret_cast<const float4*>(xc + f * ldr + p);
          l[f] = fmaf(w3, xv.w, fmaf(w2, xv.z, fmaf(w1, xv.y, fmaf(w0, xv.x, l[f]))));
        }
      }
#pragma unroll
      for (int f = 0; f < kChunk; ++f)
        if (on && f < nf) e_sh[f * 33 + j] = l[f] + bs;
    } else {
      for (int f = 0; f < nf; ++f)
        if (on) e_sh[f * 33 + j] = kShifts && f0 + f >= len ? 0.f : xc[f * ldr + j];
    }
    __syncwarp();
    if (j < nf) {  // lane j: the row max of frame j of the chunk
      float m = -FLT_MAX;
      for (int s = 0; s < S; ++s) m = fmaxf(m, e_sh[j * 33 + s]);
      mxs[j] = m;
      if (kShifts) shifts[static_cast<size_t>(b) * T + f0 + j] = m;
    }
    __syncwarp();
    if (on)
      for (int f = 0; f < nf; ++f) e_sh[f * 33 + j] = expf(e_sh[f * 33 + j] - mxs[f]);
    __syncwarp();
    float my_norm = 1.f;
    for (int f = 0; f < nf; ++f) {
      const int t = f0 + f;
      float base;
      if (t == 0) {
        base = carry;
      } else {
        // all 32 lanes (carry and A are 0 past S): no branch between the
        // shuffles, which a test of i < S serialised
        float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) q[i & 3] = fmaf(__shfl_sync(full, carry, i), a_col[i], q[i & 3]);
        base = (q[0] + q[1]) + (q[2] + q[3]);
      }
      const float raw = on ? base * e_sh[f * 33 + j] : 0.f;
      const float norm = fmaxf(warp_sum(raw), FLT_MIN);
      carry = raw * (1.f / norm);  // a reciprocal: no division's slow path in the chain
      if (on) al_b[static_cast<size_t>(t) * S + j] = carry;
      if (j == f) my_norm = norm;
    }
    if (j < nf) n_b[f0 + j] = my_norm;
    logz_acc += warp_sum(j < nf ? logf(my_norm) + mxs[j] : 0.f);
  }
  if (on) last[static_cast<size_t>(b) * S + j] = carry;
  if (j == 0) logz[b] = logz_acc;
  for (int t = n_fire; t < T; ++t)
    if (on) al_b[static_cast<size_t>(t) * S + j] = kShifts ? carry : 0.f;
  for (int t = n_fire + j; t < T; t += 32) {
    n_b[t] = 1.f;
    if (kShifts) shifts[static_cast<size_t>(b) * T + t] = 0.f;
  }
}

// ---------------------------------------------------------------------
// K6 — accumulating dense v-space backward, and K7 — the γ-emitting one.
// K6 replaces beer_tpu/ops/pallas_scan.py _make_estep_ckpt_acc_kernel_lm
// (wrapper phone_loop_estep_ckpt_acc_lm with bands=None, trans=(S, S),
// full ξ, fused ELLH, stored α̂); K7 replaces _make_estep_ckpt_kernel_lm
// (wrapper phone_loop_estep_ckpt_pass_lm with bands=None, trans=(S, S),
// full ξ; α̂ is read from K5 instead of recomputed from checkpoints).
//
// Walking t from len−1 down to 0: u1 = final_b at the last frame,
// otherwise u1_i = Σ_j A(i, j) v̂_{t+1}(j); v = e·u1; v̂ = v / max(Σv,
// FLT_MIN); γ = α̂·u1 / max(Σ α̂·u1, FLT_MIN); wgt = 1 / (norm·Σ(α̂u1)/Σv)
// (0 below the ξ floor); ξ_raw(i, j) += α̂_t(i)·wgt_{t+1}·v̂_{t+1}(j).  The
// expected transition counts are ξ_raw ⊙ A, applied by the caller.  K6
// computes llh = W·stats + bias in the kernel and reduces γ to acc (S, P+1)
// = Σ γ ⊗ [stats, 1] (written state-minor, as (P + 1, S)) plus γ₀; K7
// (kGamma) reads the llh stream and writes γ per frame (0 on frames t >=
// len).  K15 (K7 with rows and columns, replacing _make_estep_kernel,
// wrapper phone_loop_estep_pass) accumulates ξ_raw only on the block
// [rows][:, cols], (n_r, n_c), by an exact gather of α̂_t[rows] and
// v̂_{t+1}[cols] (no one-hot product): K7 gathers with the identity.
//
// What bounds it on the H100 is the serial chain, so, as in K5 and K2,
// the chain keeps only what depends on the carry.  Frames go in chunks
// from each utterance's end, chunk c + 1's statistics and α̂ arriving by
// cp.async into a two-stage ring while chunk c is worked on; the ELLH, the
// row max and e = exp(llh − max) of a chunk are computed before its chain;
// the moments (Γᵀ·[X, 1]) and ξ (Σ_f α̂_t·wgt_{t+1} ⊗ v̂_{t+1}) are
// register-tiled products over the chunk's frames after it, each
// accumulator element read and written once a chunk.  The carry v is kept
// unnormalised, with 1/Σv beside it, so that a step normalises nothing.
// Two instances, chosen by fit in one place (cuda_scan.backward_instance):
//   "warp" (S <= 32 while its block fits): the dense mode of
//       acc_chunks.cuh, K2's kernel — n_utt utterances a block, each chain
//       on one warp, lane i holding row i of A in registers, v_{t+1}(j)
//       coming by __shfl_sync, Σv and Σα̂u1 in one shuffle tree (no barrier
//       in the chain), and all the block's warps on the ELLH and the
//       products;
//   "block" (every larger S, both placements; chunks of the most of 16, 8,
//       4, 2, 1 frames that fit): one block an utterance, threads over
//       states, one block reduction (Σv and Σα̂u1) a step; its fetch, row
//       max, per-frame factors, products, γ write and carry are
//       acc_chunks.cuh's helpers, so only its ELLH and chain are its own.
//       "shared" keeps A, W, the moments and ξ in shared memory, "global"
//       reads Aᵀ and Wᵀ from device memory (32 reads of A in flight, as
//       K5) and keeps the moments and ξ in the utterance's row of `part`.
// K6's instance comes from cuda_scan.backward_instance, K7's and K15's
// from cuda_scan.gamma_instance.
// The rows are summed over the batch by sum_rows_kernel in a fixed order,
// so two calls agree bitwise.
// ---------------------------------------------------------------------
constexpr int kAccChunkBlock = 16;  // the block instance: frames a chunk, at most

// The ring's stages at `chunk` frames a chunk: two, so that the next chunk
// arrives while this one is worked on, but one in the global placement at
// a one-frame chunk, which only the largest S take (there the next frame
// is fetched after the products; the freed stage lets K7's global block
// run to S = 14,508, where two stages stopped it at 9,672).
__host__ __device__ inline int acc_block_stages(bool global, int chunk) { return global && chunk == 1 ? 1 : 2; }

// Floats of one block of the block instance in a placement, at `chunk`
// frames a chunk: K6 (p > 0, ξ (S, S): n_r = n_c = S) or K7 / K15 (p = 0,
// the llh stream; ξ (n_r, n_c), from gathered rows and columns when
// `gather`, K15).
size_t acc_block_smem_floats(int s, int p, int n_r, int n_c, bool gather, bool global, int chunk) {
  const size_t S = s, C = chunk, ldg = round4(S), ldx = p > 0 ? round4(p) : ldg;
  size_t n = (p > 0 ? 2 * ldg : 0) + acc_block_stages(global, chunk) * C * (ldx + ldg) + (C + 1) * ldg +
             (p > 0 ? C * ldg : 0) + round4(5 * C + 2) + 2 * kMaxWarps;
  if (gather) n += C * (round4(n_r) + round4(n_c)) + round4(static_cast<size_t>(n_r) + n_c);
  if (!global) {
    n += round4(S * odd_stride(s)) + static_cast<size_t>(n_r) * round4(n_c);
    if (p > 0) n += round4(S * odd_stride(p)) + S * round4(p + 1);
  }
  return n;
}

// The block instance: one block an utterance.  kFull: chunks of
// kAccChunkBlock frames, a constant; otherwise `chunk` frames.  kGamma: K7
// and K15.  kOneStage: the ring's one stage (acc_block_stages), an
// instance of its own so that the others compile as they did without it.
template <bool kGlobal, bool kFull, bool kGamma, bool kOneStage = false>
__global__ void __launch_bounds__(1024, 1) estep_acc_dense_block_kernel(
    const float* __restrict__ stats,   // (B, T, P); kGamma: llh (B, T, S)
    const int* __restrict__ lens,      // (B,)
    const float* __restrict__ w,       // (S, P), kGlobal: Wᵀ (P, S) (not kGamma)
    const float* __restrict__ bias,    // (S,) (not kGamma)
    const float* __restrict__ trans,   // (S, S), kGlobal: Aᵀ
    const float* __restrict__ final_,  // (B, S)
    const float* __restrict__ alpha,   // (B, T, S)
    const float* __restrict__ norms,   // (B, T)
    const int* __restrict__ rows,      // kGamma: (n_r,) ξ rows (K15); null: every state (K7)
    const int* __restrict__ cols,      // kGamma: (n_c,) ξ columns (K15); null: every state (K7)
    float* __restrict__ part,          // (B, (P+1)*S + S*S); kGamma: (B, n_r*n_c)
    float* __restrict__ gamma0,        // (B, S) (not kGamma)
    float* __restrict__ gamma,         // (B, T, S) (kGamma)
    int T, int S, int P, int n_r, int n_c, int chunk) {
  const int C = kFull ? kAccChunkBlock : chunk;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldg = static_cast<int>(round4(S)), ldx = kGamma ? ldg : static_cast<int>(round4(P));
  const int lda = static_cast<int>(round4(P + 1));
  const int ldt = odd_stride(S), ldw = odd_stride(P);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  // K6's ξ is (S, S); the layout below is K6's, K7's buffers are placed apart
  const int nr = kGamma ? n_r : S, nc = kGamma ? n_c : S;
  const int ldr = static_cast<int>(round4(nr)), ldc = kGamma ? static_cast<int>(round4(nc)) : ldg;
  const int n_acc = kGamma ? 0 : S * (P + 1);
  const bool gather = kGamma && rows != nullptr;  // K15: ξ's rows and columns gathered
  float* out = part + static_cast<size_t>(b) * (n_acc + nr * nc);
  float* bias_sh = smem;                                         // K6: (ldg,)
  float* fin_sh = bias_sh + ldg;                                 // K6: (ldg,)
  float* ring = kGamma ? smem : fin_sh + ldg;  // 2 (kOneStage: 1) × (stats or llh (C, ldx), α̂ (C, ldg))
  // (C + 1, ldg): e, then v; row C: v after the chunk
  float* e_sh = ring + (kOneStage ? 1 : 2) * static_cast<size_t>(C) * (ldx + ldg);
  float* g_buf = e_sh + static_cast<size_t>(C + 1) * ldg;         // K6: (C, ldg): α̂u1 (K7: in the chunk's llh stage)
  float* sc = kGamma ? g_buf : g_buf + static_cast<size_t>(C) * ldg;  // 5C + 2 scalars (acc_chunks.cuh)
  float* red = sc + round4(5 * static_cast<size_t>(C) + 2);
  float* a_sh = red + 2 * kMaxWarps;                              // shared: A (S, ldt)
  float* l_sh = a_sh;                                             // gather: L = α̂_t[rows] (C, ldr)
  float* r_sh = l_sh + static_cast<size_t>(C) * ldr;              // gather: R = v_{t+1}[cols] (C, ldc)
  int* rows_sh = reinterpret_cast<int*>(r_sh + static_cast<size_t>(C) * ldc);  // gather
  int* cols_sh = rows_sh + nr;
  if (gather) a_sh = reinterpret_cast<float*>(rows_sh) + round4(static_cast<size_t>(nr) + nc);
  float* w_sh = a_sh + round4(static_cast<size_t>(S) * ldt);      // shared: W (S, ldw)
  float* acc_sh = w_sh + (kGamma ? 0 : round4(static_cast<size_t>(S) * ldw));  // shared: moments (S, lda)
  float* xi_sh = acc_sh + (kGamma ? 0 : static_cast<size_t>(S) * lda);         // shared: ξ (nr, ldc)
  // A(i, j) = a_m[i·a_rs + j·a_cs], W(s, p) = w_m[s·w_rs + p·w_cs], the moments
  // acc(s, p) = acc_m[s·acc_rs + p·acc_cs], ξ(i, j) = xi_m[i·xi_rs + j]
  const float* a_m = kGlobal ? trans : a_sh;
  const float* w_m = kGlobal ? w : w_sh;
  float* acc_m = kGlobal ? out : acc_sh;
  float* xi_m = kGlobal ? out + n_acc : xi_sh;
  const int a_rs = kGlobal ? 1 : ldt, a_cs = kGlobal ? S : 1;
  const int w_rs = kGlobal ? 1 : ldw, w_cs = kGlobal ? S : 1;
  const int acc_rs = kGlobal ? 1 : lda, acc_cs = kGlobal ? S : 1, xi_rs = kGlobal ? nc : ldc;
  const int len = lens[b];
  auto span = [&](int c, int& lo) {
    const int hi = len - 1 - c * C;
    lo = max(hi - C + 1, 0);
    return hi - lo + 1;
  };
  auto fetch = [&](int c) {
    int lo;
    const int nf = span(c, lo);
    float* xs = ring + (kOneStage ? 0 : c & 1) * static_cast<size_t>(C) * (ldx + ldg);
    acc_fetch(xs, xs + static_cast<size_t>(C) * ldx, stats, alpha, static_cast<size_t>(b) * T + lo, nf, C, ldx, ldg,
              kGamma ? S : P, S, tid, nt);
    cp_async_commit();
  };
  const int n_chunks = (len + C - 1) / C;
  if (n_chunks > 0) fetch(0);
  if (!kGlobal) {
    for (int i = tid; i < S * S; i += nt) {
      const int r = i / S;
      a_sh[r * ldt + (i - r * S)] = trans[i];
    }
    for (int i = tid; i < (kGamma ? 0 : S * P); i += nt) {
      const int s = i / P;
      w_sh[s * ldw + (i - s * P)] = w[i];
    }
  }
  // every accumulator element belongs to one 4 × 4 tile, so to one thread
  for (int i = tid; i < (kGlobal ? n_acc + nr * nc : (kGamma ? 0 : S * lda) + nr * ldc); i += nt)
    (kGlobal ? out : acc_sh)[i] = 0.f;
  for (int s = tid; s < (kGamma ? 0 : ldg); s += nt) {
    bias_sh[s] = s < S ? bias[s] : 0.f;
    fin_sh[s] = s < S ? final_[static_cast<size_t>(b) * S + s] : 0.f;
  }
  for (size_t i = tid; i < static_cast<size_t>(kGamma ? C + 1 : 2 * C + 1) * ldg + 5 * C + 2; i += nt) e_sh[i] = 0.f;
  if (gather) {  // L and R (padding columns stay 0), the ξ rows and columns
    for (size_t i = tid; i < static_cast<size_t>(C) * (ldr + ldc); i += nt) l_sh[i] = 0.f;
    for (int i = tid; i < nr; i += nt) rows_sh[i] = rows[i];
    for (int i = tid; i < nc; i += nt) cols_sh[i] = cols[i];
  }
  float ip = 0.f;  // 1/Σv of the frame after the current one

  for (int c = 0; c < n_chunks; ++c) {
    int lo;
    const int nf = span(c, lo);
    const bool more = c + 1 < n_chunks;
    __syncthreads();  // chunk c − 1 is done with stage (c + 1) & 1, e, γ and the scalars
    if (more && !kOneStage) fetch(c + 1);
    cp_async_wait(more && !kOneStage);
    __syncthreads();  // chunk c has landed
    const float* xc = ring + (kOneStage ? 0 : c & 1) * static_cast<size_t>(C) * (ldx + ldg);
    float* ac = const_cast<float*>(xc) + static_cast<size_t>(C) * ldx;
    // α̂u1: K7 writes it over the chunk's llh, which e has replaced by then
    float* g_sh = kGamma ? const_cast<float*>(xc) : g_buf;
    // 1. llh = W·stats + bias of the chunk's frames, a state a thread (K5's order; kGamma: llh was read)
    for (int s = tid; s < (kGamma ? 0 : S); s += nt) {
      const float* wr = w_m + s * w_rs;
      if (kFull) {
        float l[kAccChunkBlock];
#pragma unroll
        for (int f = 0; f < kAccChunkBlock; ++f) l[f] = 0.f;
        for (int p = 0; p < P; ++p) {
          const float wv = wr[p * w_cs];
#pragma unroll
          for (int f = 0; f < kAccChunkBlock; ++f) l[f] = fmaf(wv, xc[f * ldx + p], l[f]);
        }
#pragma unroll
        for (int f = 0; f < kAccChunkBlock; ++f)
          if (f < nf) e_sh[f * ldg + s] = l[f] + bias_sh[s];
      } else {
        for (int f = 0; f < nf; ++f) {
          float l = 0.f;
          for (int p = 0; p < P; ++p) l = fmaf(wr[p * w_cs], xc[f * ldx + p], l);
          e_sh[f * ldg + s] = l + bias_sh[s];
        }
      }
    }
    if (!kGamma) __syncthreads();
    for (int f = warp; f < nf; f += nt >> 5)
      acc_exp_row(e_sh + static_cast<size_t>(f) * ldg, (kGamma ? xc : e_sh) + static_cast<size_t>(f) * ldg, S, lane);
    __syncthreads();
    // 2. the chain: one block reduction a step; K7 scales v_{t+1} by ip as it
    //    reads it (a normalised carry, as the warp instance's)
    for (int f = nf - 1; f >= 0; --f) {
      const bool last = lo + f == len - 1;
      const float* vn = e_sh + static_cast<size_t>(f == nf - 1 ? C : f + 1) * ldg;  // v_{t+1}
      float sv = 0.f, sa = 0.f;
      for (int i = tid; i < S; i += nt) {
        float u1;
        if (last) {
          u1 = kGamma ? final_[static_cast<size_t>(b) * S + i] : fin_sh[i];
        } else if (!kGlobal) {
          const float* ar = a_m + i * a_rs;
          u1 = 0.f;
#pragma unroll 32
          for (int k = 0; k < S; ++k) u1 = fmaf(ar[k], kGamma ? vn[k] * ip : vn[k], u1);
          u1 *= kGamma ? 1.f : ip;
        } else {
          u1 = 0.f;  // 32 reads of A from L2 in flight, then their FMAs in order (K5)
          for (int k0 = 0; k0 < S; k0 += 32) {
            float av[32];
#pragma unroll
            for (int q = 0; q < 32; ++q) av[q] = k0 + q < S ? a_m[i * a_rs + (k0 + q) * a_cs] : 0.f;
#pragma unroll
            for (int q = 0; q < 32; ++q)
              if (k0 + q < S) u1 = fmaf(av[q], kGamma ? vn[k0 + q] * ip : vn[k0 + q], u1);
          }
          u1 *= kGamma ? 1.f : ip;
        }
        const float v = e_sh[f * ldg + i] * u1, a = ac[f * ldg + i] * u1;
        e_sh[f * ldg + i] = v;
        g_sh[f * ldg + i] = a;
        sv += v;
        sa += a;
      }
      block_sum_sum(sv, sa, red);  // also: every reader of v_{t+1} is done
      ip = 1.f / fmaxf(sv, FLT_MIN);
      if (tid == 0) {
        sc[f] = sv;
        sc[C + f] = sa;
      }
    }
    __syncthreads();
    // 3. 1/Σα̂u1, wgt_{t+1} and 1/Σv_{t+1} a frame; K15: the gathers L =
    //    α̂_t[rows] and R = v_{t+1}[cols] (row f + 1 of e, row C for the last frame)
    for (int f = tid; f < nf; f += nt)
      acc_frame_factors(sc, C, f, nf, lo + f == len - 1, norms + static_cast<size_t>(b) * T + lo + f + 1);
    for (int i = tid; i < (gather ? nf * nr : 0); i += nt) {
      const int f = i / nr, k = i - f * nr;
      l_sh[f * ldr + k] = ac[f * ldg + rows_sh[k]];
    }
    for (int i = tid; i < (gather ? nf * nc : 0); i += nt) {
      const int f = i / nc, k = i - f * nc;
      r_sh[f * ldc + k] = e_sh[static_cast<size_t>(f == nf - 1 ? C : f + 1) * ldg + cols_sh[k]];
    }
    __syncthreads();
    // 4. moments += Γᵀ·[X, 1] (kGamma: γ written out instead) and ξ += Σ_f (α̂·wgt_{t+1}) ⊗
    //    (v_{t+1}/Σv_{t+1}); v_{t+1} is row f + 1 of e, row C (the carry) for the chunk's last frame
    if (kGamma) acc_write_gamma(gamma + (static_cast<size_t>(b) * T + lo) * S, g_sh, sc + 2 * C, nf, S, ldg, tid, nt);
    const AccChunkView view = gather ? AccChunkView{g_sh, xc, sc + 2 * C, l_sh, r_sh,
                                                    r_sh + static_cast<size_t>(nf - 1) * ldc, sc + 3 * C, sc + 4 * C,
                                                    ldr, ldc, nf}
                                     : AccChunkView{g_sh, xc, sc + 2 * C, ac, e_sh + ldg,
                                                    e_sh + static_cast<size_t>(C) * ldg, sc + 3 * C, sc + 4 * C, ldg,
                                                    ldg, nf};
    acc_products<!kGamma>(acc_m, acc_rs, acc_cs, xi_m, xi_rs, S, P, nr, nc, ldg, ldx, 1,
                          [&](int) { return view; }, tid, nt);
    __syncthreads();  // ξ's readers of row C (kOneStage: every reader of the stage) are done
    if (more && kOneStage) fetch(c + 1);
    // 5. γ₀ (not kGamma), and the carry into the next chunk
    acc_next_chunk<!kGamma>(e_sh, sc, g_sh, gamma0 + static_cast<size_t>(b) * S, lo, C, ldg, S,
                            norms + static_cast<size_t>(b) * T + lo, tid, nt);
  }
  __syncthreads();
  if (!kGlobal) acc_write_row(out, acc_sh, lda, xi_sh, ldc, S, P, nr, nc, true, !kGamma, tid, nt);
  if (kGamma) {
    acc_zero_tail(gamma + static_cast<size_t>(b) * T * S, len, T, S, tid, nt);
  } else if (len == 0) {
    for (int s = tid; s < S; s += nt) gamma0[static_cast<size_t>(b) * S + s] = 0.f;
  }
}

// The kernels of one entry point, shared and global placement.
template <typename Kernel, typename... Args>
cudaError_t launch_placed(bool global, Kernel shared_kernel, Kernel global_kernel, size_t smem, int B, int S,
                          cudaStream_t st, Args... args) {
  const Kernel kernel = global ? global_kernel : shared_kernel;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, block_threads(kernel, S), smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// global != 0: the global placement (see the note at the top).  The
// forward's instance: 0 block (shared placement), 1 block (global), 2 warp.
size_t beer_dense_forward_smem_bytes(int s, int p, int instance, int chunk) {
  return dense_forward_smem_floats(s, p, instance, chunk) * sizeof(float);
}

// K6 in an instance (0 block, shared placement; 1 block, global; 2 warp)
// at `chunk` frames a chunk, n_utt utterances a block (the warp instance).
size_t beer_acc_dense_smem_bytes(int s, int p, int instance, int chunk, int n_utt) {
  return (instance == 2 ? acc_layout(s, p, s, s, n_utt, chunk, false).total
                        : acc_block_smem_floats(s, p, s, s, false, instance == 1, chunk)) *
         sizeof(float);
}

// K7 (restricted = 0, n_r = n_c = S) and K15 (ξ (n_r, n_c) at gathered rows
// and columns) in an instance, as K6's.
size_t beer_gamma_dense_smem_bytes(int s, int n_r, int n_c, int restricted, int instance, int chunk, int n_utt) {
  return (instance == 2 ? acc_layout(s, 0, n_r, n_c, n_utt, chunk, false).total
                        : acc_block_smem_floats(s, 0, n_r, n_c, restricted != 0, instance == 1, chunk)) *
         sizeof(float);
}

}  // extern "C"

namespace {

// K5 / K14 in the given instance (chunk: the block instance's frames a
// chunk); P > 0: the stats stream (K5 only).
template <bool kStats, bool kShifts>
cudaError_t launch_forward(int instance, int chunk, const float* x, const int* lens, const float* w,
                           const float* bias, const float* trans, const float* init, float* alpha, float* norms,
                           float* last, float* logz, float* shifts, int B, int T, int S, int P, cudaStream_t st) {
  if (instance < 0 || instance > 2 || (instance == 2 && S > 32) || (instance < 2 && (chunk < 1 || chunk > kChunkBlock)))
    return cudaErrorInvalidValue;
  const size_t smem = dense_forward_smem_floats(S, P, instance, chunk) * sizeof(float);
  if (instance == 2) {
    auto kernel = forward_llh_warp_kernel<kStats, kShifts>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, smem, st>>>(x, lens, w, bias, trans, init, alpha, norms, last,
                                                                 logz, shifts, B, T, S, P);
    return cudaGetLastError();
  }
  const bool full = chunk == kChunkBlock;
  return launch_placed(instance == 1,
                       full ? forward_llh_dense_kernel<kStats, kShifts, false, true>
                            : forward_llh_dense_kernel<kStats, kShifts, false, false>,
                       full ? forward_llh_dense_kernel<kStats, kShifts, true, true>
                            : forward_llh_dense_kernel<kStats, kShifts, true, false>,
                       smem, B, S, st, x, lens, w, bias, trans, init, alpha, norms, last, logz, shifts, T, S, P, chunk);
}

}  // namespace

extern "C" {

// P > 0: x is the stats stream and w/bias give llh (w is Wᵀ (P, S) in the
// global placement); P == 0: x is llh.  instance and chunk as for the
// smem size.
int beer_forward_llh_dense(int device, int instance, int chunk, const float* x, const int* lens, const float* w,
                           const float* bias, const float* trans, const float* init, float* alpha, float* norms,
                           float* last, float* logz, int B, int T, int S, int P, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || B == 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P > 0)
    return launch_forward<true, false>(instance, chunk, x, lens, w, bias, trans, init, alpha, norms, last, logz,
                                       nullptr, B, T, S, P, st);
  return launch_forward<false, false>(instance, chunk, x, lens, w, bias, trans, init, alpha, norms, last, logz,
                                      nullptr, B, T, S, 0, st);
}

// K14: the llh stream, with the row-max shifts written out and the carry
// copied through frames t >= len.
int beer_forward_llh_shifts_dense(int device, int instance, int chunk, const float* llh, const int* lens,
                                  const float* trans, const float* init, float* alpha, float* norms, float* last,
                                  float* logz, float* shifts, int B, int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || B == 0) return err;
  return launch_forward<false, true>(instance, chunk, llh, lens, nullptr, nullptr, trans, init, alpha, norms, last,
                                     logz, shifts, B, T, S, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

namespace {

// K6 (kGamma false) or K7 / K15 (kGamma) in an instance (0 block shared,
// 1 block global, 2 warp) at `chunk` frames a chunk, n_utt utterances a
// block (warp); part has a row a block, out = Σ of its rows.
template <bool kGamma>
cudaError_t launch_backward(int instance, int chunk, int n_utt, const float* x, const int* lens, const float* w,
                            const float* bias, const float* trans, const float* final_, const float* alpha,
                            const float* norms, const int* rows, const int* cols, float* part, float* out,
                            float* gamma0, float* gamma, int B, int T, int S, int P, int n_r, int n_c,
                            cudaStream_t st) {
  if (instance == 2)
    return launch_acc_chunked<true, kGamma>(0, n_utt, chunk, x, lens, w, bias, nullptr, trans, final_, alpha, norms,
                                            rows, cols, part, out, gamma0, gamma, B, T, S, P, n_r, n_c, st);
  if (instance < 0 || instance > 1 || chunk < 1 || chunk > kAccChunkBlock) return cudaErrorInvalidValue;
  const size_t smem =
      acc_block_smem_floats(S, kGamma ? 0 : P, n_r, n_c, rows != nullptr, instance == 1, chunk) * sizeof(float);
  const bool full = chunk == kAccChunkBlock;
  auto kernel = instance == 1 ? (full            ? estep_acc_dense_block_kernel<true, true, kGamma>
                                 : chunk == 1 ? estep_acc_dense_block_kernel<true, false, kGamma, true>
                                              : estep_acc_dense_block_kernel<true, false, kGamma>)
                              : (full ? estep_acc_dense_block_kernel<false, true, kGamma>
                                      : estep_acc_dense_block_kernel<false, false, kGamma>);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // threads over the states, and at least 256 for the chunk's products
  if (B > 0) {
    kernel<<<B, block_threads(kernel, S > 256 ? S : 256), smem, st>>>(x, lens, w, bias, trans, final_, alpha, norms,
                                                                       rows, cols, part, gamma0, gamma, T, S, P, n_r,
                                                                       n_c, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n = (kGamma ? 0 : S * (P + 1)) + n_r * n_c;
  if (n > 0) sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, B, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6 in an instance (0 block shared, 1 block global, 2 warp) at `chunk`
// frames a chunk; the warp instance runs n_utt utterances a block.  trans is
// Aᵀ and w is Wᵀ (P, S) in the global placement; part has one row an
// utterance (block) or a block of n_utt utterances (warp), (P+1)·S + S·S
// wide; out = Σ of its rows: the moments (P + 1, S), then ξ_raw (S, S).
int beer_estep_acc_dense(int device, int instance, int chunk, int n_utt, const float* stats, const int* lens,
                         const float* w, const float* bias, const float* trans, const float* final_,
                         const float* alpha, const float* norms, float* part, float* out, float* gamma0, int B,
                         int T, int S, int P, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_backward<false>(instance, chunk, n_utt, stats, lens, w, bias, trans, final_, alpha, norms, nullptr,
                                nullptr, part, out, gamma0, nullptr, B, T, S, P, S, S,
                                static_cast<cudaStream_t>(stream));
}

// K7 (rows = cols = null: ξ over all S states, n_r = n_c = S) and K15 (ξ
// restricted to [rows][:, cols], (n_r, n_c)) in an instance, as K6; trans is
// Aᵀ in the global placement; part has n_r·n_c floats a row (an utterance,
// or a block of n_utt utterances); out (n_r, n_c) = Σ of its rows; gamma
// (B, T, S).
int beer_estep_gamma_dense(int device, int instance, int chunk, int n_utt, const float* llh, const int* lens,
                           const float* trans, const float* final_, const float* alpha, const float* norms,
                           const int* rows, const int* cols, float* part, float* out, float* gamma, int B, int T,
                           int S, int n_r, int n_c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_backward<true>(instance, chunk, n_utt, llh, lens, nullptr, nullptr, trans, final_, alpha, norms,
                               rows, cols, part, out, nullptr, gamma, B, T, S, 0, n_r, n_c,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
