// Phone-loop scan kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by beer_tpu_torch/ops/cuda_scan.py.
//
// Four kernels carry the phone-loop AUD main path: the scaled banded
// forward (VB-EM E-step, part 1), the accumulating v-space backward
// (E-step, part 2), and the banded (max,+) Viterbi forward and its
// backtrace (decode).  A fifth, the γ-emitting twin of the backward,
// carries the structured VAE's gradient (the Fisher identity ∂log Z /
// ∂llh = γ); it runs the backward frame by frame, K1 and K2 in chunks.
// Each replaces one Pallas TPU kernel of beer_tpu/ops/pallas_scan.py; the
// note above each kernel names it.
//
// Common design.  Every kernel is a serial recursion over time with an
// O(S) step: the transition matrix of a phone loop is band + rank-1
// (self loop, advance, exit ⊗ entry), so a step is a few elementwise
// passes plus reductions over the S states.  What bounds these
// recursions on an H100 is the latency of the serial chain, not bytes
// or FLOPs.  K3, K4 and K11 spread the batch: one thread block per
// utterance (B = 512 blocks over 132 SMs), threads over states in a
// strided loop (any S), and a loop over t < len_b inside the block, so
// the chains of several utterances overlap on each SM; a step needs two
// block reductions.  K1 and K2 go further: frames in chunks, the chain on
// one warp an utterance with no barrier, everything that does not depend
// on the carry out of the chain (their notes below).  Loop-invariant operands
// (the ELLH matrix W, bias, bands) live in shared memory while they fit
// a block; above that K1, K2 and K11 read Wᵀ from device memory (it stays
// in L2) and keep their accumulators in device memory, one thread an
// element (cuda_scan.banded_placement), so every phone loop runs.
// Every reduction is computed in a fixed order and broadcast to all
// threads, so the kernels are deterministic run to run.
//
// Masks are prefix masks rebuilt from per-utterance lengths; an
// utterance of length 0 contributes nothing to any sum.

#include "acc_chunks.cuh"
#include "scan_common.cuh"

namespace {

// K11: W and the (U, U) ξ accumulator in shared memory unless global.
size_t gamma_smem_floats(int s, int p, int u, bool global) {
  return (global ? 0 : static_cast<size_t>(s) * odd_stride(p) + static_cast<size_t>(u) * u) +
         11 * static_cast<size_t>(s) + p + 2 * static_cast<size_t>(u) + 2 * kMaxWarps;
}

// ---------------------------------------------------------------------
// K1 — scaled banded forward with in-kernel ELLH.
// Replaces beer_tpu/ops/pallas_scan.py _make_fwd_llh_ckpt_kernel_lm
// (wrapper forward_llh_ckpt_pass_lm, store_alpha=True).
// Per step: llh_t = W·stats_t + bias, row max, e = exp(llh − max),
// propagate p·a_self + shift_down(p·a_adv) + (p·exit)·w (the first frame
// uses init), norm = max(Σ, FLT_MIN), α̂ = raw / norm, logz_base += log
// norm + max.  Frames t >= len get α̂ = 0 and norm = 1; an empty row keeps
// last = init and logz_base = 0.
//
// What bounds it on the H100 is the serial chain, so, as in K2 (the
// backward twin, acc_chunks.cuh) and K5, the chain keeps only what depends
// on the carry.  Frames go in chunks of C from frame 0: chunk c + 1's
// statistics arrive by cp.async into a two-stage ring while chunk c is
// worked on.  A chunk is three phases between barriers:
//   1. the ELLH of all its frames (acc_ellh_tile, K2's register tiles of 8
//      frames a state), then, a warp a frame, the row max and e = exp(llh
//      − max) (acc_exp_row);
//   2. the chain, on one warp an utterance with no barrier: states
//      strided over the lanes, each reading the previous frame's raw row
//      (row f − 1 of the chunk, row C for the chunk's first frame) from
//      shared memory — state s reads s − 1 there, across lane boundaries —
//      and scaling it by ip = 1/norm of that frame as it reads it, so the
//      propagate takes α̂_{t−1} exactly as the plain version; raw = base·e
//      goes into the chunk's e row in place; one shuffle tree a step gives
//      Σraw and Σraw·exit, so the next step's q = Σα̂·exit is
//      (Σraw·exit)·ip.  The norms are the chain's own Σraw (emitted per
//      frame, never rebuilt from differences of log-scales);
//   3. α̂ = raw·ip of the chunk's frames (the product the chain used),
//      written coalesced by the whole block, the norms, log Z's terms
//      (log norm + max, a warp sum a chunk), `last`, and the carry row.
// A block runs n_utt utterances (their chains on warps 0 .. n_utt − 1 at
// once).  Two placements (kGlobal): W (S, P) in shared memory, or Wᵀ
// (round4(P), S) read from device memory (it stays in L2); the wrapper
// picks the placement, n_utt and C by fit (cuda_scan.forward_banded_geometry),
// two blocks an SM where they fit (64 registers a thread, as K2).
// kFull: C = kAccChunk, a constant.
// ---------------------------------------------------------------------
constexpr int kFwdGroup = kAccGroup;  // K1's ELLH: frames a tile item

struct FwdLayout {  // float offsets into one K1 block's shared memory
  size_t w, bands, utt, per_utt, total;
  int ldx, ldg;
};

__host__ __device__ inline FwdLayout fwd_layout(int S, int P, int n_utt, int C, bool global) {
  FwdLayout l;
  l.ldx = static_cast<int>(round4(P));
  l.ldg = static_cast<int>(round4(S));
  size_t o = 0;
  l.w = o;  // W (S, ldx + 1), zero past P
  if (!global) o += round4(static_cast<size_t>(S) * (l.ldx + 1));
  l.bands = o;  // (a_self, a_adv of the state before, exit, w) a float4 a state
  o += 4 * static_cast<size_t>(l.ldg);
  l.utt = o;
  l.per_utt = 2 * static_cast<size_t>(C) * l.ldx        // ring: 2 × stats (C, ldx)
              + static_cast<size_t>(C + 1) * l.ldg    // llh, e, then raw; row C: raw of the frame before the chunk
              + round4(3 * static_cast<size_t>(C));    // per frame: norm, row max, 1/norm
  o += static_cast<size_t>(n_utt) * l.per_utt;
  l.total = o;
  return l;
}

template <bool kGlobal, bool kFull>
__global__ void __launch_bounds__(kAccThreads, 2) forward_llh_chunked_kernel(
    const float* __restrict__ stats,  // (B, T, P)
    const int* __restrict__ lens,     // (B,)
    const float* __restrict__ w,      // (S, P), kGlobal: Wᵀ padded with zero rows to (round4(P), S)
    const float* __restrict__ bias,   // (S,)
    const float* __restrict__ bands,  // (4, S): a_self, a_adv, exit, w
    const float* __restrict__ init,   // (S,)
    float* __restrict__ alpha,        // (B, T, S)
    float* __restrict__ norms,        // (B, T)
    float* __restrict__ last,         // (B, S)
    float* __restrict__ logz,         // (B,)
    int B, int T, int S, int P, int n_utt, int chunk) {
  const int C = kFull ? kAccChunk : chunk;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const FwdLayout L = fwd_layout(S, P, n_utt, C, kGlobal);
  const int ldx = L.ldx, ldg = L.ldg, ldw = ldx + 1;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31, n_warps = nt >> 5;
  const int b0 = blockIdx.x * n_utt;
  float* w_sh = smem + L.w;
  float4* band_sh = reinterpret_cast<float4*>(smem + L.bands);  // one 16-byte read a state in the chain
  // W(s, p) = w_m[s·w_rs + p·w_cs]
  const float* w_m = kGlobal ? w : w_sh;
  const int w_rs = kGlobal ? 1 : ldw, w_cs = kGlobal ? S : 1;
  // utterance u's pieces: ring stage st, e/raw rows, per-frame scalars
  auto ring_x = [&](int u, int st) { return smem + L.utt + u * L.per_utt + static_cast<size_t>(st) * C * ldx; };
  auto ebuf = [&](int u) { return smem + L.utt + u * L.per_utt + 2 * static_cast<size_t>(C) * ldx; };
  auto scal = [&](int u) { return ebuf(u) + static_cast<size_t>(C + 1) * ldg; };
  auto len_of = [&](int u) { return b0 + u < B ? lens[b0 + u] : 0; };
  // chunk c of utterance u: frames lo = c·C .. lo + nf − 1
  auto span = [&](int u, int c, int& lo) {
    lo = c * C;
    return max(min(C, len_of(u) - lo), 0);
  };

  int n_chunks = 0;
  for (int u = 0; u < n_utt; ++u) n_chunks = max(n_chunks, (len_of(u) + C - 1) / C);
  auto fetch = [&](int c) {
    for (int u = 0; u < n_utt; ++u) {
      int lo;
      const int nf = span(u, c, lo);
      acc_fetch_rows(ring_x(u, c & 1), stats, static_cast<size_t>(b0 + u) * T + lo, nf, C, ldx, P, tid, nt);
    }
    cp_async_commit();
  };
  if (n_chunks > 0) fetch(0);

  if (!kGlobal) {
    for (int i = tid; i < S * ldw; i += nt) {
      const int s = i / ldw, p = i - s * ldw;
      w_sh[i] = p < P ? w[s * P + p] : 0.f;
    }
  }
  for (int s = tid; s < ldg; s += nt) {
    const bool on = s < S;
    band_sh[s] = on ? make_float4(bands[s], s > 0 ? bands[S + s - 1] : 0.f, bands[2 * S + s], bands[3 * S + s])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int u = 0; u < n_utt; ++u) {  // e/raw (padding columns stay 0) and the scalars
    float* e = ebuf(u);
    for (size_t i = tid; i < static_cast<size_t>(C + 1) * ldg + 3 * C; i += nt) e[i] = 0.f;
  }
  float ip = 0.f, q = 0.f;  // the chain warp's 1/norm and Σα̂·exit of the frame before the current one
  float logz_acc = 0.f;     // warp u's log Z of utterance u

  for (int c = 0; c < n_chunks; ++c) {
    const bool more = c + 1 < n_chunks;
    __syncthreads();  // chunk c − 1 is done with stage (c + 1) & 1 and e
    if (more) fetch(c + 1);
    cp_async_wait(more);
    __syncthreads();  // chunk c has landed

    // 1a. llh (nf, S) = X·Wᵀ + bias: an item is a state and up to kFwdGroup frames
    const int groups = (C + kFwdGroup - 1) / kFwdGroup;
    for (int it = tid; it < n_utt * groups * S; it += nt) {
      const int s = it % S, ug = it / S, u = ug / groups, f0 = (ug - u * groups) * kFwdGroup;
      int lo;
      const int nf = span(u, c, lo);
      if (f0 >= nf) continue;
      acc_ellh_tile<kFwdGroup>(ebuf(u) + static_cast<size_t>(f0) * ldg + s, ring_x(u, c & 1) + static_cast<size_t>(f0) * ldx,
                    w_m + s * w_rs, w_cs, bias[s], ldx, ldg, nf - f0, C - f0);
    }
    __syncthreads();
    // 1b. a warp a frame: the row max and e = exp(llh − max)
    for (int uf = warp; uf < n_utt * C; uf += n_warps) {
      const int u = uf / C, f = uf - u * C;
      int lo;
      if (f >= span(u, c, lo)) continue;
      float* e = ebuf(u) + static_cast<size_t>(f) * ldg;
      const float m = acc_exp_row(e, e, S, lane);
      if (lane == 0) scal(u)[C + f] = m;
    }
    __syncthreads();

    // 2. the chain: warp u walks utterance u's frames of the chunk forward
    if (warp < n_utt) {
      const int u = warp;
      int lo;
      const int nf = span(u, c, lo);
      float* e = ebuf(u);
      float* sc = scal(u);
      for (int f = 0; f < nf; ++f) {
        const bool first = lo + f == 0;
        const float* vp = e + static_cast<size_t>(f == 0 ? C : f - 1) * ldg;  // raw of frame t − 1
        float* er = e + static_cast<size_t>(f) * ldg;
        float sr = 0.f, sx = 0.f;
        for (int s = lane; s < S; s += 32) {
          const float4 bd = band_sh[s];  // a_self, a_adv of state s − 1, exit, w
          float base;
          if (first) {
            base = init[s];
          } else {
            const float pm = s > 0 ? vp[s - 1] * ip : 0.f;  // α̂_{t−1}(s − 1)
            base = vp[s] * ip * bd.x + pm * bd.y + q * bd.w;
          }
          const float raw = base * er[s];
          er[s] = raw;
          sr += raw;
          sx = fmaf(raw, bd.z, sx);
        }
        for (int o = 16; o > 0; o >>= 1) {  // one tree for both sums; every lane gets them
          sr += __shfl_xor_sync(0xffffffffu, sr, o);
          sx += __shfl_xor_sync(0xffffffffu, sx, o);
        }
        const float norm = fmaxf(sr, FLT_MIN);
        ip = 1.f / norm;
        q = sx * ip;
        if (lane == 0) {
          sc[f] = norm;
          sc[2 * C + f] = ip;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // 3. α̂ = raw·(1/norm) of the chunk's frames, the norms, log Z's terms,
    //    `last` at the utterance's last frame, and the carry (raw of the
    //    chunk's last frame to row C)
    for (int u = 0; u < n_utt; ++u) {
      int lo;
      const int nf = span(u, c, lo);
      const float* e = ebuf(u);
      const float* sc = scal(u);
      acc_write_gamma(alpha + (static_cast<size_t>(b0 + u) * T + lo) * S, e, sc + 2 * C, nf, S, ldg, tid, nt);
      if (nf == 0) continue;
      const float* fin = e + static_cast<size_t>(nf - 1) * ldg;
      const bool ends = lo + nf == len_of(u);
      for (int s = tid; s < S; s += nt) {
        if (ends) last[static_cast<size_t>(b0 + u) * S + s] = fin[s] * sc[2 * C + nf - 1];
        ebuf(u)[static_cast<size_t>(C) * ldg + s] = fin[s];
      }
      for (int f = tid; f < nf; f += nt) norms[static_cast<size_t>(b0 + u) * T + lo + f] = sc[f];
      if (warp == u) logz_acc += warp_sum(lane < nf ? logf(sc[lane]) + sc[C + lane] : 0.f);
    }
  }
  __syncthreads();
  for (int u = 0; u < n_utt; ++u) {
    if (b0 + u >= B) continue;
    const int len = len_of(u);
    float* a_b = alpha + static_cast<size_t>(b0 + u) * T * S;
    for (size_t i = static_cast<size_t>(len) * S + tid; i < static_cast<size_t>(T) * S; i += nt) a_b[i] = 0.f;
    for (int t = len + tid; t < T; t += nt) norms[static_cast<size_t>(b0 + u) * T + t] = 1.f;
    if (len == 0)
      for (int s = tid; s < S; s += nt) last[static_cast<size_t>(b0 + u) * S + s] = init[s];
    if (warp == u && lane == 0) logz[b0 + u] = logz_acc;
  }
}

// ---------------------------------------------------------------------
// K11 — γ-emitting banded v-space backward (γ, γ₀, loop ξ).
// Replaces the banded mode of beer_tpu/ops/pallas_scan.py
// _make_estep_ckpt_kernel_lm (wrapper phone_loop_estep_ckpt_pass_lm with
// bands, w and bias: the backward of the SVAE's log Z,
// semiring_scan._logz_stats_lm_bwd_impl); α̂ is read from K1 instead of
// recomputed from block checkpoints, and the loop ξ is an exact gather
// instead of a bf16 selection product.  K2 runs the same recursion in
// chunks of frames (acc_chunks.cuh); this per-frame chain is the next to
// take that design (ROADMAP P3).
// Walking t from len−1 down to 0, with llh recomputed from W·stats as K1
// does: u1 = final at the last frame, otherwise v̂·a_self +
// shift_up(v̂)·a_adv + (v̂·w)·exit; v = e·u1; v̂ = v / max(Σv, tiny);
// γ = normalize(α̂·u1), written per frame (0 on frames t >= len); wgt =
// 1 / (norm·Σ(α̂u1)/Σv); the loop-back ξ (U, U) += (α̂_t[ends]·wgt_{t+1})
// ⊗ v̂_{t+1}[starts], with ends/starts as int32 index vectors (an exact
// gather, not a selection product).  Bound: the serial chain (two block
// reductions per step) plus P FMAs per state and step for the ELLH; α̂
// streams in and γ streams out once, coalesced.  The per-utterance ξ
// partials (B, U·U) are summed over the batch by sum_rows_kernel in a
// fixed order, so the result is deterministic.  Two placements
// (kGlobal): W and ξ in shared memory, or Wᵀ (P, S) from device memory
// and ξ in the utterance's row of `part` (each element read and written
// by one thread), picked by cuda_scan.banded_placement.
// ---------------------------------------------------------------------
template <bool kGlobal>
__global__ void estep_gamma_banded_kernel(
    const float* __restrict__ stats,   // (B, T, P)
    const int* __restrict__ lens,      // (B,)
    const float* __restrict__ w,       // (S, P), kGlobal: Wᵀ (P, S)
    const float* __restrict__ bias,    // (S,)
    const float* __restrict__ bands,   // (4, S)
    const float* __restrict__ final_,  // (S,)
    const float* __restrict__ alpha,   // (B, T, S)
    const float* __restrict__ norms,   // (B, T)
    const int* __restrict__ ends,      // (U,)
    const int* __restrict__ starts,    // (U,)
    float* __restrict__ part,          // (B, U*U)
    float* __restrict__ gamma0,        // (B, S)
    float* __restrict__ gamma,         // (B, T, S)
    int T, int S, int P, int U) {
  extern __shared__ float smem[];
  const int ldw = odd_stride(P);
  float* w_sh = smem;
  float* xi_sh = w_sh + (kGlobal ? 0 : static_cast<size_t>(S) * ldw);
  float* bias_sh = xi_sh + (kGlobal ? 0 : static_cast<size_t>(U) * U);
  float* self_sh = bias_sh + S;
  float* adv_sh = self_sh + S;
  float* exit_sh = adv_sh + S;
  float* wv_sh = exit_sh + S;
  float* fin_sh = wv_sh + S;
  float* vh_prev = fin_sh + S;  // v̂_{t+1}
  float* vh_cur = vh_prev + S;  // v̂_t
  float* a_sh = vh_cur + S;     // α̂_t
  float* v_sh = a_sh + S;       // llh_t, then v_t
  float* ab_sh = v_sh + S;      // α̂_t·u1_t
  float* x_sh = ab_sh + S;      // stats_t
  int* ends_sh = reinterpret_cast<int*>(x_sh + P);
  int* starts_sh = ends_sh + U;
  float* red = reinterpret_cast<float*>(starts_sh + U);

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int len = lens[b];
  // W(s, p) = w_m[s·w_rs + p·w_cs]; ξ in shared memory or in this row of part
  const float* w_m = kGlobal ? w : w_sh;
  const int w_rs = kGlobal ? 1 : ldw, w_cs = kGlobal ? S : 1;
  float* out = part + static_cast<size_t>(b) * U * U;
  float* xi_m = kGlobal ? out : xi_sh;
  if (!kGlobal) {
    for (int i = tid; i < S * P; i += nt) {
      const int s = i / P;
      w_sh[s * ldw + (i - s * P)] = w[i];
    }
  }
  for (int i = tid; i < U * U; i += nt) xi_m[i] = 0.f;  // element i belongs to thread i mod nt throughout
  for (int s = tid; s < S; s += nt) {
    bias_sh[s] = bias[s];
    self_sh[s] = bands[s];
    adv_sh[s] = bands[S + s];
    exit_sh[s] = bands[2 * S + s];
    wv_sh[s] = bands[3 * S + s];
    fin_sh[s] = final_[s];
    vh_prev[s] = 0.f;
  }
  for (int u = tid; u < U; u += nt) {
    ends_sh[u] = ends[u];
    starts_sh[u] = starts[u];
  }
  const float* x_b = stats + static_cast<size_t>(b) * T * P;
  const float* a_b = alpha + static_cast<size_t>(b) * T * S;
  const float* n_b = norms + static_cast<size_t>(b) * T;
  float* g_b = gamma + static_cast<size_t>(b) * T * S;
  float wgt_next = 0.f;  // wgt_{t+1}

  for (int t = len - 1; t >= 0; --t) {
    __syncthreads();  // the previous step's readers of x_sh / a_sh are done
    for (int p = tid; p < P; p += nt) x_sh[p] = x_b[static_cast<size_t>(t) * P + p];
    for (int s = tid; s < S; s += nt) a_sh[s] = a_b[static_cast<size_t>(t) * S + s];
    __syncthreads();
    float mx = -FLT_MAX, r = 0.f;
    for (int s = tid; s < S; s += nt) {
      const float* wr = w_m + s * w_rs;
      float acc = 0.f;
#pragma unroll 8
      for (int p = 0; p < P; ++p) acc = fmaf(wr[p * w_cs], x_sh[p], acc);
      acc += bias_sh[s];
      v_sh[s] = acc;
      mx = fmaxf(mx, acc);
      r += vh_prev[s] * wv_sh[s];
    }
    block_max_sum(mx, r, red);
    const bool is_last = t == len - 1;
    float sv = 0.f, absum = 0.f;
    for (int s = tid; s < S; s += nt) {
      float u1;
      if (is_last) {
        u1 = fin_sh[s];
      } else {
        const float up = s + 1 < S ? vh_prev[s + 1] : 0.f;
        u1 = vh_prev[s] * self_sh[s] + up * adv_sh[s] + r * exit_sh[s];
      }
      const float v = expf(v_sh[s] - mx) * u1;
      const float ab = a_sh[s] * u1;
      v_sh[s] = v;
      ab_sh[s] = ab;
      sv += v;
      absum += ab;
    }
    block_sum_sum(sv, absum, red);
    sv = fmaxf(sv, FLT_MIN);
    const float gnorm = fmaxf(absum, FLT_MIN);
    const float denom = n_b[t] * absum / sv;
    const float wgt = denom > kXiFloor ? 1.f / fmaxf(denom, kXiFloor) : 0.f;
    for (int s = tid; s < S; s += nt) {
      const float g = ab_sh[s] / gnorm;
      vh_cur[s] = v_sh[s] / sv;
      g_b[static_cast<size_t>(t) * S + s] = g;
      if (t == 0) gamma0[static_cast<size_t>(b) * S + s] = g;
    }
    if (!is_last) {
      for (int k = tid; k < U * U; k += nt) {
        const int i = k / U, j = k - i * U;
        xi_m[k] = fmaf(a_sh[ends_sh[i]] * wgt_next, vh_prev[starts_sh[j]], xi_m[k]);
      }
    }
    wgt_next = wgt;
    float* tmp = vh_prev;
    vh_prev = vh_cur;
    vh_cur = tmp;
  }
  __syncthreads();
  for (size_t i = static_cast<size_t>(len) * S + tid; i < static_cast<size_t>(T) * S; i += nt) g_b[i] = 0.f;
  if (!kGlobal) {
    for (int k = tid; k < U * U; k += nt) out[k] = xi_sh[k];
  }
  if (len == 0) {
    for (int s = tid; s < S; s += nt) gamma0[static_cast<size_t>(b) * S + s] = 0.f;
  }
}

// ---------------------------------------------------------------------
// K2 — accumulating banded v-space backward (smoothing + moments + loop ξ):
// the banded mode of acc_chunks.cuh (frames in chunks, the chain on one
// warp an utterance, the ELLH and the moment and ξ products around it).
// Replaces beer_tpu/ops/pallas_scan.py _make_estep_ckpt_acc_kernel_lm
// (wrapper phone_loop_estep_ckpt_acc_lm, stored-α̂ route).
// ---------------------------------------------------------------------

// ---------------------------------------------------------------------
// K3 — banded (max,+) Viterbi forward.
// Replaces beer_tpu/ops/pallas_scan.py _make_viterbi_banded_kernel
// (wrapper viterbi_fwd_banded).  Candidates per state: stay a + ls,
// advance shift_right(a + la, −1e30), loop exb + lw where exb/exi are
// the max/argmax (smallest index) of a + le.  Priority stay > advance >
// loop; new = max(llh + best, −1e30).  The first frame is
// max(log_init + llh_0, −1e30) for every row (as in the JAX package);
// frames t >= max(len, 1) store choice 0, exit index 0 and keep α.
// Choices are int8, exit indices int32 (a float index would round
// states above 2^8 in bf16).  Bound: the serial chain (one block
// arg-max per step); the choice stream is S bytes per step.
// ---------------------------------------------------------------------
__global__ void viterbi_fwd_banded_kernel(
    const float* __restrict__ llh,       // (B, T, S)
    const int* __restrict__ lens,        // (B,)
    const float* __restrict__ lbands,    // (4, S): log a_self, a_adv, exit, w
    const float* __restrict__ log_init,  // (S,)
    int8_t* __restrict__ choices,        // (B, T, S)
    int* __restrict__ exarg,             // (B, T)
    float* __restrict__ alpha_last,      // (B, S)
    int T, int S) {
  extern __shared__ float smem[];
  float* ls = smem;
  float* la = ls + S;
  float* le = la + S;
  float* lw = le + S;
  float* a_prev = lw + S;
  float* a_next = a_prev + S;
  float* red = a_next + S;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int steps = lens[b] > 1 ? lens[b] : 1;
  const float* l_b = llh + static_cast<size_t>(b) * T * S;
  int8_t* c_b = choices + static_cast<size_t>(b) * T * S;
  int* e_b = exarg + static_cast<size_t>(b) * T;
  for (int s = tid; s < S; s += nt) {
    ls[s] = lbands[s];
    la[s] = lbands[S + s];
    le[s] = lbands[2 * S + s];
    lw[s] = lbands[3 * S + s];
    if (T > 0) {
      a_prev[s] = fmaxf(log_init[s] + l_b[s], kNeg);
      c_b[s] = 0;
    } else {
      a_prev[s] = log_init[s];
    }
  }
  if (tid == 0 && T > 0) e_b[0] = 0;
  __syncthreads();
  for (int t = 1; t < steps; ++t) {
    float exb = -FLT_MAX;
    int exi = S;
    for (int s = tid; s < S; s += nt) {
      const float ex = a_prev[s] + le[s];
      if (ex > exb) {  // strided loop visits s in increasing order
        exb = ex;
        exi = s;
      }
    }
    block_argmax(exb, exi, red);
    for (int s = tid; s < S; s += nt) {
      const float c_self = a_prev[s] + ls[s];
      const float c_adv = s > 0 ? a_prev[s - 1] + la[s - 1] : kNeg;
      const float c_loop = exb + lw[s];
      const float best = fmaxf(c_self, fmaxf(c_adv, c_loop));
      const int8_t ch = static_cast<int8_t>(c_self >= best ? 0 : (c_adv >= best ? 1 : 2));
      a_next[s] = fmaxf(l_b[static_cast<size_t>(t) * S + s] + best, kNeg);
      c_b[static_cast<size_t>(t) * S + s] = ch;
    }
    if (tid == 0) e_b[t] = exi;
    float* tmp = a_prev;
    a_prev = a_next;
    a_next = tmp;
  }
  for (size_t i = static_cast<size_t>(steps) * S + tid; i < static_cast<size_t>(T) * S; i += nt) c_b[i] = 0;
  for (int t = steps + tid; t < T; t += nt) e_b[t] = 0;
  for (int s = tid; s < S; s += nt) alpha_last[static_cast<size_t>(b) * S + s] = a_prev[s];
}

// ---------------------------------------------------------------------
// K4 — Viterbi backtrace.
// Replaces beer_tpu/ops/pallas_scan.py _make_viterbi_backtrace_kernel
// (wrapper viterbi_backtrace_banded); the final arg-max that the JAX
// package computes beside the kernel is folded in.  One thread per
// utterance: paths[T−1] = argmax(α_last + log_final) (first max), then
// stay / state − 1 / exit index by the stored choice (clamped at state
// 0).  ``log_final`` is one (S,) vector (final_stride 0) or one row per
// utterance (final_stride S: the shared transcription graphs of the
// recognizer end each utterance in its own state).  Bound: the
// latency of T dependent loads per thread (a pointer chase); B threads
// run in parallel.
// ---------------------------------------------------------------------
__global__ void viterbi_backtrace_kernel(
    const int8_t* __restrict__ choices,     // (B, T, S)
    const int* __restrict__ exarg,          // (B, T)
    const float* __restrict__ alpha_last,   // (B, S)
    const float* __restrict__ log_final,    // (S,) or (B, S)
    int* __restrict__ paths,                // (B, T)
    float* __restrict__ scores,             // (B,)
    int B, int T, int S, int final_stride) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* a = alpha_last + static_cast<size_t>(b) * S;
  const float* lf = log_final + static_cast<size_t>(b) * final_stride;
  float best = a[0] + lf[0];
  int st = 0;
  for (int s = 1; s < S; ++s) {
    const float v = a[s] + lf[s];
    if (v > best) {
      best = v;
      st = s;
    }
  }
  scores[b] = best;
  if (T == 0) return;
  int* p_b = paths + static_cast<size_t>(b) * T;
  const int8_t* c_b = choices + static_cast<size_t>(b) * T * S;
  const int* e_b = exarg + static_cast<size_t>(b) * T;
  p_b[T - 1] = st;
  for (int t = T - 1; t >= 1; --t) {
    const int c = c_b[static_cast<size_t>(t) * S + st];
    st = c == 0 ? st : (c == 1 ? st - 1 : e_b[t]);
    st = st < 0 ? 0 : st;  // an advance into state 0 needs an all-unreachable row
    p_b[t - 1] = st;
  }
}

}  // namespace

extern "C" {

// global != 0: W read as Wᵀ (P, S) from device memory, and K11's ξ (and
// K2's moments) in the partial row.  K1 and K2 at n_utt utterances a
// block and `chunk` frames a chunk.
size_t beer_forward_smem_bytes(int s, int p, int global, int n_utt, int chunk) {
  return fwd_layout(s, p, n_utt, chunk, global != 0).total * sizeof(float);
}

size_t beer_estep_smem_bytes(int s, int p, int u, int global, int n_utt, int chunk) {
  return acc_layout(s, p, u, u, n_utt, chunk, global != 0).total * sizeof(float);
}

size_t beer_estep_gamma_smem_bytes(int s, int p, int u, int global) {
  return gamma_smem_floats(s, p, u, global != 0) * sizeof(float);
}

const char* beer_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// K1: n_utt utterances a block, chunks of `chunk` frames; w is Wᵀ with zero
// rows to (round4(P), S) when global.
int beer_forward_llh_banded(int device, int global, int n_utt, int chunk, const float* stats, const int* lens,
                            const float* w, const float* bias, const float* bands, const float* init, float* alpha,
                            float* norms, float* last, float* logz, int B, int T, int S, int P, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_utt < 1 || n_utt > kAccThreads / 32 || chunk < 1 || chunk > kAccChunk) return cudaErrorInvalidValue;
  const size_t smem = beer_forward_smem_bytes(S, P, global, n_utt, chunk);
  const bool full = chunk == kAccChunk;
  auto kernel = global ? (full ? forward_llh_chunked_kernel<true, true> : forward_llh_chunked_kernel<true, false>)
                       : (full ? forward_llh_chunked_kernel<false, true> : forward_llh_chunked_kernel<false, false>);
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  kernel<<<(B + n_utt - 1) / n_utt, kAccThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      stats, lens, w, bias, bands, init, alpha, norms, last, logz, B, T, S, P, n_utt, chunk);
  return cudaGetLastError();
}

// K2: n_utt utterances a block, chunks of `chunk` frames; part is
// (ceil(B / n_utt), S·(P+1) + U·U), out = Σ over its rows: acc (S, P+1),
// then ξ_raw (U, U).  w is Wᵀ with zero rows to (round4(P), S) when global.
int beer_estep_acc_banded(int device, int global, int n_utt, int chunk, const float* stats, const int* lens,
                          const float* w, const float* bias, const float* bands, const float* final_,
                          const float* alpha, const float* norms, const int* ends, const int* starts, float* part,
                          float* out, float* gamma0, int B, int T, int S, int P, int U, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_acc_chunked<false, false>(global, n_utt, chunk, stats, lens, w, bias, bands, nullptr, final_, alpha,
                                          norms, ends, starts, part, out, gamma0, nullptr, B, T, S, P, U, U,
                                          static_cast<cudaStream_t>(stream));
}

// K11: w is Wᵀ (P, S) when global; part is (B, U·U).
int beer_estep_gamma_banded(int device, int global, const float* stats, const int* lens, const float* w,
                            const float* bias, const float* bands, const float* final_, const float* alpha,
                            const float* norms, const int* ends, const int* starts, float* part, float* out,
                            float* gamma0, float* gamma, int B, int T, int S, int P, int U, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_estep_gamma_smem_bytes(S, P, U, global);
  auto kernel = global ? estep_gamma_banded_kernel<true> : estep_gamma_banded_kernel<false>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n = U * U;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    kernel<<<B, block_threads(kernel, S), smem, st>>>(stats, lens, w, bias, bands, final_, alpha, norms, ends, starts,
                                                      part, gamma0, gamma, T, S, P, U);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, B, n);
  return cudaGetLastError();
}

int beer_viterbi_fwd_banded(int device, const float* llh, const int* lens, const float* lbands,
                            const float* log_init, int8_t* choices, int* exarg, float* alpha_last, int B, int T,
                            int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  const size_t smem = (6 * static_cast<size_t>(S) + 2 * kMaxWarps) * sizeof(float);
  err = set_smem(viterbi_fwd_banded_kernel, smem);
  if (err != cudaSuccess) return err;
  const int nt = block_threads(viterbi_fwd_banded_kernel, S);
  viterbi_fwd_banded_kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      llh, lens, lbands, log_init, choices, exarg, alpha_last, T, S);
  return cudaGetLastError();
}

int beer_viterbi_backtrace_banded(int device, const int8_t* choices, const int* exarg, const float* alpha_last,
                                  const float* log_final, int* paths, float* scores, int B, int T, int S,
                                  int final_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  viterbi_backtrace_kernel<<<(B + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      choices, exarg, alpha_last, log_final, paths, scores, B, T, S, final_stride);
  return cudaGetLastError();
}

}  // extern "C"
