// Phone-loop scan kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by beer_tpu_torch/ops/cuda_scan.py.
//
// Four kernels carry the phone-loop AUD main path: the scaled banded
// forward (VB-EM E-step, part 1), the accumulating v-space backward
// (E-step, part 2), and the banded (max,+) Viterbi forward and its
// backtrace (decode).  A fifth, the γ-emitting twin of the backward,
// carries the structured VAE's gradient (the Fisher identity ∂log Z /
// ∂llh = γ); it runs the backward frame by frame, K2 in chunks.  Each replaces one Pallas TPU kernel of
// beer_tpu/ops/pallas_scan.py; the note above each kernel names it.
//
// Common design.  Every kernel is a serial recursion over time with an
// O(S) step: the transition matrix of a phone loop is band + rank-1
// (self loop, advance, exit ⊗ entry), so a step is a few elementwise
// passes plus reductions over the S states.  What bounds these
// recursions on an H100 is the latency of the serial chain, not bytes
// or FLOPs.  K1, K3, K4 and K11 spread the batch: one thread block per
// utterance (B = 512 blocks over 132 SMs), threads over states in a
// strided loop (any S), and a loop over t < len_b inside the block, so
// the chains of several utterances overlap on each SM; a step needs two
// block reductions.  K2 goes further: frames in chunks, the chain on one
// warp an utterance with no barrier, everything that does not depend on
// the carry out of the chain (its note below).  Loop-invariant operands
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

// K1: W (S, P) in shared memory unless global (then Wᵀ (P, S) is read
// from device memory).
size_t forward_smem_floats(int s, int p, bool global) {
  return (global ? 0 : static_cast<size_t>(s) * odd_stride(p)) + 7 * static_cast<size_t>(s) + p + 2 * kMaxWarps;
}

// K11: W and the (U, U) ξ accumulator in shared memory unless global.
size_t gamma_smem_floats(int s, int p, int u, bool global) {
  return (global ? 0 : static_cast<size_t>(s) * odd_stride(p) + static_cast<size_t>(u) * u) +
         11 * static_cast<size_t>(s) + p + 2 * static_cast<size_t>(u) + 2 * kMaxWarps;
}

// ---------------------------------------------------------------------
// K1 — scaled banded forward with in-kernel ELLH.
// Replaces beer_tpu/ops/pallas_scan.py _make_fwd_llh_ckpt_kernel_lm
// (wrapper forward_llh_ckpt_pass_lm, store_alpha=True).
// Per step: llh_t = W·stats_t + bias (W in shared memory), row max,
// e = exp(llh − max), propagate p·a_self + shift_down(p·a_adv) +
// (p·exit)·w (the first frame uses init), norm = max(Σ, FLT_MIN),
// α̂ = raw / norm, logz_base += log norm + max.  Bound: the serial chain
// (two block reductions per step) and the P-long ELLH dot per state;
// α̂ (B, T, S) is the only large write and streams out coalesced.
// Frames t >= len get α̂ = 0 and norm = 1.
// Two placements (kGlobal): W in shared memory while it fits a block,
// else Wᵀ (P, S) read from device memory (a warp reads contiguous
// states; W stays in L2), picked by cuda_scan.banded_placement.
// ---------------------------------------------------------------------
template <bool kGlobal>
__global__ void forward_llh_banded_kernel(
    const float* __restrict__ stats,  // (B, T, P)
    const int* __restrict__ lens,     // (B,)
    const float* __restrict__ w,      // (S, P), kGlobal: Wᵀ (P, S)
    const float* __restrict__ bias,   // (S,)
    const float* __restrict__ bands,  // (4, S): a_self, a_adv, exit, w
    const float* __restrict__ init,   // (S,)
    float* __restrict__ alpha,        // (B, T, S)
    float* __restrict__ norms,        // (B, T)
    float* __restrict__ last,         // (B, S)
    float* __restrict__ logz,         // (B,)
    int T, int S, int P) {
  extern __shared__ float smem[];
  const int ldw = odd_stride(P);
  float* w_sh = smem;
  float* bias_sh = w_sh + (kGlobal ? 0 : static_cast<size_t>(S) * ldw);
  float* self_sh = bias_sh + S;
  float* adv_sh = self_sh + S;
  float* exit_sh = adv_sh + S;
  float* wv_sh = exit_sh + S;
  float* p_sh = wv_sh + S;   // α̂_{t−1} (init before the first frame)
  float* v_sh = p_sh + S;    // llh_t, then raw_t
  float* x_sh = v_sh + S;    // stats_t
  float* red = x_sh + P;

  // W(s, p) = w_m[s·w_rs + p·w_cs]
  const float* w_m = kGlobal ? w : w_sh;
  const int w_rs = kGlobal ? 1 : ldw, w_cs = kGlobal ? S : 1;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int len = lens[b];
  if (!kGlobal) {
    for (int i = tid; i < S * P; i += nt) {
      const int s = i / P;
      w_sh[s * ldw + (i - s * P)] = w[i];
    }
  }
  for (int s = tid; s < S; s += nt) {
    bias_sh[s] = bias[s];
    self_sh[s] = bands[s];
    adv_sh[s] = bands[S + s];
    exit_sh[s] = bands[2 * S + s];
    wv_sh[s] = bands[3 * S + s];
    p_sh[s] = init[s];
  }
  const float* x_b = stats + static_cast<size_t>(b) * T * P;
  float* a_b = alpha + static_cast<size_t>(b) * T * S;
  float* n_b = norms + static_cast<size_t>(b) * T;
  float logz_acc = 0.f;

  for (int t = 0; t < len; ++t) {
    for (int p = tid; p < P; p += nt) x_sh[p] = x_b[static_cast<size_t>(t) * P + p];
    __syncthreads();
    float mx = -FLT_MAX, q = 0.f;
    for (int s = tid; s < S; s += nt) {
      const float* wr = w_m + s * w_rs;
      float acc = 0.f;
#pragma unroll 8
      for (int p = 0; p < P; ++p) acc = fmaf(wr[p * w_cs], x_sh[p], acc);
      acc += bias_sh[s];
      v_sh[s] = acc;
      mx = fmaxf(mx, acc);
      q += p_sh[s] * exit_sh[s];
    }
    block_max_sum(mx, q, red);
    float sum = 0.f, unused = 0.f;
    for (int s = tid; s < S; s += nt) {
      float base = p_sh[s];
      if (t > 0) {
        const float shifted = s > 0 ? p_sh[s - 1] * adv_sh[s - 1] : 0.f;
        base = base * self_sh[s] + shifted + q * wv_sh[s];
      }
      const float raw = base * expf(v_sh[s] - mx);
      v_sh[s] = raw;
      sum += raw;
    }
    block_sum_sum(sum, unused, red);
    const float norm = fmaxf(sum, FLT_MIN);
    for (int s = tid; s < S; s += nt) {
      const float a = v_sh[s] / norm;
      p_sh[s] = a;
      a_b[static_cast<size_t>(t) * S + s] = a;
    }
    if (tid == 0) n_b[t] = norm;
    logz_acc += logf(norm) + mx;
  }
  for (int s = tid; s < S; s += nt) last[static_cast<size_t>(b) * S + s] = p_sh[s];
  if (tid == 0) logz[b] = logz_acc;
  for (size_t i = static_cast<size_t>(len) * S + tid; i < static_cast<size_t>(T) * S; i += nt) a_b[i] = 0.f;
  for (int t = len + tid; t < T; t += nt) n_b[t] = 1.f;
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
// K2's moments) in the partial row.
size_t beer_forward_smem_bytes(int s, int p, int global) {
  return forward_smem_floats(s, p, global != 0) * sizeof(float);
}

size_t beer_estep_smem_bytes(int s, int p, int u, int global, int n_utt, int chunk) {
  return acc_layout(s, p, u, n_utt, chunk, global != 0).total * sizeof(float);
}

size_t beer_estep_gamma_smem_bytes(int s, int p, int u, int global) {
  return gamma_smem_floats(s, p, u, global != 0) * sizeof(float);
}

const char* beer_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int beer_forward_llh_banded(int device, int global, const float* stats, const int* lens, const float* w,
                            const float* bias, const float* bands, const float* init, float* alpha, float* norms,
                            float* last, float* logz, int B, int T, int S, int P, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_forward_smem_bytes(S, P, global);
  auto kernel = global ? forward_llh_banded_kernel<true> : forward_llh_banded_kernel<false>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  kernel<<<B, block_threads(kernel, S), smem, static_cast<cudaStream_t>(stream)>>>(
      stats, lens, w, bias, bands, init, alpha, norms, last, logz, T, S, P);
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
  return launch_acc_chunked<false>(global, n_utt, chunk, stats, lens, w, bias, bands, nullptr, final_, alpha, norms,
                                   ends, starts, part, out, gamma0, B, T, S, P, U, static_cast<cudaStream_t>(stream));
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
