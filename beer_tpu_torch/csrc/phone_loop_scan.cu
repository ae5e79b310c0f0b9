// Phone-loop scan kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by beer_tpu_torch/ops/cuda_scan.py.
//
// Four kernels carry the phone-loop AUD main path: the scaled banded
// forward (VB-EM E-step, part 1), the accumulating v-space backward
// (E-step, part 2), and the banded (max,+) Viterbi forward and its
// backtrace (decode).  Each replaces one Pallas TPU kernel of
// beer_tpu/ops/pallas_scan.py; the note above each kernel names it.
//
// Common design.  Every kernel is a serial recursion over time with an
// O(S) step: the transition matrix of a phone loop is band + rank-1
// (self loop, advance, exit ⊗ entry), so a step is a few elementwise
// passes plus block-wide reductions over the S states.  What bounds
// these recursions on an H100 is the latency of the serial chain (each
// step needs two block reductions, i.e. a few __syncthreads), not
// bytes or FLOPs.  The design therefore spreads the batch: one thread
// block per utterance (B = 512 blocks over 132 SMs), threads over
// states in a strided loop (any S), and a loop over t < len_b inside
// the block, so the chains of several utterances overlap on each SM.
// Loop-invariant operands (the ELLH matrix W, bias, bands) live in
// shared memory for the whole recursion; per-step vectors are in
// shared memory, reductions use warp shuffles plus one shared pass.
// Every reduction is computed in a fixed order and broadcast to all
// threads, so the kernels are deterministic run to run.
//
// Masks are prefix masks rebuilt from per-utterance lengths; an
// utterance of length 0 contributes nothing to any sum.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;      // LOG_ZERO of the JAX package
constexpr float kXiFloor = 1e-30f;  // ξ-weight floor of the JAX package
constexpr int kMaxWarps = 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block reduction of (max a, sum b): every thread gets both results.
// The leading barrier keeps `scratch` from being overwritten while the
// previous reduction is still being read, and orders shared-memory
// writes made before the call ahead of any read after it.
__device__ __forceinline__ void block_max_sum(float& a, float& b, float* scratch) {
  a = warp_max(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) {
    scratch[warp] = a;
    scratch[kMaxWarps + warp] = b;
  }
  __syncthreads();
  a = scratch[0];
  b = scratch[kMaxWarps];
  for (int i = 1; i < nw; ++i) {
    a = fmaxf(a, scratch[i]);
    b += scratch[kMaxWarps + i];
  }
}

// Block reduction of (sum a, sum b); same contract as block_max_sum.
__device__ __forceinline__ void block_sum_sum(float& a, float& b, float* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) {
    scratch[warp] = a;
    scratch[kMaxWarps + warp] = b;
  }
  __syncthreads();
  a = scratch[0];
  b = scratch[kMaxWarps];
  for (int i = 1; i < nw; ++i) {
    a += scratch[i];
    b += scratch[kMaxWarps + i];
  }
}

// Block arg-max: the largest value, ties to the smallest index.
__device__ __forceinline__ void block_argmax(float& v, int& idx, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  int* iscratch = reinterpret_cast<int*>(scratch + kMaxWarps);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) {
    scratch[warp] = v;
    iscratch[warp] = idx;
  }
  __syncthreads();
  v = scratch[0];
  idx = iscratch[0];
  for (int i = 1; i < nw; ++i) {
    const float ov = scratch[i];
    const int oi = iscratch[i];
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

// Shared-memory row strides: odd, so that threads walking a column of
// W or of the accumulator (one state each) hit distinct banks.
__host__ __device__ inline int odd_stride(int n) { return n | 1; }

int threads_for(int s) {
  int t = ((s + 31) / 32) * 32;
  return t > 1024 ? 1024 : t;
}

size_t forward_smem_floats(int s, int p) {
  return static_cast<size_t>(s) * odd_stride(p) + 7 * static_cast<size_t>(s) + p + 2 * kMaxWarps;
}

size_t estep_smem_floats(int s, int p, int u) {
  return static_cast<size_t>(s) * odd_stride(p) + static_cast<size_t>(s) * odd_stride(p + 1) +
         static_cast<size_t>(u) * u + 11 * static_cast<size_t>(s) + p + 2 * static_cast<size_t>(u) +
         2 * kMaxWarps;
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
// ---------------------------------------------------------------------
__global__ void forward_llh_banded_kernel(
    const float* __restrict__ stats,  // (B, T, P)
    const int* __restrict__ lens,     // (B,)
    const float* __restrict__ w,      // (S, P)
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
  float* bias_sh = w_sh + static_cast<size_t>(S) * ldw;
  float* self_sh = bias_sh + S;
  float* adv_sh = self_sh + S;
  float* exit_sh = adv_sh + S;
  float* wv_sh = exit_sh + S;
  float* p_sh = wv_sh + S;   // α̂_{t−1} (init before the first frame)
  float* v_sh = p_sh + S;    // llh_t, then raw_t
  float* x_sh = v_sh + S;    // stats_t
  float* red = x_sh + P;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int len = lens[b];
  for (int i = tid; i < S * P; i += nt) {
    const int s = i / P;
    w_sh[s * ldw + (i - s * P)] = w[i];
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
      const float* wr = w_sh + s * ldw;
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc = fmaf(wr[p], x_sh[p], acc);
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
// K2 — accumulating v-space backward (smoothing + moments + loop ξ).
// Replaces beer_tpu/ops/pallas_scan.py _make_estep_ckpt_acc_kernel_lm
// (wrapper phone_loop_estep_ckpt_acc_lm, stored-α̂ route).
// Walking t from len−1 down to 0, with llh recomputed from W·stats as
// K1 does: u1 = final at the last frame, otherwise v̂·a_self +
// shift_up(v̂)·a_adv + (v̂·w)·exit; v = e·u1; v̂ = v / max(Σv, tiny);
// γ = normalize(α̂·u1); ŵ = v̂; wgt = 1 / (norm·Σ(α̂u1)/Σv).  Reduced in
// shared memory per utterance: acc (S, P+1) = Σ γ ⊗ [stats, 1] and the
// loop-back ξ (U, U) += (α̂_t[ends]·wgt_{t+1}) ⊗ ŵ_{t+1}[starts], with
// ends/starts as int32 index vectors (an exact gather, not a selection
// product).  Bound: the serial chain plus 2·P shared-memory FMAs per
// state and step; α̂ is streamed once.  The per-utterance partials
// (B, S·(P+1) + U·U) are summed over the batch by sum_rows_kernel in a
// fixed order, so the result is deterministic.
// ---------------------------------------------------------------------
__global__ void estep_acc_banded_kernel(
    const float* __restrict__ stats,   // (B, T, P)
    const int* __restrict__ lens,      // (B,)
    const float* __restrict__ w,       // (S, P)
    const float* __restrict__ bias,    // (S,)
    const float* __restrict__ bands,   // (4, S)
    const float* __restrict__ final_,  // (S,)
    const float* __restrict__ alpha,   // (B, T, S)
    const float* __restrict__ norms,   // (B, T)
    const int* __restrict__ ends,      // (U,)
    const int* __restrict__ starts,    // (U,)
    float* __restrict__ part,          // (B, S*(P+1) + U*U)
    float* __restrict__ gamma0,        // (B, S)
    int T, int S, int P, int U) {
  extern __shared__ float smem[];
  const int ldw = odd_stride(P), lda = odd_stride(P + 1);
  float* w_sh = smem;
  float* acc_sh = w_sh + static_cast<size_t>(S) * ldw;
  float* xi_sh = acc_sh + static_cast<size_t>(S) * lda;
  float* bias_sh = xi_sh + static_cast<size_t>(U) * U;
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
  for (int i = tid; i < S * P; i += nt) {
    const int s = i / P;
    w_sh[s * ldw + (i - s * P)] = w[i];
  }
  for (int i = tid; i < S * lda; i += nt) acc_sh[i] = 0.f;
  for (int i = tid; i < U * U; i += nt) xi_sh[i] = 0.f;
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
  float wgt_next = 0.f;  // wgt_{t+1}

  for (int t = len - 1; t >= 0; --t) {
    __syncthreads();  // the previous step's readers of x_sh / a_sh are done
    for (int p = tid; p < P; p += nt) x_sh[p] = x_b[static_cast<size_t>(t) * P + p];
    for (int s = tid; s < S; s += nt) a_sh[s] = a_b[static_cast<size_t>(t) * S + s];
    __syncthreads();
    float mx = -FLT_MAX, r = 0.f;
    for (int s = tid; s < S; s += nt) {
      const float* wr = w_sh + s * ldw;
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc = fmaf(wr[p], x_sh[p], acc);
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
      float* ar = acc_sh + s * lda;
      for (int p = 0; p < P; ++p) ar[p] = fmaf(g, x_sh[p], ar[p]);
      ar[P] += g;
      if (t == 0) gamma0[static_cast<size_t>(b) * S + s] = g;
    }
    if (!is_last) {
      for (int k = tid; k < U * U; k += nt) {
        const int i = k / U, j = k - i * U;
        xi_sh[k] = fmaf(a_sh[ends_sh[i]] * wgt_next, vh_prev[starts_sh[j]], xi_sh[k]);
      }
    }
    wgt_next = wgt;
    float* tmp = vh_prev;
    vh_prev = vh_cur;
    vh_cur = tmp;
  }
  __syncthreads();
  const int row = S * (P + 1) + U * U;
  float* out = part + static_cast<size_t>(b) * row;
  for (int i = tid; i < S * (P + 1); i += nt) {
    const int s = i / (P + 1);
    out[i] = acc_sh[s * lda + (i - s * (P + 1))];
  }
  for (int k = tid; k < U * U; k += nt) out[S * (P + 1) + k] = xi_sh[k];
  if (len == 0) {
    for (int s = tid; s < S; s += nt) gamma0[static_cast<size_t>(b) * S + s] = 0.f;
  }
}

// Column sums of a (B, N) row-major array in a fixed order (f64 accumulator).
__global__ void sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int B, int N) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N) return;
  double acc = 0.0;
  for (int b = 0; b < B; ++b) acc += part[static_cast<size_t>(b) * N + k];
  out[k] = static_cast<float>(acc);
}

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
// 0).  Bound: the
// latency of T dependent loads per thread (a pointer chase); B threads
// run in parallel.
// ---------------------------------------------------------------------
__global__ void viterbi_backtrace_kernel(
    const int8_t* __restrict__ choices,     // (B, T, S)
    const int* __restrict__ exarg,          // (B, T)
    const float* __restrict__ alpha_last,   // (B, S)
    const float* __restrict__ log_final,    // (S,)
    int* __restrict__ paths,                // (B, T)
    float* __restrict__ scores,             // (B,)
    int B, int T, int S) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* a = alpha_last + static_cast<size_t>(b) * S;
  float best = a[0] + log_final[0];
  int st = 0;
  for (int s = 1; s < S; ++s) {
    const float v = a[s] + log_final[s];
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

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

}  // namespace

extern "C" {

size_t beer_forward_smem_bytes(int s, int p) { return forward_smem_floats(s, p) * sizeof(float); }

size_t beer_estep_smem_bytes(int s, int p, int u) { return estep_smem_floats(s, p, u) * sizeof(float); }

const char* beer_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int beer_forward_llh_banded(int device, const float* stats, const int* lens, const float* w, const float* bias,
                            const float* bands, const float* init, float* alpha, float* norms, float* last,
                            float* logz, int B, int T, int S, int P, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_forward_smem_bytes(S, P);
  err = set_smem(forward_llh_banded_kernel, smem);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  forward_llh_banded_kernel<<<B, threads_for(S), smem, static_cast<cudaStream_t>(stream)>>>(
      stats, lens, w, bias, bands, init, alpha, norms, last, logz, T, S, P);
  return cudaGetLastError();
}

int beer_estep_acc_banded(int device, const float* stats, const int* lens, const float* w, const float* bias,
                          const float* bands, const float* final_, const float* alpha, const float* norms,
                          const int* ends, const int* starts, float* part, float* out, float* gamma0, int B,
                          int T, int S, int P, int U, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_estep_smem_bytes(S, P, U);
  err = set_smem(estep_acc_banded_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n = S * (P + 1) + U * U;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    estep_acc_banded_kernel<<<B, threads_for(S), smem, st>>>(stats, lens, w, bias, bands, final_, alpha, norms,
                                                            ends, starts, part, gamma0, T, S, P, U);
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
  viterbi_fwd_banded_kernel<<<B, threads_for(S), smem, static_cast<cudaStream_t>(stream)>>>(
      llh, lens, lbands, log_init, choices, exarg, alpha_last, T, S);
  return cudaGetLastError();
}

int beer_viterbi_backtrace_banded(int device, const int8_t* choices, const int* exarg, const float* alpha_last,
                                  const float* log_final, int* paths, float* scores, int B, int T, int S,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  viterbi_backtrace_kernel<<<(B + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      choices, exarg, alpha_last, log_final, paths, scores, B, T, S);
  return cudaGetLastError();
}

}  // extern "C"
