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
//                          and the full (S, S) ξ.
//
// Two more are template instances of K5 and K7, so that the modes cannot
// drift apart:
//
//   K14 forward_llh_shifts_dense      K5 on the llh stream, also writing the
//                                     masked per-frame row max, with the carry
//                                     copied through frames t >= len;
//   K15 estep_gamma_dense_restricted  K7 with ξ gathered to the block
//                                     [rows][:, cols] in the kernel.
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

#include "scan_common.cuh"

namespace {

size_t dense_forward_smem_floats(int s, int p) {
  size_t n = static_cast<size_t>(s) * odd_stride(s) + 2 * static_cast<size_t>(s) + 2 * kMaxWarps;
  if (p > 0) n += static_cast<size_t>(s) * odd_stride(p) + s + p;
  return n;
}

// n_xi: floats of the ξ accumulator (S·S, or n_r·n_c + the two index
// vectors when ξ is restricted).
size_t dense_backward_smem_floats(int s, int p, size_t n_xi) {
  size_t n = static_cast<size_t>(s) * odd_stride(s) + n_xi + 6 * static_cast<size_t>(s) + 2 * kMaxWarps;
  if (p > 0) n += static_cast<size_t>(s) * odd_stride(p) + static_cast<size_t>(s) * odd_stride(p + 1) + s + p;
  return n;
}

// ---------------------------------------------------------------------
// K5 — scaled dense forward.
// Replaces beer_tpu/ops/pallas_scan.py _make_fwd_llh_ckpt_kernel_lm
// (wrapper forward_llh_ckpt_pass_lm with bands=None, trans=(S, S);
// store_alpha=True), in both of its input modes: kStats streams the
// reduced statistics and computes llh_t = W·stats_t + bias (the stats
// route of HMM.infer), otherwise the llh stream is read (the llh route).
// Per step: row max, e = exp(llh − max), raw_j = e_j · Σ_i α̂_{t−1}(i)
// A(i, j) (the first frame uses the row's init), norm = max(Σ raw,
// FLT_MIN), α̂ = raw / norm, logz_base += log norm + max.  Bound: the
// serial chain (two block reductions per step) plus S (and P) shared-
// memory FMAs per state and step.  Frames t >= len get α̂ = 0, norm = 1;
// an empty row keeps last = init and logz_base = 0.
//
// K14 (kShifts, llh stream only) replaces _make_fwd_llh_kernel (wrapper
// forward_llh_pass): it also writes shifts (B, T) = the row max on frames
// t < len and 0 after, frame 0 fires on every row (an empty row sees e = 1
// there, so it carries normalise(init) with norm_0 = Σ init), and frames
// t >= max(len, 1) copy the carry into α̂ (norm = 1, shift = 0).
// ---------------------------------------------------------------------
template <bool kStats, bool kShifts>
__global__ void forward_llh_dense_kernel(
    const float* __restrict__ x,      // (B, T, P) stats or (B, T, S) llh
    const int* __restrict__ lens,     // (B,)
    const float* __restrict__ w,      // (S, P)  (kStats)
    const float* __restrict__ bias,   // (S,)    (kStats)
    const float* __restrict__ trans,  // (S, S), [i, j] = p(j | i)
    const float* __restrict__ init,   // (B, S)
    float* __restrict__ alpha,        // (B, T, S)
    float* __restrict__ norms,        // (B, T)
    float* __restrict__ last,         // (B, S)
    float* __restrict__ logz,         // (B,)
    float* __restrict__ shifts,       // (B, T)  (kShifts)
    int T, int S, int P) {
  extern __shared__ float smem[];
  const int ldt = odd_stride(S), ldw = odd_stride(P);
  float* a_sh = smem;                                  // A, (S, ldt)
  float* p_sh = a_sh + static_cast<size_t>(S) * ldt;   // α̂_{t−1}
  float* v_sh = p_sh + S;                              // llh_t, then raw_t
  float* red = v_sh + S;
  float* w_sh = red + 2 * kMaxWarps;                   // kStats: W, (S, ldw)
  float* bias_sh = w_sh + static_cast<size_t>(S) * ldw;
  float* x_sh = bias_sh + S;                           // kStats: stats_t

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int len = lens[b];
  for (int i = tid; i < S * S; i += nt) {
    const int r = i / S;
    a_sh[r * ldt + (i - r * S)] = trans[i];
  }
  if (kStats) {
    for (int i = tid; i < S * P; i += nt) {
      const int s = i / P;
      w_sh[s * ldw + (i - s * P)] = w[i];
    }
    for (int s = tid; s < S; s += nt) bias_sh[s] = bias[s];
  }
  for (int s = tid; s < S; s += nt) p_sh[s] = init[static_cast<size_t>(b) * S + s];
  const size_t row = kStats ? P : S;
  const float* x_b = x + static_cast<size_t>(b) * T * row;
  float* al_b = alpha + static_cast<size_t>(b) * T * S;
  float* n_b = norms + static_cast<size_t>(b) * T;
  float logz_acc = 0.f;
  const int n_fire = kShifts ? min(max(len, 1), T) : len;

  for (int t = 0; t < n_fire; ++t) {
    const float* x_t = x_b + static_cast<size_t>(t) * row;
    if (kStats) {
      for (int p = tid; p < P; p += nt) x_sh[p] = x_t[p];
      __syncthreads();
    }
    const bool pad = kShifts && t >= len;  // frame 0 of an empty row: e = 1, shift 0
    float mx = -FLT_MAX, unused = 0.f;
    for (int s = tid; s < S; s += nt) {
      float l;
      if (kStats) {
        const float* wr = w_sh + s * ldw;
        l = 0.f;
        for (int p = 0; p < P; ++p) l = fmaf(wr[p], x_sh[p], l);
        l += bias_sh[s];
      } else {
        l = pad ? 0.f : x_t[s];
      }
      v_sh[s] = l;
      mx = fmaxf(mx, l);
    }
    block_max_sum(mx, unused, red);
    if (kShifts && tid == 0) shifts[static_cast<size_t>(b) * T + t] = mx;
    float sum = 0.f;
    for (int j = tid; j < S; j += nt) {
      float base;
      if (t == 0) {
        base = p_sh[j];
      } else {
        base = 0.f;
        for (int i = 0; i < S; ++i) base = fmaf(p_sh[i], a_sh[i * ldt + j], base);
      }
      const float raw = base * expf(v_sh[j] - mx);
      v_sh[j] = raw;
      sum += raw;
    }
    block_sum_sum(sum, unused, red);
    const float norm = fmaxf(sum, FLT_MIN);
    for (int s = tid; s < S; s += nt) {
      const float a = v_sh[s] / norm;
      p_sh[s] = a;
      al_b[static_cast<size_t>(t) * S + s] = a;
    }
    if (tid == 0) n_b[t] = norm;
    logz_acc += logf(norm) + mx;
  }
  __syncthreads();
  for (int s = tid; s < S; s += nt) last[static_cast<size_t>(b) * S + s] = p_sh[s];
  if (tid == 0) logz[b] = logz_acc;
  for (size_t i = static_cast<size_t>(n_fire) * S + tid; i < static_cast<size_t>(T) * S; i += nt)
    al_b[i] = kShifts ? p_sh[i % S] : 0.f;
  for (int t = n_fire + tid; t < T; t += nt) {
    n_b[t] = 1.f;
    if (kShifts) shifts[static_cast<size_t>(b) * T + t] = 0.f;
  }
}

// ---------------------------------------------------------------------
// K6 (kAcc) — accumulating dense v-space backward.
// Replaces beer_tpu/ops/pallas_scan.py _make_estep_ckpt_acc_kernel_lm
// (wrapper phone_loop_estep_ckpt_acc_lm with bands=None, trans=(S, S),
// full ξ, fused ELLH, stored α̂).
// K7 (!kAcc) — γ-emitting dense v-space backward.
// Replaces beer_tpu/ops/pallas_scan.py _make_estep_ckpt_kernel_lm
// (wrapper phone_loop_estep_ckpt_pass_lm with bands=None, trans=(S, S),
// full ξ; α̂ is read from K5 instead of recomputed from checkpoints).
//
// Walking t from len−1 down to 0: u1 = final_b at the last frame,
// otherwise u1_i = Σ_j A(i, j) v̂_{t+1}(j); v = e·u1; v̂ = v / max(Σv,
// FLT_MIN); γ = α̂·u1 / max(Σ α̂·u1, FLT_MIN); wgt = 1 / (norm·Σ(α̂u1)/Σv)
// (0 below the ξ floor); ξ_raw(i, j) += α̂_t(i)·wgt_{t+1}·v̂_{t+1}(j).
// K6 computes llh from W·stats as K5 does and reduces γ in shared
// memory to acc (S, P+1) = Σ γ ⊗ [stats, 1] plus γ₀; K7 reads the llh
// stream and writes γ (0 on frames t >= len).  The expected transition
// counts are ξ_raw ⊙ A, applied by the caller.  Bound: the serial chain
// plus S FMAs (propagate) + S FMAs (ξ) + 2·P FMAs (K6: ELLH and moments)
// per state and step, all in shared memory; α̂ streams in once.
//
// K15 (!kAcc, kRestrict) replaces _make_estep_kernel (wrapper
// phone_loop_estep_pass): ξ_raw is accumulated only on the block
// [rows][:, cols], (n_r, n_c), by an exact gather of α̂_t[rows] and
// v̂_{t+1}[cols] (no one-hot product), so the per-utterance partial is
// n_r·n_c floats instead of S².
// ---------------------------------------------------------------------
template <bool kAcc, bool kRestrict>
__global__ void estep_dense_kernel(
    const float* __restrict__ x,       // kAcc: (B, T, P) stats; else (B, T, S) llh
    const int* __restrict__ lens,      // (B,)
    const float* __restrict__ w,       // (S, P)  (kAcc)
    const float* __restrict__ bias,    // (S,)    (kAcc)
    const float* __restrict__ trans,   // (S, S)
    const float* __restrict__ final_,  // (B, S)
    const float* __restrict__ alpha,   // (B, T, S)
    const float* __restrict__ norms,   // (B, T)
    const int* __restrict__ rows,      // (n_r,)  (kRestrict)
    const int* __restrict__ cols,      // (n_c,)  (kRestrict)
    float* __restrict__ part,          // (B, [S*(P+1)] + n_r*n_c)
    float* __restrict__ gamma0,        // (B, S)     (kAcc)
    float* __restrict__ gamma,         // (B, T, S)  (!kAcc)
    int T, int S, int P, int n_r, int n_c) {  // n_r = n_c = S unless kRestrict
  extern __shared__ float smem[];
  const int ldt = odd_stride(S), ldw = odd_stride(P), lda = odd_stride(P + 1);
  const int n_xi = n_r * n_c;
  float* a_sh = smem;                                   // A, (S, ldt)
  float* xi_sh = a_sh + static_cast<size_t>(S) * ldt;   // (n_r, n_c)
  int* rows_sh = reinterpret_cast<int*>(xi_sh + n_xi);  // kRestrict: n_r + n_c indices
  int* cols_sh = rows_sh + n_r;
  float* fin_sh = xi_sh + n_xi + (kRestrict ? n_r + n_c : 0);
  float* vh_prev = fin_sh + S;  // v̂_{t+1}
  float* vh_cur = vh_prev + S;  // v̂_t
  float* al_sh = vh_cur + S;    // α̂_t
  float* v_sh = al_sh + S;      // llh_t, then v_t
  float* ab_sh = v_sh + S;      // α̂_t·u1_t
  float* red = ab_sh + S;
  float* w_sh = red + 2 * kMaxWarps;                    // kAcc: W, (S, ldw)
  float* acc_sh = w_sh + static_cast<size_t>(S) * ldw;  // kAcc: (S, lda)
  float* bias_sh = acc_sh + static_cast<size_t>(S) * lda;
  float* x_sh = bias_sh + S;                            // kAcc: stats_t

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int len = lens[b];
  for (int i = tid; i < S * S; i += nt) {
    const int r = i / S;
    a_sh[r * ldt + (i - r * S)] = trans[i];
  }
  for (int i = tid; i < n_xi; i += nt) xi_sh[i] = 0.f;
  if (kRestrict) {
    for (int i = tid; i < n_r; i += nt) rows_sh[i] = rows[i];
    for (int i = tid; i < n_c; i += nt) cols_sh[i] = cols[i];
  }
  if (kAcc) {
    for (int i = tid; i < S * P; i += nt) {
      const int s = i / P;
      w_sh[s * ldw + (i - s * P)] = w[i];
    }
    for (int i = tid; i < S * lda; i += nt) acc_sh[i] = 0.f;
    for (int s = tid; s < S; s += nt) bias_sh[s] = bias[s];
  }
  for (int s = tid; s < S; s += nt) {
    fin_sh[s] = final_[static_cast<size_t>(b) * S + s];
    vh_prev[s] = 0.f;
  }
  const size_t row = kAcc ? P : S;
  const float* x_b = x + static_cast<size_t>(b) * T * row;
  const float* al_b = alpha + static_cast<size_t>(b) * T * S;
  const float* n_b = norms + static_cast<size_t>(b) * T;
  float* g_b = kAcc ? nullptr : gamma + static_cast<size_t>(b) * T * S;
  float wgt_next = 0.f;  // wgt_{t+1}

  for (int t = len - 1; t >= 0; --t) {
    __syncthreads();  // the previous step's readers of x_sh / al_sh / vh_prev are done
    const float* x_t = x_b + static_cast<size_t>(t) * row;
    if (kAcc) {
      for (int p = tid; p < P; p += nt) x_sh[p] = x_t[p];
    }
    for (int s = tid; s < S; s += nt) al_sh[s] = al_b[static_cast<size_t>(t) * S + s];
    __syncthreads();
    float mx = -FLT_MAX, unused = 0.f;
    for (int s = tid; s < S; s += nt) {
      float l;
      if (kAcc) {
        const float* wr = w_sh + s * ldw;
        l = 0.f;
        for (int p = 0; p < P; ++p) l = fmaf(wr[p], x_sh[p], l);
        l += bias_sh[s];
      } else {
        l = x_t[s];
      }
      v_sh[s] = l;
      mx = fmaxf(mx, l);
    }
    block_max_sum(mx, unused, red);
    const bool is_last = t == len - 1;
    float sv = 0.f, absum = 0.f;
    for (int i = tid; i < S; i += nt) {
      float u1;
      if (is_last) {
        u1 = fin_sh[i];
      } else {
        const float* ar = a_sh + i * ldt;
        u1 = 0.f;
        for (int j = 0; j < S; ++j) u1 = fmaf(ar[j], vh_prev[j], u1);
      }
      const float v = expf(v_sh[i] - mx) * u1;
      const float ab = al_sh[i] * u1;
      v_sh[i] = v;
      ab_sh[i] = ab;
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
      if (kAcc) {
        float* ar = acc_sh + s * lda;
        for (int p = 0; p < P; ++p) ar[p] = fmaf(g, x_sh[p], ar[p]);
        ar[P] += g;
        if (t == 0) gamma0[static_cast<size_t>(b) * S + s] = g;
      } else {
        g_b[static_cast<size_t>(t) * S + s] = g;
      }
    }
    if (!is_last) {
      for (int j = tid; j < n_c; j += nt) {
        const float vj = vh_prev[kRestrict ? cols_sh[j] : j];
        for (int i = 0; i < n_r; ++i) {
          const float ai = al_sh[kRestrict ? rows_sh[i] : i];
          xi_sh[i * n_c + j] = fmaf(ai * wgt_next, vj, xi_sh[i * n_c + j]);
        }
      }
    }
    wgt_next = wgt;
    float* tmp = vh_prev;
    vh_prev = vh_cur;
    vh_cur = tmp;
  }
  __syncthreads();
  const int n_acc = kAcc ? S * (P + 1) : 0;
  float* out = part + static_cast<size_t>(b) * (n_acc + n_xi);
  if (kAcc) {
    for (int i = tid; i < n_acc; i += nt) {
      const int s = i / (P + 1);
      out[i] = acc_sh[s * lda + (i - s * (P + 1))];
    }
    if (len == 0) {
      for (int s = tid; s < S; s += nt) gamma0[static_cast<size_t>(b) * S + s] = 0.f;
    }
  } else {
    for (size_t i = static_cast<size_t>(len) * S + tid; i < static_cast<size_t>(T) * S; i += nt) g_b[i] = 0.f;
  }
  for (int k = tid; k < n_xi; k += nt) out[n_acc + k] = xi_sh[k];
}

}  // namespace

extern "C" {

size_t beer_dense_forward_smem_bytes(int s, int p) { return dense_forward_smem_floats(s, p) * sizeof(float); }

size_t beer_dense_estep_smem_bytes(int s, int p) {
  return dense_backward_smem_floats(s, p, static_cast<size_t>(s) * s) * sizeof(float);
}

size_t beer_dense_estep_restricted_smem_bytes(int s, int n_r, int n_c) {
  return dense_backward_smem_floats(s, 0, static_cast<size_t>(n_r) * n_c + n_r + n_c) * sizeof(float);
}

// P > 0: x is the stats stream and w/bias give llh; P == 0: x is llh.
int beer_forward_llh_dense(int device, const float* x, const int* lens, const float* w, const float* bias,
                           const float* trans, const float* init, float* alpha, float* norms, float* last,
                           float* logz, int B, int T, int S, int P, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_dense_forward_smem_bytes(S, P);
  err = P > 0 ? set_smem(forward_llh_dense_kernel<true, false>, smem)
              : set_smem(forward_llh_dense_kernel<false, false>, smem);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P > 0) {
    const int nt = block_threads(forward_llh_dense_kernel<true, false>, S);
    forward_llh_dense_kernel<true, false><<<B, nt, smem, st>>>(x, lens, w, bias, trans, init, alpha, norms, last,
                                                               logz, nullptr, T, S, P);
  } else {
    const int nt = block_threads(forward_llh_dense_kernel<false, false>, S);
    forward_llh_dense_kernel<false, false><<<B, nt, smem, st>>>(x, lens, w, bias, trans, init, alpha, norms, last,
                                                                logz, nullptr, T, S, 0);
  }
  return cudaGetLastError();
}

// K14: the llh stream, with the row-max shifts written out and the carry
// copied through frames t >= len.
int beer_forward_llh_shifts_dense(int device, const float* llh, const int* lens, const float* trans,
                                  const float* init, float* alpha, float* norms, float* last, float* logz,
                                  float* shifts, int B, int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_dense_forward_smem_bytes(S, 0);
  err = set_smem(forward_llh_dense_kernel<false, true>, smem);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  const int nt = block_threads(forward_llh_dense_kernel<false, true>, S);
  forward_llh_dense_kernel<false, true><<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      llh, lens, nullptr, nullptr, trans, init, alpha, norms, last, logz, shifts, T, S, 0);
  return cudaGetLastError();
}

int beer_estep_acc_dense(int device, const float* stats, const int* lens, const float* w, const float* bias,
                         const float* trans, const float* final_, const float* alpha, const float* norms,
                         float* part, float* out, float* gamma0, int B, int T, int S, int P, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_dense_estep_smem_bytes(S, P);
  err = set_smem(estep_dense_kernel<true, false>, smem);
  if (err != cudaSuccess) return err;
  const int n = S * (P + 1) + S * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    const int nt = block_threads(estep_dense_kernel<true, false>, S);
    estep_dense_kernel<true, false><<<B, nt, smem, st>>>(stats, lens, w, bias, trans, final_, alpha, norms, nullptr,
                                                         nullptr, part, gamma0, nullptr, T, S, P, S, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, B, n);
  return cudaGetLastError();
}

int beer_estep_gamma_dense(int device, const float* llh, const int* lens, const float* trans, const float* final_,
                           const float* alpha, const float* norms, float* part, float* out, float* gamma, int B,
                           int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_dense_estep_smem_bytes(S, 0);
  err = set_smem(estep_dense_kernel<false, false>, smem);
  if (err != cudaSuccess) return err;
  const int n = S * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    const int nt = block_threads(estep_dense_kernel<false, false>, S);
    estep_dense_kernel<false, false><<<B, nt, smem, st>>>(llh, lens, nullptr, nullptr, trans, final_, alpha, norms,
                                                          nullptr, nullptr, part, nullptr, gamma, T, S, 0, S, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, B, n);
  return cudaGetLastError();
}

// K15: ξ_raw restricted to [rows][:, cols]; part is (B, n_r·n_c), out (n_r, n_c).
int beer_estep_gamma_dense_restricted(int device, const float* llh, const int* lens, const float* trans,
                                      const float* final_, const float* alpha, const float* norms, const int* rows,
                                      const int* cols, float* part, float* out, float* gamma, int B, int T, int S,
                                      int n_r, int n_c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_dense_estep_restricted_smem_bytes(S, n_r, n_c);
  err = set_smem(estep_dense_kernel<false, true>, smem);
  if (err != cudaSuccess) return err;
  const int n = n_r * n_c;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    const int nt = block_threads(estep_dense_kernel<false, true>, S);
    estep_dense_kernel<false, true><<<B, nt, smem, st>>>(llh, lens, nullptr, nullptr, trans, final_, alpha, norms,
                                                         rows, cols, part, nullptr, gamma, T, S, 0, n_r, n_c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n > 0) sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, B, n);
  return cudaGetLastError();
}

}  // extern "C"
