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
//
// Two placements of the operands, one template flag (kGlobal) on each
// kernel.  "shared": A (and the ELLH matrix W, and K6's moment
// accumulator) in shared memory, as above; it fits up to S = 239 (K5 on
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
// (cuda_scan.dense_placement).  Both placements write K6's moments as
// (P + 1, S), state-minor.

#include "scan_common.cuh"

namespace {

size_t dense_forward_smem_floats(int s, int p, bool global) {
  size_t n = 2 * static_cast<size_t>(s) + 2 * kMaxWarps;
  if (!global) n += static_cast<size_t>(s) * odd_stride(s);
  if (p > 0) n += s + p + (global ? 0 : static_cast<size_t>(s) * odd_stride(p));
  return n;
}

// n_xi: floats of the ξ accumulator (S·S, or n_r·n_c when ξ is
// restricted); n_idx: the restricted block's two index vectors.
size_t dense_backward_smem_floats(int s, int p, size_t n_xi, int n_idx, bool global) {
  size_t n = 6 * static_cast<size_t>(s) + 2 * kMaxWarps + n_idx;
  if (!global) n += static_cast<size_t>(s) * odd_stride(s) + n_xi;
  if (p > 0)
    n += s + p + (global ? 0 : static_cast<size_t>(s) * odd_stride(p) + static_cast<size_t>(s) * odd_stride(p + 1));
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
template <bool kStats, bool kShifts, bool kGlobal>
__global__ void forward_llh_dense_kernel(
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
    int T, int S, int P) {
  extern __shared__ float smem[];
  const int ldt = odd_stride(S), ldw = odd_stride(P);
  float* a_sh = smem;                                                   // A, (S, ldt)
  float* p_sh = a_sh + (kGlobal ? 0 : static_cast<size_t>(S) * ldt);   // α̂_{t−1}
  float* v_sh = p_sh + S;                                               // llh_t, then raw_t
  float* red = v_sh + S;
  float* w_sh = red + 2 * kMaxWarps;                                    // kStats: W, (S, ldw)
  float* bias_sh = w_sh + (kGlobal ? 0 : static_cast<size_t>(S) * ldw);
  float* x_sh = bias_sh + S;                                            // kStats: stats_t
  // A(i, j) = a_m[i·ldt_a + j]; W(s, p) = w_m[s·w_rs + p·w_cs]
  const float* a_m = kGlobal ? trans : a_sh;
  const float* w_m = kGlobal ? w : w_sh;
  const int ldt_a = kGlobal ? S : ldt, w_rs = kGlobal ? 1 : ldw, w_cs = kGlobal ? S : 1;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int len = lens[b];
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
        const float* wr = w_m + s * w_rs;
        l = 0.f;
#pragma unroll 16
        for (int p = 0; p < P; ++p) l = fmaf(wr[p * w_cs], x_sh[p], l);
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
#pragma unroll 32
        for (int i = 0; i < S; ++i) base = fmaf(p_sh[i], a_m[i * ldt_a + j], base);
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
// K6 computes llh from W·stats as K5 does and reduces γ to acc (S, P+1)
// = Σ γ ⊗ [stats, 1] (written as its transpose) plus γ₀; K7 reads the llh
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
template <bool kAcc, bool kRestrict, bool kGlobal>
__global__ void estep_dense_kernel(
    const float* __restrict__ x,       // kAcc: (B, T, P) stats; else (B, T, S) llh
    const int* __restrict__ lens,      // (B,)
    const float* __restrict__ w,       // (S, P), kGlobal: Wᵀ (P, S)  (kAcc)
    const float* __restrict__ bias,    // (S,)    (kAcc)
    const float* __restrict__ trans,   // (S, S), kGlobal: Aᵀ
    const float* __restrict__ final_,  // (B, S)
    const float* __restrict__ alpha,   // (B, T, S)
    const float* __restrict__ norms,   // (B, T)
    const int* __restrict__ rows,      // (n_r,)  (kRestrict)
    const int* __restrict__ cols,      // (n_c,)  (kRestrict)
    float* __restrict__ part,          // (B, [(P+1)*S] + n_r*n_c)
    float* __restrict__ gamma0,        // (B, S)     (kAcc)
    float* __restrict__ gamma,         // (B, T, S)  (!kAcc)
    int T, int S, int P, int n_r, int n_c) {  // n_r = n_c = S unless kRestrict
  extern __shared__ float smem[];
  const int ldt = odd_stride(S), ldw = odd_stride(P), lda = odd_stride(P + 1);
  const int n_xi = n_r * n_c;
  const int n_acc = kAcc ? S * (P + 1) : 0;
  float* out = part + static_cast<size_t>(blockIdx.x) * (n_acc + n_xi);  // this utterance's partial
  float* a_sh = smem;                                                      // A, (S, ldt)
  float* xi_sh = a_sh + (kGlobal ? 0 : static_cast<size_t>(S) * ldt);     // (n_r, n_c)
  int* rows_sh = reinterpret_cast<int*>(xi_sh + (kGlobal ? 0 : n_xi));     // kRestrict: n_r + n_c indices
  int* cols_sh = rows_sh + n_r;
  float* fin_sh = reinterpret_cast<float*>(rows_sh) + (kRestrict ? n_r + n_c : 0);
  float* vh_prev = fin_sh + S;  // v̂_{t+1}
  float* vh_cur = vh_prev + S;  // v̂_t
  float* al_sh = vh_cur + S;    // α̂_t
  float* v_sh = al_sh + S;      // llh_t, then v_t
  float* ab_sh = v_sh + S;      // α̂_t·u1_t
  float* red = ab_sh + S;
  float* w_sh = red + 2 * kMaxWarps;                                       // kAcc: W, (S, ldw)
  float* acc_sh = w_sh + (kGlobal ? 0 : static_cast<size_t>(S) * ldw);     // kAcc: (S, lda)
  float* bias_sh = acc_sh + (kGlobal ? 0 : static_cast<size_t>(S) * lda);
  float* x_sh = bias_sh + S;                                               // kAcc: stats_t
  // A(i, j) = a_m[i·a_rs + j·a_cs], W(s, p) = w_m[s·w_rs + p·w_cs], the
  // moments acc(s, p) = acc_m[s·acc_rs + p·acc_cs], ξ(i, j) = xi_m[i·n_c + j]
  const float* a_m = kGlobal ? trans : a_sh;
  const float* w_m = kGlobal ? w : w_sh;
  float* acc_m = kGlobal ? out : acc_sh;
  float* xi_m = kGlobal ? out + n_acc : xi_sh;
  const int a_rs = kGlobal ? 1 : ldt, a_cs = kGlobal ? S : 1;
  const int w_rs = kGlobal ? 1 : ldw, w_cs = kGlobal ? S : 1;
  const int acc_rs = kGlobal ? 1 : lda, acc_cs = kGlobal ? S : 1;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int len = lens[b];
  if (!kGlobal) {
    for (int i = tid; i < S * S; i += nt) {
      const int r = i / S;
      a_sh[r * ldt + (i - r * S)] = trans[i];
    }
  }
  // each ξ column and each state's moments belong to one thread, here and below
  for (int j = tid; j < n_c; j += nt)
    for (int i = 0; i < n_r; ++i) xi_m[i * n_c + j] = 0.f;
  if (kRestrict) {
    for (int i = tid; i < n_r; i += nt) rows_sh[i] = rows[i];
    for (int i = tid; i < n_c; i += nt) cols_sh[i] = cols[i];
  }
  if (kAcc) {
    if (!kGlobal) {
      for (int i = tid; i < S * P; i += nt) {
        const int s = i / P;
        w_sh[s * ldw + (i - s * P)] = w[i];
      }
    }
    for (int s = tid; s < S; s += nt)
      for (int p = 0; p <= P; ++p) acc_m[s * acc_rs + p * acc_cs] = 0.f;
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
        const float* wr = w_m + s * w_rs;
        l = 0.f;
#pragma unroll 16
        for (int p = 0; p < P; ++p) l = fmaf(wr[p * w_cs], x_sh[p], l);
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
        const float* ar = a_m + i * a_rs;
        u1 = 0.f;
#pragma unroll 32
        for (int j = 0; j < S; ++j) u1 = fmaf(ar[j * a_cs], vh_prev[j], u1);
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
        // sixteen reads in flight before their writes (the accumulator may
        // live in device memory); entry p gets fmaf(g, x_p, ·), entry P + g
        float* ar = acc_m + s * acc_rs;
        for (int p0 = 0; p0 <= P; p0 += 16) {
          float v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (p0 + u <= P) v[u] = ar[(p0 + u) * acc_cs];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (p0 + u <= P) ar[(p0 + u) * acc_cs] = p0 + u < P ? fmaf(g, x_sh[p0 + u], v[u]) : v[u] + g;
        }
        if (t == 0) gamma0[static_cast<size_t>(b) * S + s] = g;
      } else {
        g_b[static_cast<size_t>(t) * S + s] = g;
      }
    }
    if (!is_last) {
      for (int j = tid; j < n_c; j += nt) {
        const float vj = vh_prev[kRestrict ? cols_sh[j] : j];
        for (int i0 = 0; i0 < n_r; i0 += 16) {  // sixteen reads in flight, as above
          float v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (i0 + u < n_r) v[u] = xi_m[(i0 + u) * n_c + j];
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            if (i0 + u >= n_r) continue;
            const float ai = al_sh[kRestrict ? rows_sh[i0 + u] : i0 + u];
            xi_m[(i0 + u) * n_c + j] = fmaf(ai * wgt_next, vj, v[u]);
          }
        }
      }
    }
    wgt_next = wgt;
    float* tmp = vh_prev;
    vh_prev = vh_cur;
    vh_cur = tmp;
  }
  __syncthreads();
  if (kAcc) {
    if (!kGlobal) {
      for (int i = tid; i < n_acc; i += nt) {
        const int p = i / S, s = i - p * S;
        out[i] = acc_sh[s * lda + p];
      }
    }
    if (len == 0) {
      for (int s = tid; s < S; s += nt) gamma0[static_cast<size_t>(b) * S + s] = 0.f;
    }
  } else {
    for (size_t i = static_cast<size_t>(len) * S + tid; i < static_cast<size_t>(T) * S; i += nt) g_b[i] = 0.f;
  }
  if (!kGlobal) {
    for (int k = tid; k < n_xi; k += nt) out[n_acc + k] = xi_sh[k];
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

// global != 0: the global placement (see the note at the top).
size_t beer_dense_forward_smem_bytes(int s, int p, int global) {
  return dense_forward_smem_floats(s, p, global != 0) * sizeof(float);
}

size_t beer_dense_estep_smem_bytes(int s, int p, int global) {
  return dense_backward_smem_floats(s, p, static_cast<size_t>(s) * s, 0, global != 0) * sizeof(float);
}

size_t beer_dense_estep_restricted_smem_bytes(int s, int n_r, int n_c, int global) {
  return dense_backward_smem_floats(s, 0, static_cast<size_t>(n_r) * n_c, n_r + n_c, global != 0) * sizeof(float);
}

// P > 0: x is the stats stream and w/bias give llh (w is Wᵀ (P, S) when
// global); P == 0: x is llh.
int beer_forward_llh_dense(int device, int global, const float* x, const int* lens, const float* w,
                           const float* bias, const float* trans, const float* init, float* alpha, float* norms,
                           float* last, float* logz, int B, int T, int S, int P, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || B == 0) return err;
  const size_t smem = beer_dense_forward_smem_bytes(S, P, global);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P > 0)
    return launch_placed(global, forward_llh_dense_kernel<true, false, false>,
                         forward_llh_dense_kernel<true, false, true>, smem, B, S, st, x, lens, w, bias, trans,
                         init, alpha, norms, last, logz, static_cast<float*>(nullptr), T, S, P);
  return launch_placed(global, forward_llh_dense_kernel<false, false, false>,
                       forward_llh_dense_kernel<false, false, true>, smem, B, S, st, x, lens, w, bias, trans, init,
                       alpha, norms, last, logz, static_cast<float*>(nullptr), T, S, 0);
}

// K14: the llh stream, with the row-max shifts written out and the carry
// copied through frames t >= len.
int beer_forward_llh_shifts_dense(int device, int global, const float* llh, const int* lens, const float* trans,
                                  const float* init, float* alpha, float* norms, float* last, float* logz,
                                  float* shifts, int B, int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || B == 0) return err;
  return launch_placed(global, forward_llh_dense_kernel<false, true, false>,
                       forward_llh_dense_kernel<false, true, true>, beer_dense_forward_smem_bytes(S, 0, global), B,
                       S, static_cast<cudaStream_t>(stream), llh, lens, static_cast<const float*>(nullptr),
                       static_cast<const float*>(nullptr), trans, init, alpha, norms, last, logz, shifts, T, S, 0);
}

// trans is Aᵀ and w is Wᵀ (P, S) when global; part (B, (P+1)·S + S·S),
// out = Σ_b part[b]: the moments (P + 1, S), then ξ_raw (S, S).
int beer_estep_acc_dense(int device, int global, const float* stats, const int* lens, const float* w,
                         const float* bias, const float* trans, const float* final_, const float* alpha,
                         const float* norms, float* part, float* out, float* gamma0, int B, int T, int S, int P,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    err = launch_placed(global, estep_dense_kernel<true, false, false>, estep_dense_kernel<true, false, true>,
                        beer_dense_estep_smem_bytes(S, P, global), B, S, st, stats, lens, w, bias, trans, final_,
                        alpha, norms, static_cast<const int*>(nullptr), static_cast<const int*>(nullptr), part,
                        gamma0, static_cast<float*>(nullptr), T, S, P, S, S);
    if (err != cudaSuccess) return err;
  }
  const int n = S * (P + 1) + S * S;
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, B, n);
  return cudaGetLastError();
}

// trans is Aᵀ when global.
int beer_estep_gamma_dense(int device, int global, const float* llh, const int* lens, const float* trans,
                           const float* final_, const float* alpha, const float* norms, float* part, float* out,
                           float* gamma, int B, int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    err = launch_placed(global, estep_dense_kernel<false, false, false>, estep_dense_kernel<false, false, true>,
                        beer_dense_estep_smem_bytes(S, 0, global), B, S, st, llh, lens,
                        static_cast<const float*>(nullptr), static_cast<const float*>(nullptr), trans, final_,
                        alpha, norms, static_cast<const int*>(nullptr), static_cast<const int*>(nullptr), part,
                        static_cast<float*>(nullptr), gamma, T, S, 0, S, S);
    if (err != cudaSuccess) return err;
  }
  const int n = S * S;
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, B, n);
  return cudaGetLastError();
}

// K15: ξ_raw restricted to [rows][:, cols]; part is (B, n_r·n_c), out
// (n_r, n_c); trans is Aᵀ when global.
int beer_estep_gamma_dense_restricted(int device, int global, const float* llh, const int* lens,
                                      const float* trans, const float* final_, const float* alpha,
                                      const float* norms, const int* rows, const int* cols, float* part, float* out,
                                      float* gamma, int B, int T, int S, int n_r, int n_c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    err = launch_placed(global, estep_dense_kernel<false, true, false>, estep_dense_kernel<false, true, true>,
                        beer_dense_estep_restricted_smem_bytes(S, n_r, n_c, global), B, S, st, llh, lens,
                        static_cast<const float*>(nullptr), static_cast<const float*>(nullptr), trans, final_,
                        alpha, norms, rows, cols, part, static_cast<float*>(nullptr), gamma, T, S, 0, n_r, n_c);
    if (err != cudaSuccess) return err;
  }
  const int n = n_r * n_c;
  if (n > 0) sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, B, n);
  return cudaGetLastError();
}

}  // extern "C"
