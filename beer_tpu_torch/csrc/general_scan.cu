// General-path scan kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by beer_tpu_torch/ops/cuda_scan.py.
//
// Two kernels carry the probability-space smoothing of the general path
// (semiring_scan.forward_backward_probs on one shared transition matrix,
// i.e. PhoneLoop.smooth and the log-domain forward_backward): the
// materialised-posterior E-step that the subspace-HMM statistics bridge
// needs.
//
//   K12 scaled_pass     scaled recursion over precomputed e_llh = exp(llh −
//                       rowmax): normalised carries and the cumulative
//                       log-scale per frame.  Instances: dense forward,
//                       banded forward, dense reverse (the β̂ pass);
//   K13 smoothing_pass  v-space backward over e_llh and K12's α̂, emitting γ,
//                       ŵ = normalise(e·β̂) and the two per-frame normalisers
//                       that the ξ counts are rebuilt from.  Instances:
//                       dense and banded.
//
// Each replaces Pallas TPU kernels of beer_tpu/ops/pallas_scan.py; the note
// above each kernel names them.  The design is that of the other scan
// kernels: one thread block per utterance, threads over states in strided
// loops, the time loop inside the block, the transition operand (a dense
// (S, S) matrix with an odd row stride, or the four band vectors) in shared
// memory for the whole recursion, every reduction in a fixed order.  What
// bounds them is the serial chain (two or three block reductions a step)
// and, for the dense instances, S shared-memory FMAs per state and step;
// the (B, T, S) streams are read and written once, coalesced.
//
// The dense instances have a second placement (template flag kGlobal), as
// K5–K7 have (hmm_scan.cu): above S = 239 (K12) or 237 (K13) the (S, S)
// matrix is read from device memory, where it stays in L2, as A for the
// forward (threads walk its columns) and as Aᵀ for the reverse and the
// smoothing (threads walk rows of A), so that each warp reads contiguous
// addresses; the wrapper picks it (cuda_scan.dense_placement).
//
// The contract differs from K1/K5's: these passes copy the carry through
// frames t >= len into the outputs (callers read the last stored frame as
// the last valid one), and frame 0 always fires, so a row of length 0
// carries normalise(init).  The caller feeds e_llh = 1 on frames t >= len.

#include "scan_common.cuh"

namespace {

enum PassMode { kDenseForward = 0, kBandedForward = 1, kDenseReverse = 2 };

// Floats of the transition operand in shared memory: the four band
// vectors, the dense matrix with an odd row stride, or none (global).
__host__ __device__ inline size_t operand_smem_floats(bool banded, bool global, int s) {
  if (banded) return 4 * static_cast<size_t>(s);
  return global ? 0 : static_cast<size_t>(s) * odd_stride(s);
}

size_t scaled_pass_smem_floats(int mode, bool global, int s) {
  return operand_smem_floats(mode == kBandedForward, global, s) + 2 * static_cast<size_t>(s) + 2 * kMaxWarps;
}

size_t smoothing_smem_floats(bool banded, bool global, int s) {
  return operand_smem_floats(banded, global, s) + 5 * static_cast<size_t>(s) + 2 * kMaxWarps;
}

// Copies the transition operand into shared memory: the four band vectors
// [a_self, a_adv, exit, w] as they are, a dense matrix with row stride ldt.
template <bool kBanded>
__device__ __forceinline__ void load_transitions(float* mat_sh, const float* __restrict__ mat, int S, int ldt) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (kBanded) {
    for (int i = tid; i < 4 * S; i += nt) mat_sh[i] = mat[i];
  } else {
    for (int i = tid; i < S * S; i += nt) {
      const int r = i / S;
      mat_sh[r * ldt + (i - r * S)] = mat[i];
    }
  }
}

// ---------------------------------------------------------------------
// K12 — scaled pass over precomputed e_llh.
// Replaces beer_tpu/ops/pallas_scan.py _make_fwd_kernel (wrapper
// forward_pass; kDenseForward), _make_fwd_banded_kernel (wrapper
// forward_pass_banded; kBandedForward) and _make_bwd_kernel (wrapper
// backward_pass; kDenseReverse).
//
// Forward: p_0 = normalise(vec ⊙ e_0), p_t = normalise((p_{t−1} A) ⊙ e_t),
// c_t = c_{t−1} + log norm_t (c starts at 0); frame 0 fires on every row,
// frames t >= max(len, 1) copy (p, c).  Banded: (pA)_j = p_j·a_self_j +
// p_{j−1}·a_adv_{j−1} + (Σ_i p_i·exit_i)·w_j, lane 0 takes no advance.
// Reverse: the carry starts at vec / Σvec with c = log Σvec and is stored on
// frames t >= len − 1; frame t < len − 1 stores normalise(A (p ⊙ e_{t+1})).
// ---------------------------------------------------------------------

// The carry and the per-step scratch of one utterance's scaled pass.
struct PassState {
  const float* mat;     // the transition operand: bands or A(i, j) = mat[i·a_rs + j·a_cs]
  float* p_sh;          // the carry
  float* v_sh;          // raw_t (forward); p ⊙ e_{t+1}, then raw_t (reverse)
  float* red;
  const float* e_b;     // this utterance's (T, S) likelihoods
  float* p_b;           // its (T, S) output carries
  float* c_b;           // its (T,) output log-scales
  int len, T, S, a_rs, a_cs;
};

template <bool kBanded>
__device__ void forward_chain(const PassState& st, const float* __restrict__ vec_b) {
  const int tid = threadIdx.x, nt = blockDim.x, S = st.S, a_rs = st.a_rs;
  float* p_sh = st.p_sh;
  float* v_sh = st.v_sh;
  const float* mat_sh = st.mat;
  float c = 0.f, unused = 0.f;
  for (int s = tid; s < S; s += nt) p_sh[s] = vec_b[s];
  const int n_fire = min(max(st.len, 1), st.T);
  for (int t = 0; t < n_fire; ++t) {
    const float* e_t = st.e_b + static_cast<size_t>(t) * S;
    __syncthreads();  // the carry (or the first frame's vec) is complete
    float q = 0.f;
    if (kBanded && t > 0) {
      for (int s = tid; s < S; s += nt) q += p_sh[s] * mat_sh[2 * S + s];
      block_sum_sum(q, unused, st.red);
    }
    float sum = 0.f;
    for (int j = tid; j < S; j += nt) {
      float base;
      if (t == 0) {
        base = p_sh[j];
      } else if (kBanded) {
        const float shifted = j > 0 ? p_sh[j - 1] * mat_sh[S + j - 1] : 0.f;
        base = p_sh[j] * mat_sh[j] + shifted + q * mat_sh[3 * S + j];
      } else {
        base = 0.f;
#pragma unroll 32
        for (int i = 0; i < S; ++i) base = fmaf(p_sh[i], mat_sh[i * a_rs + j], base);  // a_cs = 1
      }
      const float raw = base * e_t[j];
      v_sh[j] = raw;
      sum += raw;
    }
    block_sum_sum(sum, unused, st.red);  // every read of the carry is behind its barrier
    const float norm = fmaxf(sum, FLT_MIN);
    for (int s = tid; s < S; s += nt) {
      const float a = v_sh[s] / norm;
      p_sh[s] = a;
      st.p_b[static_cast<size_t>(t) * S + s] = a;
    }
    c += logf(norm);
    if (tid == 0) st.c_b[t] = c;
  }
  __syncthreads();
  for (size_t i = static_cast<size_t>(n_fire) * S + tid; i < static_cast<size_t>(st.T) * S; i += nt)
    st.p_b[i] = p_sh[i % S];
  for (int t = n_fire + tid; t < st.T; t += nt) st.c_b[t] = c;
}

__device__ void reverse_chain(const PassState& st, const float* __restrict__ vec_b) {
  const int tid = threadIdx.x, nt = blockDim.x, S = st.S, a_rs = st.a_rs, a_cs = st.a_cs;
  float* p_sh = st.p_sh;
  float* v_sh = st.v_sh;
  float sum = 0.f, unused = 0.f;
  for (int s = tid; s < S; s += nt) {
    const float f = vec_b[s];
    p_sh[s] = f;
    sum += f;
  }
  block_sum_sum(sum, unused, st.red);
  const float norm0 = fmaxf(sum, FLT_MIN);
  for (int s = tid; s < S; s += nt) p_sh[s] /= norm0;
  float c = logf(norm0);
  __syncthreads();
  const int t_keep = st.len > 0 ? st.len - 1 : 0;  // frames from here on store the initial carry
  for (size_t i = static_cast<size_t>(t_keep) * S + tid; i < static_cast<size_t>(st.T) * S; i += nt)
    st.p_b[i] = p_sh[i % S];
  for (int t = t_keep + tid; t < st.T; t += nt) st.c_b[t] = c;
  for (int t = st.len - 2; t >= 0; --t) {
    const float* e_n = st.e_b + static_cast<size_t>(t + 1) * S;
    __syncthreads();  // the previous step's carry is complete (and the fill above has read it)
    for (int j = tid; j < S; j += nt) v_sh[j] = p_sh[j] * e_n[j];
    __syncthreads();
    sum = 0.f;
    for (int i = tid; i < S; i += nt) {
      const float* ar = st.mat + i * a_rs;
      float raw = 0.f;
#pragma unroll 32
      for (int j = 0; j < S; ++j) raw = fmaf(ar[j * a_cs], v_sh[j], raw);
      p_sh[i] = raw;  // only its own thread reads p_sh[i] before the next barrier
      sum += raw;
    }
    block_sum_sum(sum, unused, st.red);
    const float norm = fmaxf(sum, FLT_MIN);
    for (int i = tid; i < S; i += nt) {
      const float a = p_sh[i] / norm;
      p_sh[i] = a;
      st.p_b[static_cast<size_t>(t) * S + i] = a;
    }
    c += logf(norm);
    if (tid == 0) st.c_b[t] = c;
  }
}

template <int kMode, bool kGlobal>
__global__ void scaled_pass_kernel(
    const float* __restrict__ e,     // (B, T, S), 1 on frames t >= len
    const int* __restrict__ lens,    // (B,)
    const float* __restrict__ mat,   // (S, S) (kGlobal reverse: Aᵀ) or (4, S)
    const float* __restrict__ vec,   // (B, S) init (forward) or final (reverse)
    float* __restrict__ probs,       // (B, T, S)
    float* __restrict__ logcs,       // (B, T)
    int T, int S) {
  extern __shared__ float smem[];
  constexpr bool kBanded = kMode == kBandedForward;
  const int ldt = odd_stride(S), b = blockIdx.x;
  float* p_sh = smem + operand_smem_floats(kBanded, kGlobal, S);
  if (!kGlobal) load_transitions<kBanded>(smem, mat, S, ldt);
  // the dense matrix: shared (ldt, 1); global A (S, 1) forward, Aᵀ (1, S) reverse
  const int a_rs = !kGlobal ? ldt : kMode == kDenseReverse ? 1 : S;
  const int a_cs = kGlobal && kMode == kDenseReverse ? S : 1;
  const PassState st{kGlobal ? mat : smem,
                     p_sh,
                     p_sh + S,
                     p_sh + 2 * S,
                     e + static_cast<size_t>(b) * T * S,
                     probs + static_cast<size_t>(b) * T * S,
                     logcs + static_cast<size_t>(b) * T,
                     min(lens[b], T),
                     T,
                     S,
                     a_rs,
                     a_cs};
  const float* vec_b = vec + static_cast<size_t>(b) * S;
  if (kMode == kDenseReverse) {
    reverse_chain(st, vec_b);
  } else {
    forward_chain<kBanded>(st, vec_b);
  }
}

// ---------------------------------------------------------------------
// K13 — v-space backward with the smoothing outputs in-step.
// Replaces beer_tpu/ops/pallas_scan.py _make_smoothing_kernel (wrapper
// backward_smoothing_pass; dense) and _make_smoothing_banded_kernel
// (wrapper backward_smoothing_banded; kBanded).
//
// Walking t from len − 1 down to 0 with the carry v̂_{t+1}: u1 = final at
// the last frame, else A v̂_{t+1} (banded: v̂_i·a_self_i + v̂_{i+1}·a_adv_i +
// exit_i·Σ_j w_j v̂_j, the last lane takes no advance); ν = max(Σu1, FLT_MIN);
// ab = α̂_t ⊙ (u1/ν); post_norm = Σab; γ = ab / max(post_norm, FLT_MIN);
// v = e_t ⊙ u1; sv = max(Σv, FLT_MIN); ŵ = v / sv (the next carry);
// w_sums = sv / ν.  No transcendental.  On frames t >= len the kernel
// writes γ = 0, ŵ = 0 and w_sums = post_norm = 1: no consumer reads them
// (their ξ weight is 0), the TPU kernel writes the drifting recursion there.
// ---------------------------------------------------------------------
template <bool kBanded, bool kGlobal>
__global__ void smoothing_pass_kernel(
    const float* __restrict__ e,       // (B, T, S)
    const float* __restrict__ alpha,   // (B, T, S), K12's forward α̂
    const int* __restrict__ lens,      // (B,)
    const float* __restrict__ mat,     // (S, S) (kGlobal: Aᵀ) or (4, S)
    const float* __restrict__ final_,  // (B, S)
    float* __restrict__ gamma,         // (B, T, S)
    float* __restrict__ w_out,         // (B, T, S)
    float* __restrict__ wsum,          // (B, T)
    float* __restrict__ pnorm,         // (B, T)
    int T, int S) {
  extern __shared__ float smem[];
  const int ldt = odd_stride(S);
  float* mat_sh = smem;
  float* fin_sh = mat_sh + operand_smem_floats(kBanded, kGlobal, S);
  // A(i, j) = a_m[i·a_rs + j·a_cs]: shared (ldt, 1), global Aᵀ (1, S)
  const float* a_m = kGlobal ? mat : mat_sh;
  const int a_rs = kGlobal ? 1 : ldt, a_cs = kGlobal ? S : 1;
  float* vh_sh = fin_sh + S;  // v̂_{t+1}
  float* u_sh = vh_sh + S;    // u1_t
  float* v_sh = u_sh + S;     // v_t
  float* ab_sh = v_sh + S;    // α̂_t·u1_t/ν
  float* red = ab_sh + S;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int len = min(lens[b], T);
  if (!kGlobal) load_transitions<kBanded>(mat_sh, mat, S, ldt);
  for (int s = tid; s < S; s += nt) {
    fin_sh[s] = final_[static_cast<size_t>(b) * S + s];
    vh_sh[s] = 0.f;
  }
  const size_t row = static_cast<size_t>(b) * T;
  const float* e_b = e + row * S;
  const float* al_b = alpha + row * S;
  float* g_b = gamma + row * S;
  float* w_b = w_out + row * S;

  for (size_t i = static_cast<size_t>(len) * S + tid; i < static_cast<size_t>(T) * S; i += nt) {
    g_b[i] = 0.f;
    w_b[i] = 0.f;
  }
  for (int t = len + tid; t < T; t += nt) {
    wsum[row + t] = 1.f;
    pnorm[row + t] = 1.f;
  }

  for (int t = len - 1; t >= 0; --t) {
    const bool is_last = t == len - 1;
    const float* e_t = e_b + static_cast<size_t>(t) * S;
    const float* al_t = al_b + static_cast<size_t>(t) * S;
    __syncthreads();  // the carry v̂_{t+1} (or the loads above) is complete
    float r = 0.f, unused = 0.f;
    if (kBanded && !is_last) {
      for (int s = tid; s < S; s += nt) r += mat_sh[3 * S + s] * vh_sh[s];
      block_sum_sum(r, unused, red);
    }
    float su = 0.f, sv = 0.f;
    for (int i = tid; i < S; i += nt) {
      float u1;
      if (is_last) {
        u1 = fin_sh[i];
      } else if (kBanded) {
        const float next = i + 1 < S ? vh_sh[i + 1] : 0.f;
        u1 = vh_sh[i] * mat_sh[i] + next * mat_sh[S + i] + r * mat_sh[2 * S + i];
      } else {
        const float* ar = a_m + i * a_rs;
        u1 = 0.f;
#pragma unroll 32
        for (int j = 0; j < S; ++j) u1 = fmaf(ar[j * a_cs], vh_sh[j], u1);
      }
      const float v = e_t[i] * u1;
      u_sh[i] = u1;
      v_sh[i] = v;
      su += u1;
      sv += v;
    }
    block_sum_sum(su, sv, red);  // every read of the carry is behind its barrier
    const float nu = fmaxf(su, FLT_MIN);
    sv = fmaxf(sv, FLT_MIN);
    float pn = 0.f;
    for (int i = tid; i < S; i += nt) {
      const float ab = al_t[i] * (u_sh[i] / nu);
      ab_sh[i] = ab;
      pn += ab;
    }
    block_sum_sum(pn, unused, red);
    const float gnorm = fmaxf(pn, FLT_MIN);
    for (int i = tid; i < S; i += nt) {
      const float w = v_sh[i] / sv;
      vh_sh[i] = w;
      g_b[static_cast<size_t>(t) * S + i] = ab_sh[i] / gnorm;
      w_b[static_cast<size_t>(t) * S + i] = w;
    }
    if (tid == 0) {
      wsum[row + t] = sv / nu;
      pnorm[row + t] = pn;
    }
  }
}

template <int kMode, bool kGlobal>
cudaError_t launch_scaled_pass(const float* e, const int* lens, const float* mat, const float* vec, float* probs,
                               float* logcs, int B, int T, int S, cudaStream_t st) {
  const size_t smem = scaled_pass_smem_floats(kMode, kGlobal, S) * sizeof(float);
  cudaError_t err = set_smem(scaled_pass_kernel<kMode, kGlobal>, smem);
  if (err != cudaSuccess) return err;
  const int nt = block_threads(scaled_pass_kernel<kMode, kGlobal>, S);
  scaled_pass_kernel<kMode, kGlobal><<<B, nt, smem, st>>>(e, lens, mat, vec, probs, logcs, T, S);
  return cudaGetLastError();
}

template <bool kBanded, bool kGlobal>
cudaError_t launch_smoothing(const float* e, const float* alpha, const int* lens, const float* mat,
                             const float* final_, float* gamma, float* w_out, float* wsum, float* pnorm, int B, int T,
                             int S, cudaStream_t st) {
  const size_t smem = smoothing_smem_floats(kBanded, kGlobal, S) * sizeof(float);
  cudaError_t err = set_smem(smoothing_pass_kernel<kBanded, kGlobal>, smem);
  if (err != cudaSuccess) return err;
  const int nt = block_threads(smoothing_pass_kernel<kBanded, kGlobal>, S);
  smoothing_pass_kernel<kBanded, kGlobal><<<B, nt, smem, st>>>(e, alpha, lens, mat, final_, gamma, w_out, wsum,
                                                                pnorm, T, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 dense forward, 1 banded forward, 2 dense reverse; global != 0:
// the dense matrix in device memory (the banded instances have no global
// placement).
size_t beer_scaled_pass_smem_bytes(int mode, int s, int global) {
  return scaled_pass_smem_floats(mode, global != 0, s) * sizeof(float);
}

size_t beer_smoothing_smem_bytes(int banded, int s, int global) {
  return smoothing_smem_floats(banded != 0, global != 0, s) * sizeof(float);
}

// With global, mat is A for the forward and Aᵀ for the reverse.
int beer_scaled_pass(int device, int mode, int global, const float* e, const int* lens, const float* mat,
                     const float* vec, float* probs, float* logcs, int B, int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (global && mode != kBandedForward) {
    return mode == kDenseForward
               ? launch_scaled_pass<kDenseForward, true>(e, lens, mat, vec, probs, logcs, B, T, S, st)
               : launch_scaled_pass<kDenseReverse, true>(e, lens, mat, vec, probs, logcs, B, T, S, st);
  }
  switch (mode) {
    case kDenseForward:
      return launch_scaled_pass<kDenseForward, false>(e, lens, mat, vec, probs, logcs, B, T, S, st);
    case kBandedForward:
      return launch_scaled_pass<kBandedForward, false>(e, lens, mat, vec, probs, logcs, B, T, S, st);
    case kDenseReverse:
      return launch_scaled_pass<kDenseReverse, false>(e, lens, mat, vec, probs, logcs, B, T, S, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// With global (dense only), mat is Aᵀ.
int beer_smoothing_pass(int device, int banded, int global, const float* e, const float* alpha, const int* lens,
                        const float* mat, const float* final_, float* gamma, float* w_out, float* wsum, float* pnorm,
                        int B, int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (banded) return launch_smoothing<true, false>(e, alpha, lens, mat, final_, gamma, w_out, wsum, pnorm, B, T, S, st);
  return global ? launch_smoothing<false, true>(e, alpha, lens, mat, final_, gamma, w_out, wsum, pnorm, B, T, S, st)
                : launch_smoothing<false, false>(e, alpha, lens, mat, final_, gamma, w_out, wsum, pnorm, B, T, S, st);
}

}  // extern "C"
