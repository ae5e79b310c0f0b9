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
// above each kernel names them.  K12 and K13's dense instance: one thread
// block per utterance, threads over states in strided loops, the time loop
// inside the block, the transition operand (a dense (S, S) matrix with an
// odd row stride, or the four band vectors) in shared memory for the whole
// recursion, every reduction in a fixed order.  What bounds them is the
// serial chain (two or three block reductions a step) and, for the dense
// instances, S shared-memory FMAs per state and step; the (B, T, S) streams
// are read and written once, coalesced.  K13's banded instance runs frames
// in chunks on the chain design of K3 and K11 (its note below): the chain
// keeps only what depends on the carry.
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

#include <type_traits>

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

size_t smoothing_smem_floats(bool global, int s) {  // the dense instance
  return operand_smem_floats(false, global, s) + 5 * static_cast<size_t>(s) + 2 * kMaxWarps;
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
// K13 — v-space backward with the smoothing outputs in-step, dense.
// Replaces beer_tpu/ops/pallas_scan.py _make_smoothing_kernel (wrapper
// backward_smoothing_pass); the banded instance is the chunked kernel
// below.
//
// Walking t from len − 1 down to 0 with the carry v̂_{t+1}: u1 = final at
// the last frame, else A v̂_{t+1}; ν = max(Σu1, FLT_MIN); ab = α̂_t ⊙ (u1/ν);
// post_norm = Σab; γ = ab / max(post_norm, FLT_MIN); v = e_t ⊙ u1; sv =
// max(Σv, FLT_MIN); ŵ = v / sv (the next carry); w_sums = sv / ν.  No
// transcendental.  On frames t >= len the kernel writes γ = 0, ŵ = 0 and
// w_sums = post_norm = 1: no consumer reads them (their ξ weight is 0), the
// TPU kernel writes the drifting recursion there.
// ---------------------------------------------------------------------
template <bool kGlobal>
__global__ void smoothing_pass_kernel(
    const float* __restrict__ e,       // (B, T, S)
    const float* __restrict__ alpha,   // (B, T, S), K12's forward α̂
    const int* __restrict__ lens,      // (B,)
    const float* __restrict__ mat,     // (S, S) (kGlobal: Aᵀ)
    const float* __restrict__ final_,  // (B, S)
    float* __restrict__ gamma,         // (B, T, S)
    float* __restrict__ w_out,         // (B, T, S)
    float* __restrict__ wsum,          // (B, T)
    float* __restrict__ pnorm,         // (B, T)
    int T, int S) {
  extern __shared__ float smem[];
  const int ldt = odd_stride(S);
  float* mat_sh = smem;
  float* fin_sh = mat_sh + operand_smem_floats(false, kGlobal, S);
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
  if (!kGlobal) load_transitions<false>(mat_sh, mat, S, ldt);
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
    float unused = 0.f;
    float su = 0.f, sv = 0.f;
    for (int i = tid; i < S; i += nt) {
      float u1;
      if (is_last) {
        u1 = fin_sh[i];
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

// ---------------------------------------------------------------------
// K13 — the banded instance, in chunks.
// Replaces beer_tpu/ops/pallas_scan.py _make_smoothing_banded_kernel
// (wrapper backward_smoothing_banded).  The recursion and the outputs are
// the dense instance's with A v̂ = v̂ ⊙ a_self + shift_up(v̂) ⊙ a_adv +
// (Σ w·v̂)·exit (the last state takes no advance), in the plain version's
// per-element order: ab = α̂·(u1/ν) with ν floored, then its sum (dividing
// Σα̂u1 by ν once would change which frames underflow to γ = 0).
//
// What bounds it on the H100 is the serial chain: a step is a few FMAs a
// state and three sums, so the chain keeps only what depends on the carry,
// as K3 and K11 do.  Frames go in chunks of C from each utterance's end;
// one barrier a chunk, and in between:
//   * the chain walks chunk c.  Up to S = 32·kSmoRegs, one warp an
//     utterance, a lane holding kSmoRegs consecutive states' v̂ in
//     registers (state i + 1 of its last one by one shuffle): per step u1,
//     v = e·u1 (e from the chunk's ring stage), then one shuffle tree of
//     Σu1, Σv and Σw·v, and the carry v̂ = v·(1/Σv), r = Σw·v / Σv — no
//     barrier.  Above, a block walks one utterance: its chain threads (two
//     states a thread, up to kSmoChainWarps warps) strided over the states
//     read v_{t+1} from shared memory and scale it by 1/Σv_{t+1} as they
//     read it (K11's normalised carry), and a named barrier a step joins
//     the warps' three partial sums.  The chain writes
//     u1 and v (over e) and per frame Σu1 and Σv to shared memory; the
//     utterance's last frame (u1 = final) is a step of its own, so that no
//     step waits on a load from device memory;
//   * the other warps ("side") fetch chunk c + 1's e and α̂ (each C·S
//     contiguous floats) by 16-byte cp.async into rings of three stages
//     and finish chunk c − 1 from what its chain left, a warp a frame: ab =
//     α̂·(u1/ν), post_norm = Σab, γ = ab·(1 / max(post_norm, FLT_MIN)), ŵ =
//     v·(1/sv), w_sums = sv/ν, written coalesced.
// Frames t >= len get γ = 0, ŵ = 0, w_sums = post_norm = 1, as the dense
// instance writes them (the whole block, after its chains).  A block runs
// n_utt utterances on the warp chain; two placements (kGlobal): the bands
// in shared memory or read from device memory.  The wrapper picks the
// placement, n_utt and C (cuda_scan.smoothing_banded_geometry).
// ---------------------------------------------------------------------
constexpr int kSmoThreads = 512;      // a block: the chain's warps and the side warps
constexpr int kSmoRegs = 6;           // the warp chain keeps v̂ in registers up to S = 32·kSmoRegs
constexpr int kSmoChainWarps = 8;     // the block chain: warps on the chain at most
constexpr int kSmoChunk = 16;         // frames a chunk, at most (cuda_scan.ACC_CHUNKS)

struct SmoLayout {  // float offsets into one K13 banded block's shared memory
  size_t bands, red, utt, stage, per_utt, total;
  int ldg;
};

__host__ __device__ inline SmoLayout smo_layout(int S, int n_utt, int C, bool global) {
  SmoLayout l;
  l.ldg = static_cast<int>(round4(S));
  l.stage = round4(static_cast<size_t>(C) * S + 6);  // a chunk's C·S floats in whole 16-byte segments
  size_t o = 0;
  l.bands = o;  // (a_self, a_adv, exit, w) a float4 a state
  if (!global) o += 4 * static_cast<size_t>(l.ldg);
  l.red = o;  // the block chain: 2 stages × (Σu1, Σv, Σw·v) a warp
  o += 6 * kMaxWarps;
  l.utt = o;
  l.per_utt = 6 * l.stage                            // rings: 3 × e (then v), 3 × α̂
              + 2 * static_cast<size_t>(C) * l.ldg   // 2 × u1 (then ab) (C, ldg)
              + 2 * round4(2 * static_cast<size_t>(C));  // 2 × per frame Σu1, Σv
  o += static_cast<size_t>(n_utt) * l.per_utt;
  l.total = o;
  return l;
}

// The chain's threads of a block-chain block at S states: two states a
// thread, at most kSmoChainWarps warps; the block's other warps are side
// warps.
__host__ __device__ inline int smo_block_chain(int S) {
  const int warps = (S + 63) / 64;
  return 32 * (warps < kSmoChainWarps ? warps : kSmoChainWarps);
}

// The offset of g's float in a stage that cp_async_run filled from g.
__device__ __forceinline__ int smo_head(const float* g) { return run_head(g) >> 2; }

template <bool kGlobal, int kRegs>
__global__ void __launch_bounds__(kSmoThreads, 2) smoothing_banded_chunked_kernel(
    const float* __restrict__ e,       // (B, T, S)
    const float* __restrict__ alpha,   // (B, T, S), K12's forward α̂
    const int* __restrict__ lens,      // (B,)
    const float* __restrict__ bands,   // (4, S): a_self, a_adv, exit, w
    const float* __restrict__ final_,  // (B, S)
    float* __restrict__ gamma,         // (B, T, S)
    float* __restrict__ w_out,         // (B, T, S)
    float* __restrict__ wsum,          // (B, T)
    float* __restrict__ pnorm,         // (B, T)
    int B, int T, int S, int n_utt, int chunk) {
  constexpr bool kBlock = kRegs == 0;  // the block chain, one utterance a block
  const int C = chunk;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const SmoLayout L = smo_layout(S, n_utt, C, kGlobal);
  const int ldg = L.ldg;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * n_utt;
  // the chain's threads: warp u for utterance u, or smo_block_chain(S) threads; the rest are side threads
  const int n_chain = kBlock ? smo_block_chain(S) : 32 * n_utt;
  const int sid = tid - n_chain, n_side = nt - n_chain;
  float4* band_sh = reinterpret_cast<float4*>(smem + L.bands);
  float* red = smem + L.red;
  // utterance u's pieces: ring stage st of e (then v) and of α̂, stage st of u1 (then ab) and of the frame sums
  auto ering = [&](int u, int st) { return smem + L.utt + u * L.per_utt + st * L.stage; };
  auto aring = [&](int u, int st) { return ering(u, 3 + st); };
  auto ubuf = [&](int u, int st) { return ering(u, 6) + static_cast<size_t>(st) * C * ldg; };
  auto sbuf = [&](int u, int st) { return ubuf(u, 2) + st * round4(2 * static_cast<size_t>(C)); };
  auto len_of = [&](int u) { return b0 + u < B ? min(lens[b0 + u], T) : 0; };
  // frame lo's row of utterance u in device memory (e or α̂), whose chunk starts there
  auto grow = [&](const float* x, int u, int lo) { return x + (static_cast<size_t>(b0 + u) * T + lo) * S; };
  // chunk c of utterance u: frames lo .. lo + nf − 1, counted from its end
  auto span = [&](int u, int c, int& lo) {
    const int hi = len_of(u) - 1 - c * C;
    lo = max(hi - C + 1, 0);
    return hi >= 0 ? hi - lo + 1 : 0;
  };
  auto band = [&](int s) {
    return kGlobal ? make_float4(bands[s], bands[S + s], bands[2 * S + s], bands[3 * S + s]) : band_sh[s];
  };

  int n_chunks = 0;
  for (int u = 0; u < n_utt; ++u) n_chunks = max(n_chunks, (len_of(u) + C - 1) / C);
  const float* e_end = e + static_cast<size_t>(B) * T * S;
  const float* a_end = alpha + static_cast<size_t>(B) * T * S;
  auto fetch = [&](int c) {  // chunk c's e and α̂ (its nf·S contiguous floats each) into ring stage c % 3
    for (int u = 0; u < n_utt; ++u) {
      int lo;
      const int nf = span(u, c, lo);
      if (nf == 0) continue;
      const size_t n = sizeof(float) * nf * S;
      cp_async_run(ering(u, c % 3), grow(e, u, lo), n, e, e_end, sid, n_side);
      cp_async_run(aring(u, c % 3), grow(alpha, u, lo), n, alpha, a_end, sid, n_side);
    }
    cp_async_commit();
  };
  if (sid >= 0 && n_chunks > 0) fetch(0);
  for (int s = tid; s < (kGlobal ? 0 : ldg); s += nt)
    band_sh[s] = s < S ? make_float4(bands[s], bands[S + s], bands[2 * S + s], bands[3 * S + s])
                       : make_float4(0.f, 0.f, 0.f, 0.f);

  // the chain's carry: the warp chain's v̂ of the lane's states lane·kRegs + k at the frame after the
  // current one; the block chain reads v of that frame from shared memory and scales it by ip = 1/Σv
  float vh[kRegs > 0 ? kRegs : 1];
#pragma unroll
  for (int k = 0; k < (kRegs > 0 ? kRegs : 1); ++k) vh[k] = 0.f;
  float r = 0.f, ip = 0.f;  // Σw·v̂ of the frame after the current one; the block chain's 1/Σv there

  // one step of utterance u's chain at frame f of chunk c, nf frames, e0 its first row of e (then v), v1
  // the first row of chunk c − 1 (kLast: the utterance's last frame, u1 = final)
  auto chain_step = [&](int u, int c, int f, int nf, float* e0, const float* v1, auto last) {
    constexpr bool kLast = decltype(last)::value;
    float* er = e0 + static_cast<size_t>(f) * S;
    float* ur = ubuf(u, c & 1) + static_cast<size_t>(f) * ldg;
    float* sc = sbuf(u, c & 1);
    const float* fin = final_ + static_cast<size_t>(b0 + u) * S;
    float su = 0.f, sv = 0.f, sw = 0.f;
    if constexpr (kRegs > 0) {
      float ev[kRegs];
      float4 bd[kRegs];
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {  // what does not wait for the carry first
        const int s = lane * kRegs + k;
        ev[k] = s < S ? er[s] : 0.f;
        bd[k] = s < S ? band(s) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float vn = __shfl_down_sync(0xffffffffu, vh[0], 1);  // v̂ of the next lane's first state
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {
        const int s = lane * kRegs + k;
        const float up = k + 1 < kRegs ? vh[k + 1] : (lane < 31 ? vn : 0.f);  // 0 past S
        float u1 = 0.f;
        if (s < S) u1 = kLast ? fin[s] : fmaf(r, bd[k].z, fmaf(vh[k], bd[k].x, up * bd[k].y));
        const float v = ev[k] * u1;
        if (s < S) {
          ur[s] = u1;
          er[s] = v;
        }
        vh[k] = v;  // scaled below
        su += u1;
        sv += v;
        sw = fmaf(v, bd[k].w, sw);
      }
      for (int o = 16; o > 0; o >>= 1) {  // one tree for the three sums; every lane gets them
        su += __shfl_xor_sync(0xffffffffu, su, o);
        sv += __shfl_xor_sync(0xffffffffu, sv, o);
        sw += __shfl_xor_sync(0xffffffffu, sw, o);
      }
      const float ipv = 1.f / fmaxf(sv, FLT_MIN);
#pragma unroll
      for (int k = 0; k < kRegs; ++k) vh[k] *= ipv;
      r = sw * ipv;
      if (lane == 0) {
        sc[f] = su;
        sc[C + f] = sv;
      }
    } else {
      // v of the frame after: the row above, or chunk c − 1's first row (its stage is intact until c + 1)
      const float* vn = f == nf - 1 ? v1 : er + S;
      for (int s = tid; s < S; s += n_chain) {
        const float4 bd = band(s);
        float u1;
        if constexpr (kLast) {
          u1 = fin[s];
        } else {
          const float up = s + 1 < S ? vn[s + 1] * ip : 0.f;
          u1 = fmaf(r, bd.z, fmaf(vn[s] * ip, bd.x, up * bd.y));
        }
        const float v = er[s] * u1;
        ur[s] = u1;
        er[s] = v;
        su += u1;
        sv += v;
        sw = fmaf(v, bd.w, sw);
      }
      for (int o = 16; o > 0; o >>= 1) {
        su += __shfl_xor_sync(0xffffffffu, su, o);
        sv += __shfl_xor_sync(0xffffffffu, sv, o);
        sw += __shfl_xor_sync(0xffffffffu, sw, o);
      }
      float* part = red + (f & 1) * 3 * kMaxWarps;  // a chunk's steps alternate; chunks are apart by a barrier
      if (lane == 0) {
        part[warp] = su;
        part[kMaxWarps + warp] = sv;
        part[2 * kMaxWarps + warp] = sw;
      }
      asm volatile("bar.sync 1, %0;" ::"r"(n_chain) : "memory");  // also: row f (v) is complete
      su = sv = sw = 0.f;
      for (int i = 0; i < (n_chain >> 5); ++i) {  // every thread, in one order
        su += part[i];
        sv += part[kMaxWarps + i];
        sw += part[2 * kMaxWarps + i];
      }
      ip = 1.f / fmaxf(sv, FLT_MIN);
      r = sw * ip;
      if (tid == 0) {
        sc[f] = su;
        sc[C + f] = sv;
      }
    }
  };
  auto walk = [&](int u, int c) {  // utterance u's frames of chunk c, last first
    int lo;
    const int nf = span(u, c, lo);
    float* e0 = ering(u, c % 3) + smo_head(grow(e, u, lo));
    const float* v1 = ering(u, (c + 2) % 3) + smo_head(grow(e, u, lo + nf));  // read from c = 1 on
    int f = nf - 1;
    if (c == 0 && nf > 0) chain_step(u, c, f--, nf, e0, v1, std::true_type{});
    for (; f >= 0; --f) chain_step(u, c, f, nf, e0, v1, std::false_type{});
  };

  // frame lo + f of utterance u's chunk c, by one warp: its outputs from what the chain left
  auto finish = [&](int u, int c, int f, int lo) {
    const float* sc = sbuf(u, c & 1);
    const float nu = fmaxf(sc[f], FLT_MIN), isv = 1.f / fmaxf(sc[C + f], FLT_MIN);
    float* ur = ubuf(u, c & 1) + static_cast<size_t>(f) * ldg;
    const float* vr = ering(u, c % 3) + smo_head(grow(e, u, lo)) + static_cast<size_t>(f) * S;
    const float* ar = aring(u, c % 3) + smo_head(grow(alpha, u, lo)) + static_cast<size_t>(f) * S;
    const size_t t_row = static_cast<size_t>(b0 + u) * T + lo + f;
    float pn = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float ab = ar[s] * (ur[s] / nu);
      ur[s] = ab;  // read back below by this lane alone
      pn += ab;
    }
    pn = warp_sum(pn);
    const float ig = 1.f / fmaxf(pn, FLT_MIN);
    for (int s = lane; s < S; s += 32) {
      gamma[t_row * S + s] = ur[s] * ig;
      w_out[t_row * S + s] = vr[s] * isv;
    }
    if (lane == 0) {
      wsum[t_row] = fmaxf(sc[C + f], FLT_MIN) / nu;
      pnorm[t_row] = pn;
    }
  };

  for (int c = 0; c <= n_chunks; ++c) {
    if (sid >= 0) cp_async_wait(false);
    // chunk c has landed; chain c − 1 is done (u1, v and its sums written) and so is the output of c − 2
    __syncthreads();
    if (sid >= 0) {
      if (c + 1 < n_chunks) fetch(c + 1);  // into the stages of chunk c − 2
      for (int i = sid >> 5; c > 0 && i < n_utt * C; i += n_side >> 5) {  // chunk c − 1's frames, a warp each
        const int u = i / C, f = i - u * C;
        int lo;
        if (f < span(u, c - 1, lo)) finish(u, c - 1, f, lo);
      }
      continue;
    }
    if (c < n_chunks) walk(kBlock ? 0 : warp, c);
  }
  // frames t >= len, by the whole block: the longest utterances, which set the kernel's time, have the
  // shortest tails
  for (int u = 0; u < n_utt; ++u) {
    if (b0 + u >= B) continue;
    const size_t row = static_cast<size_t>(b0 + u) * T;
    const int len = len_of(u);
    for (size_t i = static_cast<size_t>(len) * S + tid; i < static_cast<size_t>(T) * S; i += nt) {
      gamma[row * S + i] = 0.f;
      w_out[row * S + i] = 0.f;
    }
    for (int t = len + tid; t < T; t += nt) {
      wsum[row + t] = 1.f;
      pnorm[row + t] = 1.f;
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

template <bool kGlobal>
cudaError_t launch_smoothing(const float* e, const float* alpha, const int* lens, const float* mat,
                             const float* final_, float* gamma, float* w_out, float* wsum, float* pnorm, int B, int T,
                             int S, cudaStream_t st) {
  const size_t smem = smoothing_smem_floats(kGlobal, S) * sizeof(float);
  cudaError_t err = set_smem(smoothing_pass_kernel<kGlobal>, smem);
  if (err != cudaSuccess) return err;
  const int nt = block_threads(smoothing_pass_kernel<kGlobal>, S);
  smoothing_pass_kernel<kGlobal><<<B, nt, smem, st>>>(e, alpha, lens, mat, final_, gamma, w_out, wsum, pnorm, T, S);
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

size_t beer_smoothing_smem_bytes(int s, int global) {  // the dense instance
  return smoothing_smem_floats(global != 0, s) * sizeof(float);
}

// K13's banded instance at n_utt utterances a block (above S = 32·kSmoRegs
// one) and `chunk` frames a chunk; global != 0: the bands read from device
// memory.
size_t beer_smoothing_banded_smem_bytes(int s, int global, int n_utt, int chunk) {
  return smo_layout(s, n_utt, chunk, global != 0).total * sizeof(float);
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

// K13's dense instance; with global, mat is Aᵀ.
int beer_smoothing_pass(int device, int global, const float* e, const float* alpha, const int* lens, const float* mat,
                        const float* final_, float* gamma, float* w_out, float* wsum, float* pnorm, int B, int T,
                        int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return global ? launch_smoothing<true>(e, alpha, lens, mat, final_, gamma, w_out, wsum, pnorm, B, T, S, st)
                : launch_smoothing<false>(e, alpha, lens, mat, final_, gamma, w_out, wsum, pnorm, B, T, S, st);
}

int beer_smoothing_banded(int device, int global, int n_utt, int chunk, const float* e, const float* alpha,
                          const int* lens, const float* bands, const float* final_, float* gamma, float* w_out,
                          float* wsum, float* pnorm, int B, int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int regs = (S + 31) / 32 <= kSmoRegs ? (S + 31) / 32 : 0;
  if (chunk < 1 || chunk > kSmoChunk || n_utt < 1 || (regs == 0 ? n_utt != 1 : n_utt > kSmoThreads / 64))
    return cudaErrorInvalidValue;
  const size_t smem = beer_smoothing_banded_smem_bytes(S, global, n_utt, chunk);
  // the warp chain up to S = 32·kSmoRegs, an instance a register count; the block chain above
  using Kernel = decltype(&smoothing_banded_chunked_kernel<false, 0>);
#define BEER_SMO(R) {smoothing_banded_chunked_kernel<false, R>, smoothing_banded_chunked_kernel<true, R>}
  static_assert(kSmoRegs == 6, "one instance a register count");
  const Kernel kernels[kSmoRegs + 1][2] = {BEER_SMO(0), BEER_SMO(1), BEER_SMO(2), BEER_SMO(3),
                                           BEER_SMO(4), BEER_SMO(5), BEER_SMO(6)};
#undef BEER_SMO
  const Kernel kernel = kernels[regs][global != 0];
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  kernel<<<(B + n_utt - 1) / n_utt, kSmoThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      e, alpha, lens, bands, final_, gamma, w_out, wsum, pnorm, B, T, S, n_utt, chunk);
  return cudaGetLastError();
}

}  // extern "C"
