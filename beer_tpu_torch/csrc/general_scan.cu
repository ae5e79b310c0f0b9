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
// above each kernel names them.  Two designs:
//   * the banded instances (K12's forward, K13's) run frames in chunks on
//     the chain design of K3 and K11: the chain keeps only what depends on
//     the carry (a warp an utterance up to S = 192, v̂ or p̂ in registers and
//     one shuffle tree a step; a block's chain warps above), side warps fetch
//     the next chunk by cp.async and finish the previous one.  What bounds
//     them is the chain's latency, a few FMAs a state and one tree a step;
//   * the dense instances (K12's forward and reverse, K13's) run a group of
//     n_utt utterances a block, one grouped step at a time: each step is an
//     (n_utt × S)·(S × S) product in register tiles of float32 FMA, so that
//     every element of A read from shared memory (or from L2 in the global
//     placement) feeds n_utt FMAs.  Their work is that product (S² FMAs an
//     utterance-step, 4.3 G at config 4); what bounds them on the card is the
//     latency of the three barrier-separated phases a step around it.
// Every sum is taken in a fixed order; two runs agree bitwise.
//
// The contract differs from K1/K5's: these passes copy the carry through
// frames t >= len into the outputs (callers read the last stored frame as
// the last valid one), and frame 0 always fires, so a row of length 0
// carries normalise(init).  The caller feeds e_llh = 1 on frames t >= len.

#include <type_traits>

#include "scan_common.cuh"

namespace {

// ---------------------------------------------------------------------
// The chunked chains' shape, shared by K12's and K13's banded instances.
// ---------------------------------------------------------------------
constexpr int kSmoThreads = 512;      // a block: the chain's warps and the side warps
constexpr int kSmoRegs = 6;           // the warp chain keeps its carry in registers up to S = 32·kSmoRegs
constexpr int kSmoChainWarps = 8;     // the block chain: warps on the chain at most
constexpr int kSmoChunk = 16;         // frames a chunk, at most (cuda_scan.ACC_CHUNKS)

// The chain's threads of a block-chain block at S states: two states a
// thread, at most kSmoChainWarps warps; the block's other warps are side
// warps.
__host__ __device__ inline int smo_block_chain(int S) {
  const int warps = (S + 63) / 64;
  return 32 * (warps < kSmoChainWarps ? warps : kSmoChainWarps);
}

// The offset of g's float in a stage that cp_async_run filled from g.
__device__ __forceinline__ int smo_head(const float* g) { return run_head(g) >> 2; }

// ---------------------------------------------------------------------
// K12 — the banded forward, in chunks.
// Replaces beer_tpu/ops/pallas_scan.py _make_fwd_banded_kernel (wrapper
// forward_pass_banded).
//
// p_0 = normalise(vec ⊙ e_0), p_t = normalise((p_{t−1} A) ⊙ e_t), c_t =
// c_{t−1} + log norm_t (c starts at 0), with (pA)_j = p_j·a_self_j +
// p_{j−1}·a_adv_{j−1} + q·w_j, q = Σ_i p_i·exit_i, lane 0 taking no
// advance.  Frame 0 fires on every row; frames t >= max(len, 1) copy (p, c).
//
// The parent ran a block an utterance with two block reductions a frame (q,
// then Σraw) and the e loads and probs writes on that chain.  Here frames go
// in chunks of C from frame 0, one barrier a chunk, and in between:
//   * the chain walks chunk c.  Up to S = 32·kSmoRegs one warp an
//     utterance, a lane holding kSmoRegs consecutive states' p̂ in registers
//     (state j − 1's p̂·a_adv of its first one by one shuffle): raw = (p̂A)
//     ⊙ e, then one shuffle tree of Σraw and Σraw·exit, and the carry p̂ =
//     raw·(1/norm), q = Σraw·exit / norm with norm = max(Σraw, FLT_MIN) —
//     no barrier, the carry normalised.  Above, a block walks one utterance:
//     its chain threads read raw_{t−1} from shared memory and scale it by
//     1/norm_{t−1} as they read it, and a named barrier a step joins the
//     warps' two partial sums.  The chain writes raw over e and norm per
//     frame;
//   * the side warps fetch chunk c + 1's e (C·S contiguous floats) by
//     16-byte cp.async into a ring of three stages and finish chunk c − 1: a
//     warp a frame writes probs = raw·(1/norm) coalesced, and one lane an
//     utterance adds log norm_t to its running log-scale frame by frame (the
//     plain version's order) and writes logcs.
// The copy-through frames are written after the chains, by the whole block.
// A block runs n_utt utterances on the warp chain; two placements (kGlobal):
// the bands in shared memory or read from device memory.  The wrapper picks
// the placement, n_utt and C (cuda_scan.scaled_banded_geometry).
// ---------------------------------------------------------------------
struct FwdLayout {  // float offsets into one K12 banded block's shared memory
  size_t bands, red, utt, stage, per_utt, total;
  int ldg;
};

__host__ __device__ inline FwdLayout fwd_layout(int S, int n_utt, int C, bool global) {
  FwdLayout l;
  l.ldg = static_cast<int>(round4(S));
  l.stage = round4(static_cast<size_t>(C) * S + 6);  // a chunk's C·S floats in whole 16-byte segments
  size_t o = 0;
  l.bands = o;  // (a_self, a_adv, exit, w) a float4 a state
  if (!global) o += 4 * static_cast<size_t>(l.ldg);
  l.red = o;  // the block chain: 2 stages × (Σraw, Σraw·exit) a warp
  o += 4 * kMaxWarps;
  l.utt = o;
  l.per_utt = 3 * l.stage + 2 * round4(static_cast<size_t>(C));  // ring: 3 × e (then raw); 2 × per frame norm
  o += static_cast<size_t>(n_utt) * l.per_utt;
  l.total = o;
  return l;
}

template <bool kGlobal, int kRegs>
__global__ void __launch_bounds__(kSmoThreads, 2) scaled_banded_chunked_kernel(
    const float* __restrict__ e,      // (B, T, S), 1 on frames t >= len
    const int* __restrict__ lens,     // (B,)
    const float* __restrict__ bands,  // (4, S): a_self, a_adv, exit, w
    const float* __restrict__ vec,    // (B, S) init
    float* __restrict__ probs,        // (B, T, S)
    float* __restrict__ logcs,        // (B, T)
    int B, int T, int S, int n_utt, int chunk) {
  constexpr bool kBlock = kRegs == 0;  // the block chain, one utterance a block
  const int C = chunk;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const FwdLayout L = fwd_layout(S, n_utt, C, kGlobal);
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * n_utt;
  // the chain's threads: warp u for utterance u, or smo_block_chain(S) threads; the rest are side threads
  const int n_chain = kBlock ? smo_block_chain(S) : 32 * n_utt;
  const int sid = tid - n_chain, n_side = nt - n_chain;
  float4* band_sh = reinterpret_cast<float4*>(smem + L.bands);
  float* red = smem + L.red;
  // utterance u's pieces: ring stage st of e (then raw), stage st of the per-frame norms
  auto ering = [&](int u, int st) { return smem + L.utt + u * L.per_utt + st * L.stage; };
  auto nbuf = [&](int u, int st) { return ering(u, 3) + st * round4(static_cast<size_t>(C)); };
  // frames that fire: at least frame 0 of every row
  auto n_fire = [&](int u) { return b0 + u < B ? min(max(lens[b0 + u], 1), T) : 0; };
  // frame lo's row of utterance u's e in device memory, whose chunk starts there
  auto grow = [&](int u, int lo) { return e + (static_cast<size_t>(b0 + u) * T + lo) * S; };
  // chunk c of utterance u: frames lo .. lo + nf − 1
  auto span = [&](int u, int c, int& lo) {
    lo = c * C;
    return max(min(C, n_fire(u) - lo), 0);
  };
  auto band = [&](int s) {
    return kGlobal ? make_float4(bands[s], bands[S + s], bands[2 * S + s], bands[3 * S + s]) : band_sh[s];
  };

  int n_chunks = 0;
  for (int u = 0; u < n_utt; ++u) n_chunks = max(n_chunks, (n_fire(u) + C - 1) / C);
  const float* e_end = e + static_cast<size_t>(B) * T * S;
  auto fetch = [&](int c) {  // chunk c's e (its nf·S contiguous floats) into ring stage c % 3
    for (int u = 0; u < n_utt; ++u) {
      int lo;
      const int nf = span(u, c, lo);
      if (nf > 0) cp_async_run(ering(u, c % 3), grow(u, lo), sizeof(float) * nf * S, e, e_end, sid, n_side);
    }
    cp_async_commit();
  };
  if (sid >= 0 && n_chunks > 0) fetch(0);
  for (int s = tid; s < (kGlobal ? 0 : L.ldg); s += nt)
    band_sh[s] = s < S ? make_float4(bands[s], bands[S + s], bands[2 * S + s], bands[3 * S + s])
                       : make_float4(0.f, 0.f, 0.f, 0.f);

  // the chain's carry: the warp chain's p̂ of the lane's states lane·kRegs + k at the previous frame; the
  // block chain reads raw of that frame from shared memory and scales it by ip = 1/norm there
  float ph[kRegs > 0 ? kRegs : 1];
#pragma unroll
  for (int k = 0; k < (kRegs > 0 ? kRegs : 1); ++k) ph[k] = 0.f;
  float q = 0.f, ip = 0.f;  // Σp̂·exit at the previous frame; the block chain's 1/norm there

  // one step of utterance u's chain at frame f of chunk c, e0 its first row of e (then raw), r1 the last
  // row of chunk c − 1 (kFirst: frame 0, raw = vec ⊙ e)
  auto chain_step = [&](int u, int c, int f, float* e0, const float* r1, auto first) {
    constexpr bool kFirst = decltype(first)::value;
    float* er = e0 + static_cast<size_t>(f) * S;
    float* sc = nbuf(u, c & 1);
    const float* v0 = vec + static_cast<size_t>(b0 + u) * S;
    float sr = 0.f, sx = 0.f;
    if constexpr (kRegs > 0) {
      float ev[kRegs];
      float4 bd[kRegs];
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {  // what does not wait for the carry first
        const int s = lane * kRegs + k;
        ev[k] = s < S ? er[s] : 0.f;
        bd[k] = s < S ? band(s) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      // p̂·a_adv of the previous lane's last state (0 past S and into lane 0)
      const float in = __shfl_up_sync(0xffffffffu, ph[kRegs - 1] * bd[kRegs - 1].y, 1);
      float raw[kRegs];
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {
        const int s = lane * kRegs + k;
        float base = 0.f;
        if (s < S) {
          if constexpr (kFirst) {
            base = v0[s];
          } else {
            const float shifted = k > 0 ? ph[k - 1] * bd[k - 1].y : (lane > 0 ? in : 0.f);
            base = ph[k] * bd[k].x + shifted + q * bd[k].w;
          }
        }
        raw[k] = base * ev[k];
        if (s < S) er[s] = raw[k];
        sr += raw[k];
        sx = fmaf(raw[k], bd[k].z, sx);
      }
      for (int o = 16; o > 0; o >>= 1) {  // one tree for the two sums; every lane gets them
        sr += __shfl_xor_sync(0xffffffffu, sr, o);
        sx += __shfl_xor_sync(0xffffffffu, sx, o);
      }
      const float norm = fmaxf(sr, FLT_MIN), ipn = 1.f / norm;
#pragma unroll
      for (int k = 0; k < kRegs; ++k) ph[k] = raw[k] * ipn;
      q = sx * ipn;
      if (lane == 0) sc[f] = norm;
    } else {
      // raw of the previous frame: the row above, or chunk c − 1's last row (its stage is intact until c + 1)
      const float* pr = f == 0 ? r1 : er - S;
      for (int s = tid; s < S; s += n_chain) {
        const float4 bd = band(s);
        float base;
        if constexpr (kFirst) {
          base = v0[s];
        } else {
          const float shifted = s > 0 ? (pr[s - 1] * ip) * band(s - 1).y : 0.f;
          base = (pr[s] * ip) * bd.x + shifted + q * bd.w;
        }
        const float raw = base * er[s];
        er[s] = raw;
        sr += raw;
        sx = fmaf(raw, bd.z, sx);
      }
      for (int o = 16; o > 0; o >>= 1) {
        sr += __shfl_xor_sync(0xffffffffu, sr, o);
        sx += __shfl_xor_sync(0xffffffffu, sx, o);
      }
      float* part = red + (f & 1) * 2 * kMaxWarps;  // a chunk's steps alternate; chunks are apart by a barrier
      if (lane == 0) {
        part[warp] = sr;
        part[kMaxWarps + warp] = sx;
      }
      asm volatile("bar.sync 1, %0;" ::"r"(n_chain) : "memory");  // also: row f (raw) is complete
      sr = sx = 0.f;
      for (int i = 0; i < (n_chain >> 5); ++i) {  // every thread, in one order
        sr += part[i];
        sx += part[kMaxWarps + i];
      }
      const float norm = fmaxf(sr, FLT_MIN);
      ip = 1.f / norm;
      q = sx * ip;
      if (tid == 0) sc[f] = norm;
    }
  };
  auto walk = [&](int u, int c) {  // utterance u's frames of chunk c
    int lo;
    const int nf = span(u, c, lo);
    float* e0 = ering(u, c % 3) + smo_head(grow(u, lo));
    // chunk c − 1's last row (read from c = 1 on, when chunk c − 1 held C frames)
    const float* r1 = ering(u, (c + 2) % 3) + smo_head(grow(u, lo > 0 ? lo - C : 0)) + static_cast<size_t>(C - 1) * S;
    int f = 0;
    if (c == 0 && nf > 0) chain_step(u, c, f++, e0, r1, std::true_type{});
    for (; f < nf; ++f) chain_step(u, c, f, e0, r1, std::false_type{});
  };

  float clog = 0.f;  // side thread u: utterance u's running log-scale
  for (int c = 0; c <= n_chunks; ++c) {
    if (sid >= 0) cp_async_wait(false);
    // chunk c has landed; chain c − 1 is done (raw and its norms written) and so is the output of c − 2
    __syncthreads();
    if (sid >= 0) {
      if (c + 1 < n_chunks) fetch(c + 1);  // into the stage of chunk c − 2
      if (c == 0) continue;
      for (int i = sid >> 5; i < n_utt * C; i += n_side >> 5) {  // chunk c − 1's frames, a warp each
        const int u = i / C, f = i - u * C;
        int lo;
        if (f >= span(u, c - 1, lo)) continue;
        const float ipn = 1.f / nbuf(u, (c - 1) & 1)[f];
        const float* rr = ering(u, (c - 1) % 3) + smo_head(grow(u, lo)) + static_cast<size_t>(f) * S;
        float* out = probs + (static_cast<size_t>(b0 + u) * T + lo + f) * S;
        for (int s = lane; s < S; s += 32) out[s] = rr[s] * ipn;
      }
      if (sid < n_utt) {  // the log-scales of chunk c − 1, frame by frame
        int lo;
        const int nf = span(sid, c - 1, lo);
        const float* sc = nbuf(sid, (c - 1) & 1);
        for (int f = 0; f < nf; ++f) {
          clog += logf(sc[f]);
          logcs[static_cast<size_t>(b0 + sid) * T + lo + f] = clog;
        }
      }
      continue;
    }
    if (c < n_chunks) walk(kBlock ? 0 : warp, c);
  }
  __syncthreads();  // the last frames' probs and logcs are in device memory
  // frames t >= max(len, 1) repeat the last fired frame, by the whole block
  for (int u = 0; u < n_utt; ++u) {
    if (b0 + u >= B) continue;
    const size_t row = static_cast<size_t>(b0 + u) * T;
    const int nf = n_fire(u);
    const float* last = probs + (row + nf - 1) * S;
    for (size_t i = static_cast<size_t>(nf) * S + tid; i < static_cast<size_t>(T) * S; i += nt)
      probs[row * S + i] = last[i % S];
    const float c_last = logcs[row + nf - 1];
    for (int t = nf + tid; t < T; t += nt) logcs[row + t] = c_last;
  }
}

// ---------------------------------------------------------------------
// K12 / K13 — the dense instances, a group of utterances a block.
// Replace beer_tpu/ops/pallas_scan.py _make_fwd_kernel (wrapper
// forward_pass; kGrpForward), _make_bwd_kernel (wrapper backward_pass;
// kGrpReverse) and _make_smoothing_kernel (wrapper
// backward_smoothing_pass; kGrpSmoothing).
//
// Forward: p_0 = normalise(vec ⊙ e_0), p_t = normalise((p_{t−1} A) ⊙ e_t),
// c_t = c_{t−1} + log norm_t; frame 0 fires on every row, frames t >=
// max(len, 1) copy (p, c).  Reverse: the carry starts at vec / Σvec with c =
// log Σvec and is stored on frames t >= len − 1; frame t < len − 1 stores
// normalise(A (p ⊙ e_{t+1})).  Smoothing: walking t from len − 1 down to 0
// with the carry v̂_{t+1}: u1 = final at the last frame, else A v̂_{t+1}; ν =
// max(Σu1, FLT_MIN); ab = α̂_t ⊙ (u1/ν); post_norm = Σab; γ = ab / max(post_norm,
// FLT_MIN); v = e_t ⊙ u1; sv = max(Σv, FLT_MIN); ŵ = v / sv (the next carry);
// w_sums = sv / ν — the plain version's per-element order, so γ underflows to 0
// on its frames.  On frames t >= len it writes γ = 0, ŵ = 0 and w_sums =
// post_norm = 1: no consumer reads them (their ξ weight is 0).
//
// The parent ran a block an utterance, so each step read all S² elements of
// A for one utterance: from shared memory at about 128 B a clock (about four
// utterances an SM at config 4), from L2 in the global placement (810 KB an
// utterance-step at S = 450).  Here a block carries kU utterances (the
// wrapper groups rows of similar length through a permutation, `order`) and
// every step is one product X·M of the group's carries X (S, kU), state-major,
// with M = A (forward) or Aᵀ (reverse, smoothing), padded to ld = round4(S)
// columns: a thread owns a group of four columns and a slice of the rows
// (ks slices while the column groups leave threads idle), holds a kU × 4 tile
// of sums and per row reads one float4 of M and one broadcast of X's kU
// values, so each element of M feeds kU FMAs.  The slices' partial sums go to
// shared memory and are added in slice order.  Then, per utterance (a
// thread's slot is tid mod kU, its states every kGrpThreads/kU-th): the
// step's vector, its sums by one block reduction (kU sums at once), the
// normalised carry written back in place, the outputs written coalesced;
// the log-scales are summed frame by frame after the loop.  Three barriers a
// step.  The streams of the next step (e, α̂; up to kGrpPrefetch states a
// thread) are loaded into registers a step ahead.  Two placements
// (`global`): M in shared memory, or its first rows that fit beside the rest
// there and the others read from device memory through L1.  What bounds the
// step at config 4 is latency: the product is about 0.43 of K12 dense's 1.11
// ms there, the three phases around the reductions the rest
// (stats_variants.py grpn_*); two blocks of 256 threads an SM beat one of
// 512 (PERF.md §6).  The wrapper picks the placement, kU and ks
// (cuda_scan.dense_grouped_geometry).
// ---------------------------------------------------------------------
enum GroupMode { kGrpForward = 0, kGrpReverse = 2, kGrpSmoothing = 3 };
constexpr int kGrpThreads = 256;
constexpr int kGrpMaxSlices = 8;
constexpr int kGrpSmemFloats = 232448 / 4;  // a block's shared memory at most (cuda_scan.SMEM_LIMIT)

struct GrpLayout {  // float offsets into one grouped block's shared memory
  size_t mat, x, part, ab, red, total;
  int ld, lp, rows;  // M's row stride; a partial-sum row's stride; M's rows kept in shared memory
};

// The stride of a partial-sum row, (ld, n_utt) state-major: at least ld,
// and such that the n_utt rows a warp reads at once (lane u reads row lane
// mod n_utt) fall in distinct banks.
__host__ __device__ inline int grp_part_stride(int ld, int n_utt) {
  if (n_utt == 1) return ld;
  const int m = 64 / n_utt, r = 32 / n_utt;
  return ld + ((r - ld % m) % m + m) % m;
}

// global: M read from device memory past the rows that fit beside the rest.
__host__ __device__ inline GrpLayout grp_layout(int mode, int S, int n_utt, int ks, bool global) {
  GrpLayout l;
  l.ld = static_cast<int>(round4(S));
  l.lp = grp_part_stride(l.ld, n_utt);
  const size_t vecs = static_cast<size_t>(l.ld) * n_utt;
  const size_t rest = vecs                                                  // the carries
                      + static_cast<size_t>(ks) * n_utt * l.lp               // the slices' partial sums
                      + (mode == kGrpSmoothing ? vecs : 0)                   // smoothing: α̂·u1/ν
                      + (mode == kGrpSmoothing ? 3 : 1) * static_cast<size_t>(n_utt) * kMaxWarps;  // the sums
  const size_t room = rest < static_cast<size_t>(kGrpSmemFloats) ? kGrpSmemFloats - rest : 0;
  l.rows = global ? static_cast<int>(min(static_cast<size_t>(S), room / l.ld)) : S;
  size_t o = 0;
  l.mat = o;  // M's first rows (S, ld)
  o += static_cast<size_t>(l.rows) * l.ld;
  l.x = o;  // the carries, (ld, n_utt): the product's input, then the step's vector
  o += vecs;
  l.part = o;  // ks slices of the product's partial sums, (n_utt, lp) each; slice 0 then u1 (smoothing)
  o += static_cast<size_t>(ks) * n_utt * l.lp;
  l.ab = o;  // smoothing: α̂·u1/ν, (ld, n_utt)
  if (mode == kGrpSmoothing) o += vecs;
  l.red = o;  // a sum a warp and utterance: one (forward, reverse), Σu1, Σv, Σab (smoothing)
  o += (mode == kGrpSmoothing ? 3 : 1) * static_cast<size_t>(n_utt) * kMaxWarps;
  l.total = o;
  return l;
}

template <int kU>
__device__ __forceinline__ void load_group(const float* p, float (&x)[kU]) {
  if constexpr (kU == 1) {
    x[0] = p[0];
  } else if constexpr (kU == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < kU / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  }
}

template <int kU>
__device__ __forceinline__ void grp_fma(float (&acc)[kU][4], const float4 a, const float* x) {
  float xv[kU];
  load_group<kU>(x, xv);
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    acc[u][0] = fmaf(xv[u], a.x, acc[u][0]);
    acc[u][1] = fmaf(xv[u], a.y, acc[u][1]);
    acc[u][2] = fmaf(xv[u], a.z, acc[u][2]);
    acc[u][3] = fmaf(xv[u], a.w, acc[u][3]);
  }
}

// part[sl] = X·M over slice sl of M's rows, for every column group: a thread
// a (column group, slice), striding over the column groups at one slice.
// M's first L.rows rows come from shared memory (m_sh), the others from
// device memory (m_g) with more loads in flight.
template <int kU>
__device__ __forceinline__ void grp_product(const float* m_sh, const float* __restrict__ m_g, const float* x,
                                            float* part, const GrpLayout& L, int S, int ks) {
  const int ncg = L.ld >> 2, rps = (S + ks - 1) / ks;
  const float4* s4 = reinterpret_cast<const float4*>(m_sh);
  const float4* g4 = reinterpret_cast<const float4*>(m_g);
  for (int w = threadIdx.x; w < ncg * ks; w += kGrpThreads) {
    const int cg = w % ncg, sl = w / ncg;
    const int r0 = sl * rps, r1 = min(S, r0 + rps), rs = min(r1, L.rows);
    float acc[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
#pragma unroll 4
    for (int i = r0; i < rs; ++i) grp_fma<kU>(acc, s4[static_cast<size_t>(i) * ncg + cg], x + static_cast<size_t>(i) * kU);
#pragma unroll 8
    for (int i = max(r0, L.rows); i < r1; ++i)
      grp_fma<kU>(acc, __ldg(g4 + static_cast<size_t>(i) * ncg + cg), x + static_cast<size_t>(i) * kU);
    float* out = part + static_cast<size_t>(sl) * kU * L.lp + 4 * cg;
#pragma unroll
    for (int u = 0; u < kU; ++u)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(u) * L.lp) = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }
}

// Element u of a small per-slot array, u known only at run time, without
// putting the array in local memory.
template <int kU>
__device__ __forceinline__ int slot_pick(const int (&a)[kU], int u) {
  int v = a[0];
#pragma unroll
  for (int q = 1; q < kU; ++q)
    if (q == u) v = a[q];
  return v;
}

// Block sums of v[n] over the threads of each slot (a thread's slot is
// tid mod kU): a warp's partials by one shuffle tree, then the warps in
// order; every thread gets its slot's kN sums.
template <int kN, int kU>
__device__ __forceinline__ void grp_reduce(float (&v)[kN], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, u = threadIdx.x % kU;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    for (int o = 16; o >= kU; o >>= 1) v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
    if (lane < kU) red[(n * kMaxWarps + warp) * kU + lane] = v[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    float s = 0.f;
    for (int w = 0; w < kGrpThreads / 32; ++w) s += red[(n * kMaxWarps + w) * kU + u];
    v[n] = s;
  }
}

constexpr int kGrpPrefetch = 8;  // stream values a thread loads a step ahead

template <int kMode, int kU>
__global__ void __launch_bounds__(kGrpThreads, 2) dense_grouped_kernel(
    const float* __restrict__ e,      // (B, T, S), 1 on frames t >= len
    const float* __restrict__ alpha,  // (B, T, S) K12's forward α̂ (smoothing)
    const int* __restrict__ lens,     // (B,)
    const int* __restrict__ order,    // (B,): the rows in group order
    const float* __restrict__ mat,    // (S, ld): A (forward) or Aᵀ, zero-padded columns
    const float* __restrict__ vec,    // (B, S): init (forward) or final
    float* __restrict__ out,          // (B, T, S): probs or γ
    float* __restrict__ w_out,        // (B, T, S): ŵ (smoothing)
    float* __restrict__ scal,         // (B, T): logcs or w_sums
    float* __restrict__ pnorm,        // (B, T): post_norm (smoothing)
    int B, int T, int S, int ks, int global) {
  constexpr bool kFwd = kMode == kGrpForward, kRev = kMode == kGrpReverse, kSmo = kMode == kGrpSmoothing;
  constexpr int kStride = kGrpThreads / kU;  // a thread's states are j0 + i·kStride
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const GrpLayout L = grp_layout(kMode, S, kU, ks, global != 0);
  const int tid = threadIdx.x, lp = L.lp;
  float* x = smem + L.x;
  float* part = smem + L.part;
  float* abv = smem + L.ab;
  float* red = smem + L.red;
  const size_t psl = static_cast<size_t>(kU) * lp;  // a slice of partial sums
  {  // M's first L.rows rows into shared memory
    const float4* src = reinterpret_cast<const float4*>(mat);
    float4* dst = reinterpret_cast<float4*>(smem + L.mat);
    for (size_t i = tid; i < static_cast<size_t>(L.rows) * (L.ld >> 2); i += kGrpThreads) dst[i] = src[i];
  }

  // the group's rows (slot u: row, length, steps: the forward's frames that fire, the reverse's len − 1, the
  // smoothing's len; none past B), and this thread's slot, whose states j0 + i·kStride it takes: element
  // j·kU + u of the (ld, kU) arrays is element tid + i·kGrpThreads
  int rows[kU], lens_u[kU], nst[kU], steps = 0;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int slot = blockIdx.x * kU + u;
    rows[u] = slot < B ? order[slot] : -1;
    lens_u[u] = rows[u] >= 0 ? min(lens[rows[u]], T) : 0;
    nst[u] = rows[u] < 0 ? 0 : kFwd ? min(max(lens_u[u], 1), T) : kRev ? max(lens_u[u] - 1, 0) : lens_u[u];
    steps = max(steps, nst[u]);
  }
  const int my = tid % kU, j0 = tid / kU;
  const int row = slot_pick(rows, my), len = slot_pick(lens_u, my);
  const int n_steps = slot_pick(nst, my);
  // this slot's frame at step k, the offset of its (T, S) row and of its (T,) entry
  auto frame = [&](int k) { return kFwd ? k : kRev ? len - 2 - k : len - 1 - k; };
  auto at = [&](int t) { return (static_cast<size_t>(row) * T + t) * S; };
  float* srow = scal + static_cast<size_t>(max(row, 0)) * T;
  // the thread's stream values of a step, loaded a step ahead: e (the forward's and the smoothing's at the
  // step's frame, the reverse's at the frame it computes) and α̂
  float pe[kGrpPrefetch], pa[kGrpPrefetch];
#pragma unroll
  for (int i = 0; i < kGrpPrefetch; ++i) pe[i] = pa[i] = 0.f;
  auto prefetch = [&](int k) {
    if (k >= n_steps) return;
    const size_t off = at(frame(k));
#pragma unroll
    for (int i = 0; i < kGrpPrefetch; ++i) {
      const int j = j0 + i * kStride;
      if (j < S) {
        pe[i] = __ldg(e + off + j);
        if (kSmo) pa[i] = __ldg(alpha + off + j);
      }
    }
  };
  float c0 = 0.f;  // the reverse's first log-scale
  if (kRev) {
    // the carry vec / Σvec, stored on frames t >= len − 1, then the first step's input p ⊙ e_{len−1}
    float sv[1] = {0.f};
    for (int j = j0; row >= 0 && j < S; j += kStride) {
      const float f = vec[static_cast<size_t>(row) * S + j];
      x[j * kU + my] = f;
      sv[0] += f;
    }
    grp_reduce<1, kU>(sv, red);
    if (row >= 0) {
      const float norm0 = fmaxf(sv[0], FLT_MIN);
      c0 = logf(norm0);
      const int t_keep = max(len - 1, 0);
      for (int j = j0; j < S; j += kStride) {
        const float p = x[j * kU + my] / norm0;
        for (int t = t_keep; t < T; ++t) out[at(t) + j] = p;
        x[j * kU + my] = len >= 2 ? p * e[at(len - 1) + j] : p;
      }
      for (int t = t_keep + j0; t < T; t += kStride) srow[t] = c0;
    }
  }
  prefetch(0);
  __syncthreads();  // M and the carries are in shared memory

  for (int k = 0; k < steps; ++k) {
    float ce[kGrpPrefetch], ca[kGrpPrefetch];
#pragma unroll
    for (int i = 0; i < kGrpPrefetch; ++i) {
      ce[i] = pe[i];
      ca[i] = pa[i];
    }
    prefetch(k + 1);
    // the product; the forward's and the smoothing's first step take vec in its place
    if (kRev || k > 0) grp_product<kU>(smem + L.mat, mat, x, part, L, S, ks);
    __syncthreads();  // the product is complete; x is read no more this step

    const bool live = k < n_steps;
    const int t = frame(k);
    const size_t off = live ? at(t) : 0;
    // f(j, e_t[j], α̂_t[j]) for each of the thread's states j: the first kGrpPrefetch from registers (unrolled,
    // so that their chains overlap), any further ones loaded here
    auto items = [&](auto&& f) {
      if (!live) return;
#pragma unroll
      for (int i = 0; i < kGrpPrefetch; ++i) {
        const int j = j0 + i * kStride;
        if (j < S) f(j, ce[i], ca[i]);
      }
      for (int j = j0 + kGrpPrefetch * kStride; j < S; j += kStride) f(j, e[off + j], kSmo ? alpha[off + j] : 0.f);
    };
    // the step's vector and its sums: raw = (pA) ⊙ e (forward), A v (reverse); u1, then v = e ⊙ u1 (smoothing)
    float sums[2] = {0.f, 0.f};
    items([&](int j, float ev, float) {
      float base;
      if (!kRev && k == 0) {
        base = vec[static_cast<size_t>(row) * S + j];
      } else {  // the slices' partial sums in slice order, their loads issued together
        base = part[my * lp + j];
#pragma unroll
        for (int sl = 1; sl < kGrpMaxSlices; ++sl)
          if (sl < ks) base += part[sl * psl + my * lp + j];
      }
      if (kRev) {
        x[j * kU + my] = base;
        sums[0] += base;
      } else {
        const float v = base * ev;
        x[j * kU + my] = v;
        if (kSmo) {
          part[my * lp + j] = base;  // u1, read back by this thread
          sums[0] += base;
          sums[1] += v;
        } else {
          sums[0] += v;
        }
      }
    });
    if constexpr (!kSmo) {
      float s1[1] = {sums[0]};
      grp_reduce<1, kU>(s1, red);
      const float norm = fmaxf(s1[0], FLT_MIN), inv = 1.f / norm;
      items([&](int j, float ev, float) {
        const float p = x[j * kU + my] * inv;
        out[off + j] = p;
        x[j * kU + my] = kFwd ? p : p * ev;  // the forward's carry p; the reverse's next input p ⊙ e_t
      });
      if (live && tid == my) srow[t] = norm;  // the log-scales are summed after the loop
      __syncthreads();  // the carries are complete
    } else {
      grp_reduce<2, kU>(sums, red);
      const float nu = fmaxf(sums[0], FLT_MIN), sv = fmaxf(sums[1], FLT_MIN);
      float sab[1] = {0.f};
      const float isv = 1.f / sv;
      items([&](int j, float, float av) {
        const float ab = av * (part[my * lp + j] / nu);
        abv[j * kU + my] = ab;
        sab[0] += ab;
        const float w = x[j * kU + my] * isv;
        x[j * kU + my] = w;
        w_out[off + j] = w;
      });
      if (live && tid == my) srow[t] = sv / nu;
      grp_reduce<1, kU>(sab, red + 2 * kMaxWarps * kU);  // also: the carries are complete
      const float ig = 1.f / fmaxf(sab[0], FLT_MIN);
      items([&](int j, float, float) { out[off + j] = abv[j * kU + my] * ig; });
      if (live && tid == my) pnorm[static_cast<size_t>(row) * T + t] = sab[0];
    }
  }

  if (row < 0) return;
  if (!kSmo && tid == my) {
    // the log-scales: norm_t summed frame by frame in the plain version's order (the reverse's from c0 down
    // from frame len − 2), the forward's last one repeated on frames t >= max(len, 1)
    float c = kRev ? c0 : 0.f;
#pragma unroll 4
    for (int k = 0; k < n_steps; ++k) {
      const int t = frame(k);
      c += logf(srow[t]);
      srow[t] = c;
    }
    for (int t = n_steps; kFwd && t < T; ++t) srow[t] = c;
  }
  if constexpr (kFwd) {
    // frames t >= max(len, 1) repeat the last carry (x holds it)
    for (int t = n_steps; t < T; ++t)
      for (int j = j0; j < S; j += kStride) out[at(t) + j] = x[j * kU + my];
  } else if constexpr (kSmo) {
    for (size_t i = static_cast<size_t>(len) * S + j0; i < static_cast<size_t>(T) * S; i += kStride) {
      out[static_cast<size_t>(row) * T * S + i] = 0.f;
      w_out[static_cast<size_t>(row) * T * S + i] = 0.f;
    }
    for (int t = len + j0; t < T; t += kStride) {
      scal[static_cast<size_t>(row) * T + t] = 1.f;
      pnorm[static_cast<size_t>(row) * T + t] = 1.f;
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

template <int kMode, int kU>
cudaError_t launch_grouped(int global, int ks, const float* e, const float* alpha, const int* lens, const int* order,
                           const float* mat, const float* vec, float* out, float* w_out, float* scal, float* pnorm,
                           int B, int T, int S, cudaStream_t st) {
  const auto kernel = dense_grouped_kernel<kMode, kU>;
  const size_t smem = grp_layout(kMode, S, kU, ks, global != 0).total * sizeof(float);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(B + kU - 1) / kU, kGrpThreads, smem, st>>>(e, alpha, lens, order, mat, vec, out, w_out, scal, pnorm, B, T,
                                                       S, ks, global);
  return cudaGetLastError();
}

// The grouped kernel at n_utt ∈ {1, 2, 4, 8} utterances a block and ks ∈ [1, kGrpMaxSlices] slices.
template <int kMode>
cudaError_t launch_grouped(int global, int n_utt, int ks, const float* e, const float* alpha, const int* lens,
                           const int* order, const float* mat, const float* vec, float* out, float* w_out,
                           float* scal, float* pnorm, int B, int T, int S, cudaStream_t st) {
  if (ks < 1 || ks > kGrpMaxSlices) return cudaErrorInvalidValue;
#define BEER_GRP(U)                                                                                              \
  if (n_utt == U)                                                                                                \
    return launch_grouped<kMode, U>(global, ks, e, alpha, lens, order, mat, vec, out, w_out, scal, pnorm, B, T, S, st);
  BEER_GRP(1) BEER_GRP(2) BEER_GRP(4) BEER_GRP(8)
#undef BEER_GRP
  return cudaErrorInvalidValue;
}

// The chunked banded kernels' instance at S states: the warp chain's register count up to S = 32·kSmoRegs,
// 0 (the block chain, one utterance a block) above; whether n_utt and chunk are ones they take.
int chain_regs(int S) { return (S + 31) / 32 <= kSmoRegs ? (S + 31) / 32 : 0; }
bool chunked_takes(int S, int n_utt, int chunk) {
  return chunk >= 1 && chunk <= kSmoChunk && n_utt >= 1 &&
         (chain_regs(S) == 0 ? n_utt == 1 : n_utt <= kSmoThreads / 64);
}

}  // namespace

extern "C" {

// K12: mode 0 dense forward, 1 banded forward, 2 dense reverse; global != 0:
// the operand in device memory; n_utt utterances a block; param: the dense
// instances' slices, the banded instance's frames a chunk.
size_t beer_scaled_pass_smem_bytes(int mode, int s, int global, int n_utt, int param) {
  if (mode == 1) return fwd_layout(s, n_utt, param, global != 0).total * sizeof(float);
  return grp_layout(mode, s, n_utt, param, global != 0).total * sizeof(float);
}

// K13's dense instance at n_utt utterances a block and ks slices.
size_t beer_smoothing_smem_bytes(int s, int global, int n_utt, int ks) {
  return grp_layout(kGrpSmoothing, s, n_utt, ks, global != 0).total * sizeof(float);
}

// K13's banded instance at n_utt utterances a block (above S = 32·kSmoRegs
// one) and `chunk` frames a chunk; global != 0: the bands read from device
// memory.
size_t beer_smoothing_banded_smem_bytes(int s, int global, int n_utt, int chunk) {
  return smo_layout(s, n_utt, chunk, global != 0).total * sizeof(float);
}

// mat: the bands (4, S) (banded), A (forward) or Aᵀ (reverse) as (S,
// round4(S)) with zero columns past S; order: the rows in group order (the
// dense instances; the banded one takes none).
int beer_scaled_pass(int device, int mode, int global, int n_utt, int param, const float* e, const int* lens,
                     const int* order, const float* mat, const float* vec, float* probs, float* logcs, int B, int T,
                     int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kGrpForward || mode == kGrpReverse) {
    if (B == 0 || T == 0) return cudaSuccess;
    return mode == kGrpForward ? launch_grouped<kGrpForward>(global, n_utt, param, e, nullptr, lens, order, mat, vec,
                                                             probs, nullptr, logcs, nullptr, B, T, S, st)
                               : launch_grouped<kGrpReverse>(global, n_utt, param, e, nullptr, lens, order, mat, vec,
                                                             probs, nullptr, logcs, nullptr, B, T, S, st);
  }
  if (mode != 1 || !chunked_takes(S, n_utt, param)) return cudaErrorInvalidValue;
  const size_t smem = beer_scaled_pass_smem_bytes(1, S, global, n_utt, param);
  using Kernel = decltype(&scaled_banded_chunked_kernel<false, 0>);
#define BEER_FWD(R) {scaled_banded_chunked_kernel<false, R>, scaled_banded_chunked_kernel<true, R>}
  static_assert(kSmoRegs == 6, "one instance a register count");
  const Kernel kernels[kSmoRegs + 1][2] = {BEER_FWD(0), BEER_FWD(1), BEER_FWD(2), BEER_FWD(3),
                                           BEER_FWD(4), BEER_FWD(5), BEER_FWD(6)};
#undef BEER_FWD
  const Kernel kernel = kernels[chain_regs(S)][global != 0];
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  kernel<<<(B + n_utt - 1) / n_utt, kSmoThreads, smem, st>>>(e, lens, mat, vec, probs, logcs, B, T, S, n_utt, param);
  return cudaGetLastError();
}

// K13's dense instance; mat is Aᵀ as (S, round4(S)) with zero columns past S.
int beer_smoothing_pass(int device, int global, int n_utt, int ks, const float* e, const float* alpha,
                        const int* lens, const int* order, const float* mat, const float* final_, float* gamma,
                        float* w_out, float* wsum, float* pnorm, int B, int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  return launch_grouped<kGrpSmoothing>(global, n_utt, ks, e, alpha, lens, order, mat, final_, gamma, w_out, wsum,
                                       pnorm, B, T, S, static_cast<cudaStream_t>(stream));
}

int beer_smoothing_banded(int device, int global, int n_utt, int chunk, const float* e, const float* alpha,
                          const int* lens, const float* bands, const float* final_, float* gamma, float* w_out,
                          float* wsum, float* pnorm, int B, int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!chunked_takes(S, n_utt, chunk)) return cudaErrorInvalidValue;
  const size_t smem = beer_smoothing_banded_smem_bytes(S, global, n_utt, chunk);
  // the warp chain up to S = 32·kSmoRegs, an instance a register count; the block chain above
  using Kernel = decltype(&smoothing_banded_chunked_kernel<false, 0>);
#define BEER_SMO(R) {smoothing_banded_chunked_kernel<false, R>, smoothing_banded_chunked_kernel<true, R>}
  const Kernel kernels[kSmoRegs + 1][2] = {BEER_SMO(0), BEER_SMO(1), BEER_SMO(2), BEER_SMO(3),
                                           BEER_SMO(4), BEER_SMO(5), BEER_SMO(6)};
#undef BEER_SMO
  const Kernel kernel = kernels[chain_regs(S)][global != 0];
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0) return cudaSuccess;
  kernel<<<(B + n_utt - 1) / n_utt, kSmoThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      e, alpha, lens, bands, final_, gamma, w_out, wsum, pnorm, B, T, S, n_utt, chunk);
  return cudaGetLastError();
}

}  // extern "C"
