// Phone-loop scan kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by beer_tpu_torch/ops/cuda_scan.py.
//
// Four kernels carry the phone-loop AUD main path: the scaled banded
// forward (VB-EM E-step, part 1), the accumulating v-space backward
// (E-step, part 2), and the banded (max,+) Viterbi forward and its
// backtrace (decode).  A fifth, the γ-emitting twin of the backward,
// carries the structured VAE's gradient (the Fisher identity ∂log Z /
// ∂llh = γ).  Each replaces one Pallas TPU kernel of
// beer_tpu/ops/pallas_scan.py; the note above each kernel names it.
//
// Common design.  Every kernel is a serial recursion over time with an
// O(S) step: the transition matrix of a phone loop is band + rank-1
// (self loop, advance, exit ⊗ entry), so a step is a few elementwise
// passes plus reductions over the S states.  What bounds these
// recursions on an H100 is the latency of the serial chain, not bytes
// or FLOPs.  So K1, K2, K3 and K11 run frames in chunks, the chain on
// one warp an utterance with no barrier, and everything that does not
// depend on the carry out of the chain (their notes below; K2 and K11 are
// the banded mode of acc_chunks.cuh, K1 and K3 its forward twins on that
// file's helpers).  K4, a pointer chase, takes one warp an utterance over
// its choices staged in shared memory (up to S = 1,024; in device memory
// above).
// Loop-invariant operands (the ELLH matrix W, bias, bands) live in shared
// memory while they fit a block; above that K1, K2 and K11 read Wᵀ from
// device memory (it stays in L2) and keep their accumulators in device
// memory, one thread an element, and K3 reads its bands there
// (cuda_scan.banded_placement), so every phone loop runs.
// Every reduction is computed in a fixed order and broadcast to all
// threads, so the kernels are deterministic run to run.
//
// Masks are prefix masks rebuilt from per-utterance lengths; an
// utterance of length 0 contributes nothing to any sum.

#include <climits>

#include "acc_chunks.cuh"
#include "scan_common.cuh"

namespace {

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
// K2 — accumulating banded v-space backward (smoothing + moments + loop ξ):
// the banded mode of acc_chunks.cuh (frames in chunks, the chain on one
// warp an utterance, the ELLH and the moment and ξ products around it).
// Replaces beer_tpu/ops/pallas_scan.py _make_estep_ckpt_acc_kernel_lm
// (wrapper phone_loop_estep_ckpt_acc_lm, stored-α̂ route).
//
// K11 — γ-emitting banded v-space backward (γ, γ₀, loop ξ): the same
// kernel emitting γ (acc_chunks.cuh kGamma: γ written per chunk in place
// of the moments, a normalised carry), llh = W·stats + bias computed in
// the kernel as K2 does.  Replaces the banded mode of
// beer_tpu/ops/pallas_scan.py _make_estep_ckpt_kernel_lm (wrapper
// phone_loop_estep_ckpt_pass_lm with bands, w and bias: the backward of
// the SVAE's log Z, semiring_scan._logz_stats_lm_bwd_impl); α̂ is read
// from K1 instead of recomputed from block checkpoints, and the loop ξ is
// an exact gather instead of a bf16 selection product.
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
// states above 2^8 in bf16).
//
// K1's skeleton in the (max, +) semiring, frames in chunks of C from frame
// 0 (chunk c + 1's llh arriving by cp.async into a two-stage ring while
// chunk c is worked on), in one of two forms chosen by S:
//   up to S = 32·kVitRegs (kRegs > 0) one warp walks an utterance's chain
//   with no barrier, a lane keeping the α of its states s = lane + 32k in
//   registers and reading α(s − 1) from lane s − 1 by one shuffle (lane 0
//   from lane 31's previous register), so that a step's only
//   shared-memory reads, the llh row and the bands, do not wait for the
//   carry; a step's max of α + le is one redux.sync on order-preserving
//   integer keys (vkey), where a shuffle tree took five dependent rounds,
//   and the smallest index holding it, which only the output needs, a
//   second one issued a step later, off the chain;
//   above it (kRegs = 0) a warp's lanes would walk too many states a step
//   (at S = 750 a warp's chain took twice a block's, PERF.md PR 10), so
//   all but kVitCopyWarps warps of a block of kVitBlockThreads walk one
//   utterance,
//   states strided over their threads, α written over the llh row in place
//   (state s reads row f − 1, s − 1 across threads), one named barrier a
//   step among them for the arg-max across their warps (two scratch
//   stages).
// Either way the choices go to a staging row (int8), the exit indices
// beside them, the chunk's last α to the carry row, and the block's other
// warps fetch chunk c + 1 (acc_fetch_rows) and write out chunk c − 1's
// staged choices and exit indices (two staging stages) while the chain
// walks chunk c: one block barrier a chunk, and the chain never waits for
// the copies.  (max, +) rounds once, in the add, as the plain version
// does: the kernel equals it.  Two placements
// (kGlobal): the bands in shared memory (a float4 a state), or read from
// device memory in the chain (the largest S); the wrapper picks the
// placement, n_utt and C by fit (cuda_scan.viterbi_banded_geometry, K1's
// rule; one utterance a block for the block chain), the launcher the form
// from S.  kFull: C = kAccChunk, a constant.
// ---------------------------------------------------------------------
constexpr int kVitRegs = 6;              // the warp chain keeps α in registers up to S = 32·kVitRegs
constexpr int kVitBlockThreads = 1024;   // the block chain's block
constexpr int kVitCopyWarps = 8;         // ... of which warps copy, the rest walk the chain

struct VitLayout {  // float offsets into one K3 block's shared memory
  size_t bands, red, utt, per_utt, total;
  int ldg;
};

__host__ __device__ inline VitLayout vit_layout(int S, int n_utt, int C, bool global) {
  VitLayout l;
  l.ldg = static_cast<int>(round4(S));
  size_t o = 0;
  l.bands = o;  // (ls, la of the state before, le, lw) a float4 a state
  if (!global) o += 4 * static_cast<size_t>(l.ldg);
  l.red = o;  // the block chain: 2 stages × (each warp's max key, its smallest index holding it)
  o += 4 * kMaxWarps;
  l.utt = o;
  l.per_utt = 2 * static_cast<size_t>(C) * l.ldg            // ring: 2 × llh (C, ldg) (kRegs = 0: α written over it)
              + l.ldg                                       // the carry: α of the frame before the chunk
              + 2 * (static_cast<size_t>(C) * l.ldg / 4     // 2 × choices (C, ldg) int8
                     + round4(static_cast<size_t>(C)));     //     and exit indices (C,) int32
  o += static_cast<size_t>(n_utt) * l.per_utt;
  l.total = o;
  return l;
}

// An int whose order is the float's (for the values here, none NaN); its
// own inverse.
__device__ __forceinline__ int vkey(float v) {
  const int k = __float_as_int(v);
  return k >= 0 ? k : k ^ 0x7fffffff;
}

template <bool kGlobal, bool kFull, int kRegs>
__global__ void __launch_bounds__(kRegs > 0 ? kAccThreads : kVitBlockThreads, kRegs > 0 ? 2 : 1)
    viterbi_fwd_chunked_kernel(
    const float* __restrict__ llh,       // (B, T, S)
    const int* __restrict__ lens,        // (B,)
    const float* __restrict__ lbands,    // (4, S): log a_self, a_adv, exit, w
    const float* __restrict__ log_init,  // (S,)
    int8_t* __restrict__ choices,        // (B, T, S)
    int* __restrict__ exarg,             // (B, T)
    float* __restrict__ alpha_last,      // (B, S)
    int B, int T, int S, int n_utt, int chunk) {
  constexpr bool kBlock = kRegs == 0;  // the block chain, one utterance a block
  const int C = kFull ? kAccChunk : chunk;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const VitLayout L = vit_layout(S, n_utt, C, kGlobal);
  const int ldg = L.ldg;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * n_utt;
  // the chain's threads: warp u for utterance u, or all but kVitCopyWarps warps; the rest copy
  const int n_chain = kBlock ? nt - 32 * kVitCopyWarps : 32 * n_utt;
  const int ptid = tid - n_chain, pnt = nt - n_chain;
  float4* band_sh = reinterpret_cast<float4*>(smem + L.bands);
  int* red = reinterpret_cast<int*>(smem + L.red);
  // utterance u's pieces: ring stage st (llh, then α), the carry row, staging stage st's choices and exit indices
  auto ring = [&](int u, int st) { return smem + L.utt + u * L.per_utt + static_cast<size_t>(st) * C * ldg; };
  auto carry = [&](int u) { return smem + L.utt + u * L.per_utt + 2 * static_cast<size_t>(C) * ldg; };
  auto chs = [&](int u, int st) {
    return reinterpret_cast<int8_t*>(carry(u) + ldg + st * (static_cast<size_t>(C) * ldg / 4 + round4(C)));
  };
  auto exs = [&](int u, int st) { return reinterpret_cast<int*>(chs(u, st) + static_cast<size_t>(C) * ldg); };
  // the frames a row runs: max(len, 1), frame 0 firing on every row; none when T = 0
  auto steps_of = [&](int u) { return b0 + u < B && T > 0 ? max(lens[b0 + u], 1) : 0; };
  // chunk c of utterance u: frames lo = c·C .. lo + nf − 1
  auto span = [&](int u, int c, int& lo) {
    lo = c * C;
    return max(min(C, steps_of(u) - lo), 0);
  };
  // ls, la of state s − 1, le, lw
  auto band = [&](int s) {
    return kGlobal ? make_float4(lbands[s], s > 0 ? lbands[S + s - 1] : 0.f, lbands[2 * S + s], lbands[3 * S + s])
                   : band_sh[s];
  };

  int n_chunks = 0;
  for (int u = 0; u < n_utt; ++u) n_chunks = max(n_chunks, (steps_of(u) + C - 1) / C);
  auto fetch = [&](int c) {
    for (int u = 0; u < n_utt; ++u) {
      int lo;
      const int nf = span(u, c, lo);
      acc_fetch_rows(ring(u, c & 1), llh, static_cast<size_t>(b0 + u) * T + lo, nf, C, ldg, S, ptid, pnt);
    }
    cp_async_commit();
  };
  auto write_out = [&](int c) {  // chunk c's staged choices and exit indices
    for (int u = 0; u < n_utt; ++u) {
      int lo;
      const int nf = span(u, c, lo);
      const size_t row0 = static_cast<size_t>(b0 + u) * T + lo;
      const int8_t* ch = chs(u, c & 1);
      int8_t* dst = choices + row0 * S;
      const float inv_s = 1.f / S;
      for (int e = ptid; e < nf * S; e += pnt) {
        const int f = row_of(e, inv_s), s = e - f * S;
        dst[e] = ch[static_cast<size_t>(f) * ldg + s];
      }
      for (int f = ptid; f < nf; f += pnt) exarg[row0 + f] = exs(u, c & 1)[f];
    }
  };
  if (ptid >= 0 && n_chunks > 0) fetch(0);
  for (int s = tid; s < (kGlobal ? 0 : ldg); s += nt) {
    const bool on = s < S;
    band_sh[s] = on ? make_float4(lbands[s], s > 0 ? lbands[S + s - 1] : 0.f, lbands[2 * S + s], lbands[3 * S + s])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float exb = 0.f;  // the chain's max of α + le over the frame before the current one
  int cand = S;     // ... the lane's smallest state holding it (S: none; the block chain: the block's)
  float a[kRegs > 0 ? kRegs : 1];  // the warp chain: the lane's α of states lane + 32k at that frame
#pragma unroll
  for (int k = 0; k < (kRegs > 0 ? kRegs : 1); ++k) a[k] = kNeg;

  // utterance u's frames of chunk c: a warp's lanes over the states (α in registers), or the block's threads
  auto walk = [&](int u, int c) {
    const int s0 = kBlock ? tid : lane, ds = kBlock ? n_chain : 32;
    int lo;
    const int nf = span(u, c, lo);
    float* ra = ring(u, c & 1);
    int8_t* ch = chs(u, c & 1);
    int* ex = exs(u, c & 1);
    for (int f = 0; f < nf; ++f) {
      const bool first = lo + f == 0;
      // the arg-max of the frame before, off the chain: stored at the step's end
      const int exi = kBlock ? cand : static_cast<int>(__reduce_min_sync(0xffffffffu, static_cast<unsigned>(cand)));
      float* row = ra + static_cast<size_t>(f) * ldg;  // llh (kRegs = 0: α written over it)
      int8_t* cr = ch + static_cast<size_t>(f) * ldg;
      float mb = -FLT_MAX;
      int mi = S;
      if constexpr (kRegs > 0) {
        float l[kRegs], pm[kRegs];
        float4 bd[kRegs];
#pragma unroll
        for (int k = 0; k < kRegs; ++k) {  // what does not wait for the carry first
          const int s = lane + 32 * k;
          l[k] = s < S ? row[s] : 0.f;
          bd[k] = s < S ? band(s) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < kRegs; ++k) {  // α(s − 1): lane − 1's register k, or lane 31's k − 1
          const float up = __shfl_up_sync(0xffffffffu, a[k], 1);
          const float wrap = __shfl_sync(0xffffffffu, a[k > 0 ? k - 1 : 0], 31);
          pm[k] = lane > 0 ? up : (k > 0 ? wrap : kNeg);
        }
#pragma unroll
        for (int k = 0; k < kRegs; ++k) {
          const int s = lane + 32 * k;
          if (s >= S) continue;
          float v;
          int8_t choice = 0;
          if (first) {
            v = fmaxf(log_init[s] + l[k], kNeg);
          } else {
            const float c_self = a[k] + bd[k].x;
            const float c_adv = s > 0 ? pm[k] + bd[k].y : kNeg;
            const float c_loop = exb + bd[k].w;
            const float best = fmaxf(c_self, fmaxf(c_adv, c_loop));
            choice = static_cast<int8_t>(c_self >= best ? 0 : (c_adv >= best ? 1 : 2));
            v = fmaxf(l[k] + best, kNeg);
          }
          a[k] = v;
          cr[s] = choice;
          const float ev = v + bd[k].z;
          if (ev > mb) {  // k visits the lane's states in increasing order
            mb = ev;
            mi = s;
          }
        }
      } else {
        const float* prev = f == 0 ? carry(u) : row - ldg;  // α of frame t − 1
        for (int s = s0; s < S; s += ds) {
          const float4 bd = band(s);
          float v;
          int8_t choice = 0;
          if (first) {
            v = fmaxf(log_init[s] + row[s], kNeg);
          } else {
            const float c_self = prev[s] + bd.x;
            const float c_adv = s > 0 ? prev[s - 1] + bd.y : kNeg;
            const float c_loop = exb + bd.w;
            const float best = fmaxf(c_self, fmaxf(c_adv, c_loop));
            choice = static_cast<int8_t>(c_self >= best ? 0 : (c_adv >= best ? 1 : 2));
            v = fmaxf(row[s] + best, kNeg);
          }
          row[s] = v;
          cr[s] = choice;
          const float ev = v + bd.z;
          if (ev > mb) {  // the strided loop visits s in increasing order
            mb = ev;
            mi = s;
          }
        }
      }
      const int top = __reduce_max_sync(0xffffffffu, vkey(mb));
      if constexpr (kBlock) {  // the warps' maxima and indices, then the block's
        const int mine = static_cast<int>(__reduce_min_sync(0xffffffffu, static_cast<unsigned>(vkey(mb) == top ? mi : S)));
        int* stage = red + ((lo + f) & 1) * 2 * kMaxWarps;
        if (lane == 0) {
          stage[warp] = top;
          stage[kMaxWarps + warp] = mine;
        }
        asm volatile("bar.sync 1, %0;" ::"r"(n_chain) : "memory");  // also: row f, the next step's α, is complete
        const int n_w = n_chain >> 5;
        const int wk = lane < n_w ? stage[lane] : vkey(-FLT_MAX);
        const int all = __reduce_max_sync(0xffffffffu, wk);
        exb = __int_as_float(vkey(__int_as_float(all)));
        cand = static_cast<int>(__reduce_min_sync(
            0xffffffffu, static_cast<unsigned>(lane < n_w && wk == all ? stage[kMaxWarps + lane] : S)));
        if (tid == 0) ex[f] = first ? 0 : exi;
      } else {
        exb = __int_as_float(vkey(__int_as_float(top)));
        cand = mb == exb ? mi : S;
        if (lane == 0) ex[f] = first ? 0 : exi;
      }
    }
    // the carry: α of the chunk's last frame
    if constexpr (kRegs > 0) {
#pragma unroll
      for (int k = 0; k < kRegs; ++k)
        if (nf > 0 && lane + 32 * k < S) carry(u)[lane + 32 * k] = a[k];
    } else {
      for (int s = s0; s < (nf > 0 ? S : 0); s += ds) carry(u)[s] = ra[static_cast<size_t>(nf - 1) * ldg + s];
    }
  };

  for (int c = 0; c <= n_chunks; ++c) {
    if (ptid >= 0) cp_async_wait(false);
    // chunk c has landed; chain c − 1 is done (its staging full, the carry
    // written) and so is the write-out of chunk c − 2
    __syncthreads();
    if (ptid >= 0) {
      if (c + 1 < n_chunks) fetch(c + 1);  // into the stage chunk c − 1 has finished with
      if (c > 0) write_out(c - 1);
      continue;
    }
    if (c < n_chunks) walk(kBlock ? 0 : warp, c);
  }
  __syncthreads();
  for (int u = 0; u < n_utt; ++u) {
    if (b0 + u >= B) continue;
    const int steps = steps_of(u);
    int8_t* c_b = choices + static_cast<size_t>(b0 + u) * T * S;
    for (size_t i = static_cast<size_t>(steps) * S + tid; i < static_cast<size_t>(T) * S; i += nt) c_b[i] = 0;
    for (int t = steps + tid; t < T; t += nt) exarg[static_cast<size_t>(b0 + u) * T + t] = 0;
    for (int s = tid; s < S; s += nt) alpha_last[static_cast<size_t>(b0 + u) * S + s] = T > 0 ? carry(u)[s] : log_init[s];
  }
}

// ---------------------------------------------------------------------
// K4 — Viterbi backtrace.
// Replaces beer_tpu/ops/pallas_scan.py _make_viterbi_backtrace_kernel
// (wrapper viterbi_backtrace_banded); the final arg-max that the JAX
// package computes beside the kernel is folded in.  paths[T−1] =
// argmax(α_last + log_final) (first max), then stay / state − 1 / exit
// index by the stored choice (clamped at state 0).  ``log_final`` is one
// (S,) vector (final_stride 0) or one row per utterance (final_stride S:
// the shared transcription graphs of the recognizer end each utterance in
// its own state).
//
// A pointer chase: a frame's state picks the byte of the frame before, so
// what bounds it is the latency of one dependent load a frame, not bytes.
// One warp walks one utterance (n_utt warps a block, spread over the SMs):
//   1. the final arg-max by the warp: each lane's first max over its
//      strided states, one redux.sync for the largest order-preserving key
//      (vkey, K3's; −0 counted as +0) and a second for the smallest state
//      that holds it, the first max as a serial scan finds it; the score is
//      that state's α_last + log_final, the serial scan's own sum;
//   2. the frames in chunks of C from the end.  kStaged: chunk k's choices,
//      C·S contiguous bytes, arrive in shared memory by 16-byte cp.async in
//      a ring of kBtStages, kBtStages − 1 chunks ahead of the chase, so the
//      chase reads one shared byte a frame (every lane the same address);
//      !kStaged (S too large for a staged chunk) reads device memory, C =
//      kBtDirectChunk.  A chunk's exit indices come by one coalesced load a
//      chunk ahead and a shuffle a frame, off the chain;
//   3. lane f keeps frame lo + f's state, and the warp writes the chunk's
//      path in one coalesced store.
// The wrapper picks the instance, n_utt and C by fit and the batch size
// (cuda_scan.backtrace_banded_geometry).
// ---------------------------------------------------------------------
constexpr int kBtStages = 4;        // kStaged: chunks in flight a warp, the chased one included
constexpr int kBtMaxUtt = 4;        // warps (utterances) a block
constexpr int kBtDirectChunk = 32;  // !kStaged: frames a chunk (a lane a frame of the path)

// Bytes of one staged chunk: C·S bytes from any address, in whole 16-byte
// segments (up to 15 bytes before and after).
__host__ __device__ inline size_t bt_stage_bytes(int S, int C) { return (static_cast<size_t>(C) * S + 30) / 16 * 16; }

template <bool kStaged>
__global__ void __launch_bounds__(32 * kBtMaxUtt) viterbi_backtrace_chunked_kernel(
    const int8_t* __restrict__ choices,     // (B, T, S)
    const int* __restrict__ exarg,          // (B, T)
    const float* __restrict__ alpha_last,   // (B, S)
    const float* __restrict__ log_final,    // (S,) or (B, S)
    int* __restrict__ paths,                // (B, T)
    float* __restrict__ scores,             // (B,)
    int B, int T, int S, int final_stride, int chunk) {
  extern __shared__ int4 smem_bt[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // a whole warp; no block barrier below
  const int C = kStaged ? chunk : kBtDirectChunk;

  // 1. the final arg-max
  const float* a = alpha_last + static_cast<size_t>(b) * S;
  const float* lf = log_final + static_cast<size_t>(b) * final_stride;
  float mb = lane < S ? a[lane] + lf[lane] : 0.f;
  int mi = lane;
  for (int s = lane + 32; s < S; s += 32) {
    const float v = a[s] + lf[s];
    if (v > mb) {  // strided in increasing s: the lane's first max
      mb = v;
      mi = s;
    }
  }
  const int key = lane < S ? vkey(mb == 0.f ? 0.f : mb) : INT_MIN;
  const int top = __reduce_max_sync(0xffffffffu, key);
  int st = __reduce_min_sync(0xffffffffu, key == top ? mi : INT_MAX);
  if (lane == 0) scores[b] = a[st] + lf[st];
  if (T == 0) return;

  // 2. the chase, chunk k holding frames lo .. lo + nf − 1 counted from the end
  const size_t row = static_cast<size_t>(b) * T;
  const int n_k = (T + C - 1) / C;
  auto span = [&](int k, int& lo) {
    const int hi = T - 1 - k * C;
    lo = max(hi - C + 1, 0);
    return hi - lo + 1;
  };
  const size_t stage = bt_stage_bytes(S, C);
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_bt) + static_cast<size_t>(warp) * kBtStages * stage;
  const int8_t* c_end = choices + static_cast<size_t>(B) * T * S;
  auto fetch = [&](int k) {  // chunk k's nf·S bytes
    if (kStaged && k < n_k) {
      int lo;
      const int nf = span(k, lo);
      cp_async_run(ring + static_cast<size_t>(k % kBtStages) * stage, choices + (row + lo) * S,
                   static_cast<size_t>(nf) * S, choices, c_end, lane, 32);
    }
    if (kStaged) cp_async_commit();
  };
  auto exits = [&](int k) {  // lane f: the exit index of chunk k's frame lo + f
    int lo;
    const int nf = k < n_k ? span(k, lo) : 0;
    return lane < nf ? exarg[row + lo + lane] : 0;
  };
  for (int k = 0; k < kBtStages - 1; ++k) fetch(k);
  int ex_next = exits(0);
  for (int k = 0; k < n_k; ++k) {
    int lo;
    const int nf = span(k, lo);
    const int ex = ex_next;
    ex_next = exits(k + 1);
    const int8_t* ch;
    if constexpr (kStaged) {
      fetch(k + kBtStages - 1);  // into the stage chunk k − 1 left
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kBtStages - 1) : "memory");
      __syncwarp();
      ch = reinterpret_cast<const int8_t*>(ring + static_cast<size_t>(k % kBtStages) * stage +
                                           run_head(choices + (row + lo) * S));
    } else {
      ch = choices + (row + lo) * S;
    }
    int pv = 0;  // lane f: the state of frame lo + f
    ch += static_cast<size_t>(nf - 1) * S;  // frame lo + f's row, f from nf − 1 down
    for (int f = nf - 1; f >= 0; --f, ch -= S) {
      if (lane == f) pv = st;
      if (lo + f > 0) {
        const int e = __shfl_sync(0xffffffffu, ex, f);
        const int c = ch[st];
        st = c == 0 ? st : (c == 1 ? st - 1 : e);
        st = max(st, 0);  // an advance into state 0 needs an all-unreachable row
      }
    }
    if (lane < nf) paths[row + lo + lane] = pv;
    __syncwarp();  // every lane has read the stage the next fetch writes
  }
}

}  // namespace

extern "C" {

// global != 0: W read as Wᵀ (P, S) from device memory, and K2's moments
// and K11's ξ in the partial row (K3: the bands read from device memory).
// K1, K2, K3 and K11 at n_utt utterances a block and `chunk` frames a chunk.
size_t beer_forward_smem_bytes(int s, int p, int global, int n_utt, int chunk) {
  return fwd_layout(s, p, n_utt, chunk, global != 0).total * sizeof(float);
}

size_t beer_estep_smem_bytes(int s, int p, int u, int global, int n_utt, int chunk) {
  return acc_layout(s, p, u, u, n_utt, chunk, global != 0).total * sizeof(float);
}

size_t beer_estep_gamma_smem_bytes(int s, int p, int u, int global, int n_utt, int chunk) {
  return acc_layout(s, p, u, u, n_utt, chunk, global != 0, true).total * sizeof(float);
}

size_t beer_viterbi_smem_bytes(int s, int global, int n_utt, int chunk) {
  return vit_layout(s, n_utt, chunk, global != 0).total * sizeof(float);
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

// K2 and, below, K11: n_utt utterances a block, chunks of `chunk` frames;
// part is (ceil(B / n_utt), width), out = Σ over its rows: K2's acc (S,
// P+1), then ξ_raw (U, U) (width S·(P+1) + U·U); K11's ξ_raw alone (width
// U·U), γ and γ₀ written.  w is Wᵀ with zero rows to (round4(P), S) when
// global.
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

int beer_estep_gamma_banded(int device, int global, int n_utt, int chunk, const float* stats, const int* lens,
                            const float* w, const float* bias, const float* bands, const float* final_,
                            const float* alpha, const float* norms, const int* ends, const int* starts, float* part,
                            float* out, float* gamma0, float* gamma, int B, int T, int S, int P, int U, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_acc_chunked<false, true>(global, n_utt, chunk, stats, lens, w, bias, bands, nullptr, final_, alpha,
                                         norms, ends, starts, part, out, gamma0, gamma, B, T, S, P, U, U,
                                         static_cast<cudaStream_t>(stream));
}

// K3: n_utt utterances a block, chunks of `chunk` frames; the bands read
// from device memory when global.
int beer_viterbi_fwd_banded(int device, int global, int n_utt, int chunk, const float* llh, const int* lens,
                            const float* lbands, const float* log_init, int8_t* choices, int* exarg,
                            float* alpha_last, int B, int T, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_utt < 1 || n_utt > kAccThreads / 32 || chunk < 1 || chunk > kAccChunk) return cudaErrorInvalidValue;
  const size_t smem = beer_viterbi_smem_bytes(S, global, n_utt, chunk);
  const bool full = chunk == kAccChunk;
  // the warp chain up to S = 32·kVitRegs, an instance a register count; the block chain above
  using Kernel = decltype(&viterbi_fwd_chunked_kernel<false, true, 0>);
#define BEER_VIT(R) {viterbi_fwd_chunked_kernel<false, false, R>, viterbi_fwd_chunked_kernel<false, true, R>, \
                     viterbi_fwd_chunked_kernel<true, false, R>, viterbi_fwd_chunked_kernel<true, true, R>}
  static_assert(kVitRegs == 6, "one instance a register count");
  const Kernel kernels[kVitRegs + 1][4] = {BEER_VIT(0), BEER_VIT(1), BEER_VIT(2), BEER_VIT(3),
                                           BEER_VIT(4), BEER_VIT(5), BEER_VIT(6)};
#undef BEER_VIT
  const int regs = (S + 31) / 32 <= kVitRegs ? (S + 31) / 32 : 0;
  if (regs == 0 ? n_utt != 1 : n_utt >= kAccThreads / 32) return cudaErrorInvalidValue;
  const Kernel kernel = kernels[regs][2 * (global != 0) + full];
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  kernel<<<(B + n_utt - 1) / n_utt, regs > 0 ? kAccThreads : kVitBlockThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(llh, lens, lbands, log_init, choices, exarg, alpha_last, B, T, S, n_utt,
                                                chunk);
  return cudaGetLastError();
}

// K4: staged != 0, chunks of `chunk` frames staged in shared memory; n_utt
// utterances (warps) a block.
size_t beer_backtrace_smem_bytes(int s, int n_utt, int chunk) {
  return static_cast<size_t>(n_utt) * kBtStages * bt_stage_bytes(s, chunk);
}

int beer_viterbi_backtrace_banded(int device, int staged, int n_utt, int chunk, const int8_t* choices,
                                  const int* exarg, const float* alpha_last, const float* log_final, int* paths,
                                  float* scores, int B, int T, int S, int final_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_utt < 1 || n_utt > kBtMaxUtt || (staged && (chunk < 1 || chunk > kAccChunk))) return cudaErrorInvalidValue;
  const size_t smem = staged ? beer_backtrace_smem_bytes(S, n_utt, chunk) : 0;
  auto kernel = staged ? viterbi_backtrace_chunked_kernel<true> : viterbi_backtrace_chunked_kernel<false>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  kernel<<<(B + n_utt - 1) / n_utt, 32 * n_utt, smem, static_cast<cudaStream_t>(stream)>>>(
      choices, exarg, alpha_last, log_final, paths, scores, B, T, S, final_stride, chunk);
  return cudaGetLastError();
}

}  // extern "C"
