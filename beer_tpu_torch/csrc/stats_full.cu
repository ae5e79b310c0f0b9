// Full-covariance statistics kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by beer_tpu_torch/ops/stats_kernels.py.
//
// Three kernels carry the full-covariance Bayesian GMM (BASELINE config 1)
// and full-covariance NormalSet / MixtureSet emissions:
//
//   K8 gmm_estep_full   the whole GMM E-step: joint = S(x)·W, llh =
//                       logsumexp_k(joint)·mask, r = softmax_k(joint)·mask
//                       (kept in shared memory), partial Σ_t r_t ⊗ S(x_t);
//   K9 ellh_full        llh (T, K) = S(x)·W;
//   K10 accumulate_full partial Σ_t r_t ⊗ S(x_t) for given r (T, K).
//
// S(x) = [x_i·x_j (i <= j), x, 1] is the packed statistic, L = D(D+1)/2 +
// D + 1 lanes (820 at D = 39), in the upper-triangular pair order of
// beer_tpu/ops/stats_kernels.py _ut_pairs; W (L, K) is packed on the host.
// Each replaces one Pallas TPU kernel of beer_tpu/ops/stats_kernels.py; the
// note above each kernel names it.  S is built on the chip from the frames,
// each entry one float32 product of float32 values (the exact product the
// TPU's bf16 three-limb split reconstructs; that split and its 0/1 selector
// matmuls are TPU artifacts and have no counterpart here), and never stored
// in device memory.  No TF32, bf16 or tensor cores: every product and sum
// is float32 FFMA (the JAX package's history records 16-bit products making
// the VB ELBO oscillate at production magnitudes).
//
// Bound on the H100 (float32 outside the tensor cores, 67 TFLOP/s; 3.35
// TB/s): operations.  At config 1 (T = 256,000, D = 39, K = 64) K8 does
// 4·T·K·L = 53.7 GFLOP (0.80 ms) against 40 MB of frames (12 µs); K9 and
// K10 half of that each.  So each is a float32 SIMT GEMM whose S operand is
// generated instead of loaded:
//
//   K9  output-stationary over (frames × components), 8 × 4 outputs a
//       thread (8 × 8 for the component tile of 128), a component tile
//       of 16, 32, 64 or 128 and a frame tile of 64 or 128 chosen by the
//       wrapper from K and T (stats_kernels.ellh_tiles); the lanes run in
//       chunks of 16 through a two-stage ring in shared memory: while the
//       warps multiply chunk c, the W chunk c + 1 arrives by cp.async and
//       the S chunk c + 1 is built from the frame tile, with one barrier a
//       chunk;
//   K10 output-stationary over (components × lanes) with a split over
//       frames: each block keeps a 64 (or 32) × 128 tile of Σ r ⊗ S in
//       registers, 8 × 8 a thread, for its whole slice of frames, brings
//       frames and responsibilities in by cp.async 32 frames at a time and
//       builds only its own 128 lanes of S; it writes its partial once,
//       and sum_rows_kernel adds the slices' partials in a fixed order;
//   K8  both, joined by the softmax in shared memory: a persistent block
//       takes supertiles of frames (stats_kernels.estep_tiles: 128 at
//       config 1, two blocks an SM), runs K9's ring and micro-kernel over
//       them into a (frames × K) joint in shared memory, turns it into
//       responsibilities one warp a frame, and runs K10's micro-kernel in
//       two groups of 128 threads over the (component tile × 128-lane)
//       tiles of Σ r ⊗ S, adding each to the block's partial once a
//       supertile.  What it costs beyond the bound: S is built twice (once
//       a product, from the lane table, for each of the two GEMMs; K9
//       measured the build at 23 % of its time), the two GEMMs run at
//       K9's and K10's rates (60 % and 48 % of the bound without the
//       build), the accumulation computes 896 lanes for 820 at config 1,
//       and the partial moves through L2 once per 128 frames.
//
// The arithmetic stays float32 FFMA: a 3×TF32 tensor-core form was probed
// at config 1 before K8 was rebuilt (stats_variants.py probe) and drifted
// 5.2e-4 ELBO/frame from this kernel over 15 VB steps, five times the
// trajectory gate, with statistics 53× further from float64.  No atomics
// anywhere: two runs agree bitwise.  Limits: 1 <= D <= 128; K8 and K10
// take 1 <= K <= 256 (K8 holds a supertile's responsibilities in shared
// memory); K9 takes any K.  The wrappers raise above them.

#include <initializer_list>

#include "scan_common.cuh"

namespace {

constexpr int kMaxDim = 128;
constexpr int kMaxComp = 256;

enum Kind { kEstep = 0, kEllh = 1, kAcc = 2 };

__host__ __device__ inline int n_lanes(int D) { return D * (D + 1) / 2 + D + 1; }

// K9's and K10's lane table: S(x)_l = x̃_i · x̃_j over the extended frame
// x̃ = [x, 1, 0], with lanes[l] = i << 8 | j: the pairs (i <= j), then (i,
// D) for the linear lanes, (D, D) for the constant one and (D + 1, D + 1)
// past the last lane, so that building S takes no branch.
__host__ __device__ inline void lane_pair(int l, int D, int& i, int& j) {
  const int n_ut = D * (D + 1) / 2;
  if (l < n_ut) {
    int off = 0;
    i = 0;
    while (l >= off + D - i) {
      off += D - i;
      ++i;
    }
    j = i + l - off;
  } else if (l < n_ut + D) {
    i = l - n_ut, j = D;
  } else {
    i = j = l == n_ut + D ? D : D + 1;
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// ---------------------------------------------------------------------
// K8's tiles.  256 threads a block.  The joint runs K9's micro-kernel:
// a BM × BN tile, 8 × 4 outputs a thread, BM·BN = 8192 (BN = 32, 64 or
// 128 components, so BM = 256, 128 or 64 frames), the lanes in chunks of
// kLc8 through a two-stage ring.  The accumulation runs K10's: two groups
// of 128 threads, each holding a BK × 128 tile (BK = 32 or 64
// components, 8 × 8 or 4 × 8 outputs a thread) over a supertile's frames,
// 32 frames of S at a time.
// ---------------------------------------------------------------------
constexpr int kThr8 = 256;
constexpr int kLc8 = 16;        // lanes a chunk of the joint's ring
constexpr int kAccL = 128;      // lanes a tile of the accumulation
constexpr int kAccT = 32;       // frames of S built at a time
constexpr int kLdS8 = kAccL + 4;

// K8's shared memory (float offsets, multiples of 4) at (D, K), joint
// component tile bn and F frames a supertile.
struct EstepLayout {
  int ldx, ldr, kp, n_table;
  size_t ms, lanes, rs, work, total;
  __host__ __device__ EstepLayout(int D, int K, int bn, int F) {
    const int L = n_lanes(D), bk = K <= 32 ? 32 : 64;
    const int step = bn > bk ? bn : bk;
    ldx = (D + 2) | 1;                                  // x̃ = [x, 1, 0], odd stride
    kp = (K + step - 1) / step * step;
    ldr = kp + 4;
    const int joint_lanes = ((L + kLc8 - 1) / kLc8 + 1) * kLc8;   // one chunk past the last
    const int acc_lanes = (L + kAccL - 1) / kAccL * kAccL;
    n_table = joint_lanes > acc_lanes ? joint_lanes : acc_lanes;
    ms = round4(static_cast<size_t>(F) * ldx);
    lanes = ms + round4(F);
    rs = lanes + round4((static_cast<size_t>(n_table) + 1) / 2);
    work = rs + static_cast<size_t>(F) * ldr;
    const size_t ring = 2 * (static_cast<size_t>(kLc8) * (8192 / bn + 4) + static_cast<size_t>(kLc8) * bn);
    const size_t acc = 2 * static_cast<size_t>(kAccT) * kLdS8;
    total = work + (ring > acc ? ring : acc);
  }
};

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

// rs[t0.., k0..] = S(x̃ rows t0 .. t0+BM−1)·W[:, k0 .. k0+BN−1]: K9's ring
// and micro-kernel over the supertile's frames in shared memory.  Begins
// and ends with a barrier.
template <int BN>
__device__ __forceinline__ void estep_joint_tile(const float* __restrict__ w, int Kp, int n_chunks, int k0,
                                                 const float* xs, int ldx, const unsigned short* lanes,
                                                 float* rs, int ldr, float* ring) {
  constexpr int BM = 8192 / BN, kCols = BN / 4, kLdS = BM + 4, kStage = kLc8 * kLdS + kLc8 * BN;
  static_assert(kLc8 * BM % kThr8 == 0, "whole build rounds");
  const int tid = threadIdx.x;
  auto fetch_w = [&](int c, int b) {
    float* ws = ring + b * kStage + kLc8 * kLdS;
    const float* src = w + static_cast<size_t>(c) * kLc8 * Kp + k0;
    for (int q = tid; q < kLc8 * BN / 4; q += kThr8) {
      const int r = q / (BN / 4), k4 = (q % (BN / 4)) * 4;
      cp_async16(ws + r * BN + k4, src + static_cast<size_t>(r) * Kp + k4);
    }
    cp_async_commit();
  };
  auto build_s = [&](int c, int b) {
    float* st = ring + b * kStage;
    const unsigned short* lc = lanes + c * kLc8;
#pragma unroll
    for (int n = 0; n < kLc8 * BM / kThr8; ++n) {
      const int e = tid + n * kThr8, r = e / BM, t = e % BM, p = lc[r];
      const float* xr = xs + t * ldx;
      st[r * kLdS + t] = xr[p >> 8] * xr[p & 255];
    }
  };
  __syncthreads();  // every reader of the ring (and writer of xs) is done
  fetch_w(0, 0);
  build_s(0, 0);
  cp_async_wait_all();
  __syncthreads();
  const int tx = tid % kCols, ty = tid / kCols;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int cur = c & 1;
    fetch_w(c + 1, cur ^ 1);
    build_s(c + 1, cur ^ 1);
    const float* st = ring + cur * kStage;
    const float* ws = st + kLc8 * kLdS;
#pragma unroll
    for (int r = 0; r < kLc8; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(st + r * kLdS + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(st + r * kLdS + BM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(ws + r * BN + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    cp_async_wait_all();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
    *reinterpret_cast<float4*>(rs + static_cast<size_t>(t) * ldr + k0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The accumulation of one supertile: group g (128 threads) takes the
// (component tile, 128-lane chunk) items g, g + 2, ...; each keeps its BK
// × 128 tile in registers over the supertile's `rows` frames (r = 0 on the
// padding rows) and then adds it to the block's partial (K, Lpa) in device
// memory, or writes it there on the block's first supertile.
template <int BK>
__device__ __forceinline__ void estep_acc(float* __restrict__ part, bool first, int K, int lpa, int rows,
                                          const float* xs, int ldx, const unsigned short* lanes,
                                          const float* rs, int ldr, float* work) {
  constexpr int TK = BK / 8;
  const int g = threadIdx.x >> 7, gt = threadIdx.x & 127, tl = gt & 15, tk = gt >> 4;
  float* ss = work + g * kAccT * kLdS8;
  const int n_lc = lpa / kAccL, n_items = (K + BK - 1) / BK * n_lc;
  const int n_t = (rows + kAccT - 1) / kAccT * kAccT;
  for (int item = g; item < n_items; item += 2) {
    const int l0 = (item % n_lc) * kAccL, k0 = (item / n_lc) * BK;
    const int p = lanes[l0 + gt], ia = p >> 8, ib = p & 255;
    float acc[TK][8];
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int t0 = 0; t0 < n_t; t0 += kAccT) {
      group_sync(g);  // the previous readers of ss are done
#pragma unroll 8
      for (int t = 0; t < kAccT; ++t) {
        const float* xr = xs + (t0 + t) * ldx;
        ss[t * kLdS8 + gt] = xr[ia] * xr[ib];
      }
      group_sync(g);
      const float* rt = rs + static_cast<size_t>(t0) * ldr + k0;
#pragma unroll 4
      for (int t = 0; t < kAccT; ++t) {
        float a[TK];
        const float4 a0 = *reinterpret_cast<const float4*>(rt + t * ldr + tk * 4);
        a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
        if constexpr (TK == 8) {
          const float4 a1 = *reinterpret_cast<const float4*>(rt + t * ldr + BK / 2 + tk * 4);
          a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
        }
        const float4 b0 = *reinterpret_cast<const float4*>(ss + t * kLdS8 + tl * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(ss + t * kLdS8 + kAccL / 2 + tl * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TK; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TK; ++i) {
      const int k = k0 + (i < 4 ? 0 : BK / 2) + tk * 4 + (i & 3);
      if (k >= K) continue;
      float* row = part + static_cast<size_t>(k) * lpa + l0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* q = reinterpret_cast<float4*>(row + h * (kAccL / 2) + tl * 4);
        float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        if (!first) {
          const float4 o = *q;
          v.x += o.x, v.y += o.y, v.z += o.z, v.w += o.w;
        }
        *q = v;
      }
    }
  }
}

// ---------------------------------------------------------------------
// K8 — fused GMM E-step.
// Replaces beer_tpu/ops/stats_kernels.py _gmm_estep_kernel (wrapper
// fused_gmm_estep, pallas_call at :352).  The TPU carried the (K, L) sum
// across its sequential grid in VMEM scratch.  Here a persistent block
// takes supertiles of F frames (blockIdx.x, + gridDim.x, ...), each:
//   1. the frames as x̃ = [x, 1, 0] and the mask into shared memory;
//   2. joint (F, Kp) = S·W into shared memory, one BM × BN tile at a time
//      through K9's ring (W's constant row carries E[log w]; W is
//      zero-padded on the host to whole chunks, one chunk past the last,
//      and Kp columns);
//   3. one warp per frame: m = max_k joint, s = Σ exp(joint − m), llh =
//      (m + log s)·mask (the only per-frame write) and r = exp(joint −
//      m)/s·mask over the joint, 0 on padding rows and columns;
//   4. Σ_t r_t ⊗ S(x_t) over the supertile by K10's micro-kernel, added to
//      the block's partial once per supertile.
// sum_rows_kernel adds the blocks' partials in a fixed order.
// ---------------------------------------------------------------------
template <int BN>
__global__ void __launch_bounds__(kThr8, 2) gmm_estep_full_kernel(
    const float* __restrict__ x,     // (T, D)
    const float* __restrict__ mask,  // (T,) or null (all frames count)
    const float* __restrict__ w,     // (Lp, Kp), zero-padded: Lp = (⌈L/kLc8⌉ + 1)·kLc8
    float* __restrict__ llh,         // (T,)
    float* __restrict__ part,        // (gridDim.x, K, Lpa), Lpa = ⌈L/128⌉·128
    int T, int D, int K, int F) {
  constexpr int BM = 8192 / BN;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const EstepLayout lay(D, K, BN, F);
  const int L = n_lanes(D), n_chunks = (L + kLc8 - 1) / kLc8, lpa = (L + kAccL - 1) / kAccL * kAccL;
  const int ldx = lay.ldx, ldr = lay.ldr;
  float* xs = smem;
  float* ms = smem + lay.ms;
  unsigned short* lanes = reinterpret_cast<unsigned short*>(smem + lay.lanes);
  float* rs = smem + lay.rs;
  float* work = smem + lay.work;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int l = tid; l < lay.n_table; l += kThr8) {
    int i, j;
    lane_pair(l, D, i, j);
    lanes[l] = static_cast<unsigned short>((i << 8) | j);
  }
  float* my_part = part + static_cast<size_t>(blockIdx.x) * K * lpa;
  const int n_super = (T + F - 1) / F;
  bool first = true;
  for (int su = blockIdx.x; su < n_super; su += gridDim.x) {
    const int f0 = su * F, rows = min(F, T - f0);
    __syncthreads();  // the previous supertile's readers of xs, ms and rs are done
    for (int e = tid; e < F * (D + 2); e += kThr8) {
      const int t = e / (D + 2), d = e - t * (D + 2);
      xs[t * ldx + d] = d < D ? (t < rows ? x[static_cast<size_t>(f0 + t) * D + d] : 0.f) : d == D ? 1.f : 0.f;
    }
    for (int t = tid; t < F; t += kThr8) ms[t] = t < rows ? (mask ? mask[f0 + t] : 1.f) : 0.f;
    for (int t0 = 0; t0 < rows; t0 += BM)
      for (int k0 = 0; k0 < K; k0 += BN)
        estep_joint_tile<BN>(w, lay.kp, n_chunks, k0, xs + t0 * ldx, ldx, lanes, rs + static_cast<size_t>(t0) * ldr,
                             ldr, work);
    __syncthreads();
    for (int t = warp; t < F; t += kThr8 / 32) {
      float* row = rs + static_cast<size_t>(t) * ldr;
      const float msk = ms[t];
      if (t >= rows) {
        for (int k = lane; k < lay.kp; k += 32) row[k] = 0.f;
        continue;
      }
      float m = -FLT_MAX, s = 0.f;
      for (int k = lane; k < K; k += 32) m = fmaxf(m, row[k]);
      m = warp_max(m);
      for (int k = lane; k < K; k += 32) s += expf(row[k] - m);
      s = warp_sum(s);
      for (int k = lane; k < lay.kp; k += 32) row[k] = k < K ? expf(row[k] - m) / s * msk : 0.f;
      if (lane == 0) llh[f0 + t] = (m + logf(s)) * msk;
    }
    __syncthreads();
    if (K <= 32)
      estep_acc<32>(my_part, first, K, lpa, rows, xs, ldx, lanes, rs, ldr, work);
    else
      estep_acc<64>(my_part, first, K, lpa, rows, xs, ldx, lanes, rs, ldr, work);
    first = false;
  }
}

// ---------------------------------------------------------------------
// K9 — full-covariance expected log-likelihood.
// Replaces beer_tpu/ops/stats_kernels.py _ellh_kernel (wrapper
// fused_ellh_full, pallas_call at :85).  llh[t, k] = −½ xᵀE[Λ_k]x +
// xᵀE[Λμ]_k + const_k as S(x)·W; the TPU contracted the full D² block, the
// packed upper triangle is the same function.
//
// A float32 SIMT GEMM out (T, K) = S (T, L) · W (L, K) whose A operand S is
// generated.  Grid (⌈T/BM⌉, Kp/BN), one BM × BN output block each,
// (BM/8)·(BN/TN) threads with 8 × TN outputs apiece (rows ty·4 + i and
// BM/2 + ty·4 + i, columns tx·4 + j and, for TN = 8, BN/2 + tx·4 + j, so
// that each warp's 128-bit shared loads are contiguous).  The block's
// frames sit in shared memory as x̃ = [x, 1, 0] (odd row stride); the lanes
// run in chunks of kLc9 through a two-stage ring: S chunk c is stored
// lane-major, (kLc9, BM + 4), built by threads that walk frames, one
// product x̃_i·x̃_j an entry from the lane table (a broadcast load, no
// branch), and W chunk c, (kLc9, BN), comes
// by cp.async from the wrapper's zero-padded W (Lp, Kp; one chunk of zeros
// past the last).  While the warps multiply chunk c, chunk c + 1 is built
// and fetched, all in one basic block with fixed trip counts, so that the
// scheduler interleaves the build's loads with the FMAs: one barrier a
// chunk.  Registers are capped at 128 a thread (at least 512 threads an
// SM), which measured faster than the 164–167 the compiler takes uncapped
// (stats_variants.py).
// The epilogue stores 128 bits at a time where K is a multiple of 4,
// masked on the ragged frame and component edges.  Bound: 2·T·K·L FLOPs.
// ---------------------------------------------------------------------
constexpr int kLc9 = 16;  // lanes per chunk

template <int BM, int BN, int TN>
struct EllhTile {
  static constexpr int kCols = BN / TN;                // thread columns
  static constexpr int kThreads = (BM / 8) * kCols;
  static constexpr int kLdS = BM + 4;                  // row stride of an S chunk
  static constexpr int kStage = kLc9 * kLdS + kLc9 * BN;
  static_assert(kLc9 * BM % kThreads == 0 && kLc9 * BN / 4 % kThreads == 0, "whole build and fetch rounds");
  // floats: the ring, the frame tile, the lane table (one chunk past the last)
  __host__ __device__ static size_t smem_floats(int D) {
    const size_t lanes = ((n_lanes(D) + kLc9 - 1) / kLc9 + 1) * kLc9;
    return 2 * static_cast<size_t>(kStage) + round4(static_cast<size_t>(BM) * ((D + 2) | 1)) +
           round4((lanes + 1) / 2);
  }
};

template <int BM, int BN, int TN>
__global__ void __launch_bounds__(EllhTile<BM, BN, TN>::kThreads, 512 / EllhTile<BM, BN, TN>::kThreads)
    ellh_full_kernel(
    const float* __restrict__ x,  // (T, D)
    const float* __restrict__ w,  // (Lp, Kp), zero-padded: Lp = (⌈L/kLc9⌉ + 1)·kLc9, Kp a multiple of BN
    float* __restrict__ out,      // (T, K)
    int T, int D, int K, int Kp) {
  using Tile = EllhTile<BM, BN, TN>;
  constexpr int kThr = Tile::kThreads, kLdS = Tile::kLdS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldx = (D + 2) | 1, n_chunks = (n_lanes(D) + kLc9 - 1) / kLc9;
  float* ring = smem;                                     // 2 × [S (kLc9, kLdS), W (kLc9, BN)]
  float* xs = ring + 2 * Tile::kStage;                    // (BM, ldx): x̃ = [x, 1, 0]
  unsigned short* lanes = reinterpret_cast<unsigned short*>(xs + round4(static_cast<size_t>(BM) * ldx));
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BM, k0 = blockIdx.y * BN, rows = min(BM, T - t0);

  for (int l = tid; l < (n_chunks + 1) * kLc9; l += kThr) {
    int i, j;
    lane_pair(l, D, i, j);
    lanes[l] = static_cast<unsigned short>((i << 8) | j);
  }
  for (int e = tid; e < BM * (D + 2); e += kThr) {
    const int t = e / (D + 2), d = e - t * (D + 2);
    xs[t * ldx + d] = d < D ? (t < rows ? x[static_cast<size_t>(t0 + t) * D + d] : 0.f) : d == D ? 1.f : 0.f;
  }
  // W chunk c → stage b by cp.async (all of it lies inside the padded W)
  auto fetch_w = [&](int c, int b) {
    float* ws = ring + b * Tile::kStage + kLc9 * kLdS;
    const float* src = w + static_cast<size_t>(c) * kLc9 * Kp + k0;
#pragma unroll
    for (int n = 0; n < kLc9 * BN / 4 / kThr; ++n) {
      const int q = tid + n * kThr, r = q / (BN / 4), k4 = (q % (BN / 4)) * 4;
      cp_async16(ws + r * BN + k4, src + static_cast<size_t>(r) * Kp + k4);
    }
    cp_async_commit();
  };
  // S chunk c → stage b: entry n of a thread is frame e % BM of lane e / BM,
  // e = tid + n·kThr, one product x̃_i·x̃_j from the lane table
  auto build_s = [&](int c, int b) {
    float* st = ring + b * Tile::kStage;
    const unsigned short* lc = lanes + c * kLc9;
#pragma unroll
    for (int n = 0; n < kLc9 * BM / kThr; ++n) {
      const int e = tid + n * kThr, r = e / BM, t = e % BM, p = lc[r];
      const float* xr = xs + t * ldx;
      st[r * kLdS + t] = xr[p >> 8] * xr[p & 255];
    }
  };
  fetch_w(0, 0);
  __syncthreads();  // the frame tile and the lane table are complete
  build_s(0, 0);
  cp_async_wait_all();
  __syncthreads();

  const int tx = tid % Tile::kCols, ty = tid / Tile::kCols;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int cur = c & 1;
    fetch_w(c + 1, cur ^ 1);  // stage cur ^ 1 was last read before the previous barrier
    build_s(c + 1, cur ^ 1);  // (past the last chunk: zeros, never read)
    const float* st = ring + cur * Tile::kStage;
    const float* ws = st + kLc9 * kLdS;
#pragma unroll
    for (int r = 0; r < kLc9; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(st + r * kLdS + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(st + r * kLdS + BM / 2 + ty * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
      const float4 b0 = *reinterpret_cast<const float4*>(ws + r * BN + tx * 4);
      bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 = *reinterpret_cast<const float4*>(ws + r * BN + BN / 2 + tx * 4);
        bv[TN - 4] = b1.x, bv[TN - 3] = b1.y, bv[TN - 2] = b1.z, bv[TN - 1] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  const bool vec = K % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
    if (t >= rows) continue;
    float* row = out + static_cast<size_t>(t0 + t) * K;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int k = k0 + h * (BN / 2) + tx * 4;
      if (vec && k < K) {
        *reinterpret_cast<float4*>(row + k) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K) row[k + j] = acc[i][4 * h + j];
      }
    }
  }
}

// ---------------------------------------------------------------------
// K10 — full-covariance accumulation.
// Replaces beer_tpu/ops/stats_kernels.py _acc_kernel (wrapper
// fused_accumulate_full, pallas_call at :151).  The TPU carried the (K, L)
// sum across its sequential grid; here the frames are split into slices.
//
// A float32 SIMT GEMM (K, Lp) = rᵀ (K, T) · S (T, Lp), output-stationary:
// block (lane chunk, component tile, frame slice), the lane chunks running
// fastest so that the blocks of one slice run together and read its frames
// and responsibilities from L2 after the first.  Each block holds a BK × 128
// tile in registers, 128 threads of TK × 8 outputs (components tk·4 + i
// and, for TK = 8, BK/2 + tk·4 + i; lanes tl·4 + j and 64 + tl·4 + j), for
// its whole slice.  Per 32 frames: the frames (32, D), contiguous, and the
// responsibilities (32, BK) arrive by 16-byte cp.async (4-byte where K is
// not a multiple of 4; zero-filled past the slice and past K) one tile
// ahead, each thread builds its own lane of S for the 32 frames, a(t)·b(t)
// with a and b a frame's x_i and x_j, or a constant 1 or 0 beside the
// tile (stride 0), its pair decoded once for the whole kernel, and the
// tile's outer products are summed.  The block writes its partial (BK, 128) of the
// slice's (K, Lp) once, 128 bits at a time; sum_rows_kernel adds the
// slices in a fixed order.  Bound: 2·T·K·L FLOPs.
// ---------------------------------------------------------------------
constexpr int kBl10 = 128;  // lanes a block
constexpr int kTt10 = 32;   // frames a tile
constexpr int kThr10 = 128;

template <int BK>
struct AccTile {
  static constexpr int kLdS = kBl10 + 4, kLdR = BK + 4;
  __host__ __device__ static size_t smem_floats(int D) {
    return static_cast<size_t>(kTt10) * kLdS + 2 * (static_cast<size_t>(kTt10) * kLdR +
                                                    round4(static_cast<size_t>(kTt10) * D + 2));
  }
};

template <int BK>
__global__ void __launch_bounds__(kThr10) accumulate_full_kernel(
    const float* __restrict__ x,  // (T, D)
    const float* __restrict__ r,  // (T, K)
    float* __restrict__ part,     // (n_slices, K, Lp)
    int T, int D, int K, int Lp, int n_kc, int slice) {  // slice: frames a slice, a multiple of kTt10
  using Tile = AccTile<BK>;
  constexpr int TK = BK / 8, kLdS = Tile::kLdS, kLdR = Tile::kLdR;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_lc = Lp / kBl10, ldxs = static_cast<int>(round4(static_cast<size_t>(kTt10) * D + 2));
  float* ss = smem;                          // (kTt10, kLdS)
  float* rs = ss + kTt10 * kLdS;             // 2 × (kTt10, kLdR)
  float* xs = rs + 2 * kTt10 * kLdR;         // 2 × [(kTt10, D) frames, 1, 0]
  const int tid = threadIdx.x;
  const int lc = blockIdx.x % n_lc, kc = (blockIdx.x / n_lc) % n_kc, sl = blockIdx.x / (n_lc * n_kc);
  const int l0 = lc * kBl10, k0 = kc * BK;
  const int f0 = sl * slice, f1 = min(T, f0 + slice);
  const int n_tiles = (f1 - f0 + kTt10 - 1) / kTt10;

  // this thread's lane of S at frame t of a stage xt: xt[oa + t·sa]·xt[ob +
  // t·sb], index D and D + 1 standing for the stage's 1 and 0
  int ia, ib;
  lane_pair(l0 + tid, D, ia, ib);
  const int oa = ia < D ? ia : kTt10 * D + ia - D, sa = ia < D ? D : 0;
  const int ob = ib < D ? ib : kTt10 * D + ib - D, sb = ib < D ? D : 0;
  if (tid < 2) {
    xs[tid * ldxs + kTt10 * D] = 1.f;
    xs[tid * ldxs + kTt10 * D + 1] = 0.f;
  }
  const bool vec_r = K % 4 == 0;

  // frames and responsibilities of tile i → stage b, zero-filled past the slice and K
  auto fetch = [&](int i, int b) {
    const int f = f0 + i * kTt10;
    const float* xsrc = x + static_cast<size_t>(f) * D;   // 16-byte aligned: f is a multiple of 32
    const int x_bytes = min(kTt10, f1 - f) * D * 4;
    for (int q = tid; q < kTt10 * D / 4; q += kThr10) {
      const int bytes = min(max(x_bytes - q * 16, 0), 16);
      cp_async16z(xs + b * ldxs + 4 * q, bytes ? xsrc + 4 * q : x, bytes);
    }
    float* rt = rs + b * kTt10 * kLdR;
    if (vec_r) {
#pragma unroll
      for (int n = 0; n < kTt10 * BK / 4 / kThr10; ++n) {
        const int q = tid + n * kThr10, t = q / (BK / 4), k = (q % (BK / 4)) * 4;
        const int bytes = f + t < f1 ? min(max((K - k0 - k) * 4, 0), 16) : 0;
        cp_async16z(rt + t * kLdR + k, bytes ? r + static_cast<size_t>(f + t) * K + k0 + k : r, bytes);
      }
    } else {
      for (int q = tid; q < kTt10 * BK; q += kThr10) {
        const int t = q / BK, k = q % BK;
        const bool ok = f + t < f1 && k0 + k < K;
        cp_async4(rt + t * kLdR + k, ok ? r + static_cast<size_t>(f + t) * K + k0 + k : r, ok);
      }
    }
    cp_async_commit();
  };

  const int tl = tid & 15, tk = tid >> 4;
  float acc[TK][8];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (n_tiles > 0) fetch(0, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int cur = i & 1;
    cp_async_wait_all();
    __syncthreads();  // tile i has landed; every reader of tile i − 1 (ss, stage cur ^ 1) is done
    if (i + 1 < n_tiles) fetch(i + 1, cur ^ 1);
    const float* xt = xs + cur * ldxs;
#pragma unroll 8
    for (int t = 0; t < kTt10; ++t) ss[t * kLdS + tid] = xt[oa + t * sa] * xt[ob + t * sb];
    __syncthreads();  // the S tile is complete
    const float* rt = rs + cur * kTt10 * kLdR;
#pragma unroll 4
    for (int t = 0; t < kTt10; ++t) {
      float a[TK];
      const float4 a0 = *reinterpret_cast<const float4*>(rt + t * kLdR + tk * 4);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      if constexpr (TK == 8) {
        const float4 a1 = *reinterpret_cast<const float4*>(rt + t * kLdR + BK / 2 + tk * 4);
        a[TK - 4] = a1.x, a[TK - 3] = a1.y, a[TK - 2] = a1.z, a[TK - 1] = a1.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(ss + t * kLdS + tl * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(ss + t * kLdS + kBl10 / 2 + tl * 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int ii = 0; ii < TK; ++ii)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[ii][j] = fmaf(a[ii], bv[j], acc[ii][j]);
    }
  }
#pragma unroll
  for (int ii = 0; ii < TK; ++ii) {
    const int k = k0 + (ii < 4 ? 0 : BK / 2) + tk * 4 + (ii & 3);
    if (k >= K) continue;
    float* row = part + (static_cast<size_t>(sl) * K + k) * Lp + l0;
    *reinterpret_cast<float4*>(row + tl * 4) = make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
    *reinterpret_cast<float4*>(row + kBl10 / 2 + tl * 4) =
        make_float4(acc[ii][4], acc[ii][5], acc[ii][6], acc[ii][7]);
  }
}

// Resident blocks of a kernel on the whole card: blocks per SM × SMs.
template <typename Kernel>
int resident_blocks(Kernel kernel, int device, int threads, size_t smem) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return err != cudaSuccess ? -static_cast<int>(err) : per_sm * sms;
}

// Calls f with K9's instance for (BM, BN); false if there is none.
template <typename F>
bool with_ellh_instance(int bm, int bn, F&& f) {
  switch (bm * 1000 + bn) {
    case 64016: f(ellh_full_kernel<64, 16, 4>, EllhTile<64, 16, 4>()); return true;
    case 64032: f(ellh_full_kernel<64, 32, 4>, EllhTile<64, 32, 4>()); return true;
    case 64064: f(ellh_full_kernel<64, 64, 4>, EllhTile<64, 64, 4>()); return true;
    case 64128: f(ellh_full_kernel<64, 128, 8>, EllhTile<64, 128, 8>()); return true;
    case 128016: f(ellh_full_kernel<128, 16, 4>, EllhTile<128, 16, 4>()); return true;
    case 128032: f(ellh_full_kernel<128, 32, 4>, EllhTile<128, 32, 4>()); return true;
    case 128064: f(ellh_full_kernel<128, 64, 4>, EllhTile<128, 64, 4>()); return true;
    case 128128: f(ellh_full_kernel<128, 128, 8>, EllhTile<128, 128, 8>()); return true;
    default: return false;
  }
}

// Calls f with K8's instance for its joint component tile bn.
template <typename F>
bool with_estep_instance(int bn, F&& f) {
  switch (bn) {
    case 32: f(gmm_estep_full_kernel<32>); return true;
    case 64: f(gmm_estep_full_kernel<64>); return true;
    case 128: f(gmm_estep_full_kernel<128>); return true;
    default: return false;
  }
}

template <typename F>
bool with_acc_instance(int bk, F&& f) {
  switch (bk) {
    case 32: f(accumulate_full_kernel<32>, AccTile<32>()); return true;
    case 64: f(accumulate_full_kernel<64>, AccTile<64>()); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// Shared memory of one block: K8 (kind 0) at (D, K) with tile_t frames a
// supertile and joint component tile tile_k; K9 (kind 1) at its frame
// and component tiles (tile_t, tile_k); K10 (kind 2) at its component
// tile.  0 for a tile with no instance.
size_t beer_stats_smem_bytes(int kind, int D, int K, int tile_t, int tile_k) {
  size_t floats = 0;
  if (kind == kEstep && with_estep_instance(tile_k, [](auto) {}) && tile_t > 0 && tile_t % (8192 / tile_k) == 0)
    floats = EstepLayout(D, K, tile_k, tile_t).total;
  if (kind == kEllh) with_ellh_instance(tile_t, tile_k, [&](auto, auto tile) { floats = tile.smem_floats(D); });
  if (kind == kAcc) with_acc_instance(tile_k, [&](auto, auto tile) { floats = tile.smem_floats(D); });
  return floats * sizeof(float);
}

// Once per device: lets every kernel here take the shared memory a block
// may use, so that a launch sets no attribute.  0 or a CUDA error.
int beer_stats_prepare(int device) {
  cudaError_t err = cudaSetDevice(device);
  const size_t most = 232448;
  for (int bn : {32, 64, 128})
    with_estep_instance(bn, [&](auto kernel) {
      if (err == cudaSuccess) err = set_smem(kernel, most);
    });
  for (int bm : {64, 128})
    for (int bn : {16, 32, 64, 128})
      with_ellh_instance(bm, bn, [&](auto kernel, auto) {
        if (err == cudaSuccess) err = set_smem(kernel, most);
      });
  for (int bk : {32, 64})
    with_acc_instance(bk, [&](auto kernel, auto) {
      if (err == cudaSuccess) err = set_smem(kernel, most);
    });
  return err;
}

// Resident blocks on the card of K8 (kind 0, at (D, K), tile_t frames a
// supertile and joint component tile tile_k) or K10 (kind 2, at its
// component tile tile_k); −(CUDA error) on failure.
int beer_stats_blocks(int device, int kind, int D, int K, int tile_t, int tile_k) {
  const size_t smem = beer_stats_smem_bytes(kind, D, K, tile_t, tile_k);
  int n = -static_cast<int>(cudaErrorInvalidValue);
  if (kind == kEstep && smem > 0)
    with_estep_instance(tile_k, [&](auto kernel) { n = resident_blocks(kernel, device, kThr8, smem); });
  if (kind == kAcc)
    with_acc_instance(tile_k, [&](auto kernel, auto) { n = resident_blocks(kernel, device, kThr10, smem); });
  return n;
}

// llh (T,); out (K·Lpa) = Σ over the n_blk partials part (n_blk, K·Lpa),
// Lpa = ⌈L/128⌉·128; w (Lp, Kp) zero-padded as the kernel's note says;
// frames a supertile and the joint component tile tile_k name the
// geometry.
int beer_gmm_estep_full(int device, const float* x, const float* mask, const float* w, float* llh, float* part,
                        float* out, int n_blk, int T, int D, int K, int frames, int tile_k, void* stream) {
  const size_t smem = beer_stats_smem_bytes(kEstep, D, K, frames, tile_k);
  if (D < 1 || D > kMaxDim || K < 1 || K > kMaxComp || smem == 0 || EstepLayout(D, K, tile_k, frames).kp % tile_k)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int n = K * ((n_lanes(D) + kAccL - 1) / kAccL * kAccL);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blk > 0) {
    with_estep_instance(tile_k, [&](auto kernel) {
      kernel<<<n_blk, kThr8, smem, st>>>(x, mask, w, llh, part, T, D, K, frames);
    });
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, n_blk, n);
  return cudaGetLastError();
}

// out (T, K) = S(x)·W with W zero-padded to (⌈L/16⌉·16, Kp), Kp a multiple
// of tile_k; the tiles (tile_t, tile_k) name the instance.
int beer_ellh_full(int device, const float* x, const float* w, float* out, int T, int D, int K, int Kp,
                   int tile_t, int tile_k, void* stream) {
  if (D < 1 || D > kMaxDim || K < 1 || Kp % tile_k != 0 || Kp < K) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || T == 0) return err;
  const size_t smem = beer_stats_smem_bytes(kEllh, D, K, tile_t, tile_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool found = with_ellh_instance(tile_t, tile_k, [&](auto kernel, auto tile) {
    const dim3 grid((T + tile_t - 1) / tile_t, Kp / tile_k);
    kernel<<<grid, tile.kThreads, smem, st>>>(x, w, out, T, D, K, Kp);
  });
  return found ? cudaGetLastError() : cudaErrorInvalidValue;
}

// out (K·Lp) = Σ over the n_slices partials part (n_slices, K, Lp), Lp =
// ⌈L/128⌉·128; slice frames a slice (a multiple of 32); tile_k the
// component tile (the instance).
int beer_accumulate_full(int device, const float* x, const float* r, float* part, float* out, int n_slices,
                         int slice, int T, int D, int K, int tile_k, void* stream) {
  if (D < 1 || D > kMaxDim || K < 1 || K > kMaxComp || slice % kTt10 != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int lp = (n_lanes(D) + kBl10 - 1) / kBl10 * kBl10, n_kc = (K + tile_k - 1) / tile_k;
  const size_t smem = beer_stats_smem_bytes(kAcc, D, K, 0, tile_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_slices > 0) {
    const bool found = with_acc_instance(tile_k, [&](auto kernel, auto) {
      kernel<<<n_slices * n_kc * (lp / kBl10), kThr10, smem, st>>>(x, r, part, T, D, K, lp, n_kc, slice);
    });
    err = found ? cudaGetLastError() : cudaErrorInvalidValue;
    if (err != cudaSuccess) return err;
  }
  const int n = K * lp;
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, n_slices, n);
  return cudaGetLastError();
}

}  // extern "C"
