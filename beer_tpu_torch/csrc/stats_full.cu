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
// generated instead of loaded; K9 and K10 are built as such:
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
//       and sum_rows_kernel adds the slices' partials in a fixed order.
//
// K8 keeps the first design (a persistent grid of 128-frame tiles, 8 × 4
// and 4 × 4 thread tiles, a (K, L) partial per block in device memory);
// its rebuild from K9's and K10's tiles is the next step.  No atomics
// anywhere: two runs agree bitwise.  Limits: 1 <= D <= 128; K8 and K10
// take 1 <= K <= 256 (K8 holds a tile's responsibilities in shared
// memory); K9 takes any K.  The wrappers raise above them.

#include <initializer_list>

#include "scan_common.cuh"

namespace {

constexpr int kMaxDim = 128;
constexpr int kMaxComp = 256;

enum Kind { kEstep = 0, kEllh = 1, kAcc = 2 };

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline int n_lanes(int D) { return D * (D + 1) / 2 + D + 1; }

// pairs[l] = i << 8 | j for the l-th upper-triangular pair (i <= j).
__device__ void build_pairs(unsigned short* pairs, int D, int n_ut) {
  for (int l = threadIdx.x; l < n_ut; l += blockDim.x) {
    int i = 0, off = 0;
    while (l >= off + D - i) {
      off += D - i;
      ++i;
    }
    pairs[l] = static_cast<unsigned short>((i << 8) | (i + l - off));
  }
}

// Lane l of S for one frame row of an x tile (0 past the last lane).
__device__ __forceinline__ float s_entry(const float* xr, int l, int n_ut, int D,
                                         const unsigned short* pairs) {
  if (l < n_ut) {
    const int p = pairs[l];
    return xr[p >> 8] * xr[p & 255];
  }
  if (l < n_ut + D) return xr[l - n_ut];
  return l == n_ut + D ? 1.f : 0.f;
}

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

// 4 bytes, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// ---------------------------------------------------------------------
// K8's tiles: 128 frames, 256 threads, 64 components a pass.
// ---------------------------------------------------------------------
constexpr int kTile = 128;       // frames per tile
constexpr int kThreads = 256;    // threads per block
constexpr int kKc = 64;          // components per pass
constexpr int kLcJ = 32;         // lanes per chunk of the joint product
constexpr int kLcA = 64;         // lanes per chunk of the accumulation
constexpr int kLdT = kTile + 4;  // row stride of the c-major S chunk
constexpr int kLdA = kLcA + 4;   // row stride of the frame-major S chunk

// K8's shared-memory layout (float offsets, each a multiple of 4 floats so
// that float4 accesses stay 16-byte aligned).
struct Layout {
  int n_ut, ldx, ldr;
  size_t xs, ms, rs, work, total;
  __host__ __device__ Layout(int D, int K) {
    n_ut = D * (D + 1) / 2;
    ldx = D | 1;                                  // odd: conflict-free column walks
    ldr = (K + kKc - 1) / kKc * kKc + 4;
    const size_t pairs = round4((static_cast<size_t>(n_ut) + 1) / 2);  // ushort pairs
    xs = pairs;
    ms = xs + round4(static_cast<size_t>(kTile) * ldx);
    rs = ms + kTile;
    const size_t joint = static_cast<size_t>(kLcJ) * kLdT + static_cast<size_t>(kLcJ) * kKc;
    const size_t acc = static_cast<size_t>(kTile) * kLdA;
    work = rs + static_cast<size_t>(kTile) * ldr;
    total = work + (joint > acc ? joint : acc);
  }
};

// Frames t0 .. t0+rows−1 into xs (rows past the end zero-filled).
__device__ void load_x(float* xs, int ldx, const float* __restrict__ x, int t0, int rows, int D) {
  for (int e = threadIdx.x; e < kTile * D; e += blockDim.x) {
    const int t = e / D, d = e - t * D;
    xs[t * ldx + d] = t < rows ? x[static_cast<size_t>(t0 + t) * D + d] : 0.f;
  }
}

// acc[i][j] = Σ_l S[ty·8+i, l] · W[l, k0+tx·4+j] for the tile in xs; W (L, K)
// in device memory.  Starts with a barrier, so writes to xs made before the
// call are visible.
__device__ __forceinline__ void joint_pass(const float* __restrict__ w, int L, int K, int k0, int n_ut, int D,
                           const unsigned short* pairs, const float* xs, int ldx, float* work,
                           float acc[8][4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* st = work;                 // (kLcJ, kLdT): st[c][t] = S[t, l0+c]
  float* ws = work + kLcJ * kLdT;   // (kLcJ, kKc):  ws[c][k] = W[l0+c, k0+k]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int l0 = 0; l0 < L; l0 += kLcJ) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < kLcJ * kTile; e += kThreads) {
      const int c = e / kTile, t = e - c * kTile;
      st[c * kLdT + t] = s_entry(xs + t * ldx, l0 + c, n_ut, D, pairs);
    }
    for (int e = tid; e < kLcJ * kKc; e += kThreads) {
      const int c = e / kKc, k = k0 + (e - c * kKc), l = l0 + c;
      ws[e] = (l < L && k < K) ? w[static_cast<size_t>(l) * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kLcJ; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(st + c * kLdT + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(st + c * kLdT + ty * 8 + 4);
      const float4 b = *reinterpret_cast<const float4*>(ws + c * kKc + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
}

// part (K, L) = (first ? 0 : part) + Σ_t rs[t, k] · S[t, l] over the tile in
// xs, with rs (kTile, ldr) the tile's responsibilities (0 on padding rows and
// columns).  Starts with a barrier, so writes to xs and rs made before the
// call are visible.
__device__ __forceinline__ void acc_pass(float* __restrict__ part, bool first, int L, int K, int n_ut, int D,
                         const unsigned short* pairs, const float* xs, int ldx, const float* rs,
                         int ldr, float* ss) {
  const int tid = threadIdx.x, tc = tid & 15, tk = tid >> 4;
  for (int l0 = 0; l0 < L; l0 += kLcA) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < kTile * kLcA; e += kThreads) {
      const int t = e / kLcA, c = e - t * kLcA;
      ss[t * kLdA + c] = s_entry(xs + t * ldx, l0 + c, n_ut, D, pairs);
    }
    __syncthreads();
    for (int k0 = 0; k0 < K; k0 += kKc) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int t = 0; t < kTile; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(rs + t * ldr + k0 + tk * 4);
        const float4 b = *reinterpret_cast<const float4*>(ss + t * kLdA + tc * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + tk * 4 + i;
        if (k >= K) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = l0 + tc * 4 + j;
          if (l >= L) continue;
          float* p = part + static_cast<size_t>(k) * L + l;
          *p = first ? acc[i][j] : *p + acc[i][j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// K8 — fused GMM E-step.
// Replaces beer_tpu/ops/stats_kernels.py _gmm_estep_kernel (wrapper
// fused_gmm_estep, pallas_call at :352).  Per tile: joint (128, K) = S·W
// (W's constant row carries E[log w]) into shared memory, one warp per frame
// for m = max_k joint, s = Σ exp(joint − m), llh = (m + log s)·mask and r =
// exp(joint − m)/s·mask written over the joint, then the block's partial
// (K, L) += rᵀ·S.  The TPU carried the (K, L) sum across its sequential grid
// in VMEM scratch; here the block's own partial in device memory does, and
// the partials are summed in a fixed order.  Bound: 4·T·K·L FLOPs.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) gmm_estep_full_kernel(
    const float* __restrict__ x,     // (T, D)
    const float* __restrict__ mask,  // (T,) or null (all frames count)
    const float* __restrict__ w,     // (L, K)
    float* __restrict__ llh,         // (T,)
    float* __restrict__ part,        // (gridDim.x, K, L)
    int T, int D, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(D, K);
  const int L = lay.n_ut + D + 1;
  unsigned short* pairs = reinterpret_cast<unsigned short*>(smem);
  float* xs = smem + lay.xs;
  float* ms = smem + lay.ms;
  float* rs = smem + lay.rs;
  float* work = smem + lay.work;
  build_pairs(pairs, D, lay.n_ut);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (T + kTile - 1) / kTile;
  float* my_part = part + static_cast<size_t>(blockIdx.x) * K * L;
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t0 = tile * kTile, rows = min(kTile, T - t0);
    __syncthreads();  // the previous tile's readers of xs, ms and rs are done
    load_x(xs, lay.ldx, x, t0, rows, D);
    for (int t = tid; t < kTile; t += kThreads) ms[t] = t < rows ? (mask ? mask[t0 + t] : 1.f) : 0.f;
    for (int k0 = 0; k0 < K; k0 += kKc) {
      float acc[8][4];
      joint_pass(w, L, K, k0, lay.n_ut, D, pairs, xs, lay.ldx, work, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(rs + (ty * 8 + i) * lay.ldr + k0 + tx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    for (int t = warp; t < kTile; t += kThreads / 32) {
      float* row = rs + t * lay.ldr;
      float m = -FLT_MAX, s = 0.f;
      for (int k = lane; k < K; k += 32) m = fmaxf(m, row[k]);
      m = warp_max(m);
      for (int k = lane; k < K; k += 32) s += expf(row[k] - m);
      s = warp_sum(s);
      const float msk = ms[t];
      for (int k = lane; k < lay.ldr - 4; k += 32) row[k] = k < K ? expf(row[k] - m) / s * msk : 0.f;
      if (lane == 0 && t < rows) llh[t0 + t] = (m + logf(s)) * msk;
    }
    acc_pass(my_part, first, L, K, lay.n_ut, D, pairs, xs, lay.ldx, rs, lay.ldr, work);
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

// Shared memory of one block: K8 (kind 0) at (D, K); K9 (kind 1) at its
// frame and component tiles (tile_t, tile_k); K10 (kind 2) at its
// component tile.  0 for a tile with no instance.
size_t beer_stats_smem_bytes(int kind, int D, int K, int tile_t, int tile_k) {
  size_t floats = 0;
  if (kind == kEstep) floats = Layout(D, K).total;
  if (kind == kEllh) with_ellh_instance(tile_t, tile_k, [&](auto, auto tile) { floats = tile.smem_floats(D); });
  if (kind == kAcc) with_acc_instance(tile_k, [&](auto, auto tile) { floats = tile.smem_floats(D); });
  return floats * sizeof(float);
}

// Once per device: lets every kernel here take the shared memory a block
// may use, so that a launch sets no attribute.  0 or a CUDA error.
int beer_stats_prepare(int device) {
  cudaError_t err = cudaSetDevice(device);
  const size_t most = 232448;
  if (err == cudaSuccess) err = set_smem(gmm_estep_full_kernel, most);
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

// Resident blocks on the card of K8 (kind 0, at (D, K)) or K10 (kind 2, at
// its component tile tile_k); −(CUDA error) on failure.
int beer_stats_blocks(int device, int kind, int D, int K, int tile_k) {
  const size_t smem = beer_stats_smem_bytes(kind, D, K, 0, tile_k);
  if (kind == kEstep) return resident_blocks(gmm_estep_full_kernel, device, kThreads, smem);
  int n = -static_cast<int>(cudaErrorInvalidValue);
  with_acc_instance(tile_k, [&](auto kernel, auto) { n = resident_blocks(kernel, device, kThr10, smem); });
  return n;
}

// llh (T,); out (K·L) = Σ over the n_blk partials part (n_blk, K·L).
int beer_gmm_estep_full(int device, const float* x, const float* mask, const float* w, float* llh, float* part,
                        float* out, int n_blk, int T, int D, int K, void* stream) {
  if (D < 1 || D > kMaxDim || K < 1 || K > kMaxComp) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int n = K * n_lanes(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blk > 0) {
    gmm_estep_full_kernel<<<n_blk, kThreads, Layout(D, K).total * sizeof(float), st>>>(x, mask, w, llh, part, T,
                                                                                       D, K);
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
