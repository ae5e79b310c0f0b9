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
// note above each kernel names it.
//
// Design.  A tile is 128 frames; its frames x (128, D) sit in shared memory
// and S is built from them in chunks of lanes, each entry one float32
// product of float32 values (the exact product the TPU's bf16 three-limb
// split reconstructs; that split and its 0/1 selector matmuls are TPU
// artifacts and have no counterpart here).  Two SIMT float32 micro-kernels
// with FMA accumulation do the work, 256 threads a block:
//   joint  (128 frames × 64 components) += S chunk (c-major) · W chunk,
//          8 × 4 outputs per thread, reduced over 32-lane chunks of L;
//   accum  (64 components × 64 lanes) += rᵀ · S chunk (frame-major),
//          4 × 4 outputs per thread, reduced over the tile's 128 frames.
// No TF32, bf16 or tensor cores: every product and sum is float32 (the JAX
// package's history records 16-bit products making the VB ELBO oscillate at
// production magnitudes).  The (K, L) sums do not fit beside a frame tile in
// shared memory (210 KB at K = 64, D = 39), so K8 and K10 run a persistent
// grid (blocks per SM × SMs, capped at the tile count) in which block b
// takes tiles b, b + grid, ... and adds each tile's sums into its own
// (K, L) partial in device memory (L2-resident at 1-2 blocks per SM);
// sum_rows_kernel then adds the partials in a fixed order.  No atomics:
// two runs agree bitwise.  The ragged last tile is zero-filled and masked.
//
// Bound on the H100 (float32 outside the tensor cores, 67 TFLOP/s; 3.35
// TB/s): operations.  At config 1 (T = 256,000, D = 39, K = 64) K8 does
// 4·T·K·L = 53.7 GFLOP (0.80 ms) against 40 MB of frames (12 µs); K9 and
// K10 half of that each.  Limits: 1 <= D <= 128; K8 and K10 hold a tile's
// K responsibilities in shared memory, 1 <= K <= 256 (within the 227 KB a
// block may use: at D = 39 every K up to 256 fits); K9 takes any K.  The
// wrappers raise above them.

#include "scan_common.cuh"

namespace {

constexpr int kTile = 128;       // frames per tile
constexpr int kThreads = 256;    // threads per block, every kernel
constexpr int kKc = 64;          // components per pass
constexpr int kLcJ = 32;         // lanes per chunk of the joint product
constexpr int kLcA = 64;         // lanes per chunk of the accumulation
constexpr int kLdT = kTile + 4;  // row stride of the c-major S chunk
constexpr int kLdA = kLcA + 4;   // row stride of the frame-major S chunk
constexpr int kMaxDim = 128;
constexpr int kMaxComp = 256;

enum Kind { kEstep = 0, kEllh = 1, kAcc = 2 };

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// Shared-memory layout (float offsets, each a multiple of 4 floats so that
// float4 accesses stay 16-byte aligned).
struct Layout {
  int n_ut, ldx, ldr;
  size_t xs, ms, rs, work, total;
  __host__ __device__ Layout(int kind, int D, int K) {
    n_ut = D * (D + 1) / 2;
    ldx = D | 1;                                  // odd: conflict-free column walks
    ldr = (K + kKc - 1) / kKc * kKc + 4;
    const size_t pairs = round4((static_cast<size_t>(n_ut) + 1) / 2);  // ushort pairs
    xs = pairs;
    ms = xs + round4(static_cast<size_t>(kTile) * ldx);
    rs = ms + (kind == kEstep ? kTile : 0);
    const size_t joint = static_cast<size_t>(kLcJ) * kLdT + static_cast<size_t>(kLcJ) * kKc;
    const size_t acc = static_cast<size_t>(kTile) * kLdA;
    work = rs + (kind == kEllh ? 0 : static_cast<size_t>(kTile) * ldr);
    total = work + (kind == kEstep ? (joint > acc ? joint : acc) : kind == kEllh ? joint : acc);
  }
};

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

// Lane l of S for one frame row of the x tile (0 past the last lane).
__device__ __forceinline__ float s_entry(const float* xr, int l, int n_ut, int D,
                                         const unsigned short* pairs) {
  if (l < n_ut) {
    const int p = pairs[l];
    return xr[p >> 8] * xr[p & 255];
  }
  if (l < n_ut + D) return xr[l - n_ut];
  return l == n_ut + D ? 1.f : 0.f;
}

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
  const Layout lay(kEstep, D, K);
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
// packed upper triangle is the same function.  Grid (tiles, ⌈K/64⌉), one
// 128 × 64 output block each.  Bound: 2·T·K·L FLOPs.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ellh_full_kernel(
    const float* __restrict__ x,  // (T, D)
    const float* __restrict__ w,  // (L, K)
    float* __restrict__ out,      // (T, K)
    int T, int D, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(kEllh, D, K);
  const int L = lay.n_ut + D + 1;
  unsigned short* pairs = reinterpret_cast<unsigned short*>(smem);
  float* xs = smem + lay.xs;
  build_pairs(pairs, D, lay.n_ut);
  const int t0 = blockIdx.x * kTile, rows = min(kTile, T - t0), k0 = blockIdx.y * kKc;
  load_x(xs, lay.ldx, x, t0, rows, D);
  float acc[8][4];
  joint_pass(w, L, K, k0, lay.n_ut, D, pairs, xs, lay.ldx, smem + lay.work, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty * 8 + i;
    if (t >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < K) out[static_cast<size_t>(t0 + t) * K + k] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------
// K10 — full-covariance accumulation.
// Replaces beer_tpu/ops/stats_kernels.py _acc_kernel (wrapper
// fused_accumulate_full, pallas_call at :151).  Per tile the responsibilities
// (128, K) are loaded into shared memory and the block's partial (K, L) +=
// rᵀ·S, as K8's second half.  Bound: 2·T·K·L FLOPs.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) accumulate_full_kernel(
    const float* __restrict__ x,  // (T, D)
    const float* __restrict__ r,  // (T, K)
    float* __restrict__ part,     // (gridDim.x, K, L)
    int T, int D, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(kAcc, D, K);
  const int L = lay.n_ut + D + 1;
  unsigned short* pairs = reinterpret_cast<unsigned short*>(smem);
  float* xs = smem + lay.xs;
  float* rs = smem + lay.rs;
  build_pairs(pairs, D, lay.n_ut);
  const int n_tiles = (T + kTile - 1) / kTile, kp = lay.ldr - 4;
  float* my_part = part + static_cast<size_t>(blockIdx.x) * K * L;
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t0 = tile * kTile, rows = min(kTile, T - t0);
    __syncthreads();  // the previous tile's readers of xs and rs are done
    load_x(xs, lay.ldx, x, t0, rows, D);
    for (int e = threadIdx.x; e < kTile * kp; e += kThreads) {
      const int t = e / kp, k = e - t * kp;
      rs[t * lay.ldr + k] = (t < rows && k < K) ? r[static_cast<size_t>(t0 + t) * K + k] : 0.f;
    }
    acc_pass(my_part, first, L, K, lay.n_ut, D, pairs, xs, lay.ldx, rs, lay.ldr, smem + lay.work);
    first = false;
  }
}

// Blocks of a persistent launch: resident blocks per SM × SMs, at most one per tile.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int device, size_t smem, int T) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int n_tiles = (T + kTile - 1) / kTile;
  const int n = per_sm * sms;
  return n < n_tiles ? n : n_tiles;
}

}  // namespace

extern "C" {

size_t beer_stats_smem_bytes(int kind, int D, int K) { return Layout(kind, D, K).total * sizeof(float); }

// Blocks of K8's (kind 0) or K10's (kind 2) persistent grid; −(CUDA error) on failure.
int beer_stats_blocks(int device, int kind, int T, int D, int K) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t smem = beer_stats_smem_bytes(kind, D, K);
  if (kind == kEstep) {
    err = set_smem(gmm_estep_full_kernel, smem);
    return err != cudaSuccess ? -static_cast<int>(err) : persistent_blocks(gmm_estep_full_kernel, device, smem, T);
  }
  err = set_smem(accumulate_full_kernel, smem);
  return err != cudaSuccess ? -static_cast<int>(err) : persistent_blocks(accumulate_full_kernel, device, smem, T);
}

// llh (T,); out (K·L) = Σ over the n_blk partials part (n_blk, K·L).
int beer_gmm_estep_full(int device, const float* x, const float* mask, const float* w, float* llh, float* part,
                        float* out, int n_blk, int T, int D, int K, void* stream) {
  if (D < 1 || D > kMaxDim || K < 1 || K > kMaxComp) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_stats_smem_bytes(kEstep, D, K);
  err = set_smem(gmm_estep_full_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n = K * (D * (D + 1) / 2 + D + 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blk > 0) {
    gmm_estep_full_kernel<<<n_blk, kThreads, smem, st>>>(x, mask, w, llh, part, T, D, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, n_blk, n);
  return cudaGetLastError();
}

int beer_ellh_full(int device, const float* x, const float* w, float* out, int T, int D, int K, void* stream) {
  if (D < 1 || D > kMaxDim || K < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_stats_smem_bytes(kEllh, D, K);
  err = set_smem(ellh_full_kernel, smem);
  if (err != cudaSuccess) return err;
  if (T == 0) return cudaSuccess;
  const dim3 grid((T + kTile - 1) / kTile, (K + kKc - 1) / kKc);
  ellh_full_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, w, out, T, D, K);
  return cudaGetLastError();
}

// out (K·L) = Σ over the n_blk partials part (n_blk, K·L).
int beer_accumulate_full(int device, const float* x, const float* r, float* part, float* out, int n_blk, int T,
                         int D, int K, void* stream) {
  if (D < 1 || D > kMaxDim || K < 1 || K > kMaxComp) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = beer_stats_smem_bytes(kAcc, D, K);
  err = set_smem(accumulate_full_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n = K * (D * (D + 1) / 2 + D + 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blk > 0) {
    accumulate_full_kernel<<<n_blk, kThreads, smem, st>>>(x, r, part, T, D, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, n_blk, n);
  return cudaGetLastError();
}

}  // extern "C"
