// Helpers shared by the scan kernels of phone_loop_scan.cu and hmm_scan.cu:
// block-wide reductions that broadcast their result to every thread, the
// launch geometry (one block per utterance, threads over states), and the
// fixed-order batch sum of per-utterance partials.  Each .cu file is its own
// translation unit; everything here lives in an anonymous namespace.

#pragma once

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

// Block reduction of (sum a, sum b): every thread gets both results.
// The leading barrier keeps `scratch` from being overwritten while the
// previous reduction is still being read, and orders shared-memory
// writes made before the call ahead of any read after it.
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

// cp.async of 4 bytes, zero-filled when !valid (src is then not read):
// a chunk of frames arrives in shared memory while the previous one is
// worked on.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// The offset of g's byte in its 16-byte segment, and so in a buffer that
// cp_async_run filled from g.
__device__ __forceinline__ int run_head(const void* g) { return static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15); }

// cp.async of the n bytes at g, one contiguous run, into dst (16-byte
// aligned) in whole 16-byte segments from the one that holds g, the
// threads tid of nt each taking segments; a segment across the first or
// last byte of the tensor [lo, hi) is copied byte by byte (visible after the
// caller's barrier).  Returns run_head(g); the caller commits.
__device__ __forceinline__ int cp_async_run(void* dst, const void* g, size_t n, const void* lo, const void* hi,
                                            int tid, int nt) {
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g) & ~static_cast<uintptr_t>(15);
  const uintptr_t ulo = reinterpret_cast<uintptr_t>(lo), uhi = reinterpret_cast<uintptr_t>(hi);
  const int head = run_head(g);
  uint8_t* d = static_cast<uint8_t*>(dst);
  const size_t n_seg = (head + n + 15) >> 4;
  for (size_t j = tid; j < n_seg; j += nt) {
    const uintptr_t src = ga + 16 * j;
    if (src >= ulo && src + 16 <= uhi) {
      const unsigned sd = static_cast<unsigned>(__cvta_generic_to_shared(d + 16 * j));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sd), "l"(src));
    } else {
      for (int q = 0; q < 16; ++q)
        if (src + q >= ulo && src + q < uhi) d[16 * j + q] = *reinterpret_cast<const uint8_t*>(src + q);
    }
  }
  return head;
}
// all but the newest group (more) or every group (!more) have landed
__device__ __forceinline__ void cp_async_wait(bool more) {
  if (more)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// Shared-memory row strides: odd, so that threads walking a column of
// a row-major array (one row each) hit distinct banks.
__host__ __device__ inline int odd_stride(int n) { return n | 1; }

inline int threads_for(int s) {
  int t = ((s + 31) / 32) * 32;
  return t > 1024 ? 1024 : t;
}

// Threads of a kernel that walks S states in strided loops: threads_for(S),
// capped at what the kernel can launch with.  A kernel that holds many
// registers per thread cannot launch 1024 threads (111 registers × 1024
// exceeds the SM's 65,536), and such a launch is refused.
template <typename Kernel>
int block_threads(Kernel kernel, int s) {
  cudaFuncAttributes attr;
  int cap = 1024;
  if (cudaFuncGetAttributes(&attr, kernel) == cudaSuccess) cap = attr.maxThreadsPerBlock / 32 * 32;
  const int t = threads_for(s);
  return t < cap ? t : cap;
}

// Column sums of a (B, N) row-major array in a fixed order (f64 accumulator).
__global__ void sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int B, int N) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N) return;
  double acc = 0.0;
  for (int b = 0; b < B; ++b) acc += part[static_cast<size_t>(b) * N + k];
  out[k] = static_cast<float>(acc);
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

}  // namespace
