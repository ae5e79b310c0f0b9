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
