// The diagonal NormalSet's frame statistics [−½x², x] for Hopper (sm_90a),
// with a plain C interface loaded through ctypes by
// beer_tpu_torch/ops/stats_kernels.py (diag_stats).
//
// It replaces no Pallas kernel: the JAX package leaves the statistics
// (beer_tpu/models/normal.py NormalSet.sufficient_statistics,
// jnp.concatenate([-0.5 * data**2, data])) to XLA.  It was added because
// PyTorch computed them in three device operations, a square, a scale and
// a torch.cat, ~8.3 ms of every VB step and decode at the benchmark's
// shape (8,192,000 frames of D = 39): two 1.28 GB temporaries written and
// read back, and a concatenation writing each 39-float half into a
// 78-float row at 0.78 TB/s.
//
// Bound: bytes.  It reads N·D floats and writes 2·N·D, with two products
// a float: 3.83 GB at that shape, 1.14 ms at 3.35 TB/s.  The design only
// has to keep the memory busy with whole transactions, in one pass:
//   * a persistent grid, kDiagBlocksPerSm blocks an SM, walks tiles of
//     whole rows, so that a tile's frames are one contiguous run and its
//     statistics another;
//   * a tile holds the most rows within kDiagTileFloats floats, cut to a
//     multiple of 16 / gcd(D, 16) where that leaves any, so that every
//     tile's statistics start on a 128-byte line and each warp's store is
//     one whole line.  Tiles that start inside a 32-byte sector, whose
//     sectors two blocks write in parts, took 1.64–1.74 ms at the shape
//     above, sector-aligned ones 1.47 ms, line-aligned ones 1.38 ms (one
//     H100 80GB HBM3 at 700 W, CUDA-event medians);
//   * the frames arrive in shared memory by plain 16-byte loads; cp.async,
//     with or without a second buffer to keep a block's next tile in
//     flight, took 1.41 ms: the SM's other blocks hide the wait;
//   * float e of a tile's statistics lies in row e / 2D, column e % 2D;
//     each thread steps its (row, column) by a constant as e grows by the
//     block's threads, so no thread divides after its first float.
// There a device-to-device copy of as many bytes takes 1.27 ms, and a
// kernel that reads N·D floats and writes each twice, in 16-byte runs
// with no layout, 1.38 ms: the memory's rate for this mix of reads and
// writes, which this kernel reaches to within 1 %.
// Arithmetic: −½x² is fl(−0.5·fl(x·x)) by __fmul_rn (nothing to contract),
// the bits of PyTorch's square then scale, so every consumer reads the
// bytes the plain expression gives.  The same kernel takes float64 frames
// (the general route runs float64 models on the card), by __dmul_rn, with
// its tiles, segments and lines counted in bytes as above.  Limit: 1 <= D
// <= kDiagMaxDim (a tile of one row in 32 KB of shared memory at most);
// the wrapper raises above it.

#include "scan_common.cuh"

namespace {

constexpr int kDiagThreads = 256;
constexpr int kDiagBlocksPerSm = 8;      // 2,048 threads an SM
constexpr int kDiagTileBytes = 12288;    // a tile's frames: 12 KB at most (3,072 floats)
constexpr int kDiagMaxDim = 4096;

__device__ inline float neg_half_square(float v) { return __fmul_rn(-0.5f, __fmul_rn(v, v)); }
__device__ inline double neg_half_square(double v) { return __dmul_rn(-0.5, __dmul_rn(v, v)); }

// The rows of a tile: the most within kDiagTileBytes, cut so that its
// statistics (2·rows·D values) start on a 128-byte line (rows·D a multiple
// of 64 bytes' values), else on a 32-byte sector, where that leaves any.
template <typename T>
__host__ __device__ inline int diag_tile_rows(int D) {
  constexpr int tile = kDiagTileBytes / sizeof(T), line = 64 / sizeof(T), sector = 16 / sizeof(T);
  const int rows = D >= tile ? 1 : tile / D;
  const int low = D & -D;                            // the largest power of two dividing D
  const int l = line / (low < line ? low : line), s = sector / (low < sector ? low : sector);
  if (rows >= l) return rows - rows % l;
  return rows >= s ? rows - rows % s : rows;
}

// Shared memory of a block: a tile of n values that starts h <= seg − 1
// values into a 16-byte segment of seg values spans (h + n + seg − 1) / seg
// <= (n + 2·seg − 2) / seg segments.
template <typename T>
inline size_t diag_smem_bytes(int D) {
  constexpr int seg = 16 / sizeof(T);
  return (static_cast<size_t>(diag_tile_rows<T>(D)) * D + 2 * seg - 2) / seg * sizeof(float4);
}

template <typename T>
__global__ void __launch_bounds__(kDiagThreads, kDiagBlocksPerSm)
diag_stats_kernel(const T* __restrict__ x, T* __restrict__ out, size_t n_rows, int D) {
  constexpr int kSeg = 16 / sizeof(T);   // values a 16-byte segment
  extern __shared__ float4 seg[];
  const int rows = diag_tile_rows<T>(D), w = 2 * D;
  // the (row, column) of a thread's first value of a tile's statistics,
  // and the step from one of its values to the next
  const int r0 = threadIdx.x / w, c0 = threadIdx.x % w;
  const int dr = kDiagThreads / w, dc = kDiagThreads % w;
  const size_t n = n_rows * D, n_tiles = (n_rows + rows - 1) / rows;
  auto tile_values = [&](size_t t) {
    const size_t left = n_rows - t * rows;
    return (left < static_cast<size_t>(rows) ? static_cast<int>(left) : rows) * D;
  };
  for (size_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // the tile's frames, from the 16-byte segment that holds its first
    // value: every whole segment of the tensor by one 16-byte load, the
    // tensor's last segment, where partial, value by value
    const size_t a = t * rows * D, a4 = a & ~static_cast<size_t>(kSeg - 1);
    const int n_in = tile_values(t);
    for (int j = threadIdx.x; kSeg * j < static_cast<int>(a - a4) + n_in; j += kDiagThreads) {
      const size_t i = a4 + kSeg * static_cast<size_t>(j);
      if (i + kSeg <= n) {
        seg[j] = __ldg(reinterpret_cast<const float4*>(x + i));
      } else {
        T* d = reinterpret_cast<T*>(seg + j);
        for (int q = 0; q < kSeg; ++q) d[q] = i + q < n ? x[i + q] : T(0);
      }
    }
    __syncthreads();
    const int n_out = 2 * n_in;
    const T* tile = reinterpret_cast<const T*>(seg) + (a - a4);
    T* dst = out + 2 * a;
    int r = r0, c = c0;
    for (int e = threadIdx.x; e < n_out; e += kDiagThreads) {
      const T v = tile[r * D + (c < D ? c : c - D)];
      dst[e] = c < D ? neg_half_square(v) : v;
      r += dr;
      c += dc;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
    __syncthreads();   // before the next tile's frames overwrite this one's
  }
}

template <typename T>
int launch_diag_stats(const void* x, void* out, size_t n_rows, int D, int n_sm, cudaStream_t stream) {
  const size_t n_tiles = (n_rows + diag_tile_rows<T>(D) - 1) / diag_tile_rows<T>(D);
  const size_t most = static_cast<size_t>(n_sm) * kDiagBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(n_tiles < most ? n_tiles : most);
  diag_stats_kernel<T><<<grid, kDiagThreads, diag_smem_bytes<T>(D), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n_rows, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (N, 2D) = [−½x², x] of x (N, D), both contiguous and 16-byte
// aligned, float32 (f64 = 0) or float64 (f64 = 1); the grid is
// kDiagBlocksPerSm blocks on each of n_sm SMs (fewer when there are fewer
// tiles).  0 or a CUDA error.
int beer_diag_stats(int device, const void* x, void* out, size_t n_rows, int D, int f64, int n_sm,
                    void* stream) {
  if (D < 1 || D > kDiagMaxDim || n_sm < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n_rows == 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_diag_stats<double>(x, out, n_rows, D, n_sm, s)
             : launch_diag_stats<float>(x, out, n_rows, D, n_sm, s);
}

}  // extern "C"
