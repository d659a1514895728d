// Fused RBF Gram for NVIDIA Hopper (sm_90a):
//
//     K[i, j] = eta^2 * expf(-0.5 * sum_k (x1[i, k] / ls[k] - x2[j, k] / ls[k])^2)
//
// Replaces the TPU kernel gumbi_tpu/ops/pallas_kernels.py
// `_rbf_gram_fwd_impl` / `_rbf_kernel_body` (the pallas_call that fills
// 512x512 or 256x256 tiles in VMEM). What carries over is WHAT it computes:
// exact f32 elementwise squared distances (no matmul identity, no bf16, no
// TF32), one exponential per entry, and K written to device memory once.
//
// One launch per call: the kernel reads x1, x2, ls (1 or d entries, any
// stride) and eta from device memory, divides by ls while it stages the
// coordinates and squares eta itself, so the wrapper does no arithmetic.
// The numbers are the plain torch version's, operation for operation:
// a = x1 / ls and b = x2 / ls as IEEE divisions (__fdiv_rn), the squared
// differences summed in coordinate order with __fmul_rn/__fadd_rn (no FMA
// contraction), the accurate expf (no --use_fast_math) and eta * eta.
//
// Bound: the output. K is n*m*4 bytes (204.8 MB at 5120 x 10000, 1.07 GB at
// 16384^2) against a few hundred KB of inputs, and each entry costs 3*d + 2
// flops and one expf, so the large shapes are store-bound at the H100's
// 3.35 TB/s (>= 61 us at 5120 x 10000). The design aims at the store path:
//   * a persistent grid of at most 264 CTAs (two per SM on 132 SMs); CTA c
//     walks the contiguous run of tiles [c*T/C, (c+1)*T/C) in row-major
//     tile order, so the tail is one tile and staged x1 rows serve every
//     column tile of their row block that the CTA meets;
//   * each thread holds four consecutive columns of up to eight rows and
//     stores each row's four values as one 16-byte streaming store
//     (st.global.cs: K is larger than the 50 MB L2 and written once), from
//     a row address computed once per tile; a warp writes 512 contiguous
//     bytes of one row per store;
//   * m not a multiple of four (rows not 16-byte aligned) takes a scalar
//     epilogue of the same kernel: four 4-byte streaming stores;
//   * two configurations of the same kernel (rbf_config, mirrored by
//     hopper_kernels.rbf_tile_config): 32 x 256 tiles (4 x 2 warps, eight
//     rows a thread) and, for n <= 8 (the pivoted Cholesky's (1, N) rows),
//     a row strip of n x 1024 tiles (eight warps along the columns, every
//     row of x1 in each thread), so no CTA computes masked rows;
//   * the coordinates are staged in shared memory DC at a time, so any
//     runtime d works with a fixed amount of shared memory.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace rbf {

constexpr int THREADS = 256;         // eight warps
constexpr int VEC = 4;               // consecutive columns a thread: one 16-byte store
constexpr int WARP_COLS = 32 * VEC;  // columns a warp covers
constexpr int RPT = 8;               // rows a thread holds (at most, in the strip)
constexpr int DC = 8;                // coordinates staged per pass
constexpr int TARGET_CTAS = 264;     // two CTAs per SM on 132 SMs
constexpr int STRIP_MAX_ROWS = 8;    // n at or below this takes the row strip

template <bool STRIP>
struct Shape {
  static constexpr int WARPS_C = STRIP ? 8 : 2;                      // warps along the columns
  static constexpr int ROWS = STRIP ? STRIP_MAX_ROWS : (8 / WARPS_C) * RPT;  // 8 : 32
  static constexpr int COLS = WARPS_C * WARP_COLS;                   // 1024 : 256
};

template <bool STRIP>
struct Staged {
  float a[DC][Shape<STRIP>::ROWS];            // x1 / ls, coordinate-major
  float4 b[DC][Shape<STRIP>::COLS / VEC];     // x2 / ls, four columns a float4
};

struct Config {
  long long strip, tile_rows, tile_cols, tiles, ctas;
};

// The launch configuration: a pure function of (n, m, d); all zero for an
// empty or invalid call. d does not change the tiling (it only sets the
// number of staging passes).
inline Config config(long long n, long long m, int d) {
  Config c{0, 0, 0, 0, 0};
  if (n <= 0 || m <= 0 || d <= 0) return c;
  c.strip = n <= STRIP_MAX_ROWS;
  c.tile_rows = c.strip ? n : Shape<false>::ROWS;
  c.tile_cols = c.strip ? Shape<true>::COLS : Shape<false>::COLS;
  c.tiles = ((n + c.tile_rows - 1) / c.tile_rows) * ((m + c.tile_cols - 1) / c.tile_cols);
  c.ctas = c.tiles < TARGET_CTAS ? c.tiles : TARGET_CTAS;
  return c;
}

// acc[r][c] = sum_k (a[row0 + trow + r, k] - b[col0 + tcol + c, k])^2 for
// this thread's rows below `rows` (the tile's rows that exist), in
// coordinate order. Stages a only when `same_rows` is false or d needs
// several passes. Every thread of the block must call it (it synchronises).
template <bool STRIP>
__device__ __forceinline__ void tile_sums(Staged<STRIP>& s, float (&acc)[RPT][VEC],
                                          const float* __restrict__ x1, const float* __restrict__ x2,
                                          const float* __restrict__ ls, long long ls_stride, int m, int d,
                                          long long row0, int rows, long long col0, bool same_rows,
                                          int trow, int tcol) {
  using S = Shape<STRIP>;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[r][c] = 0.0f;
  float* sb = &s.b[0][0].x;
  for (int k0 = 0; k0 < d; k0 += DC) {
    const int kc = min(DC, d - k0);
    __syncthreads();  // every thread is done reading the previous pass
    if (!same_rows || d > DC) {
      for (int r = threadIdx.x; r < S::ROWS; r += THREADS)
        for (int k = 0; k < kc; ++k)
          s.a[k][r] = r < rows ? __fdiv_rn(x1[(row0 + r) * d + k0 + k], ls[(k0 + k) * ls_stride]) : 0.0f;
    }
    for (int c = threadIdx.x; c < S::COLS; c += THREADS)
      for (int k = 0; k < kc; ++k)
        sb[k * S::COLS + c] = col0 + c < m ? __fdiv_rn(x2[(col0 + c) * d + k0 + k], ls[(k0 + k) * ls_stride])
                                           : 0.0f;
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float4 b4 = s.b[k][tcol / VEC];
      const float bv[VEC] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (trow + r >= rows) break;  // warp-uniform
        const float av = s.a[k][trow + r];
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const float diff = av - bv[c];
          acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(diff, diff));
        }
      }
    }
  }
}

template <bool STRIP>
__global__ void __launch_bounds__(THREADS, 2)
rbf_gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ ls,
                long long ls_stride, const float* __restrict__ eta, float* __restrict__ out, int n, int m, int d,
                int tile_rows, long long tiles_m, long long tiles) {
  using S = Shape<STRIP>;
  __shared__ Staged<STRIP> s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tcol = (warp % S::WARPS_C) * WARP_COLS + lane * VEC;
  const int trow = (warp / S::WARPS_C) * RPT;
  const float e2 = __fmul_rn(*eta, *eta);
  const bool vec = m % VEC == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;  // every row 16-byte aligned
  const long long first = tiles * blockIdx.x / gridDim.x, last = tiles * (blockIdx.x + 1) / gridDim.x;
  long long staged_rb = -1;
  for (long long t = first; t < last; ++t) {
    const long long rb = t / tiles_m;
    const long long row0 = rb * tile_rows, col0 = (t - rb * tiles_m) * S::COLS;
    const int rows = (int)min((long long)tile_rows, n - row0);
    float acc[RPT][VEC];
    tile_sums<STRIP>(s, acc, x1, x2, ls, ls_stride, m, d, row0, rows, col0, rb == staged_rb, trow, tcol);
    staged_rb = rb;
    const int j = (int)col0 + tcol;  // column of this thread's first value
    if (j >= m) continue;
    float* p = out + (row0 + trow) * (long long)m + j;
#pragma unroll
    for (int r = 0; r < RPT; ++r, p += m) {
      if (trow + r >= rows) break;
      float v[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) v[c] = e2 * expf(-0.5f * acc[r][c]);
      if (vec) {
        __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          if (j + c < m) __stcs(p + c, v[c]);
      }
    }
  }
}

}  // namespace rbf

// (strip, tile_rows, tile_cols, tiles, ctas) of the launch for an (n, m)
// output over d coordinates; hopper_kernels.rbf_tile_config mirrors it.
extern "C" void rbf_gram_config(long long n, long long m, int d, long long* out) {
  const rbf::Config c = rbf::config(n, m, d);
  out[0] = c.strip, out[1] = c.tile_rows, out[2] = c.tile_cols, out[3] = c.tiles, out[4] = c.ctas;
}

// Plain C entry point for ctypes. All pointers are device pointers (ls has
// 1 or d entries, `ls_stride` elements apart; eta one); x1 (n, d) and x2
// (m, d) are row-major and contiguous, out (n, m) row-major. The launch
// goes on `stream` (PyTorch's current stream) and does not synchronise.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int rbf_gram_f32(const float* x1, const float* x2, const float* ls, long long ls_stride,
                            const float* eta, float* out, long long n, long long m, int d, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || n > INT_MAX || m > INT_MAX) return (int)cudaErrorInvalidValue;
  const rbf::Config c = rbf::config(n, m, d);
  const long long tiles_m = (m + c.tile_cols - 1) / c.tile_cols;
  cudaStream_t s = (cudaStream_t)stream;
  if (c.strip)
    rbf::rbf_gram_kernel<true><<<(unsigned)c.ctas, rbf::THREADS, 0, s>>>(
        x1, x2, ls, ls_stride, eta, out, (int)n, (int)m, d, (int)c.tile_rows, tiles_m, c.tiles);
  else
    rbf::rbf_gram_kernel<false><<<(unsigned)c.ctas, rbf::THREADS, 0, s>>>(
        x1, x2, ls, ls_stride, eta, out, (int)n, (int)m, d, (int)c.tile_rows, tiles_m, c.tiles);
  return (int)cudaGetLastError();
}
