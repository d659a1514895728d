// Fused RBF Gram for NVIDIA Hopper (sm_90a):
//
//     K[i, j] = eta2 * expf(-0.5 * sum_k (a[i, k] - b[j, k])^2)
//
// with a = x1 / ls and b = x2 / ls pre-scaled by the caller.
//
// Replaces the TPU kernel gumbi_tpu/ops/pallas_kernels.py
// `_rbf_gram_fwd_impl` / `_rbf_kernel_body` (the pallas_call that fills
// 512x512 or 256x256 tiles in VMEM). What carries over is WHAT it computes:
// exact f32 elementwise squared distances (no matmul identity, no bf16, no
// TF32), one exponential per entry, and K written to device memory once.
//
// Bound: the output. K is n*m*4 bytes (204.8 MB at 5120 x 10000, 104.9 MB
// at 5120 x 5120) against a few hundred KB of inputs, and each entry costs
// 3*d flops plus one expf, so the kernel is memory-bound at the H100's
// 3.35 TB/s (>= 61 us at 5120 x 10000). The design therefore aims at full
// store bandwidth and nothing else:
//   * one block computes a BM x BN = 64 x 128 output tile with 256 threads,
//     32 entries per thread held in registers;
//   * the tile's rows of a and b are staged in shared memory DC coordinates
//     at a time, so any runtime d works with a fixed 12 KB of shared memory;
//   * thread x walks columns, so each warp store is 32 consecutive floats
//     (128 bytes, coalesced) of one row-major output row;
//   * the ragged edge is masked at the store; output offsets are int64
//     (n*m reaches 5.1e7 on the bench path and more at larger N);
//   * eta2 is read from device memory, so the host never syncs to read it.
// The distance sum uses __fmul_rn/__fadd_rn (no FMA contraction), in the
// same order as the plain torch version, and expf is the accurate one (no
// --use_fast_math), so the two agree to a few f32 ulps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // output rows per block
constexpr int BN = 128;   // output columns per block
constexpr int TX = 32;    // threads along columns
constexpr int TY = 8;     // threads along rows
constexpr int RM = BM / TY;  // rows per thread
constexpr int RN = BN / TX;  // columns per thread
constexpr int DC = 16;    // coordinates staged per pass

__global__ void __launch_bounds__(TX * TY)
rbf_gram_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ eta2, float* __restrict__ out,
                int64_t n, int64_t m, int d) {
  __shared__ float sa[DC][BM];
  __shared__ float sb[DC][BN];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += DC) {
    const int kc = min(DC, d - k0);
    // Stage a[row0:row0+BM, k0:k0+kc] and b[col0:col0+BN, k0:k0+kc],
    // transposed so the inner loop reads one coordinate across rows.
    for (int idx = tid; idx < BM * DC; idx += TX * TY) {
      const int r = idx / DC, k = idx % DC;
      const int64_t gi = row0 + r;
      sa[k][r] = (k < kc && gi < n) ? a[gi * d + k0 + k] : 0.0f;
    }
    for (int idx = tid; idx < BN * DC; idx += TX * TY) {
      const int c = idx / DC, k = idx % DC;
      const int64_t gj = col0 + c;
      sb[k][c] = (k < kc && gj < m) ? b[gj * d + k0 + k] : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      float av[RM], bv[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) av[r] = sa[k][ty + r * TY];
#pragma unroll
      for (int c = 0; c < RN; ++c) bv[c] = sb[k][tx + c * TX];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          const float diff = av[r] - bv[c];
          acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(diff, diff));
        }
    }
    __syncthreads();
  }

  const float e2 = *eta2;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int64_t i = row0 + ty + r * TY;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int64_t j = col0 + tx + c * TX;
      if (j < m) out[i * m + j] = e2 * expf(-0.5f * acc[r][c]);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers; the
// launch goes on `stream` (PyTorch's current stream) and does not
// synchronise. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int rbf_gram_f32(const float* a, const float* b, const float* eta2,
                            float* out, long long n, long long m, int d,
                            void* stream) {
  if (n <= 0 || m <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long gy = (n + BM - 1) / BM;
  const long long gx = (m + BN - 1) / BN;
  if (gy > 65535 || gx > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)gx, (unsigned)gy);
  dim3 block(TX, TY);
  rbf_gram_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a, b, eta2, out, n, m, d);
  return (int)cudaGetLastError();
}
