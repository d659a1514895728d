// Blocked Cholesky of a batched SPD matrix for NVIDIA Hopper (sm_90a):
//
//     L[d] L[d]^T = A[d],   A of shape (D, N, N), f32, N a multiple of 128
//
// in place: on entry the buffer holds the lower triangle of A (anything
// above the diagonal is never read), on exit the lower factor, with zeros
// above the diagonal of every diagonal block.
//
// Replaces the TPU kernel gumbi_tpu/ops/pallas_chol.py `pallas_cholesky`
// (`_chol_kernel` with `_factor_block`, `_micro_chol`, `_micro_tri_inv`).
// What carries over is WHAT it computes: the right-looking blocked
// factorization, the diagonal block factored by a sequential column sweep
// and inverted, the column strips formed as L_ik = A_ik W_k^T with
// W_k = L_kk^-1, and the trailing update A_ij -= L_ik L_jk^T. Every product
// is this file's own FP32 FMA code (no TF32, no library call). The TPU
// kernel walks all panels of one matrix on one core with the panel in
// VMEM; here a host loop makes three launches per 128-wide panel, on one
// stream and with no synchronisation, and the panel stays in L2 (8 MB at
// N = 16,384):
//   * chol_diag_kernel, one CTA per matrix: the 128 x 128 diagonal block in
//     shared memory, 128 column steps of two __syncthreads() each, then its
//     triangular inverse, eight lanes per column;
//   * chol_strip_kernel, one CTA per (matrix, 128-row tile below): the
//     tile times W_k^T, written over the tile;
//   * chol_trail_kernel, one CTA per (matrix, lower 128 x 128 tile of the
//     trailing matrix): the tile minus L_ik L_jk^T.
// Each output tile has one writer and a fixed summation order, so the
// result is deterministic; there are no atomics. A pivot that is not
// positive gives NaN from its column on (sqrtf of a negative number), as
// on the TPU; nothing raises and no loop waits on data.
//
// Bound: operations. The function does D N^3 / 3 flops on 8 D N^2 bytes
// (1.47 TFLOP on 2.1 GB at N = 16,384: 21.9 ms at the H100's 67 TFLOP/s
// FP32 peak against 0.64 ms of memory time). Nearly all of them are in the
// trailing update, a 128 x 128 x 128 product per tile: each thread keeps an
// 8 x 8 block of the tile in registers, operands go through shared memory
// 16 columns at a time, and the next 16 are fetched into registers while
// the current ones are multiplied. Each tile's 128 products are summed from
// zero and then subtracted from the tile, so a long update rounds once per
// panel, not once per term. __launch_bounds__(256, 2) holds the product
// kernels to 128 registers so that two CTAs share an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NB = 128;        // panel width and tile edge
constexpr int NT = 256;        // threads per CTA of the strip and trailing kernels
constexpr int NTD = 1024;      // threads of the diagonal kernel's one CTA per matrix
constexpr int LDD = NB + 1;    // row stride of the diagonal block in shared memory
constexpr int BK = 16;         // operand columns staged per pass of the tile product
constexpr int LDT = NB + 4;    // row stride of a staged operand (keeps float4 alignment)
constexpr int DIAG_SMEM = (2 * NB * LDD + NB) * (int)sizeof(float);

// Factor the diagonal block of panel k and invert the factor:
// L[kk] <- chol(A[kk]) (zeros above the diagonal), Winv[d] <- L[kk]^-1.
__global__ void __launch_bounds__(NTD)
chol_diag_kernel(float* __restrict__ L, float* __restrict__ Winv, int64_t n, int k) {
  extern __shared__ float smem[];
  float* S = smem;             // [NB][LDD] the block, then its factor
  float* W = S + NB * LDD;     // [NB][LDD] the factor's inverse
  float* dsum = W + NB * LDD;  // [NB] sum of squares of the row's finished entries
  const int tid = threadIdx.x;
  float* blk = L + (int64_t)blockIdx.x * n * n + (int64_t)k * NB * n + (int64_t)k * NB;

  for (int idx = tid; idx < NB * NB; idx += NTD) {
    const int r = idx / NB, c = idx % NB;
    S[r * LDD + c] = (c <= r) ? blk[(int64_t)r * n + c] : 0.0f;
  }
  if (tid < NB) dsum[tid] = 0.0f;
  __syncthreads();

  // Right-looking column sweep. Warp ty takes rows j+1+ty, j+33+ty, ...; its
  // lanes take the row's columns below the diagonal. A diagonal entry is
  // not updated in place: its subtrahend sum_t l_it^2 is summed from zero in
  // dsum[i] and leaves at the pivot, so the pivot rounds once at the
  // entry's magnitude and not once per column.
  const int tx = tid % 32, ty = tid / 32;
  for (int j = 0; j < NB; ++j) {
    const float piv = sqrtf(S[j * LDD + j] - dsum[j]);
    if (tid > j && tid < NB) {
      const float l = S[tid * LDD + j] / piv;
      S[tid * LDD + j] = l;
      dsum[tid] = fmaf(l, l, dsum[tid]);
    }
    __syncthreads();
    for (int i = j + 1 + ty; i < NB; i += NTD / 32) {
      const float lij = S[i * LDD + j];
#pragma unroll
      for (int q = 0; q < NB / 32; ++q) {
        const int c = tx + 32 * q;
        if (c > j && c < i) S[i * LDD + c] = fmaf(-lij, S[c * LDD + j], S[i * LDD + c]);
      }
    }
    if (tid == 0) S[j * LDD + j] = piv;  // nobody reads S[j][j] after the barrier above
    __syncthreads();
  }

  // W = S^-1 by forward substitution down each column: eight lanes share
  // column c = tid / 8, split the row's dot product and add the parts up in
  // a fixed order; the warp's four columns advance row by row together.
  {
    const int c = tid / 8, l8 = tid % 8;
    for (int i = 0; i < NB; ++i) {
      float s = 0.0f;
      for (int t = c + l8; t < i; t += 8) s = fmaf(S[i * LDD + t], W[t * LDD + c], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (l8 == 0)
        W[i * LDD + c] = (i < c) ? 0.0f : (i == c ? 1.0f / S[c * LDD + c] : -s / S[i * LDD + i]);
      __syncwarp();
    }
  }
  __syncthreads();

  float* wout = Winv + (int64_t)blockIdx.x * NB * NB;
  for (int idx = tid; idx < NB * NB; idx += NTD) {
    const int r = idx / NB, c = idx % NB;
    blk[(int64_t)r * n + c] = S[r * LDD + c];
    wout[idx] = W[r * LDD + c];
  }
}

struct Stage {
  float4 x[2], y[2];
};

// Rows [0, NB) and columns [k0, k0 + BK) of X and Y into registers: 512
// float4 per operand, two per thread, four threads along a row's 64 bytes.
__device__ __forceinline__ void fetch(Stage& st, const float* X, int64_t ldx, const float* Y,
                                      int64_t ldy, int k0) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = threadIdx.x + q * NT;
    const int row = idx / 4, kq = idx % 4;
    st.x[q] = *reinterpret_cast<const float4*>(X + (int64_t)row * ldx + k0 + 4 * kq);
    st.y[q] = *reinterpret_cast<const float4*>(Y + (int64_t)row * ldy + k0 + 4 * kq);
  }
}

__device__ __forceinline__ void stash(const Stage& st, float (*Xs)[LDT], float (*Ys)[LDT]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = threadIdx.x + q * NT;
    const int row = idx / 4, kq = idx % 4;
    Xs[4 * kq + 0][row] = st.x[q].x;
    Xs[4 * kq + 1][row] = st.x[q].y;
    Xs[4 * kq + 2][row] = st.x[q].z;
    Xs[4 * kq + 3][row] = st.x[q].w;
    Ys[4 * kq + 0][row] = st.y[q].x;
    Ys[4 * kq + 1][row] = st.y[q].y;
    Ys[4 * kq + 2][row] = st.y[q].z;
    Ys[4 * kq + 3][row] = st.y[q].w;
  }
}

// acc[e][f] = sum_{t < NB} X[row(e)][t] * Y[col(f)][t] for row-major X and Y
// (leading dimensions ldx, ldy). Thread (ty, tx) = (tid / 16, tid % 16) owns
// rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, and the same pattern of columns
// from tx: every shared-memory read is one aligned float4 and a warp's 16
// column reads are contiguous.
__device__ __forceinline__ void tile_product(float (&acc)[8][8], const float* X, int64_t ldx,
                                             const float* Y, int64_t ldy, float (*Xs)[LDT],
                                             float (*Ys)[LDT]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int f = 0; f < 8; ++f) acc[e][f] = 0.0f;
  Stage st;
  fetch(st, X, ldx, Y, ldy, 0);
  for (int k0 = 0; k0 < NB; k0 += BK) {
    stash(st, Xs, Ys);
    __syncthreads();
    if (k0 + BK < NB) fetch(st, X, ldx, Y, ldy, k0 + BK);
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[t][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Xs[t][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ys[t][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ys[t][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int f = 0; f < 8; ++f) acc[e][f] = fmaf(a[e], b[f], acc[e][f]);
    }
    __syncthreads();
  }
}

// Row of the tile that accumulator row e of this thread holds.
__device__ __forceinline__ int tile_row(int e) {
  const int ty = threadIdx.x / 16;
  return (e < 4 ? 0 : 60) + 4 * ty + e;
}

// Column strip of panel k: L[ik] <- A[ik] W_k^T for row tile i = blockIdx.x
// below the diagonal block. The CTA reads all of its tile before it writes.
__global__ void __launch_bounds__(NT, 2)
chol_strip_kernel(float* L, const float* Winv, int64_t n, int k) {
  __shared__ __align__(16) float Xs[BK][LDT];
  __shared__ __align__(16) float Ys[BK][LDT];
  float* base = L + (int64_t)blockIdx.y * n * n;
  float* tile = base + ((int64_t)(k + 1 + blockIdx.x) * NB) * n + (int64_t)k * NB;
  const float* W = Winv + (int64_t)blockIdx.y * NB * NB;
  float acc[8][8];
  tile_product(acc, tile, n, W, NB, Xs, Ys);
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float* row = tile + (int64_t)tile_row(e) * n;
    *reinterpret_cast<float4*>(row + 4 * tx) = make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) = make_float4(acc[e][4], acc[e][5], acc[e][6], acc[e][7]);
  }
}

// Trailing update of panel k: A[ij] -= L[ik] L[jk]^T for the lower tiles
// (i >= j) of the trailing matrix; blockIdx.x = i (i + 1) / 2 + j.
__global__ void __launch_bounds__(NT, 2)
chol_trail_kernel(float* L, int64_t n, int k) {
  __shared__ __align__(16) float Xs[BK][LDT];
  __shared__ __align__(16) float Ys[BK][LDT];
  const int t = blockIdx.x;
  int i = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  const int j = t - i * (i + 1) / 2;
  float* base = L + (int64_t)blockIdx.y * n * n;
  const int64_t r0 = (int64_t)(k + 1 + i) * NB, c0 = (int64_t)(k + 1 + j) * NB, p0 = (int64_t)k * NB;
  float acc[8][8];
  tile_product(acc, base + r0 * n + p0, n, base + c0 * n + p0, n, Xs, Ys);
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float* row = base + (r0 + tile_row(e)) * n + c0;
    float4 lo = *reinterpret_cast<float4*>(row + 4 * tx);
    float4 hi = *reinterpret_cast<float4*>(row + 64 + 4 * tx);
    lo.x -= acc[e][0]; lo.y -= acc[e][1]; lo.z -= acc[e][2]; lo.w -= acc[e][3];
    hi.x -= acc[e][4]; hi.y -= acc[e][5]; hi.z -= acc[e][6]; hi.w -= acc[e][7];
    *reinterpret_cast<float4*>(row + 4 * tx) = lo;
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) = hi;
  }
}

}  // namespace

// Panel width, for the caller's scratch (D, NB, NB) and its shape check.
extern "C" int blocked_chol_panel() { return NB; }

// Plain C entry point for ctypes. `L` (D, N, N) holds the lower triangle of
// A and receives the factor; `winv` is a (D, NB, NB) scratch. All launches
// go on `stream` (PyTorch's current stream) in order, with no
// synchronisation. Returns the first CUDA error of any launch (0 = success).
extern "C" int blocked_chol_f32(float* L, float* winv, long long D, long long N, void* stream) {
  if (D <= 0 || N <= 0 || N % NB != 0 || D > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(chol_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DIAG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nb = (int)(N / NB);
  for (int k = 0; k < nb; ++k) {
    chol_diag_kernel<<<(unsigned)D, NTD, DIAG_SMEM, s>>>(L, winv, N, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int m = nb - 1 - k;  // row tiles below the diagonal block
    if (m == 0) break;
    chol_strip_kernel<<<dim3((unsigned)m, (unsigned)D), NT, 0, s>>>(L, winv, N, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    chol_trail_kernel<<<dim3((unsigned)(m * (m + 1) / 2), (unsigned)D), NT, 0, s>>>(L, N, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
