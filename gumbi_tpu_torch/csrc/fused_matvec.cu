// Fused stationary Gram-matvec for NVIDIA Hopper (sm_90a):
//
//     out = K(x1, x2) @ V,   K[i, j] = k(sum_c (a[i, c] - b[j, c])^2)
//
// with a = x1 / ls and b = x2 / ls pre-scaled by the caller and k one of the
// six unit-amplitude stationary kernels (the caller applies eta^2). K is
// never written to device memory.
//
// Replaces two TPU kernels of gumbi_tpu/ops/pallas_kernels.py:
//   * `fused_stationary_matvec` (`_fused_matvec_body`): general x1, x2;
//   * `fused_stationary_matvec_sym` (`_fused_matvec_sym_body`): the
//     self-Gram K(x, x) @ V, each unordered tile pair built once and used
//     twice (T @ V[j] into rows i, T^T @ V[i] into rows j).
// What carries over is WHAT they compute: exact f32 elementwise squared
// distances (no matmul identity), the stationary kernel on every entry, and
// the tile consumed against V at once. The TPU's 3-pass bf16 hi/lo MXU
// product becomes a plain FP32 FMA product (no TF32).
//
// Bound: operations. Per Gram entry the function does 3*d distance flops,
// one kernel evaluation and 2*r product flops; the inputs and the output
// are a few MB. At N = 50,000 and r = 65 that is 2*N^2*(d + r) = 3.4e11
// flops, >= 5 ms at the H100's 67 TFLOP/s FP32 (non-tensor) peak. The
// design is the plainest one that keeps K on chip:
//   * a CTA of 256 threads builds one 64 x 64 tile of K in shared memory
//     (16 entries a thread, coordinates staged 16 at a time, so any d
//     works), then multiplies it with 32-row slabs of V;
//   * each thread keeps a 4 x TN block of the output (TN = RC / 16, RC the
//     columns of V a CTA carries: 16, 32, 64, 80 or 128) in registers;
//     wider r runs as several column chunks, each rebuilding its tiles;
//   * ragged edges are masked (zero K entries, zero V rows); offsets are
//     int64; nothing is read back to the host.
// The distance sum uses __fmul_rn/__fadd_rn in coordinate order, as the
// plain torch version does, and expf/sqrtf are the accurate ones (no
// --use_fast_math), so K matches the plain version to a few ulps; only the
// order of the product's sums differs.
//
// The symmetric kernel is DETERMINISTIC. Tiles of the band grid are
// T = 1024 rows (SYM_T). CTA (i, band jj) owns the tile pair (i, j =
// (i + jj) mod nb) and writes T @ V[j] into its own slot scratch[0][jj][rows
// of i] and T^T @ V[i] into scratch[1][jj][rows of j]. For a fixed band
// i -> j is a permutation, so every slot has exactly one writer; a second
// kernel sums the slots over bands in a fixed order. For even nb the wrap
// band (jj = nb / 2) holds each pair twice, and only i < nb / 2 is active,
// as in the reference. The scratch is 2 * (nb / 2 + 1) * n * r floats; the
// caller's gate (`sym_matvec_fits`) keeps it under 1 GiB and sends larger
// requests to the general kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // K tile edge (rows and columns)
constexpr int NT = 256;       // threads per CTA
constexpr int DC = 16;        // coordinates staged per pass
constexpr int KC = 32;        // V rows per slab
constexpr int TM = 4;         // output rows per thread (16 thread rows)
constexpr int ENT = TILE * TILE / NT;  // K entries built per thread
constexpr int SYM_T = 1024;   // band-grid tile of the symmetric kernel

enum Kind { EXPQUAD = 0, MATERN12 = 1, EXPONENTIAL = 2, MATERN32 = 3, MATERN52 = 4 };

__device__ __forceinline__ float kfun(int kind, float r2) {
  if (kind == EXPQUAD) return expf(__fmul_rn(-0.5f, r2));
  const float r = sqrtf(__fadd_rn(r2, 1e-36f));
  switch (kind) {
    case MATERN12:
      return expf(-r);
    case EXPONENTIAL:
      return expf(__fmul_rn(-0.5f, r));
    case MATERN32: {
      const float c = __fmul_rn(1.7320508075688772f, r);
      return __fmul_rn(__fadd_rn(1.0f, c), expf(-c));
    }
    default: {  // MATERN52; torch on CUDA divides by a scalar via its reciprocal
      const float c = __fmul_rn(2.23606797749979f, r);
      const float p = __fadd_rn(__fadd_rn(1.0f, c), __fmul_rn(__fmul_rn(c, c), 1.0f / 3.0f));
      return __fmul_rn(p, expf(-c));
    }
  }
}

struct Smem {
  float a[DC][TILE];
  float b[DC][TILE];
  float k[TILE][TILE + 1];
};

// sK[r][c] = k(|a[ra0 + r] - b[rb0 + c]|^2) for r < na, c < nbc; 0 elsewhere.
__device__ void build_tile(Smem& s, const float* __restrict__ a, int64_t ra0, int na,
                           const float* __restrict__ b, int64_t rb0, int nbc, int d,
                           int kind) {
  const int tid = threadIdx.x;
  const int col = tid % TILE;
  const int row0 = tid / TILE;  // rows row0 + (NT / TILE) * e
  float sq[ENT];
#pragma unroll
  for (int e = 0; e < ENT; ++e) sq[e] = 0.0f;
  for (int k0 = 0; k0 < d; k0 += DC) {
    const int kc = min(DC, d - k0);
    for (int idx = tid; idx < TILE * DC; idx += NT) {
      const int r = idx / DC, k = idx % DC;
      s.a[k][r] = (k < kc && r < na) ? a[(ra0 + r) * d + k0 + k] : 0.0f;
      s.b[k][r] = (k < kc && r < nbc) ? b[(rb0 + r) * d + k0 + k] : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float bv = s.b[k][col];
#pragma unroll
      for (int e = 0; e < ENT; ++e) {
        const float diff = s.a[k][row0 + (NT / TILE) * e] - bv;
        sq[e] = __fadd_rn(sq[e], __fmul_rn(diff, diff));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < ENT; ++e) {
    const int r = row0 + (NT / TILE) * e;
    s.k[r][col] = (r < na && col < nbc) ? kfun(kind, sq[e]) : 0.0f;
  }
  __syncthreads();
}

// acc[q][c] += sum_t S[row(q)][t] * V[v0 + t][c0 + col(c)]   (TRANS: S[t][row])
// over the tile's TILE inner indices; V rows >= v0 + nv and columns >= r
// read as 0. Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 q and
// columns tx + 16 c.
template <int TN, bool TRANS>
__device__ void tile_product(float (&acc)[TM][TN], const Smem& s,
                             float (*sv)[16 * TN], const float* __restrict__ v,
                             int64_t v0, int nv, int64_t c0, int64_t r) {
  constexpr int RC = 16 * TN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // Two-level sum: the tile's 64 products go into `part`, which is then
  // added to `acc`, so a long row sums in O(64 + m / 64) steps, not O(m).
  float part[TM][TN];
#pragma unroll
  for (int q = 0; q < TM; ++q)
#pragma unroll
    for (int c = 0; c < TN; ++c) part[q][c] = 0.0f;
  for (int t0 = 0; t0 < TILE; t0 += KC) {
    for (int idx = tid; idx < KC * RC; idx += NT) {
      const int t = idx / RC, c = idx % RC;
      const int64_t gr = v0 + t0 + t, gc = c0 + c;
      sv[t][c] = (t0 + t < nv && gc < r) ? v[gr * r + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < KC; ++t) {
      float av[TM], bv[TN];
#pragma unroll
      for (int q = 0; q < TM; ++q)
        av[q] = TRANS ? s.k[t0 + t][ty + 16 * q] : s.k[ty + 16 * q][t0 + t];
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = sv[t][tx + 16 * c];
#pragma unroll
      for (int q = 0; q < TM; ++q)
#pragma unroll
        for (int c = 0; c < TN; ++c) part[q][c] = fmaf(av[q], bv[c], part[q][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < TM; ++q)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[q][c] += part[q][c];
}

template <int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int q = 0; q < TM; ++q)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[q][c] = 0.0f;
}

// General: CTA (blockIdx.x, blockIdx.y) owns rows [64 x, 64 x + 64) and
// columns [col_base + RC y, + RC) of out, and loops over all of x2.
template <int TN>
__global__ void __launch_bounds__(NT)
fused_matvec_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ v, float* __restrict__ out, int64_t n,
                    int64_t m, int64_t r, int d, int kind, int64_t col_base) {
  constexpr int RC = 16 * TN;
  __shared__ Smem s;
  __shared__ float sv[KC][RC];
  const int64_t i0 = (int64_t)blockIdx.x * TILE;
  const int64_t c0 = col_base + (int64_t)blockIdx.y * RC;
  const int ni = (int)min((int64_t)TILE, n - i0);
  float acc[TM][TN];
  zero(acc);
  for (int64_t j0 = 0; j0 < m; j0 += TILE) {
    const int nj = (int)min((int64_t)TILE, m - j0);
    build_tile(s, a, i0, ni, b, j0, nj, d, kind);
    tile_product<TN, false>(acc, s, sv, v, j0, nj, c0, r);
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int q = 0; q < TM; ++q) {
    const int64_t row = i0 + ty + 16 * q;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int64_t col = c0 + tx + 16 * c;
      if (col < r) out[row * r + col] = acc[q][c];
    }
  }
}

__device__ __forceinline__ bool band_active(int64_t jj, int64_t i, int64_t nb) {
  return (2 * jj < nb) || (nb % 2 == 1) || (2 * i < nb);
}

// Symmetric: CTA (i = blockIdx.x, jj = blockIdx.y, chunk = blockIdx.z).
template <int TN>
__global__ void __launch_bounds__(NT)
fused_matvec_sym_kernel(const float* __restrict__ a, const float* __restrict__ v,
                        float* __restrict__ slots, int64_t n, int64_t r, int d, int kind,
                        int64_t nb, int64_t n_bands, int64_t col_base) {
  constexpr int RC = 16 * TN;
  __shared__ Smem s;
  __shared__ float sv[KC][RC];
  const int64_t i = blockIdx.x, jj = blockIdx.y;
  if (!band_active(jj, i, nb)) return;  // uniform across the CTA
  const int64_t j = (i + jj) % nb;
  const int64_t c0 = col_base + (int64_t)blockIdx.z * RC;
  const int64_t ri0 = i * SYM_T, rj0 = j * SYM_T;
  const int ci = (int)min((int64_t)SYM_T, n - ri0);
  const int cj = (int)min((int64_t)SYM_T, n - rj0);
  float* s0 = slots + jj * n * r;              // slot 0 of band jj: rows of block i
  float* s1 = slots + (n_bands + jj) * n * r;  // slot 1 of band jj: rows of block j
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  for (int is = 0; is < ci; is += TILE) {
    const int ni = min(TILE, ci - is);
    float acc_i[TM][TN];
    zero(acc_i);
    for (int js = 0; js < cj; js += TILE) {
      const int nj = min(TILE, cj - js);
      build_tile(s, a, ri0 + is, ni, a, rj0 + js, nj, d, kind);
      tile_product<TN, false>(acc_i, s, sv, v, rj0 + js, nj, c0, r);
      if (jj > 0) {
        float acc_j[TM][TN];
        zero(acc_j);
        tile_product<TN, true>(acc_j, s, sv, v, ri0 + is, ni, c0, r);
        // This CTA is the only writer of these slot rows; each thread
        // always owns the same (row, column) entries, so the
        // read-modify-write is race-free and its order fixed.
#pragma unroll
        for (int q = 0; q < TM; ++q) {
          const int rl = ty + 16 * q;
          if (rl >= nj) continue;
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            const int64_t col = c0 + tx + 16 * c;
            if (col >= r) continue;
            float* p = s1 + (rj0 + js + rl) * r + col;
            *p = (is == 0) ? acc_j[q][c] : *p + acc_j[q][c];
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int rl = ty + 16 * q;
      if (rl >= ni) continue;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int64_t col = c0 + tx + 16 * c;
        if (col < r) s0[(ri0 + is + rl) * r + col] = acc_i[q][c];
      }
    }
  }
}

// out[row, col] = sum over bands (fixed order) of the valid slot entries.
__global__ void sym_reduce_kernel(const float* __restrict__ slots, float* __restrict__ out,
                                  int64_t n, int64_t r, int64_t nb, int64_t n_bands) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * r) return;
  const int64_t row = idx / r;
  const int64_t blk = row / SYM_T;
  float acc = 0.0f;
  for (int64_t jj = 0; jj < n_bands; ++jj) {
    if (band_active(jj, blk, nb)) acc += slots[jj * n * r + idx];
    if (jj > 0 && band_active(jj, (blk - jj + nb) % nb, nb))
      acc += slots[(n_bands + jj) * n * r + idx];
  }
  out[idx] = acc;
}

// Column chunks: the smallest RC >= r up to 128; wider r runs full
// 128-column chunks, then one launch for the remainder.
int pick_tn(int64_t cols) {
  if (cols <= 16) return 1;
  if (cols <= 32) return 2;
  if (cols <= 64) return 4;
  if (cols <= 80) return 5;
  return 8;
}

template <typename Launch>
int for_each_chunk(int64_t r, Launch launch) {
  const int64_t full = r / 128;
  const int64_t rem = r - full * 128;
  if (full > 65535) return (int)cudaErrorInvalidConfiguration;
  if (full > 0) {
    launch(8, full, (int64_t)0);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (rem > 0) {
    launch(pick_tn(rem), (int64_t)1, full * 128);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers, all arrays
// row-major and contiguous; launches go on `stream` and do not synchronise.
// Each returns the first CUDA error of its launches (0 = success).

extern "C" int fused_matvec_f32(const float* a, const float* b, const float* v, float* out,
                                long long n, long long m, long long r, int d, int kind,
                                void* stream) {
  if (n <= 0 || m <= 0 || r <= 0 || d <= 0 || kind < 0 || kind > 4)
    return (int)cudaErrorInvalidValue;
  const long long gx = (n + TILE - 1) / TILE;
  if (gx > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  return for_each_chunk(r, [&](int tn, int64_t chunks, int64_t base) {
    dim3 grid((unsigned)gx, (unsigned)chunks);
    switch (tn) {
      case 1: fused_matvec_kernel<1><<<grid, NT, 0, st>>>(a, b, v, out, n, m, r, d, kind, base); break;
      case 2: fused_matvec_kernel<2><<<grid, NT, 0, st>>>(a, b, v, out, n, m, r, d, kind, base); break;
      case 4: fused_matvec_kernel<4><<<grid, NT, 0, st>>>(a, b, v, out, n, m, r, d, kind, base); break;
      case 5: fused_matvec_kernel<5><<<grid, NT, 0, st>>>(a, b, v, out, n, m, r, d, kind, base); break;
      default: fused_matvec_kernel<8><<<grid, NT, 0, st>>>(a, b, v, out, n, m, r, d, kind, base); break;
    }
  });
}

// The band-grid tile, for the wrapper's scratch arithmetic.
extern "C" int fused_matvec_sym_tile(void) { return SYM_T; }

// `slots` is scratch of 2 * n_bands * n * r floats, n_bands = nb / 2 + 1.
extern "C" int fused_matvec_sym_f32(const float* a, const float* v, float* slots, float* out,
                                    long long n, long long r, int d, int kind, void* stream) {
  if (n <= 0 || r <= 0 || d <= 0 || kind < 0 || kind > 4) return (int)cudaErrorInvalidValue;
  const long long nb = (n + SYM_T - 1) / SYM_T;
  const long long n_bands = nb / 2 + 1;
  if (nb > 2147483647LL || n_bands > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = for_each_chunk(r, [&](int tn, int64_t chunks, int64_t base) {
    dim3 grid((unsigned)nb, (unsigned)n_bands, (unsigned)chunks);
    switch (tn) {
      case 1: fused_matvec_sym_kernel<1><<<grid, NT, 0, st>>>(a, v, slots, n, r, d, kind, nb, n_bands, base); break;
      case 2: fused_matvec_sym_kernel<2><<<grid, NT, 0, st>>>(a, v, slots, n, r, d, kind, nb, n_bands, base); break;
      case 4: fused_matvec_sym_kernel<4><<<grid, NT, 0, st>>>(a, v, slots, n, r, d, kind, nb, n_bands, base); break;
      case 5: fused_matvec_sym_kernel<5><<<grid, NT, 0, st>>>(a, v, slots, n, r, d, kind, nb, n_bands, base); break;
      default: fused_matvec_sym_kernel<8><<<grid, NT, 0, st>>>(a, v, slots, n, r, d, kind, nb, n_bands, base); break;
    }
  });
  if (err) return err;
  const long long total = n * r;
  const long long blocks = (total + 255) / 256;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  sym_reduce_kernel<<<(unsigned)blocks, 256, 0, st>>>(slots, out, n, r, nb, n_bands);
  return (int)cudaGetLastError();
}
