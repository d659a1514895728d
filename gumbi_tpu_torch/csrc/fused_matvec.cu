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
// the tile consumed against V at once. The distance sum uses
// __fmul_rn/__fadd_rn in coordinate order, as the plain torch version does,
// and expf/sqrtf are the accurate ones (no --use_fast_math), so K matches
// the plain version to a few ulps; only the order of the product's sums
// differs. Ragged edges are masked (zero K entries, zero V rows); offsets
// are int64; nothing is read back to the host.
//
// Bound: operations. Per Gram entry the function does 3*d distance flops,
// one kernel evaluation and 2*r product flops; the inputs and the output
// are a few MB. The least time for an f32-class product on this card is
// three TF32 passes on the tensor cores (3 * 2 n m r / 495 TFLOP/s: 2.0 ms
// at n = m = 50,000, r = 65, against 4.9 ms at the 67 TFLOP/s FP32 FMA peak).
//
// The general kernel keeps its FP32 FMA product (one launch on the fit's
// path): a CTA of 256 threads builds one 64 x 64 tile of K in shared memory
// (16 entries a thread, coordinates staged 16 at a time, so any d works),
// then multiplies it with 32-row slabs of V; each thread keeps a 4 x TN
// block of the output (TN = RC / 16, RC the columns of V a CTA carries: 16,
// 32, 64, 80 or 128) in registers; wider r runs as several column chunks,
// each rebuilding its tiles.
//
// The symmetric kernel is the iterative fit's matvec (PCG, SLQ, LOVE), and
// its time was the product, so both of its products, T V[j] and T^T V[i],
// run on the tensor cores as tf32x3.cuh's 3xTF32 warpgroup product
// (wgmma m64nNk8), in chunks of up to 72 columns (N = 72 for r = 65). A, the
// tile or its transpose, comes from registers: each thread loads its
// fragment from the f32 tile in shared memory either way round and splits
// it, so no transposed copy of the tile is needed. B, 64 rows of V, must lie
// K-major as TF32 values in the tensor cores' core-matrix layout: one small
// kernel per call splits V into hi and lo and writes both in that layout,
// zero-padded (rows to a multiple of 64, columns to the chunk widths), so a
// CTA fetches a tile's B operand as one contiguous cp.async copy. The design
// keeps every partial sum on chip until it is complete:
//   * Band-grid blocks are 384 rows (SYM_T). CTA (I, s) owns row block I and
//     walks the bands jj = s, s + n_split, ...; in band jj it meets column
//     block J = (I + jj) mod nb. For even nb the wrap band (jj = nb / 2)
//     holds each pair twice, and only I < nb / 2 is active, as in the
//     reference.
//   * Within a block pair the 64 x 64 tiles go j outer, i inner. All 256
//     threads build the tile once into shared memory (row stride 68:
//     conflict-free fragment loads; coordinates read through L1, no
//     staging; every entry evaluated then masked, so a thread's 16 kernel
//     evaluations overlap). Then it is used twice at once: warpgroup 0 forms
//     T V[j] and adds it to the CTA's own (384 x 72) accumulator in shared
//     memory, which collects rows I over all of the CTA's bands; warpgroup
//     1 forms T^T V[i] and carries it in registers across the inner loop.
//     One CTA fits an SM (the accumulator takes 111 KB, V's operands 74 KB).
//   * Each sum leaves the chip once: rows J of band jj to slot jj - 1 after
//     the inner loop, rows I to the CTA's own slot s at the end. For a fixed
//     band I -> J is a permutation, so every slot row has one writer; a last
//     kernel adds own slots and band slots in a fixed order. The result is
//     DETERMINISTIC. Each tile's 64-term partial is summed from zero
//     (inside it, each 8-deep step too: the tensor cores' accumulation
//     truncates) and then added to the carried sum with an f32 add.
//   * The scratch is (n_split + nb / 2) (n padded to 64) (r padded) floats;
//     the caller picks n_split so that about three waves of CTAs fill the
//     card, keeps the scratch under 1 GiB (`sym_matvec_fits`) and sends
//     larger requests to the general kernel.
//
// What still bounds it (one H100 at 700 W, n = 50,000, r = 65, 8.0 ms
// against the 2.0 ms bound; tools/probe_sym_parts.py): leaving out the
// products saves 3.6 ms where the tensor cores need 2.3; leaving out the
// tile build saves 2.0 ms; with both gone 2.5 ms remain, mostly fetching
// V[i]'s hi and lo for every tile (37 KB, 11 GB a sweep from L2). The three
// overlap little, because the build, the fetch and the products of a tile
// take turns in one CTA per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int TILE = 64;      // K tile edge (rows and columns)
constexpr int NT = 256;       // threads per CTA
constexpr int DC = 16;        // coordinates staged per pass
constexpr int KC = 32;        // V rows per slab
constexpr int TM = 4;         // output rows per thread (16 thread rows)
constexpr int ENT = TILE * TILE / NT;  // K entries built per thread
constexpr int SYM_T = 384;    // band-grid block of the symmetric kernel
constexpr int SYM_LDK = TILE + 4;   // row stride of its K tile (mma fragment loads)
constexpr int SYM_NTL = 9;    // 8-column mma tiles per column chunk, at most (72 columns)
constexpr int SYM_NT = 256;   // threads per CTA of the symmetric kernel: two warpgroups
// Measurement builds only (tools/probe_sym_parts.py): bit 0 leaves out the
// tile build, bit 1 the products. Every other build has 0 here.
#ifndef SYM_PROBE_SKIP
#define SYM_PROBE_SKIP 0
#endif
constexpr int SYM_DEPTH = 2;  // 8-deep wgmma steps in flight per warpgroup (at most 3; 3 measured no faster)
constexpr int SYM_ENT = TILE * TILE / SYM_NT;  // K entries built per thread there

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
struct SymSmem {
  float k[TILE][SYM_LDK];
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

// acc[q][c] += sum_t S[row(q)][t] * V[v0 + t][c0 + col(c)]
// over the tile's TILE inner indices; V rows >= v0 + nv and columns >= r
// read as 0. Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 q and
// columns tx + 16 c.
template <int TN>
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
        av[q] = s.k[ty + 16 * q][t0 + t];
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
    tile_product<TN>(acc, s, sv, v, j0, nj, c0, r);
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

template <int KIND>
__device__ __forceinline__ void store_tile(SymSmem& s, const float (&sq)[SYM_ENT], int row0, int col, int na,
                                           bool col_ok) {
  // every entry is evaluated, then masked: no branch around a kernel
  // evaluation, so a thread's 16 of them overlap
  float kv[SYM_ENT];
#pragma unroll
  for (int e = 0; e < SYM_ENT; ++e) kv[e] = kfun(KIND, sq[e]);
#pragma unroll
  for (int e = 0; e < SYM_ENT; ++e) {
    const int r = row0 + (SYM_NT / TILE) * e;
    s.k[r][col] = (r < na && col_ok) ? kv[e] : 0.0f;
  }
}

// build_tile without the staging and its barriers, for the symmetric kernel
// (one CTA per SM, where every barrier is idle time): a thread reads its
// column's coordinates and its 16 rows' (the same address across a warp)
// straight from device memory through L1, any d. Same arithmetic, same
// order. The caller synchronises before the tile is read.
__device__ __forceinline__ void build_tile_direct(SymSmem& s, const float* __restrict__ a, int64_t ra0,
                                                  int na, int64_t rb0, int nbc, int d, int kind) {
  constexpr int RS = SYM_NT / TILE;  // rows row0 + RS * e
  const int col = threadIdx.x % TILE;
  const int row0 = threadIdx.x / TILE;
  const bool col_ok = col < nbc;
  const float* bp = a + (rb0 + (col_ok ? col : 0)) * d;
  const float* ap = a + (ra0 + row0) * d;
  float sq[SYM_ENT];
#pragma unroll
  for (int e = 0; e < SYM_ENT; ++e) sq[e] = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float bv = bp[k];
#pragma unroll
    for (int e = 0; e < SYM_ENT; ++e) {
      const float av = (row0 + RS * e < na) ? ap[(int64_t)RS * e * d + k] : 0.0f;
      const float diff = av - bv;
      sq[e] = __fadd_rn(sq[e], __fmul_rn(diff, diff));
    }
  }
  // One branch on the kind for the whole tile, so the 16 kernel evaluations
  // of a thread are straight-line code and overlap.
  switch (kind) {
    case EXPQUAD: store_tile<EXPQUAD>(s, sq, row0, col, na, col_ok); break;
    case MATERN12: store_tile<MATERN12>(s, sq, row0, col, na, col_ok); break;
    case EXPONENTIAL: store_tile<EXPONENTIAL>(s, sq, row0, col, na, col_ok); break;
    case MATERN32: store_tile<MATERN32>(s, sq, row0, col, na, col_ok); break;
    default: store_tile<MATERN52>(s, sq, row0, col, na, col_ok); break;
  }
}


// Row stride of the own accumulator: at least 8 NTL, and 8 (mod 32) words,
// so the float2 accesses of accumulator rows fall in distinct banks.
__host__ __device__ constexpr int sym_ldo(int ntl) { return ((8 * ntl + 23) / 32) * 32 + 8; }

// V as the tensor cores read it. The wrapper's V (n, r) is split once per
// call into TF32 hi and lo and laid out so that the B operand of a 64-row
// tile and a chunk of column blocks is one contiguous piece already in the
// unswizzled K-major core-matrix layout of tf32x3.cuh: float offset
//   ((((h * n_tiles + row / 64) * (rp / 8) + col / 8) * 16 + (row % 64) / 4) * 8 + col % 8) * 4 + row % 4
// for h = 0 (hi), 1 (lo); rows >= n and columns >= r are zero.
__global__ void sym_split_v_kernel(const float* __restrict__ v, float* __restrict__ vs, int64_t n, int64_t r,
                                   int64_t n_pad, int64_t rp) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pad * rp) return;
  const int64_t row = idx / rp, col = idx % rp;
  uint32_t hi, lo;
  tf32x3::split((row < n && col < r) ? v[row * r + col] : 0.0f, hi, lo);
  const int64_t off = ((((row / TILE) * (rp / 8) + col / 8) * 16 + (row % TILE) / 4) * 8 + col % 8) * 4 + row % 4;
  vs[off] = __uint_as_float(hi);
  vs[n_pad * rp + off] = __uint_as_float(lo);
}

// The hi and lo B operands (512 NTL floats each) of row tile `tile` and
// column blocks cb0.. into shared memory: two contiguous copies.
template <int NTL>
__device__ __forceinline__ void load_v(float* dst_hi, float* dst_lo, const float* vs, int64_t tile, int64_t cb0,
                                       int64_t n_pad, int64_t rp) {
  const float* src = vs + ((tile * (rp / 8) + cb0) * 16) * 32;
  for (int idx = threadIdx.x; idx < 128 * NTL; idx += SYM_NT) {
    tf32x3::cp_async16(dst_hi + 4 * idx, src + 4 * idx);
    tf32x3::cp_async16(dst_lo + 4 * idx, src + n_pad * rp + 4 * idx);
  }
}

// part += 64 rows x 8 NTL columns of T V (this warp: rows 16 (warp % 4).. of
// the tile) or, TRANS, of T^T V (columns 16 (warp % 4).. of the tile), over
// the tile's 64 inner indices, by one warpgroup: A from registers (T has
// row stride SYM_LDK), B = V's hi and lo operands in shared memory.
template <int NTL, bool TRANS>
__device__ __forceinline__ void wg_product(float (&part)[4 * NTL], const float* T, const float* bhi,
                                           const float* blo) {
  using namespace tf32x3;
  const int m0 = 16 * ((threadIdx.x / 32) % 4);
  // SYM_DEPTH steps in flight: a step is waited for and added only after
  // the next SYM_DEPTH - 1 have been started, in rotating accumulators.
  constexpr int STEPS = TILE / 8;
  float d[SYM_DEPTH][4 * NTL];
  FragA a[SYM_DEPTH];
#pragma unroll
  for (int st = 0; st < STEPS + SYM_DEPTH - 1; ++st) {
    if (st < STEPS) {
      const int k0 = 8 * st;
      a[st % SYM_DEPTH] = TRANS ? load_a_t(T, SYM_LDK, m0, k0) : load_a(T, SYM_LDK, m0, k0);
      // this step's two core matrices along K start 8 k0 floats in; the next
      // along K is 128 bytes on, the next column block 16 * 128 bytes
      wgmma3_start<4 * NTL>(d[st % SYM_DEPTH], a[st % SYM_DEPTH], wgmma_desc(bhi + 8 * k0, 128, 2048),
                            wgmma_desc(blo + 8 * k0, 128, 2048));
    }
    const int done = st - (SYM_DEPTH - 1);
    if (done >= 0) {
      switch ((st < STEPS ? st : STEPS - 1) - done) {  // steps that may still be running
        case 0: wgmma_wait<0>(); break;
        case 1: wgmma_wait<1>(); break;
        default: wgmma_wait<2>(); break;
      }
#pragma unroll
      for (int e = 0; e < 4 * NTL; ++e) part[e] += d[done % SYM_DEPTH][e];
    }
  }
}

__device__ __forceinline__ bool band_active(int64_t jj, int64_t i, int64_t nb) {
  return (2 * jj < nb) || (nb % 2 == 1) || (2 * i < nb);
}

template <int NTL>
constexpr int sym_smem_bytes() {
  return (int)sizeof(SymSmem) + (4 * 512 * NTL + SYM_T * sym_ldo(NTL)) * (int)sizeof(float);
}

// Symmetric: CTA (I = blockIdx.x, s = blockIdx.y of n_split = gridDim.y,
// column chunk blockIdx.z). `vs` is V split and laid out by
// sym_split_v_kernel; `own` is (n_split, n_pad, rp), `slots`
// (n_bands - 1, n_pad, rp). Two warpgroups: both build the tile; then
// warpgroup 0 forms T V[j] and adds it to the own accumulator (each warp
// its own 16 rows), warpgroup 1 forms T^T V[i] and carries it in registers.
template <int NTL>
__global__ void __launch_bounds__(SYM_NT, 1)
fused_matvec_sym_kernel(const float* __restrict__ a, const float* __restrict__ vs,
                        float* __restrict__ own, float* __restrict__ slots, int64_t n,
                        int64_t n_pad, int64_t rp, int d, int kind, int64_t nb, int64_t n_bands,
                        int64_t col_base) {
  using namespace tf32x3;
  constexpr int LDO = sym_ldo(NTL);
  extern __shared__ __align__(128) float smem[];
  SymSmem& s = *reinterpret_cast<SymSmem*>(smem);
  float* vi_hi = smem + sizeof(SymSmem) / sizeof(float);  // [NTL][16] core matrices each
  float* vi_lo = vi_hi + 512 * NTL;
  float* vj_hi = vi_lo + 512 * NTL;
  float* vj_lo = vj_hi + 512 * NTL;
  float* acc_own = vj_lo + 512 * NTL;  // [SYM_T][LDO]: rows I over all of the CTA's bands
  const int64_t I = blockIdx.x;
  const int64_t c0 = col_base + (int64_t)blockIdx.z * 8 * NTL;
  const int warp = threadIdx.x / 32;
  const bool own_side = warp < 4;
  const int64_t ri0 = I * SYM_T;
  const int ci = (int)min((int64_t)SYM_T, n - ri0);

  for (int idx = threadIdx.x; idx < SYM_T * LDO; idx += SYM_NT) acc_own[idx] = 0.0f;
  __syncthreads();

  for (int64_t jj = blockIdx.y; jj < n_bands; jj += gridDim.y) {
    if (!band_active(jj, I, nb)) continue;  // uniform across the CTA
    const int64_t rj0 = ((I + jj) % nb) * SYM_T;
    const int cj = (int)min((int64_t)SYM_T, n - rj0);
    for (int js = 0; js < cj; js += TILE) {
      const int nj = min(TILE, cj - js);
      load_v<NTL>(vj_hi, vj_lo, vs, (rj0 + js) / TILE, c0 / 8, n_pad, rp);
      cp_async_commit();
      float acc_j[4 * NTL];
#pragma unroll
      for (int e = 0; e < 4 * NTL; ++e) acc_j[e] = 0.0f;
      for (int is = 0; is < ci; is += TILE) {
        const int ni = min(TILE, ci - is);
        load_v<NTL>(vi_hi, vi_lo, vs, (ri0 + is) / TILE, c0 / 8, n_pad, rp);
        cp_async_commit();
        if (!(SYM_PROBE_SKIP & 1)) build_tile_direct(s, a, ri0 + is, ni, rj0 + js, nj, d, kind);
        // the next tile's row coordinates into L1 while this one is multiplied
        if (is + TILE < ci && threadIdx.x * 32 < TILE * d)
          asm volatile("prefetch.global.L1 [%0];" ::"l"(a + (ri0 + is + TILE) * d + threadIdx.x * 32));
        cp_async_wait<0>();
        fence_async_smem();
        __syncthreads();
        if (!(SYM_PROBE_SKIP & 2) && (own_side || jj > 0)) {  // uniform across each warpgroup
          float part[4 * NTL];
#pragma unroll
          for (int e = 0; e < 4 * NTL; ++e) part[e] = 0.0f;
          if (own_side) {
            wg_product<NTL, false>(part, &s.k[0][0], vj_hi, vj_lo);
            // rows is + 16 warp.. of the own accumulator, which this warp alone touches
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float2* p = reinterpret_cast<float2*>(acc_own + (is + 16 * warp + acc_row(2 * h)) * LDO + 8 * nt +
                                                      acc_col(0));
                float2 o = *p;
                o.x += part[4 * nt + 2 * h];
                o.y += part[4 * nt + 2 * h + 1];
                *p = o;
              }
          } else {
            wg_product<NTL, true>(part, &s.k[0][0], vi_hi, vi_lo);
#pragma unroll
            for (int e = 0; e < 4 * NTL; ++e) acc_j[e] += part[e];
          }
        }
        __syncthreads();
      }
      if (jj > 0 && !own_side) {
        // rows js + 16 (warp - 4).. of block J in band jj's slot: written once
        float* slot = slots + ((jj - 1) * n_pad + rj0 + js + 16 * (warp - 4)) * rp + c0;
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(slot + (int64_t)acc_row(2 * h) * rp + 8 * nt + acc_col(0)) =
                make_float2(acc_j[4 * nt + 2 * h], acc_j[4 * nt + 2 * h + 1]);
      }
    }
  }
  __syncthreads();
  const int rows = (int)min((int64_t)SYM_T, n_pad - ri0);
  float* o = own + ((int64_t)blockIdx.y * n_pad + ri0) * rp + c0;
  for (int idx = threadIdx.x; idx < rows * 2 * NTL; idx += SYM_NT) {
    const int row = idx / (2 * NTL), c4 = idx % (2 * NTL);
    *reinterpret_cast<float4*>(o + (int64_t)row * rp + 4 * c4) =
        *reinterpret_cast<const float4*>(acc_own + row * LDO + 4 * c4);
  }
}

// out[row, col] = own slots in order, then the valid band slots in order.
__global__ void sym_reduce_kernel(const float* __restrict__ own, const float* __restrict__ slots,
                                  float* __restrict__ out, int64_t n, int64_t n_pad, int64_t r,
                                  int64_t rp, int64_t nb, int64_t n_bands, int64_t n_split) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * r) return;
  const int64_t row = idx / r, col = idx % r;
  const int64_t blk = row / SYM_T, off = row * rp + col;
  float acc = 0.0f;
  for (int64_t sp = 0; sp < n_split; ++sp) acc += own[sp * n_pad * rp + off];
  for (int64_t jj = 1; jj < n_bands; ++jj)
    if (band_active(jj, (blk - jj + nb) % nb, nb)) acc += slots[(jj - 1) * n_pad * rp + off];
  out[idx] = acc;
}

// out (m x r, r <= 72) = t v for row-major t (m x k) and v (k x r), or,
// TRANS, t^T v for row-major t (k x m): the symmetric kernel's warpgroup
// product alone, on zero-padded 64 x 64 tiles. One warpgroup a CTA.
constexpr int TEST_SMEM_BYTES = (TILE * SYM_LDK + 2 * 512 * SYM_NTL) * (int)sizeof(float);

template <bool TRANS>
__global__ void __launch_bounds__(128)
product_test_kernel(const float* __restrict__ t, const float* __restrict__ v, float* __restrict__ out,
                    int m, int k, int r) {
  using namespace tf32x3;
  extern __shared__ __align__(128) float smem[];
  float* Ts = smem;                    // [TILE][SYM_LDK]
  float* bhi = Ts + TILE * SYM_LDK;    // [SYM_NTL][16] core matrices
  float* blo = bhi + 512 * SYM_NTL;
  const int row0 = blockIdx.x * TILE, warp = threadIdx.x / 32;
  float acc[4 * SYM_NTL];
#pragma unroll
  for (int e = 0; e < 4 * SYM_NTL; ++e) acc[e] = 0.0f;
  for (int k0 = 0; k0 < k; k0 += TILE) {
    for (int idx = threadIdx.x; idx < TILE * TILE; idx += 128) {
      const int i = idx / TILE, j = idx % TILE;
      // tile[i][j]: rows are output rows (plain) or inner indices (TRANS)
      const int mm = TRANS ? row0 + j : row0 + i, kk = TRANS ? k0 + i : k0 + j;
      Ts[i * SYM_LDK + j] = (mm < m && kk < k) ? (TRANS ? t[(int64_t)kk * m + mm] : t[(int64_t)mm * k + kk]) : 0.0f;
    }
    for (int idx = threadIdx.x; idx < TILE * 8 * SYM_NTL; idx += 128) {
      const int i = idx / (8 * SYM_NTL), c = idx % (8 * SYM_NTL);
      uint32_t hi, lo;
      split((k0 + i < k && c < r) ? v[(int64_t)(k0 + i) * r + c] : 0.0f, hi, lo);
      const int off = (((c / 8) * 16 + i / 4) * 8 + c % 8) * 4 + i % 4;
      bhi[off] = __uint_as_float(hi);
      blo[off] = __uint_as_float(lo);
    }
    fence_async_smem();
    __syncthreads();
    float part[4 * SYM_NTL];
#pragma unroll
    for (int e = 0; e < 4 * SYM_NTL; ++e) part[e] = 0.0f;
    wg_product<SYM_NTL, TRANS>(part, Ts, bhi, blo);
#pragma unroll
    for (int e = 0; e < 4 * SYM_NTL; ++e) acc[e] += part[e];
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < SYM_NTL; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 16 * warp + acc_row(e), col = 8 * nt + acc_col(e);
      if (row < m && col < r) out[(int64_t)row * r + col] = acc[4 * nt + e];
    }
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

// The band-grid block, for the wrapper's scratch arithmetic.
extern "C" int fused_matvec_sym_tile(void) { return SYM_T; }

namespace {

// 8-column mma tiles of a column chunk of `cols` <= 72 columns.
int pick_ntl(int64_t cols) {
  if (cols <= 8) return 1;
  if (cols <= 16) return 2;
  if (cols <= 32) return 4;
  if (cols <= 64) return 8;
  return SYM_NTL;
}

template <int NTL>
cudaError_t launch_sym(dim3 grid, cudaStream_t st, const float* a, const float* vs, float* own, float* slots,
                       int64_t n, int64_t n_pad, int64_t rp, int d, int kind, int64_t nb, int64_t n_bands,
                       int64_t base) {
  constexpr int BYTES = sym_smem_bytes<NTL>();
  cudaError_t err = cudaFuncSetAttribute(fused_matvec_sym_kernel<NTL>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return err;
  fused_matvec_sym_kernel<NTL><<<grid, SYM_NT, BYTES, st>>>(a, vs, own, slots, n, n_pad, rp, d, kind, nb, n_bands, base);
  return cudaGetLastError();
}

}  // namespace

// Columns of the zero-padded V and of the scratch for r columns: full
// chunks of 72, then the remainder's chunk of 8, 16, 32, 64 or 72.
extern "C" long long fused_matvec_sym_padded_cols(long long r) {
  const long long full = r / (8 * SYM_NTL), rem = r - full * 8 * SYM_NTL;
  return full * 8 * SYM_NTL + (rem > 0 ? 8 * pick_ntl(rem) : 0);
}

// `v` is (n, r) row-major. `vsplit` (2 * n_pad * rp floats) receives V split
// into TF32 hi and lo in the tensor cores' layout, n_pad = n rounded up to
// 64 and rp = fused_matvec_sym_padded_cols(r); `scratch` holds
// (n_split + nb / 2) * n_pad * rp floats, nb = ceil(n / SYM_T).
extern "C" int fused_matvec_sym_f32(const float* a, const float* v, float* vsplit, float* scratch, float* out,
                                    long long n, long long r, int d, int kind, int n_split, void* stream) {
  if (n <= 0 || r <= 0 || d <= 0 || kind < 0 || kind > 4 || n_split <= 0 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const long long nb = (n + SYM_T - 1) / SYM_T;
  const long long n_bands = nb / 2 + 1;
  const long long n_pad = (n + TILE - 1) / TILE * TILE;
  const long long rp = fused_matvec_sym_padded_cols(r);
  const long long full = r / (8 * SYM_NTL), rem = r - full * 8 * SYM_NTL;
  if (nb > 2147483647LL || full > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  float* own = scratch;
  float* slots = scratch + (long long)n_split * n_pad * rp;
  const long long split_blocks = (n_pad * rp + 255) / 256;
  if (split_blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  sym_split_v_kernel<<<(unsigned)split_blocks, 256, 0, st>>>(v, vsplit, n, r, n_pad, rp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* vp = vsplit;
  if (full > 0)
    err = launch_sym<SYM_NTL>(dim3((unsigned)nb, (unsigned)n_split, (unsigned)full), st, a, vp, own, slots, n, n_pad,
                              rp, d, kind, nb, n_bands, 0);
  if (err != cudaSuccess) return (int)err;
  if (rem > 0) {
    const dim3 grid((unsigned)nb, (unsigned)n_split, 1u);
    const long long base = full * 8 * SYM_NTL;
    switch (pick_ntl(rem)) {
      case 1: err = launch_sym<1>(grid, st, a, vp, own, slots, n, n_pad, rp, d, kind, nb, n_bands, base); break;
      case 2: err = launch_sym<2>(grid, st, a, vp, own, slots, n, n_pad, rp, d, kind, nb, n_bands, base); break;
      case 4: err = launch_sym<4>(grid, st, a, vp, own, slots, n, n_pad, rp, d, kind, nb, n_bands, base); break;
      case 8: err = launch_sym<8>(grid, st, a, vp, own, slots, n, n_pad, rp, d, kind, nb, n_bands, base); break;
      default: err = launch_sym<SYM_NTL>(grid, st, a, vp, own, slots, n, n_pad, rp, d, kind, nb, n_bands, base); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const long long total = n * r;
  const long long blocks = (total + 255) / 256;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  sym_reduce_kernel<<<(unsigned)blocks, 256, 0, st>>>(own, slots, out, n, n_pad, r, rp, nb, n_bands, n_split);
  return (int)cudaGetLastError();
}

// out (m x r, r <= 72) = t v (trans = 0: t is m x k) or t^T v (trans = 1: t
// is k x m), row-major, through the symmetric kernel's warp product: for
// checks of the product alone.
extern "C" int fused_matvec_product_test_f32(const float* t, const float* v, float* out, int m, int k, int r,
                                             int trans, void* stream) {
  if (m <= 0 || k <= 0 || r <= 0 || r > 8 * SYM_NTL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((m + TILE - 1) / TILE);
  cudaError_t err = cudaFuncSetAttribute(product_test_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TEST_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(product_test_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TEST_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (trans)
    product_test_kernel<true><<<grid, 128, TEST_SMEM_BYTES, (cudaStream_t)stream>>>(t, v, out, m, k, r);
  else
    product_test_kernel<false><<<grid, 128, TEST_SMEM_BYTES, (cudaStream_t)stream>>>(t, v, out, m, k, r);
  return (int)cudaGetLastError();
}
