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
// Both kernels run their products on the tensor cores. The symmetric kernel
// is the iterative fit's matvec (PCG, SLQ, LOVE); both of its products,
// T V[j] and T^T V[i], run as tf32x3.cuh's 3xTF32 warpgroup product
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
// against the 2.0 ms bound; tools/probe_matvec_parts.py): leaving out the
// products saves 3.6 ms where the tensor cores need 2.3; leaving out the
// tile build saves 2.0 ms; with both gone 2.5 ms remain, mostly fetching
// V[i]'s hi and lo for every tile (37 KB, 11 GB a sweep from L2). The three
// overlap little, because the build, the fetch and the products of a tile
// take turns in one CTA per SM.
//
// The general kernel is the grid predict's cross-Gram against [alpha | W]
// (10,000 x 50,000, r = 513: bound 3.1 ms), `iter_predict_mean` (r = 1) and
// every sweep that the symmetric kernel does not take (past its scratch
// gate, about 52,500 rows at r = 65, or IterConfig(sym_matvec=False)). It
// runs the same product, wg_product<NTL, false> against V split once per
// call by sym_split_v_kernel, with these choices:
//   * 128 rows of x1 per CTA, two warpgroups of 64: each staged V chunk
//     feeds both, which halves V's traffic from L2 against 64 rows (at
//     r = 513 each tile pass fetches 64 x 520 x 8 bytes of hi and lo).
//   * A column group per CTA: up to two chunks of 72 columns (GEN_GROUP),
//     whose sums stay in registers across the CTA's whole walk over x2, so
//     each K tile is built once per group: once per call for r <= 144,
//     four times for r = 513 (7 x 72 + 16 padded columns). The last chunk
//     of V is as narrow as the remainder (8 NTL_LAST columns) and rides in
//     the last group: no launch covers less than a whole group. Two chunks
//     is what the registers hold: 72 sums a consumer thread beside
//     wg_product's working set (two steps in flight) fit its 224 registers
//     (ptxas spills them at 200); a third chunk would need 36 more than the
//     register file leaves beside the producer, and a 128 x 288 group in
//     shared memory (147 KB) leaves no room for the K buffers and V ring.
//   * The tile, off the products' path: a third, producer warpgroup
//     builds each 128 x 64 tile once per group into one of two buffers
//     while the two consumer warpgroups multiply the other (named barriers
//     hand the buffers over; setmaxnreg moves registers from the producer
//     to the consumers). It reads x1's 128 rows from a copy staged in
//     shared memory once per call (up to 32 coordinates; through L1 past
//     that) and evaluates every entry, then masks it. The consumers take
//     the group chunk by chunk, each its 64 rows, while cp.async brings the
//     next chunk (or the next tile's first) into the other stage of a
//     two-stage ring of V chunks.
//   * Enough CTAs, deterministically: the x2 tiles split into s contiguous
//     segments, s the least number that makes row blocks x groups x s at
//     least 352 CTAs (8/3 waves; fused_matvec_general_split, mirrored by
//     hopper_kernels.general_split). At s = 1 each CTA writes out directly;
//     else segment z writes its own (n_pad, rp) slot, one writer per entry,
//     and gen_reduce_kernel adds the slots in order. No atomics: two calls
//     on the same inputs agree bit for bit. Each tile's 64-term partial is
//     summed from zero (each 8-deep step too) and then added to the running
//     sum, as in the symmetric kernel.
// One call is three launches at most: the split, the matvec over every row
// block, group and segment, and at s > 1 the reduction.
//
// What bounds it (one H100 at 700 W, tools/probe_matvec_parts.py): at
// 50,000^2, r = 65, 7.4 ms against the 2.0 ms bound; leaving out the build
// gives 4.3 ms, leaving out the products 4.4, both 1.9 (mostly V's hi and
// lo from L2, 11 GB a call at 128 rows a CTA), so the producer's build and
// the consumers' products still take turns more than they overlap. At
// 10,000 x 50,000, r = 513: 9.2 ms against 3.1; the loop alone takes 3.2,
// 16 GB of V from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int TILE = 64;      // K tile edge (rows and columns)
constexpr int SYM_T = 384;    // band-grid block of the symmetric kernel
constexpr int SYM_LDK = TILE + 4;   // row stride of a K tile (mma fragment loads)
constexpr int SYM_NTL = 9;    // 8-column mma tiles per column chunk, at most (72 columns)
constexpr int SYM_NT = 256;   // threads per CTA of either matvec kernel: two warpgroups
// Measurement builds only (tools/probe_matvec_parts.py): bit 0 leaves out the
// tile build, bit 1 the products. Every other build has 0 here.
#ifndef SYM_PROBE_SKIP
#define SYM_PROBE_SKIP 0
#endif
constexpr int SYM_DEPTH = 2;  // 8-deep wgmma steps in flight per warpgroup (at most 3; 3 measured no faster)
constexpr int SYM_ENT = TILE * TILE / SYM_NT;  // K entries built per thread and 64 x 64 tile
constexpr int GEN_ROWS = 2 * TILE;  // rows of x1 per CTA of the general kernel, one 64-row half per warpgroup
constexpr int GEN_GROUP = 2;  // column chunks per CTA of the general kernel (a column group)
constexpr int GEN_TARGET_CTAS = 352;  // 8/3 waves of one CTA per SM on 132 SMs

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

struct SymSmem {
  float k[TILE][SYM_LDK];
};

// The kernel values of N entries that share a column: coordinate k of entry
// e's row is row_at(e, k) (0 where the row is masked), the column's
// coordinates bp[0 .. d). The squared distances are summed in coordinate
// order with __fmul_rn/__fadd_rn; then every entry is evaluated, with no
// branch around an evaluation, so a thread's N of them overlap. sym_tile
// and produce_tile take their entries from here; the caller masks them.
template <int KIND, int N, class RowAt>
__device__ __forceinline__ void kernel_entries(float (&kv)[N], RowAt row_at, const float* __restrict__ bp, int d) {
#pragma unroll
  for (int e = 0; e < N; ++e) kv[e] = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float bv = bp[k];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float diff = row_at(e, k) - bv;
      kv[e] = __fadd_rn(kv[e], __fmul_rn(diff, diff));
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e) kv[e] = kfun(KIND, kv[e]);
}

// sK[r][c] = k(|a[ra0 + r] - a[rb0 + c]|^2) for r < na, c < nbc; 0 elsewhere.
// No staging and no barriers (one CTA per SM, where every barrier is idle
// time): a thread reads its column's coordinates and its 16 rows' (the same
// address across a warp) straight from device memory through L1, any d. The
// caller synchronises before the tile is read.
template <int KIND>
__device__ __forceinline__ void sym_tile(SymSmem& s, const float* __restrict__ a, int64_t ra0, int na, int64_t rb0,
                                         int nbc, int d) {
  constexpr int RS = SYM_NT / TILE;  // rows row0 + RS * e
  const int col = threadIdx.x % TILE;
  const int row0 = threadIdx.x / TILE;
  const bool col_ok = col < nbc;
  const float* ap = a + (ra0 + row0) * d;
  float kv[SYM_ENT];
  kernel_entries<KIND>(
      kv, [&](int e, int k) { return row0 + RS * e < na ? ap[(int64_t)RS * e * d + k] : 0.0f; },
      a + (rb0 + (col_ok ? col : 0)) * d, d);
#pragma unroll
  for (int e = 0; e < SYM_ENT; ++e) {
    const int r = row0 + RS * e;
    s.k[r][col] = (r < na && col_ok) ? kv[e] : 0.0f;
  }
}

__device__ __forceinline__ void build_tile_direct(SymSmem& s, const float* __restrict__ a, int64_t ra0, int na,
                                                  int64_t rb0, int nbc, int d, int kind) {
  switch (kind) {  // one branch on the kind for the whole tile
    case EXPQUAD: sym_tile<EXPQUAD>(s, a, ra0, na, rb0, nbc, d); break;
    case MATERN12: sym_tile<MATERN12>(s, a, ra0, na, rb0, nbc, d); break;
    case EXPONENTIAL: sym_tile<EXPONENTIAL>(s, a, ra0, na, rb0, nbc, d); break;
    case MATERN32: sym_tile<MATERN32>(s, a, ra0, na, rb0, nbc, d); break;
    default: sym_tile<MATERN52>(s, a, ra0, na, rb0, nbc, d); break;
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

// ---------------------------------------------------------------------
// General: out = K(x1, x2) V for any x1 (n rows) and x2 (m rows).
// ---------------------------------------------------------------------

constexpr int GEN_THREADS = 3 * 128;  // two consumer warpgroups, one producer warpgroup
constexpr int GEN_LDK = SYM_LDK;      // row stride of a K tile
constexpr int GEN_KTILE = GEN_ROWS * GEN_LDK;  // floats of one 128 x 64 K tile
// Registers a thread after the split (setmaxnreg): 256 x consumer + 128 x
// producer <= 65,536. Measured on the card: the consumers spill at 200
// registers and below; from 208 to 224 the times are alike; 232 leaves the
// producer 48, where it spills, and is slower.
constexpr int GEN_CONSUMER_REGS = 224, GEN_PRODUCER_REGS = 56;
// Named barriers (0 is __syncthreads): the consumers' own, then "tile b
// built" and "tile b free" for the two K buffers.
constexpr int BAR_CONSUMERS = 1, BAR_FULL = 2, BAR_EMPTY = 4;
// Up to this many coordinates, the CTA's 128 rows of x1 are staged in shared
// memory once per call (zero past n); a wider x1 is read through L1.
constexpr int GEN_D_SMEM = 32;
// A CTA's shared memory: two 128 x 64 K tiles, a two-stage ring of V chunks
// (each stage the hi and lo B operands of up to 72 columns), then the staged
// rows of x1 (d x 128 floats, when d <= GEN_D_SMEM).
constexpr int GEN_SMEM_BYTES = (2 * GEN_KTILE + 2 * 2 * 512 * SYM_NTL) * (int)sizeof(float);

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// The producer warpgroup builds the CTA's 128 x 64 K tile for x2 rows
// rb0 .. rb0 + nbc: thread p takes column p % 64 and rows p / 64 + 2 e, in
// four passes of 16 rows, through kernel_entries, masked (zero past row
// `na` or column `nbc`). Rows come from the staged copy `sa` ([d][128],
// zero past n) or, STAGED false, from `a` through L1.
template <int KIND, bool STAGED>
__device__ __forceinline__ void produce_tile(float* kt, const float* sa, const float* __restrict__ a, int64_t i0,
                                             int na, const float* __restrict__ b, int64_t rb0, int nbc, int d) {
  const int p = threadIdx.x - 2 * 128;
  const int col = p % TILE, rg = p / TILE;
  const bool col_ok = col < nbc;
  const float* bp = b + (rb0 + (col_ok ? col : 0)) * d;
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const int r0 = rg + 32 * q;  // rows r0 + 2 e, e < 16
    const float* ap = a + (i0 + r0) * d;  // STAGED false: row r0 + 2 e at ap[2 e d]
    float kv[16];
    kernel_entries<KIND>(
        kv,
        [&](int e, int k) {
          const int row = r0 + 2 * e;
          return STAGED ? sa[k * GEN_ROWS + row] : (row < na ? ap[2 * e * d + k] : 0.0f);
        },
        bp, d);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int row = r0 + 2 * e;
      kt[row * GEN_LDK + col] = (row < na && col_ok) ? kv[e] : 0.0f;
    }
  }
}

template <bool STAGED>
__device__ __forceinline__ void produce_tile_kind(int kind, float* kt, const float* sa, const float* __restrict__ a,
                                                  int64_t i0, int na, const float* __restrict__ b, int64_t rb0,
                                                  int nbc, int d) {
  switch (kind) {  // one branch on the kind for the whole tile
    case EXPQUAD: produce_tile<EXPQUAD, STAGED>(kt, sa, a, i0, na, b, rb0, nbc, d); break;
    case MATERN12: produce_tile<MATERN12, STAGED>(kt, sa, a, i0, na, b, rb0, nbc, d); break;
    case EXPONENTIAL: produce_tile<EXPONENTIAL, STAGED>(kt, sa, a, i0, na, b, rb0, nbc, d); break;
    case MATERN32: produce_tile<MATERN32, STAGED>(kt, sa, a, i0, na, b, rb0, nbc, d); break;
    default: produce_tile<MATERN52, STAGED>(kt, sa, a, i0, na, b, rb0, nbc, d); break;
  }
}

// The hi and lo B operands of V chunk q (8 ntl columns from column 72 q)
// of row tile `tile` into one stage of the ring; ntl is NTL_LAST for the
// last chunk of V, else SYM_NTL. Consumer threads only (0 .. 255).
template <int NTL_LAST>
__device__ __forceinline__ void load_chunk(float* stage, const float* vs, int64_t tile, int q, int n_chunks,
                                           int64_t m_pad, int64_t rp) {
  float* hi = stage;
  float* lo = stage + 512 * SYM_NTL;
  if (NTL_LAST != SYM_NTL && q == n_chunks - 1)
    load_v<NTL_LAST>(hi, lo, vs, tile, (int64_t)q * SYM_NTL, m_pad, rp);
  else
    load_v<SYM_NTL>(hi, lo, vs, tile, (int64_t)q * SYM_NTL, m_pad, rp);
}

// CTA (x, y, z) owns rows [128 x, 128 x + 128) of out, the GEN_GROUP
// chunks of V from chunk GEN_GROUP y (a column group; fewer in the last
// group where the chunks run out, e.g. the one chunk of r <= 72) and segment z of the x2 tiles, [mt z / s, mt (z + 1) / s) with
// mt = m_pad / 64 and s = gridDim.z. `vs` is V split and laid out by
// sym_split_v_kernel (m_pad rows, rp columns). Warp-specialised:
//   * the producer warpgroup builds each 128 x 64 K tile once, into one of
//     two buffers, while the consumers multiply the other;
//   * consumer warpgroup h multiplies its 64 rows of the tile with each
//     chunk of the group in turn: a two-stage ring of V chunks, which both
//     share, brings the next chunk (or the next tile's first) in with
//     cp.async while the current one is multiplied. Each tile's 64-term
//     partial is summed from zero (each 8-deep step too) and added to the
//     running sum in registers.
// At s = 1 the sums go to `out` (n x r); else to slot z of `slots`
// (s, n_pad, rp), which gen_reduce_kernel adds in order.
template <int NTL_LAST>
__global__ void __launch_bounds__(GEN_THREADS, 1)
fused_matvec_gen_kernel(const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ vs,
                        float* __restrict__ out, float* __restrict__ slots, int64_t n, int64_t m, int64_t r,
                        int64_t n_pad, int64_t m_pad, int64_t rp, int d, int kind, int n_chunks) {
  using namespace tf32x3;
  extern __shared__ __align__(128) float smem[];
  float* ktiles = smem;                       // [2][GEN_ROWS][GEN_LDK]
  float* ring = smem + 2 * GEN_KTILE;         // [2 stages][hi, lo][512 SYM_NTL]
  float* sa = ring + 2 * 2 * 512 * SYM_NTL;   // [d][GEN_ROWS] when staged
  constexpr int STAGE = 2 * 512 * SYM_NTL;
  const int64_t i0 = (int64_t)blockIdx.x * GEN_ROWS;
  const int64_t mt = m_pad / TILE;
  const int64_t t_begin = blockIdx.z * mt / gridDim.z, t_end = (blockIdx.z + 1) * mt / gridDim.z;
  const int n_tiles = (int)(t_end - t_begin);
  const bool staged = d <= GEN_D_SMEM;
  if (staged)
    for (int idx = threadIdx.x; idx < d * GEN_ROWS; idx += GEN_THREADS) {
      const int k = idx / GEN_ROWS, row = idx % GEN_ROWS;
      sa[idx] = i0 + row < n ? a[(i0 + row) * d + k] : 0.0f;
    }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ---- producer warpgroup: the K tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(GEN_PRODUCER_REGS));
    const int na = (int)min((int64_t)GEN_ROWS, n - i0);
    for (int it = 0; it < n_tiles; ++it) {
      const int buf = it & 1;
      const int64_t j0 = (t_begin + it) * TILE;
      if (it >= 2) bar_sync(BAR_EMPTY + buf, GEN_THREADS);  // the consumers are done with tile it - 2
      if (!(SYM_PROBE_SKIP & 1)) {
        const int nj = (int)min((int64_t)TILE, m - j0);
        if (staged)
          produce_tile_kind<true>(kind, ktiles + buf * GEN_KTILE, sa, a, i0, na, b, j0, nj, d);
        else
          produce_tile_kind<false>(kind, ktiles + buf * GEN_KTILE, sa, a, i0, na, b, j0, nj, d);
      }
      // the tile after next's x2 coordinates into L1
      const int p = threadIdx.x - 2 * 128;
      if (it + 2 < n_tiles && p * 32 < TILE * d)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(b + (j0 + 2 * TILE) * d + p * 32));
      bar_arrive(BAR_FULL + buf, GEN_THREADS);
    }
  } else {
    // ---- consumer warpgroups: the products ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(GEN_CONSUMER_REGS));
    constexpr int G = GEN_GROUP;
    const int q0 = blockIdx.y * G;
    const int nch = min(G, n_chunks - q0);
    const int wg = threadIdx.x / 128;
    float acc[G][4 * SYM_NTL];
#pragma unroll
    for (int c = 0; c < G; ++c)
#pragma unroll
      for (int e = 0; e < 4 * SYM_NTL; ++e) acc[c][e] = 0.0f;
    int st = 0;
    load_chunk<NTL_LAST>(ring, vs, t_begin, q0, n_chunks, m_pad, rp);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
      const int buf = it & 1;
      const int64_t t = t_begin + it;
      bar_sync(BAR_FULL + buf, GEN_THREADS);  // tile it is built
      const float* T = ktiles + buf * GEN_KTILE + TILE * wg * GEN_LDK;
#pragma unroll
      for (int c = 0; c < G; ++c) {
        if (c < nch) {  // uniform across the CTA
          cp_async_wait<0>();
          fence_async_smem();
          // this stage has landed for every consumer, and every consumer
          // is done with the other stage
          bar_sync(BAR_CONSUMERS, 2 * 128);
          float* other = ring + (st ^ 1) * STAGE;
          if (c + 1 < nch)
            load_chunk<NTL_LAST>(other, vs, t, q0 + c + 1, n_chunks, m_pad, rp);
          else if (it + 1 < n_tiles)
            load_chunk<NTL_LAST>(other, vs, t + 1, q0, n_chunks, m_pad, rp);
          cp_async_commit();
          const float* bhi = ring + st * STAGE;
          const float* blo = bhi + 512 * SYM_NTL;
          if (!(SYM_PROBE_SKIP & 2)) {
            if (NTL_LAST != SYM_NTL && q0 + c == n_chunks - 1) {
              float part[4 * NTL_LAST];
#pragma unroll
              for (int e = 0; e < 4 * NTL_LAST; ++e) part[e] = 0.0f;
              wg_product<NTL_LAST, false>(part, T, bhi, blo);
#pragma unroll
              for (int e = 0; e < 4 * NTL_LAST; ++e) acc[c][e] += part[e];
            } else {
              float part[4 * SYM_NTL];
#pragma unroll
              for (int e = 0; e < 4 * SYM_NTL; ++e) part[e] = 0.0f;
              wg_product<SYM_NTL, false>(part, T, bhi, blo);
#pragma unroll
              for (int e = 0; e < 4 * SYM_NTL; ++e) acc[c][e] += part[e];
            }
          }
          st ^= 1;
        }
      }
      if (it + 2 < n_tiles) bar_arrive(BAR_EMPTY + buf, GEN_THREADS);  // the producer may rebuild this buffer
    }

    const int64_t row0 = i0 + TILE * wg + 16 * ((threadIdx.x / 32) % 4);
#pragma unroll
    for (int c = 0; c < G; ++c) {
      if (c >= nch) continue;
      const int q = q0 + c;
      const int ntl = q == n_chunks - 1 ? NTL_LAST : SYM_NTL;
      const int64_t c0 = (int64_t)q * 8 * SYM_NTL;
#pragma unroll
      for (int nt = 0; nt < SYM_NTL; ++nt) {
        if (nt >= ntl) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = row0 + acc_row(2 * h), col = c0 + 8 * nt + acc_col(0);
          const float x = acc[c][4 * nt + 2 * h], y = acc[c][4 * nt + 2 * h + 1];
          if (gridDim.z == 1) {
            if (row < n && col < r) out[row * r + col] = x;
            if (row < n && col + 1 < r) out[row * r + col + 1] = y;
          } else {
            *reinterpret_cast<float2*>(slots + ((int64_t)blockIdx.z * n_pad + row) * rp + col) = make_float2(x, y);
          }
        }
      }
    }
  }
}

// out[row, col] = the s segment slots in order.
__global__ void gen_reduce_kernel(const float* __restrict__ slots, float* __restrict__ out, int64_t n, int64_t r,
                                  int64_t n_pad, int64_t rp, int s) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * r) return;
  const int64_t off = (idx / r) * rp + idx % r;
  float acc = 0.0f;
  for (int k = 0; k < s; ++k) acc += slots[k * n_pad * rp + off];
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

// 8-column mma tiles of a column chunk of `cols` <= 72 columns.
int pick_ntl(int64_t cols) {
  if (cols <= 8) return 1;
  if (cols <= 16) return 2;
  if (cols <= 32) return 4;
  if (cols <= 64) return 8;
  return SYM_NTL;
}

// Full chunks of 72 columns, then the remainder's chunk of 8, 16, 32, 64 or 72.
int64_t padded_cols(int64_t r) {
  const int64_t full = r / (8 * SYM_NTL), rem = r - full * 8 * SYM_NTL;
  return full * 8 * SYM_NTL + (rem > 0 ? 8 * pick_ntl(rem) : 0);
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

struct GenArgs {
  const float *a, *b, *vs;
  float *out, *slots;
  int64_t n, m, r, n_pad, m_pad, rp;
  int d, kind, n_chunks;
};

template <int NTL_LAST>
cudaError_t launch_gen(dim3 grid, cudaStream_t st, const GenArgs& g) {
  const int smem = GEN_SMEM_BYTES + (g.d <= GEN_D_SMEM ? g.d * GEN_ROWS * (int)sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(fused_matvec_gen_kernel<NTL_LAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_matvec_gen_kernel<NTL_LAST><<<grid, GEN_THREADS, smem, st>>>(
      g.a, g.b, g.vs, g.out, g.slots, g.n, g.m, g.r, g.n_pad, g.m_pad, g.rp, g.d, g.kind, g.n_chunks);
  return cudaGetLastError();
}

// One kernel per width of V's last chunk (8 ntl_last columns).
cudaError_t launch_gen_width(int ntl_last, dim3 grid, cudaStream_t st, const GenArgs& g) {
  switch (ntl_last) {
    case 1: return launch_gen<1>(grid, st, g);
    case 2: return launch_gen<2>(grid, st, g);
    case 4: return launch_gen<4>(grid, st, g);
    case 8: return launch_gen<8>(grid, st, g);
    default: return launch_gen<SYM_NTL>(grid, st, g);
  }
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers, all arrays
// row-major and contiguous; launches go on `stream` and do not synchronise.
// Each returns the first CUDA error of its launches (0 = success).

// The general kernel's split of an (n x m) Gram against r columns, for the
// wrapper's allocations (hopper_kernels.general_split mirrors it):
// out[0] = s, the x2 segments: the least s that makes row blocks x column
// groups x s at least GEN_TARGET_CTAS CTAs, at most one per x2 tile;
// out[1] = n_pad (n rounded up to 128 rows), out[2] = m_pad (m rounded up
// to 64), out[3] = rp (the padded columns of V and of a slot).
extern "C" void fused_matvec_general_split(long long n, long long m, long long r, long long* out) {
  const long long n_pad = (n + GEN_ROWS - 1) / GEN_ROWS * GEN_ROWS;
  const long long m_pad = (m + TILE - 1) / TILE * TILE;
  const long long rp = padded_cols(r);
  const long long n_chunks = (rp + 8 * SYM_NTL - 1) / (8 * SYM_NTL);
  const long long groups = (n_chunks + GEN_GROUP - 1) / GEN_GROUP;
  const long long ctas = (n_pad / GEN_ROWS) * groups;
  const long long s = (GEN_TARGET_CTAS + ctas - 1) / ctas;
  out[0] = s < m_pad / TILE ? s : m_pad / TILE;
  out[1] = n_pad;
  out[2] = m_pad;
  out[3] = rp;
}

// `a` (n, d) and `b` (m, d) are x1 and x2 pre-scaled by the lengthscales,
// `v` is (m, r). `vsplit` (2 * m_pad * rp floats) receives V split into
// TF32 hi and lo in the tensor cores' layout; `slots` holds s * n_pad * rp
// floats when s > 1 and is not touched at s = 1 (n_pad, m_pad and rp as
// fused_matvec_general_split gives them; s may be any of 1 .. m_pad / 64).
// Launches: the split, one matvec launch over every row block, column group
// and segment, and at s > 1 the reduction.
extern "C" int fused_matvec_f32(const float* a, const float* b, const float* v, float* vsplit, float* slots,
                                float* out, long long n, long long m, long long r, int d, int kind, int s,
                                void* stream) {
  if (n <= 0 || m <= 0 || r <= 0 || d <= 0 || kind < 0 || kind > 4) return (int)cudaErrorInvalidValue;
  long long split[4];
  fused_matvec_general_split(n, m, r, split);
  const long long n_pad = split[1], m_pad = split[2], rp = split[3];
  if (s < 1 || s > m_pad / TILE || s > 65535) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (rp + 8 * SYM_NTL - 1) / (8 * SYM_NTL);
  const long long rb = n_pad / GEN_ROWS, groups = (n_chunks + GEN_GROUP - 1) / GEN_GROUP;
  const long long split_blocks = (m_pad * rp + 255) / 256, blocks = (n * r + 255) / 256;
  if (rb > 2147483647LL || groups > 65535 || split_blocks > 2147483647LL || blocks > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  sym_split_v_kernel<<<(unsigned)split_blocks, 256, 0, st>>>(v, vsplit, m, r, m_pad, rp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const GenArgs g{a, b, vsplit, out, slots, n, m, r, n_pad, m_pad, rp, d, kind, (int)n_chunks};
  const dim3 grid((unsigned)rb, (unsigned)groups, (unsigned)s);
  const int ntl_last = (int)(rp - (n_chunks - 1) * 8 * SYM_NTL) / 8;
  err = launch_gen_width(ntl_last, grid, st, g);
  if (err != cudaSuccess || s == 1) return (int)err;
  gen_reduce_kernel<<<(unsigned)blocks, 256, 0, st>>>(slots, out, n, r, n_pad, rp, s);
  return (int)cudaGetLastError();
}

// The band-grid block, for the wrapper's scratch arithmetic.
extern "C" int fused_matvec_sym_tile(void) { return SYM_T; }

// Columns of the zero-padded V and of the scratch for r columns.
extern "C" long long fused_matvec_sym_padded_cols(long long r) { return padded_cols(r); }

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
