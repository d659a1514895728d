// Blocked Cholesky of a batched SPD matrix for NVIDIA Hopper (sm_90a):
//
//     L[d] L[d]^T = A[d],   A of shape (D, N, N), f32, N a multiple of 128
//
// in place: on entry the buffer holds the lower triangle of A (anything
// above the diagonal is never used), on exit the lower factor, with zeros
// above the diagonal of every diagonal block.
//
// Replaces the TPU kernel gumbi_tpu/ops/pallas_chol.py `pallas_cholesky`
// (`_chol_kernel` with `_factor_block`, `_micro_chol`, `_micro_tri_inv`).
// What carries over is WHAT it computes: the right-looking blocked
// factorization, the diagonal block factored in 32-wide micro blocks and
// inverted, the column strips formed as L_ik = A_ik W_k^T with
// W_k = L_kk^-1, and the trailing update A_ij -= L_ik L_jk^T.
//
// Bound: operations. The function does D N^3 / 3 flops on 8 D N^2 bytes
// (1.47 TFLOP on 2.1 GB at N = 16,384). At f32-class accuracy the least time
// for the products is three TF32 passes on the tensor cores
// (3 * flops / 495 TFLOP/s: 8.9 ms at N = 16,384, against 21.9 ms at the
// 67 TFLOP/s FP32 FMA peak and 0.64 ms of memory time). Two things keep a
// kernel off that bound, and the design answers each:
//
//   * The product. Strip and trailing update are 128 x 128 x 128 tile
//     products on tf32x3.cuh's 3xTF32 mma.sync block: 8 warps, each a
//     64 x 32 piece of the tile, both operands K-major as they lie in the
//     matrix (row-major L_ik and L_jk, k contiguous), staged 32 columns at a
//     time by cp.async into a ring of three stages. Each tile's product is
//     summed from zero and then subtracted from the tile, so a long update
//     rounds once per panel, not once per term.
//   * The panel chain (diagonal block, its inverse, the strip), which one
//     CTA must do while the card waits. It is shortened and it is hidden.
//     Shortened: the 128 x 128 block is factored left-looking in four
//     32-wide micro blocks (the part already factored enters by one small
//     product summed from zero, one warp factors the 32 x 32 diagonal micro
//     block in registers with shuffles, one thread per row solves the rows
//     below), and the inverse comes from the same recursion (four 32 x 32
//     inverses, then the off-diagonal blocks -W_bb L_ba W_aa at 32 and at
//     64), about 20 block-wide barriers instead of 256 and no 128-step
//     sweep. Hidden: the diagonal step of panel p + 1 needs only its own
//     tile brought up to date by panel p, so the CTA that updates that tile
//     goes on to factor and invert it, beside the CTAs that update the rest
//     of the trailing matrix. Two launches per panel, on one stream, with no
//     events and no second stream:
//       chol_strip_kernel(p), one CTA per row tile i > p: L_ip = A_ip W_p^T;
//       chol_panel_kernel(p + 1), one CTA per lower tile (i, j), i >= j > p:
//         A_ij -= L_ip L_jp^T, and the CTA of tile (p + 1, p + 1) then
//         factors it and writes W_p+1.
//
// What still bounds it (one H100 at 700 W, chip_smoke.py phase 7): a panel
// of the chain takes ~84 us (1.35 ms for the 16 panels of N = 2,048, where
// the library takes 0.82 ms): the diagonal CTA's small products run out of
// shared memory at its bandwidth, and two tile products (the diagonal
// tile's update, then the strip) run one after the other on one SM each.
// The tile product reaches 58 TFLOP/s f32-equivalent with its operands
// already in shared memory (tools/probe_tf32x3.py; mma.sync holds the warp's
// dispatch slot, so the split and the f32 adds add to it) and the whole call
// 34 TFLOP/s at N = 16,384 (43.0 ms; library 45.7 ms; bound 8.9 ms).
//
// A diagonal entry's subtrahend sum_t l_it^2 is summed apart from zero (the
// micro-block product plus the in-warp terms) and leaves at the pivot, so
// the pivot rounds once at the entry's magnitude. Each output tile has one
// writer and a fixed summation order, so the result is deterministic; there
// are no atomics. A pivot that is not positive gives NaN from its column on
// (the reciprocal square root of a negative number), as on the TPU; nothing
// raises and no loop waits on data.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int NB = 128;        // panel width and tile edge
constexpr int NT = 256;        // threads per CTA
constexpr int SB = 32;         // micro block of the diagonal step
constexpr int LDD = NB + 1;    // row stride of the diagonal block in shared memory
constexpr int LDP = SB + 1;    // row stride of the micro-block product
constexpr int BK = 32;         // operand columns per ring stage
constexpr int LDS = BK + 4;    // row stride of a staged operand (conflict-free fragment loads)
constexpr int STAGES = 3;
constexpr int STAGE_FLOATS = 2 * NB * LDS;  // X rows, then Y rows
constexpr int RING_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);
constexpr int TMP_FLOATS = NB * LDP;  // micro-block product; 64 x 65 temporary of the inverse
constexpr int DIAG_BYTES = (NB * LDD + TMP_FLOATS + NB * LDP + NB) * (int)sizeof(float);
constexpr int LDC = NB + 8;    // row stride of a prefetched output tile (conflict-free float2 reads)
static_assert((NB / BK - 1) % STAGES == 0, "the last chunk must sit in stage 0: the output tile is prefetched behind it");
static_assert(NB * LDC <= (STAGES - 1) * STAGE_FLOATS, "the prefetched output tile must fit behind stage 0");
constexpr int SMEM_BYTES = RING_BYTES > DIAG_BYTES ? RING_BYTES : DIAG_BYTES;
static_assert(TMP_FLOATS >= 64 * 65, "the inverse's temporary must hold a 64 x 65 block");

// Rows [0, NB) and columns [k0, k0 + BK) of X and of Y into one ring stage.
__device__ __forceinline__ void stage_load(float* st, const float* X, int64_t ldx, const float* Y,
                                           int64_t ldy, int k0) {
#pragma unroll
  for (int q = 0; q < NB * BK / 4 / NT; ++q) {
    const int idx = threadIdx.x + q * NT;
    const int row = idx / (BK / 4), c4 = idx % (BK / 4);
    cp_async16(st + row * LDS + 4 * c4, X + (int64_t)row * ldx + k0 + 4 * c4);
    cp_async16(st + (NB + row) * LDS + 4 * c4, Y + (int64_t)row * ldy + k0 + 4 * c4);
  }
}

// acc = X Y^T for row-major 128 x 128 X and Y (leading dimensions ldx, ldy),
// summed from zero. Warp w owns rows 64 (w / 4) + [0, 64) and columns
// 32 (w % 4) + [0, 32) as 4 x 4 mma tiles of 16 x 8. All threads return
// with the copies drained. Where the product will be subtracted from a tile
// C (leading dimension ldc), C is copied into the ring's stages behind the
// last chunk while that chunk is multiplied, and waits there (row stride
// LDC) for tile_store: reading it after the product, 32 bytes a row a warp,
// cost more than a third of the whole tile's time.
__device__ void tile_product(float (&acc)[4][4][4], const float* X, int64_t ldx, const float* Y,
                             int64_t ldy, float* ring, const float* C = nullptr, int64_t ldc = 0) {
  const int warp = threadIdx.x / 32;
  const int m0 = 64 * (warp / 4), n0 = 32 * (warp % 4);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  constexpr int NCH = NB / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    stage_load(ring + s * STAGE_FLOATS, X, ldx, Y, ldy, s * BK);
    cp_async_commit();
  }
  for (int c = 0; c < NCH; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's part)
    __syncthreads();              // everyone's part; and chunk c - 1 is consumed
    if (c + STAGES - 1 < NCH)
      stage_load(ring + ((c + STAGES - 1) % STAGES) * STAGE_FLOATS, X, ldx, Y, ldy, (c + STAGES - 1) * BK);
    if (C != nullptr && c == NCH - 1) {
#pragma unroll 4
      for (int idx = threadIdx.x; idx < NB * NB / 4; idx += NT) {
        const int row = idx / (NB / 4), c4 = idx % (NB / 4);
        cp_async16(ring + STAGE_FLOATS + row * LDC + 4 * c4, C + (int64_t)row * ldc + 4 * c4);
      }
    }
    cp_async_commit();
    const float* Xs = ring + (c % STAGES) * STAGE_FLOATS;
    const float* Ys = Xs + NB * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      FragB b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) b[nt] = load_b(Ys, LDS, n0 + 8 * nt, kk);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const FragA a = load_a(Xs, LDS, m0 + 16 * mt, kk);
        mma3<4>(acc[mt], a, b);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// tile = acc (SUB false), or tile = old - acc (SUB true) with the old tile
// where tile_product left it in the ring; tile has row stride ld.
template <bool SUB>
__device__ __forceinline__ void tile_store(float* tile, int64_t ld, const float (&acc)[4][4][4],
                                           const float* ring = nullptr) {
  const int warp = threadIdx.x / 32;
  const int m0 = 64 * (warp / 4), n0 = 32 * (warp % 4);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* p = reinterpret_cast<float2*>(tile + (int64_t)(m0 + 16 * mt + acc_row(2 * h)) * ld + n0 +
                                              8 * nt + acc_col(0));
        float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (SUB) {
          const float2 o = *reinterpret_cast<const float2*>(ring + STAGE_FLOATS + (m0 + 16 * mt + acc_row(2 * h)) * LDC +
                                                            n0 + 8 * nt + acc_col(0));
          v = make_float2(o.x - v.x, o.y - v.y);
        }
        *p = v;
      }
}

// 32 x 32 block (rb, cb) of W = L^-1 where the diagonal step keeps it: the
// diagonal blocks in Wd, a block below the diagonal in the mirrored block of
// S above the diagonal (free once the factor has left).
__device__ __forceinline__ float* wblock(float* S, float* Wd, int rb, int cb, int& ld) {
  if (rb == cb) {
    ld = LDP;
    return Wd + rb * SB * LDP;
  }
  ld = LDD;
  return S + (SB * cb) * LDD + SB * rb;
}

// Off-diagonal part of W = L^-1 between block rows [rb0, rb0 + nblk) and
// block columns [cb0, cb0 + nblk) (32 x 32 blocks), whose two diagonal
// neighbours are done: W_rc = -W_rr (L_rc W_cc), first T = L_rc W_cc, then
// -W_rr T. Each thread carries four entries of the result, four rows apart
// or eight, so four independent sums are in flight.
__device__ void inverse_offdiag(float* S, float* Wd, float* T, int rb0, int cb0, int nblk) {
  const int size = SB * nblk, ldt = size + 1, step = NT / size;
  const int n = threadIdx.x % size, nbk = n / SB, ni = n % SB;
  for (int q0 = 0; q0 < size / step; q0 += 4) {
    const int m0 = threadIdx.x / size + step * q0;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kb = nbk; kb < nblk; ++kb) {
      int ldw;
      const float* w = wblock(S, Wd, cb0 + kb, cb0 + nbk, ldw) + ni;
      const float* l = S + (SB * rb0 + m0) * LDD + SB * (cb0 + kb);
      for (int k0 = 0; k0 < SB; k0 += 8) {
#pragma unroll
        for (int k = k0; k < k0 + 8; ++k) {
          const float wk = w[k * ldw];
#pragma unroll
          for (int q = 0; q < 4; ++q) s[q] = fmaf(l[q * step * LDD + k], wk, s[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) T[(m0 + q * step) * ldt + n] = s[q];
  }
  __syncthreads();
  for (int q0 = 0; q0 < size / step; q0 += 4) {
    const int m0 = threadIdx.x / size + step * q0;  // the four rows m0 + q step share a block
    const int mbk = m0 / SB;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kb = 0; kb <= mbk; ++kb) {
      int lda;
      const float* a = wblock(S, Wd, rb0 + mbk, rb0 + kb, lda) + (m0 % SB) * lda;
      const float* t = T + (SB * kb) * ldt + n;
      for (int k0 = 0; k0 < SB; k0 += 8) {
#pragma unroll
        for (int k = k0; k < k0 + 8; ++k) {
          const float tk = t[k * ldt];
#pragma unroll
          for (int q = 0; q < 4; ++q) s[q] = fmaf(a[q * step * lda + k], tk, s[q]);
        }
      }
    }
    int ldo;
    float* o = wblock(S, Wd, rb0 + mbk, cb0 + nbk, ldo) + (m0 % SB) * ldo + ni;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q * step * ldo] = -s[q];
  }
  __syncthreads();
}

// The diagonal step of panel p, by one CTA: where a panel lies to the left,
// blk -= left left^T first (the last panel's update of this one tile, which
// the trailing CTAs leave to this one); then blk <- chol(blk) (zeros above
// the diagonal) and Wg <- blk^-1.
__device__ void diagonal_step(float* smem, float* blk, int64_t n, float* Wg, const float* left) {
  float* S = smem;              // [NB][LDD] the block, then its factor, then W's blocks above the diagonal
  float* P = S + NB * LDD;      // [NB][LDP] product of the finished micro blocks; the inverse's temporary
  float* Wd = P + TMP_FLOATS;   // [NB / SB][SB][LDP] inverses of the diagonal micro blocks
  float* Rd = Wd + NB * LDP;    // [NB] reciprocals of the pivots
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  if (left != nullptr) {
    float acc[4][4][4];
    tile_product(acc, left, n, left, n, smem, blk, n);
    tile_store<true>(blk, n, acc, smem);
    __syncthreads();  // the block is read back below; the ring becomes S
  }
#pragma unroll 4
  for (int idx = tid; idx < NB * NB / 4; idx += NT) {
    const int r = idx / (NB / 4), c = 4 * (idx % (NB / 4));
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c <= r) v = *reinterpret_cast<const float4*>(blk + (int64_t)r * n + c);
    float* d = S + r * LDD + c;
    d[0] = v.x;
    d[1] = (c + 1 <= r) ? v.y : 0.0f;
    d[2] = (c + 2 <= r) ? v.z : 0.0f;
    d[3] = (c + 3 <= r) ? v.w : 0.0f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < NB; c0 += SB) {
    const int rows = NB - c0;
    // P[m][j] = sum_{k < c0} L[c0 + m][k] L[c0 + j][k], summed from zero: what
    // the finished micro blocks take from column block c0. Four rows a thread.
    for (int q0 = 0; q0 < rows / 8; q0 += 4) {
      const int j = tid % SB, m0 = tid / SB + 8 * q0;
      const float* x = S + (c0 + m0) * LDD;
      const float* y = S + (c0 + j) * LDD;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k0 = 0; k0 < c0; k0 += 8) {
#pragma unroll
        for (int k = k0; k < k0 + 8; ++k) {
          const float yk = y[k];
#pragma unroll
          for (int q = 0; q < 4; ++q) s[q] = fmaf(x[q * 8 * LDD + k], yk, s[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) P[(m0 + 8 * q) * LDP + j] = s[q];
    }
    __syncthreads();
    // The 32 x 32 diagonal micro block, by one warp: lane i holds row i of
    // the factor in registers. The subtrahend of entry (i, j) starts from
    // P and takes the row's finished entries; it leaves at the pivot. The
    // pivot's reciprocal square root (one Newton step on the hardware's)
    // scales the column and is kept for the solves below.
    if (warp == 0) {
      float* row = S + (c0 + lane) * LDD + c0;
      float l[SB];
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        float s = P[lane * LDP + j];
#pragma unroll
        for (int t = 0; t < j; ++t) s = fmaf(l[t], __shfl_sync(0xffffffffu, l[t], j), s);
        const float d = row[j] - s;
        const float dj = __shfl_sync(0xffffffffu, d, j);
        float r = rsqrtf(dj);
        r = r * fmaf(-0.5f * dj * r, r, 1.5f);
        l[j] = (lane == j) ? dj * r : (lane > j ? d * r : 0.0f);
        if (lane == j) Rd[c0 + j] = r;
      }
#pragma unroll
      for (int j = 0; j < SB; ++j) row[j] = l[j];
    }
    __syncthreads();
    // Rows below the micro block, one thread a row: x L_bb^T = a - P by
    // forward substitution, the subtrahend again summed apart.
    if (tid < rows - SB) {
      float* out = S + (c0 + SB + tid) * LDD + c0;
      const float* p = P + (SB + tid) * LDP;
      float x[SB];
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const float* lj = S + (c0 + j) * LDD + c0;
        float s = p[j];
#pragma unroll
        for (int t = 0; t < j; ++t) s = fmaf(x[t], lj[t], s);
        x[j] = (out[j] - s) * Rd[c0 + j];
      }
#pragma unroll
      for (int j = 0; j < SB; ++j) out[j] = x[j];
    }
    __syncthreads();
  }

  // The factor leaves (S is zero above the diagonal).
#pragma unroll 4
  for (int idx = tid; idx < NB * NB / 4; idx += NT) {
    const int r = idx / (NB / 4), c = 4 * (idx % (NB / 4));
    const float* d = S + r * LDD + c;
    *reinterpret_cast<float4*>(blk + (int64_t)r * n + c) = make_float4(d[0], d[1], d[2], d[3]);
  }
  // Inverses of the four 32 x 32 diagonal micro blocks, a warp each: lane c
  // solves L_bb w = e_c down its column, w in registers.
  if (warp < NB / SB) {
    const int b0 = SB * warp;
    float* wd = Wd + b0 * LDP + lane;
    float w[SB];
#pragma unroll
    for (int i = 0; i < SB; ++i) {
      const float* li = S + (b0 + i) * LDD + b0;
      float s = 0.0f;
#pragma unroll
      for (int t = 0; t < i; ++t) s = fmaf(li[t], w[t], s);
      w[i] = ((i == lane ? 1.0f : 0.0f) - s) * Rd[b0 + i];
      wd[i * LDP] = w[i];
    }
  }
  __syncthreads();
  // Blocks below the diagonal by the block-triangular inverse, at 32 then at 64.
  inverse_offdiag(S, Wd, P, 1, 0, 1);
  inverse_offdiag(S, Wd, P, 3, 2, 1);
  inverse_offdiag(S, Wd, P, 2, 0, 2);
  for (int idx = tid; idx < NB * NB; idx += NT) {
    const int r = idx / NB, c = idx % NB, rb = r / SB, cb = c / SB;
    int ld;
    Wg[idx] = (cb > rb) ? 0.0f : wblock(S, Wd, rb, cb, ld)[(r % SB) * ld + c % SB];
  }
}

// Lower tile (i, j), i >= j, of linear index t = i (i + 1) / 2 + j.
__device__ __forceinline__ void lower_tile(int t, int& i, int& j) {
  i = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  j = t - i * (i + 1) / 2;
}

// Panel step p over the lower tiles (i, j) of the matrix from block p on,
// blockIdx.x = i (i + 1) / 2 + j: every tile takes panel p - 1's update
// A_ij -= L_i,p-1 L_j,p-1^T; the CTA of tile (0, 0), the diagonal block of
// panel p, goes on to factor and invert it while the others work. For
// p = 0 there is no update and the grid is that one CTA.
__global__ void __launch_bounds__(NT, 2)
chol_panel_kernel(float* L, float* Winv, int64_t n, int p) {
  extern __shared__ __align__(16) float smem[];
  float* base = L + (int64_t)blockIdx.y * n * n;
  const int64_t k0 = (int64_t)(p - 1) * NB;
  if (blockIdx.x == 0) {
    float* blk = base + (int64_t)p * NB * n + (int64_t)p * NB;
    diagonal_step(smem, blk, n, Winv + (int64_t)blockIdx.y * NB * NB, p > 0 ? blk - NB : nullptr);
    return;
  }
  int i, j;
  lower_tile((int)blockIdx.x, i, j);
  const int64_t r0 = (int64_t)(p + i) * NB, c0 = (int64_t)(p + j) * NB;
  float acc[4][4][4];
  tile_product(acc, base + r0 * n + k0, n, base + c0 * n + k0, n, smem, base + r0 * n + c0, n);
  tile_store<true>(base + r0 * n + c0, n, acc, smem);
}

// Strip of panel p, one CTA per row tile i = p + 1 + blockIdx.x:
// L_ip = A_ip W_p^T in place (the CTA reads all of its tile before it writes).
__global__ void __launch_bounds__(NT, 2)
chol_strip_kernel(float* L, const float* Winv, int64_t n, int p) {
  extern __shared__ __align__(16) float smem[];
  float* tile = L + (int64_t)blockIdx.y * n * n + (int64_t)(p + 1 + blockIdx.x) * NB * n + (int64_t)p * NB;
  float acc[4][4][4];
  tile_product(acc, tile, n, Winv + (int64_t)blockIdx.y * NB * NB, NB, smem);
  tile_store<false>(tile, n, acc);
}

// c = a b^T for 128 x 128 row-major a and b: the tile product alone.
__global__ void __launch_bounds__(NT, 2)
tile_product_test_kernel(const float* a, const float* b, float* c) {
  extern __shared__ __align__(16) float smem[];
  float acc[4][4][4];
  tile_product(acc, a, NB, b, NB, smem);
  tile_store<false>(c, NB, acc);
}

cudaError_t allow_smem() {
  static cudaError_t done = [] {
    cudaError_t e = cudaFuncSetAttribute(chol_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(chol_strip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tile_product_test_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
    return e;
  }();
  return done;
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
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const int nb = (int)(N / NB);
  chol_panel_kernel<<<dim3(1u, (unsigned)D), NT, SMEM_BYTES, s>>>(L, winv, N, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int p = 0; p + 1 < nb; ++p) {
    const int below = nb - 1 - p;  // row tiles below diagonal block p
    chol_strip_kernel<<<dim3((unsigned)below, (unsigned)D), NT, RING_BYTES, s>>>(L, winv, N, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    chol_panel_kernel<<<dim3((unsigned)(below * (below + 1) / 2), (unsigned)D), NT, SMEM_BYTES, s>>>(
        L, winv, N, p + 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// c (128 x 128) = a b^T for row-major 128 x 128 a and b, through the same
// tile product as the factorization: for checks of the product alone.
extern "C" int blocked_chol_product_test_f32(const float* a, const float* b, float* c, void* stream) {
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  tile_product_test_kernel<<<1, NT, RING_BYTES, (cudaStream_t)stream>>>(a, b, c);
  return (int)cudaGetLastError();
}
